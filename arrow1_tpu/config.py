"""Engine configuration (reference model: per-call option structs + explicit
context, no globals — cpp/src/arrow/compute/exec.h:58 ExecContext and the
FunctionOptions hierarchy, SURVEY.md §5 "Config / flag system").

Environment variables honored (reference analogues):
- ``A1T_TARGET_BATCH_ROWS``: streaming batch target, default 2^21 rows
  (reference: kDefaultExecChunksize 64Ki at exec.h:50 — device-resident
  batches want millions of rows to amortize dispatch).
- ``A1T_DEFAULT_DEVICE``: jax device to place ingested tables on.
- ``JAX_COMPILATION_CACHE_DIR``: JAX's own persistent compile cache
  location; ``enable_compile_cache`` defers to it when set.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional

import jax

__all__ = ["ExecContext", "default_context", "TARGET_BATCH_ROWS",
           "enable_compile_cache"]

TARGET_BATCH_ROWS = int(os.environ.get("A1T_TARGET_BATCH_ROWS", 1 << 21))

# the checkout root: <repo>/arrow1_tpu/config.py -> <repo>
_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@dataclasses.dataclass
class ExecContext:
    """Execution context threaded through kernels (reference: exec.h:58).

    ``exec_chunksize`` plays the role of the reference's chunked execution
    target.
    """

    exec_chunksize: int = TARGET_BATCH_ROWS
    use_threads: bool = True
    device: Optional[jax.Device] = None


_default_context = ExecContext()


def default_context() -> ExecContext:
    return _default_context


def enable_compile_cache() -> str:
    """Turn on JAX's persistent compile cache for entry-point scripts and
    return its directory: ``$JAX_COMPILATION_CACHE_DIR`` when set (JAX
    reads it itself; no other directory is set here), else
    ``<repo>/.jax_cache``. The path is fixed, never per process or
    time-stamped, because it is part of the cache key."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    path = os.path.join(_REPO_ROOT, ".jax_cache")
    jax.config.update("jax_compilation_cache_dir", path)
    return path

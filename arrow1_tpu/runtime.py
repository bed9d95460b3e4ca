"""Runtime/build info + memory observability.

Reference: cpp/src/arrow/config.{h,cc} (GetBuildInfo/GetRuntimeInfo —
version + active SIMD level) and memory_pool.h:114,138
(LoggingMemoryPool/ProxyMemoryPool + bytes_allocated/max_memory
counters). Device mapping: "SIMD level" becomes the active XLA backend +
device kind; pool counters come from the PJRT allocator via
Device.memory_stats().
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

__all__ = ["build_info", "runtime_info", "device_memory_stats",
           "MemoryLog"]


@dataclasses.dataclass(frozen=True)
class BuildInfo:
    version: str
    jax_version: str
    pyarrow_version: str
    native_library: bool


def build_info() -> BuildInfo:
    """Reference: GetBuildInfo (config.h)."""
    import jax
    import pyarrow

    from . import __version__
    from .native import native_available

    return BuildInfo(__version__, jax.__version__, pyarrow.__version__,
                     native_available())


@dataclasses.dataclass(frozen=True)
class RuntimeInfo:
    backend: str          # the "SIMD level" analogue: cpu | gpu | ...
    device_kind: str
    device_count: int
    x64_enabled: bool


def runtime_info() -> RuntimeInfo:
    """Reference: GetRuntimeInfo (config.h) — reports the compute tier the
    dispatch actually selected."""
    import jax

    devs = jax.devices()
    return RuntimeInfo(
        backend=jax.default_backend(),
        device_kind=getattr(devs[0], "device_kind", "unknown"),
        device_count=len(devs),
        x64_enabled=bool(jax.config.jax_enable_x64),
    )


def device_memory_stats(device=None) -> Dict[str, int]:
    """Allocator counters (reference: MemoryPool::bytes_allocated /
    max_memory). Empty dict when the backend exposes none (CPU)."""
    import jax

    dev = device or jax.devices()[0]
    try:
        return dict(dev.memory_stats() or {})
    except Exception:
        return {}


class profile:
    """JAX profiler trace context (SURVEY.md §5 tracing: the reference has
    only benchmark counters; the device equivalent is a real profiler trace
    viewable in XProf/TensorBoard).

        with runtime.profile("/tmp/a1t-trace"):
            pipe(batch)
    """

    def __init__(self, log_dir: str):
        self.log_dir = log_dir

    def __enter__(self):
        import jax

        jax.profiler.start_trace(self.log_dir)
        return self

    def __exit__(self, *exc):
        import jax

        jax.profiler.stop_trace()


class MemoryLog:
    """LoggingMemoryPool analogue (memory_pool.h:114): snapshot allocator
    stats around a code region and report the delta."""

    def __init__(self, device=None, label: str = ""):
        self.device = device
        self.label = label
        self.before: Dict[str, int] = {}
        self.after: Dict[str, int] = {}

    def __enter__(self):
        self.before = device_memory_stats(self.device)
        return self

    def __exit__(self, *exc):
        self.after = device_memory_stats(self.device)

    @property
    def delta(self) -> Dict[str, int]:
        return {k: self.after.get(k, 0) - self.before.get(k, 0)
                for k in set(self.before) | set(self.after)}

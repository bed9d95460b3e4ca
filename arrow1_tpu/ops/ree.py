"""Run-end encoding + random (reference: vector_run_end_encode.cc +
vector_random.cc).

Run-end-encoded data is represented as a RecordBatch{run_ends: int32,
values} — structurally identical to the reference's REE array (child
run_ends + values), without a dedicated wrapper type. Device note: REE is a
host/storage format; compute always runs on the decoded dense form.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp

from .. import dtypes as dt
from ..column import Column
from ..errors import Invalid
from ..registry import register_function
from ..table import RecordBatch


@dataclasses.dataclass
class RunEndEncodeOptions:
    """Reference: api_vector.h RunEndEncodeOptions (run_end_type in
    {int16, int32, int64})."""
    run_end_type: object = None


def _run_end_dtype(options):
    t = options.run_end_type if options is not None else None
    if t is None:
        return dt.int32, jnp.int32
    t = dt.from_arrow(t) if not isinstance(t, dt.DataType) else t
    phys = {"int16": jnp.int16, "int32": jnp.int32,
            "int64": jnp.int64}.get(t.kind)
    if phys is None:
        raise Invalid(f"run_end_type must be int16/int32/int64, got {t}")
    return t, phys


def _run_end_encode_exec(args, options: RunEndEncodeOptions, ctx):
    (col,) = args
    end_t, end_phys = _run_end_dtype(options)
    n = col.length
    if n == 0:
        return RecordBatch(
            (Column(jnp.zeros(0, end_phys), end_t), col),
            ("run_ends", "values"))
    x = col.data
    valid = col.mask()
    first = jnp.ones(n, jnp.bool_)
    if n > 1:
        same = (x[1:] == x[:-1]) & (valid[1:] == valid[:-1])
        # two nulls are the same run regardless of payload
        same = same | (~valid[1:] & ~valid[:-1])
        first = first.at[1:].set(~same)
    (starts,) = jnp.nonzero(first)
    ends = jnp.concatenate([starts[1:], jnp.asarray([n])]).astype(end_phys)
    from .selection import take_column

    vals = take_column(col, starts)
    return RecordBatch((Column(ends, end_t), vals),
                       ("run_ends", "values"))


def _run_end_decode_exec(args, options, ctx):
    (ree,) = args
    if not isinstance(ree, RecordBatch) or \
            "run_ends" not in ree.names or "values" not in ree.names:
        raise Invalid("run_end_decode: expects {run_ends, values}")
    ends = ree.column("run_ends").data.astype(jnp.int64)
    vals = ree.column("values")
    k = int(ends.shape[0])
    n = int(ends[-1]) if k else 0
    starts = jnp.concatenate([jnp.zeros(1, jnp.int64), ends[:-1]])
    lengths = ends - starts
    parent = jnp.repeat(jnp.arange(k, dtype=jnp.int64), lengths,
                        total_repeat_length=n)
    from .selection import take_column

    return take_column(vals, parent)


register_function("run_end_encode", "vector", 1, RunEndEncodeOptions)(
    _run_end_encode_exec)
register_function("run_end_decode", "vector", 1)(_run_end_decode_exec)


@dataclasses.dataclass
class RandomOptions:
    length: int = 0
    initializer: object = "system"


def _random_exec(args, options: RandomOptions, ctx):
    """Uniform [0,1) float64 (reference: vector_random.cc). device-native:
    jax threefry PRNG — deterministic for an integer initializer."""
    options = options or RandomOptions()
    n = int(options.length)
    seed = options.initializer
    if seed == "system" or seed is None:
        import secrets

        seed = secrets.randbits(63)
    key = jax.random.PRNGKey(int(seed))
    return Column(jax.random.uniform(key, (n,), jnp.float64), dt.float64)


register_function("random", "vector", -1, RandomOptions)(_random_exec)

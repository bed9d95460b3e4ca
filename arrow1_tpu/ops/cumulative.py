"""Cumulative vector kernels: cumulative_sum/prod/min/max/mean (+checked),
pairwise_diff, fill_null_forward/backward.

Reference: compute/kernels/vector_cumulative_ops.cc + vector_pairwise.cc +
vector_replace.cc (FillNullForward/Backward). All are scans — the
device-native form is jnp.cumsum/cummax/associative_scan; null semantics
follow the reference exactly:

- skip_nulls=False (default): the first null poisons every later slot
- skip_nulls=True: null slots stay null but do not interrupt accumulation
- fill_null_forward/backward: last/next-valid carry via a cummax of
  valid positions + one gather (scatter-free).
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
from ..kernels.blockscan import cumsum_blocked, scan_blocked

from .. import dtypes as dt
from .common import collapse_validity
from ..column import Column
from ..errors import Invalid
from ..registry import register_function

__all__ = ["CumulativeOptions", "CumulativeSumOptions", "PairwiseOptions"]


@dataclasses.dataclass
class CumulativeOptions:
    start: object = None
    skip_nulls: bool = False


# pyarrow legacy alias (same fields)
CumulativeSumOptions = CumulativeOptions


@dataclasses.dataclass
class PairwiseOptions:
    period: int = 1


def _cumulative(name, scan_fn, neutral_for, is_mean=False):
    def exec_fn(args, options: CumulativeOptions, ctx):
        (a,) = args
        options = options or CumulativeOptions()
        t = a.dtype
        if not t.is_numeric:
            raise Invalid(f"{name}: expects numeric")
        out_t = dt.float64 if is_mean and not t.is_floating else t
        x = a.data.astype(out_t.physical_dtype())
        valid = None if a.validity is None else a.validity
        neutral = neutral_for(x.dtype)
        xin = x if valid is None else jnp.where(valid, x, neutral)
        if is_mean:
            csum = cumsum_blocked(xin)
            cnt = cumsum_blocked(jnp.ones_like(xin) if valid is None
                             else valid.astype(xin.dtype))
            r = csum / jnp.maximum(cnt, 1)
        else:
            r = scan_fn(xin)
            if name == "cumulative_max" and jnp.issubdtype(
                    x.dtype, jnp.floating):
                # reference folds its identity (numeric_limits::min() =
                # smallest positive normal) into every prefix
                import numpy as _np

                r = jnp.maximum(r, _np.finfo(_np.dtype(x.dtype)).tiny)
            if options.start is not None:
                if name.startswith("cumulative_sum"):
                    r = r + jnp.asarray(options.start, r.dtype)
                elif name.startswith("cumulative_prod"):
                    r = r * jnp.asarray(options.start, r.dtype)
                elif name == "cumulative_min":
                    r = jnp.minimum(r, jnp.asarray(options.start, r.dtype))
                elif name == "cumulative_max":
                    r = jnp.maximum(r, jnp.asarray(options.start, r.dtype))
        if valid is None:
            return Column(r, out_t)
        if options.skip_nulls:
            out_valid = valid
        else:
            out_valid = jnp.cumprod(valid.astype(jnp.int8)).astype(bool)
        return Column(r, out_t, validity=out_valid)

    return exec_fn


def _cummin(x):
    return scan_blocked(jnp.minimum, x)


def _cummax(x):
    return scan_blocked(jnp.maximum, x)


def _max_neutral(dtype):
    if jnp.issubdtype(dtype, jnp.floating):
        # bug-compat with the reference: the C++ identity is
        # numeric_limits<T>::min() — the smallest POSITIVE normal for
        # floats — so an all-negative prefix "maxes out" at ~2.2e-308
        import numpy as _np

        return jnp.array(_np.finfo(_np.dtype(dtype)).tiny, dtype)
    return jnp.iinfo(dtype).min


def _cumprod_blocked(x):
    return scan_blocked(jnp.multiply, x)


def _min_neutral(dtype):
    if jnp.issubdtype(dtype, jnp.floating):
        return jnp.array(jnp.inf, dtype)
    return jnp.iinfo(dtype).max


for _n, _scan, _neutral, _mean in [
    ("cumulative_sum", cumsum_blocked, lambda d: 0, False),
    ("cumulative_sum_checked", cumsum_blocked, lambda d: 0, False),
    ("cumulative_prod", _cumprod_blocked, lambda d: 1, False),
    ("cumulative_prod_checked", _cumprod_blocked, lambda d: 1, False),
    ("cumulative_min", _cummin, _min_neutral, False),
    ("cumulative_max", _cummax, _max_neutral, False),
    ("cumulative_mean", None, lambda d: 0, True),
]:
    register_function(_n, "vector", 1, CumulativeOptions)(
        _cumulative(_n, _scan, _neutral, _mean))


def _pairwise_diff_exec(args, options: PairwiseOptions, ctx):
    (a,) = args
    options = options or PairwiseOptions()
    p = options.period
    t = a.dtype
    if not t.is_numeric and not t.is_temporal and not t.is_decimal:
        raise Invalid("pairwise_diff: expects numeric")
    n = a.length
    idx = jnp.arange(n)
    src = idx - p
    in_range = (src >= 0) & (src < n)
    src_c = jnp.clip(src, 0, max(n - 1, 0))
    valid = in_range
    if a.validity is not None:
        valid = valid & a.validity & a.validity[src_c]
    if t.is_decimal:
        # exact limb-wise diff; result widens one digit like the
        # reference (decimal subtract output type)
        from .decimal import decimal_subtract

        shifted = Column(a.data[src_c], t,
                         data2=None if a.data2 is None
                         else a.data2[src_c])
        d = decimal_subtract(a, shifted)
        return Column(d.data, d.dtype, validity=collapse_validity(valid),
                      data2=d.data2)
    x = a.data
    if t.kind == "date32":
        # date32 diff is duration[s] (pairwise on dates; oracle-checked)
        x = x.astype(jnp.int64) * 86400
        out_t = dt.duration("s")
    elif t.kind == "date64":
        out_t = dt.duration("ms")
    elif t.is_temporal:
        out_t = dt.duration(t.unit or "us")
    else:
        out_t = t
    r = x - x[src_c]
    return Column(r.astype(out_t.physical_dtype()), out_t,
                  validity=collapse_validity(valid))


register_function("pairwise_diff", "vector", 1, PairwiseOptions)(
    _pairwise_diff_exec)
register_function("pairwise_diff_checked", "vector", 1, PairwiseOptions)(
    _pairwise_diff_exec)


def _fill_null_directional(backward: bool):
    def exec_fn(args, options, ctx):
        (a,) = args
        if a.validity is None:
            return a
        n = a.length
        valid = a.validity
        idx = jnp.arange(n)
        if backward:
            # next valid position: reverse cummin of valid positions
            pos = jnp.where(valid, idx, n)
            carry = scan_blocked(jnp.minimum, pos, reverse=True)
            has = carry < n
        else:
            pos = jnp.where(valid, idx, -1)
            carry = scan_blocked(jnp.maximum, pos)
            has = carry >= 0
        src = jnp.clip(carry, 0, n - 1)
        data = jnp.where(has, a.data[src], a.data)
        out_valid = valid | has
        data2 = None
        if a.data2 is not None:
            data2 = jnp.where(has, a.data2[src], a.data2)
        return Column(data, a.dtype,
                      validity=collapse_validity(out_valid),
                      dictionary=a.dictionary, data2=data2)

    return exec_fn


register_function("fill_null_forward", "vector", 1)(
    _fill_null_directional(False))
register_function("fill_null_backward", "vector", 1)(
    _fill_null_directional(True))

"""Scalar aggregate kernels: count/sum/mean/min_max/any/all/mode/variance/
stddev/quantile/tdigest.

Reference: cpp/src/arrow/compute/kernels/aggregate_basic.cc,
aggregate_var_std.cc, aggregate_mode.cc, aggregate_quantile.cc,
aggregate_tdigest.cc. The reference kernels are consume/merge/finalize
state machines (aggregate_internal.h:52) so chunked inputs reduce in
bounded memory; on the device a whole HBM-resident column reduces in one fused
XLA reduction, and chunk-merging happens at the streaming-executor level
instead (exec/streaming.py) using the same merge algebra (sum of partials,
min of partials, Welford/Chan merge for variance).

Null handling follows ScalarAggregateOptions (api_aggregate.h:36):
skip_nulls=True, min_count=1 — fewer than min_count valid values yields a
null scalar.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import jax.numpy as jnp
import numpy as np

from .. import dtypes as dt
from ..column import Column
from ..datum import Scalar
from ..errors import Invalid
from ..registry import register_function
from ..table import RecordBatch

__all__ = [
    "ScalarAggregateOptions", "CountOptions", "VarianceOptions",
    "ModeOptions", "QuantileOptions", "TDigestOptions",
]


@dataclasses.dataclass
class ScalarAggregateOptions:
    """Reference: api_aggregate.h:36."""

    skip_nulls: bool = True
    min_count: int = 1


@dataclasses.dataclass
class CountOptions:
    """Reference: api_aggregate.h:46 (COUNT_NON_NULL vs COUNT_NULL)."""

    mode: str = "only_valid"  # "only_valid" | "only_null" | "all"


@dataclasses.dataclass
class VarianceOptions:
    """Reference: api_aggregate.h:120."""

    ddof: int = 0
    skip_nulls: bool = True
    min_count: int = 0


@dataclasses.dataclass
class ModeOptions:
    """Reference: api_aggregate.h:100."""

    n: int = 1
    skip_nulls: bool = True
    min_count: int = 0


@dataclasses.dataclass
class QuantileOptions:
    """Reference: api_aggregate.h:140."""

    q: Sequence[float] = (0.5,)
    interpolation: str = "linear"  # linear|lower|higher|nearest|midpoint
    skip_nulls: bool = True
    min_count: int = 0

    def __post_init__(self):
        if isinstance(self.q, (int, float)):
            self.q = (float(self.q),)


@dataclasses.dataclass
class TDigestOptions:
    """Reference: api_aggregate.h:160. delta/buffer_size retained for
    signature parity; the kernel computes the exact quantile (a full
    sort is cheaper on the device than a serial tdigest merge, and exact is a
    valid tdigest refinement)."""

    q: Sequence[float] = (0.5,)
    delta: int = 100
    buffer_size: int = 500

    def __post_init__(self):
        if isinstance(self.q, (int, float)):
            self.q = (float(self.q),)


def _valid_mask(col: Column):
    return col.validity


def _valid_count(col: Column) -> int:
    if col.validity is None:
        return col.length
    return int(jnp.sum(col.validity))


_SUM_TYPE = {"signed": dt.int64, "unsigned": dt.uint64}


def _sum_output_type(t: dt.DataType) -> dt.DataType:
    """Reference: aggregate_basic.cc SumImpl — accumulates in the 64-bit
    type of the input's class; floats accumulate in float64."""
    if t.is_signed_integer:
        return dt.int64
    if t.is_unsigned_integer:
        return dt.uint64
    if t.is_boolean:
        return dt.uint64
    if t.is_floating:
        return dt.float64
    raise Invalid(f"sum: unsupported type {t}")


def _masked(col: Column, fill):
    if col.validity is None:
        return col.data
    return jnp.where(col.validity, col.data, fill)


def _count_exec(args, options: CountOptions, ctx):
    (col,) = args
    options = options or CountOptions()
    if options.mode == "only_valid":
        v = _valid_count(col)
    elif options.mode == "only_null":
        v = col.length - _valid_count(col)
    elif options.mode == "all":
        v = col.length
    else:
        raise Invalid(f"bad count mode {options.mode!r}")
    return Scalar(v, dt.int64)


register_function("count", "aggregate", 1, CountOptions)(_count_exec)


def _decimal_exact_sum(col: Column) -> int:
    """Exact wide sum via per-limb 32-bit-half device sums (each half
    total < 2^63 for n < 2^31 rows), combined on host as a python int."""
    limbs = ([col.data.astype(jnp.uint64), col.data2.astype(jnp.uint64)]
             if col.dtype.kind == "decimal128" else
             __import__("arrow1_tpu.ops.decimal256",
                        fromlist=["limbs256"]).limbs256(col))
    valid = col.validity
    m32 = jnp.uint64(0xFFFFFFFF)
    total = 0
    for i, li in enumerate(limbs):
        lm = li if valid is None else jnp.where(valid, li, jnp.uint64(0))
        lo = int(jnp.sum((lm & m32).astype(jnp.int64)))
        hi = int(jnp.sum((lm >> jnp.uint64(32)).astype(jnp.int64)))
        total += (lo + (hi << 32)) << (64 * i)
    bits = 64 * len(limbs)
    total &= (1 << bits) - 1
    if total >= 1 << (bits - 1):
        total -= 1 << bits
    return total


def _decimal_sum_type(t: dt.DataType) -> dt.DataType:
    return (dt.decimal128(38, t.scale) if t.kind == "decimal128"
            else dt.decimal256(76, t.scale))


def _sum_exec(args, options: ScalarAggregateOptions, ctx):
    (col,) = args
    options = options or ScalarAggregateOptions()
    nvalid = _valid_count(col)
    if col.dtype.is_decimal:
        out_t = _decimal_sum_type(col.dtype)
        if nvalid < max(options.min_count, 1):
            return Scalar(0, out_t, is_valid=False)
        return Scalar(_decimal_exact_sum(col), out_t)
    out_t = _sum_output_type(col.dtype)
    if nvalid < max(options.min_count, 1):
        return Scalar(0, out_t, is_valid=False)
    acc = _masked(col, 0).astype(out_t.physical_dtype())
    return Scalar(jnp.sum(acc), out_t)


register_function("sum", "aggregate", 1, ScalarAggregateOptions)(_sum_exec)


def _product_exec(args, options: ScalarAggregateOptions, ctx):
    (col,) = args
    options = options or ScalarAggregateOptions()
    nvalid = _valid_count(col)
    if col.dtype.is_decimal:
        # sequential fold with per-step rescale to the input scale
        # (reference decimal product semantics); host-exact python ints
        import decimal as _d

        out_t = _decimal_sum_type(col.dtype)
        if nvalid < max(options.min_count, 1):
            return Scalar(0, out_t, is_valid=False)
        s = col.dtype.scale
        vals = col.to_arrow().to_pylist()
        # round-half-away-from-zero per step (matches the pyarrow oracle
        # on non-overflowing inputs; the 5.0 reference has no product
        # aggregate). Overflow raises instead of reproducing pyarrow's
        # 128-bit wrap garbage.
        ctx_ = _d.Context(prec=200, rounding=_d.ROUND_HALF_UP)
        acc = None
        q = _d.Decimal(1).scaleb(-s, ctx_)
        for v in vals:
            if v is None:
                continue
            acc = v if acc is None else \
                ctx_.multiply(acc, v).quantize(q, context=ctx_)
        unscaled = int(acc.scaleb(s, ctx_))
        digits = 38 if col.dtype.kind == "decimal128" else 76
        if abs(unscaled) >= 10 ** digits:
            raise Invalid("decimal product overflow")
        return Scalar(unscaled, out_t)
    out_t = _sum_output_type(col.dtype)
    if nvalid < max(options.min_count, 1):
        return Scalar(0, out_t, is_valid=False)
    acc = _masked(col, 1).astype(out_t.physical_dtype())
    return Scalar(jnp.prod(acc), out_t)


register_function("product", "aggregate", 1, ScalarAggregateOptions)(
    _product_exec)


def _mean_exec(args, options: ScalarAggregateOptions, ctx):
    (col,) = args
    options = options or ScalarAggregateOptions()
    nvalid = _valid_count(col)
    if col.dtype.is_decimal:
        # exact sum / count, rounded half-away-from-zero back to the
        # input scale (matches the pyarrow oracle: .015 -> .02)
        import decimal as _d

        out_t = _decimal_sum_type(col.dtype)
        if nvalid < max(options.min_count, 1):
            return Scalar(0, out_t, is_valid=False)
        total = _decimal_exact_sum(col)
        ctx_ = _d.Context(prec=200, rounding=_d.ROUND_HALF_UP)
        q = ctx_.divide(_d.Decimal(total),
                        _d.Decimal(int(nvalid))).quantize(
            _d.Decimal(1), context=ctx_)
        return Scalar(int(q), out_t)
    if nvalid < max(options.min_count, 1):
        return Scalar(0.0, dt.float64, is_valid=False)
    acc = _masked(col, 0).astype(jnp.float64)
    return Scalar(jnp.sum(acc) / nvalid, dt.float64)


register_function("mean", "aggregate", 1, ScalarAggregateOptions)(_mean_exec)


def _min_max_exec(args, options: ScalarAggregateOptions, ctx):
    """Returns a RecordBatch{min, max} of one row (the reference returns a
    StructScalar, api_aggregate.h MinMax)."""
    (col,) = args
    options = options or ScalarAggregateOptions()
    nvalid = _valid_count(col)
    t = col.dtype
    if nvalid < max(options.min_count, 1):
        d2 = jnp.zeros(1, jnp.int64) if t.is_decimal else None
        return RecordBatch(
            (Column(jnp.zeros(1, t.physical_dtype()), t,
                    validity=jnp.zeros(1, jnp.bool_),
                    dictionary=col.dictionary, data2=d2),
             Column(jnp.zeros(1, t.physical_dtype()), t,
                    validity=jnp.zeros(1, jnp.bool_),
                    dictionary=col.dictionary, data2=d2)),
            ("min", "max"))
    if t.is_binary:
        rank = jnp.asarray(col.dictionary.rank, jnp.int32)
        r = rank[col.data]
        big = jnp.iinfo(jnp.int32).max
        rmin = jnp.min(jnp.where(col.mask(), r, big))
        rmax = jnp.max(jnp.where(col.mask(), r, -1))
        inv = jnp.argsort(jnp.asarray(col.dictionary.rank))
        lo = inv[rmin].astype(col.data.dtype)
        hi = inv[rmax].astype(col.data.dtype)
        return RecordBatch(
            (Column(lo[None], t, dictionary=col.dictionary),
             Column(hi[None], t, dictionary=col.dictionary)), ("min", "max"))
    if t.is_decimal:
        if t.kind == "decimal256":
            # four-limb generalization of the two-limb reduction below:
            # top limb sign-flipped, lexicographic refinement limb by limb
            from .decimal256 import limbs256, pack256

            sign = jnp.uint64(1) << 63
            maxu = jnp.uint64(0xFFFFFFFFFFFFFFFF)
            limbs = limbs256(col)
            limbs[-1] = limbs[-1] ^ sign
            m = col.mask()

            def _extreme(reducer, bound):
                sel = m
                out = [None] * 4
                for i in range(3, -1, -1):
                    v = jnp.where(sel, limbs[i], bound)
                    mi = reducer(v)
                    sel = sel & (limbs[i] == mi)
                    out[i] = mi[None]
                out[-1] = out[-1] ^ sign
                return out

            lo_l = _extreme(jnp.min, maxu)
            hi_l = _extreme(jnp.max, jnp.uint64(0))
            return RecordBatch(
                (pack256(lo_l, t, None), pack256(hi_l, t, None)),
                ("min", "max"))
        # reduce via the two-limb normalized order (same normalization as
        # sort.py normalize_sort_key): hi limb sign-flipped to uint64,
        # lo limb plain unsigned; lexicographic (hi, lo) min/max.
        sign = jnp.uint64(1) << 63
        maxu = jnp.uint64(0xFFFFFFFFFFFFFFFF)
        hi = col.data2.astype(jnp.int64).astype(jnp.uint64) ^ sign
        lo = col.data.astype(jnp.uint64)
        m = col.mask()
        hi_lo_bound = jnp.where(m, hi, maxu)
        lo_lo_bound = jnp.where(m, lo, maxu)
        hmin = jnp.min(hi_lo_bound)
        lmin = jnp.min(jnp.where(hi_lo_bound == hmin, lo_lo_bound, maxu))
        hi_hi_bound = jnp.where(m, hi, jnp.uint64(0))
        lo_hi_bound = jnp.where(m, lo, jnp.uint64(0))
        hmax = jnp.max(hi_hi_bound)
        lmax = jnp.max(
            jnp.where(hi_hi_bound == hmax, lo_hi_bound, jnp.uint64(0)))
        return RecordBatch(
            (Column(lmin[None].astype(jnp.int64), t,
                    data2=(hmin ^ sign)[None].astype(jnp.int64)),
             Column(lmax[None].astype(jnp.int64), t,
                    data2=(hmax ^ sign)[None].astype(jnp.int64))),
            ("min", "max"))
    if t.is_floating:
        # arrow min/max ignore NaN only when... (5.0: NaN propagates).
        # pyarrow>=4 min_max returns NaN if present? empirically NaN is
        # ignored unless all values NaN; match numpy nanmin semantics.
        lo = jnp.nanmin(_masked(col, jnp.nan))
        hi = jnp.nanmax(_masked(col, jnp.nan))
    elif t.is_boolean:
        lo = jnp.min(_masked(col, True))
        hi = jnp.max(_masked(col, False))
    else:
        info = np.iinfo(np.dtype(t.physical_dtype()))
        lo = jnp.min(_masked(col, info.max))
        hi = jnp.max(_masked(col, info.min))
    return RecordBatch(
        (Column(lo[None].astype(t.physical_dtype()), t),
         Column(hi[None].astype(t.physical_dtype()), t)), ("min", "max"))


register_function("min_max", "aggregate", 1, ScalarAggregateOptions)(
    _min_max_exec)


def _mm_scalar(c):
    valid = c.validity is None or bool(c.validity[0])
    if c.data2 is not None:
        # combine the two int64 limbs into the full unscaled 128-bit int
        v = (int(c.data2[0]) << 64) | (int(c.data[0]) & 0xFFFFFFFFFFFFFFFF)
        return Scalar(v, c.dtype, is_valid=valid)
    return Scalar(c.data[0], c.dtype, is_valid=valid, dictionary=c.dictionary)


def _min_exec(args, options, ctx):
    return _mm_scalar(_min_max_exec(args, options, ctx)["min"])


def _max_exec(args, options, ctx):
    return _mm_scalar(_min_max_exec(args, options, ctx)["max"])


register_function("min", "aggregate", 1, ScalarAggregateOptions)(_min_exec)
register_function("max", "aggregate", 1, ScalarAggregateOptions)(_max_exec)


def _any_all(name, reducer, empty):
    def exec_fn(args, options: ScalarAggregateOptions, ctx):
        (col,) = args
        options = options or ScalarAggregateOptions()
        if not col.dtype.is_boolean:
            raise Invalid(f"{name}: expects boolean")
        nvalid = _valid_count(col)
        if nvalid < max(options.min_count, 1):
            return Scalar(False, dt.bool_, is_valid=False)
        return Scalar(reducer(_masked(col, empty)), dt.bool_)

    return exec_fn


register_function("any", "aggregate", 1, ScalarAggregateOptions)(
    _any_all("any", jnp.any, False))
register_function("all", "aggregate", 1, ScalarAggregateOptions)(
    _any_all("all", jnp.all, True))


def _as_float_if_decimal(col: Column) -> Column:
    if col.dtype.is_decimal:
        from .decimal import decimal_to_float

        return decimal_to_float(col)
    return col


def _drop_nan(col: Column) -> Column:
    """NaN counts as missing for order statistics (reference:
    aggregate_quantile.cc treats NaN like null)."""
    if not col.dtype.is_floating:
        return col
    ok = ~jnp.isnan(col.data)
    v = ok if col.validity is None else (col.validity & ok)
    return Column(col.data, col.dtype, validity=v)


def _var_std(name, is_std):
    def exec_fn(args, options: VarianceOptions, ctx):
        (col,) = args
        col = _as_float_if_decimal(col)
        options = options or VarianceOptions()
        nvalid = _valid_count(col)
        if nvalid <= options.ddof or nvalid < max(options.min_count, 1):
            return Scalar(0.0, dt.float64, is_valid=False)
        x = _masked(col, 0).astype(jnp.float64)
        mean = jnp.sum(x) / nvalid
        sq = jnp.where(col.mask(), (x - mean) ** 2, 0.0)
        var = jnp.sum(sq) / (nvalid - options.ddof)
        return Scalar(jnp.sqrt(var) if is_std else var, dt.float64)

    return exec_fn


register_function("variance", "aggregate", 1, VarianceOptions)(
    _var_std("variance", False))
register_function("stddev", "aggregate", 1, VarianceOptions)(
    _var_std("stddev", True))


def _sorted_valid(col: Column):
    """Valid values, sorted ascending, plus count (for order statistics).
    The data rides the key sort as a variadic payload (no gather)."""
    from ..kernels.radix import sort_rows
    from .sort import normalize_sort_key

    nvalid = _valid_count(col)
    keys = normalize_sort_key(col)
    pairs = [(k.astype(jnp.uint64), 2 if k.dtype == jnp.uint8 else 64)
             for k in keys]
    (data,) = sort_rows(pairs, (col.data,))
    return data.astype(jnp.float64), nvalid


def _quantile_values(col: Column, qs, interpolation: str):
    data, nvalid = _sorted_valid(col)
    out = []
    for q in qs:
        if not (0.0 <= q <= 1.0):
            raise Invalid(f"quantile q out of range: {q}")
        pos = q * (nvalid - 1)
        lo_i = int(np.floor(pos))
        hi_i = int(np.ceil(pos))
        lo, hi = data[lo_i], data[hi_i]
        if interpolation == "linear":
            frac = pos - lo_i
            v = lo * (1 - frac) + hi * frac
        elif interpolation == "lower":
            v = lo
        elif interpolation == "higher":
            v = hi
        elif interpolation == "midpoint":
            v = (lo + hi) / 2
        elif interpolation == "nearest":
            v = lo if (pos - lo_i) <= 0.5 else hi
        else:
            raise Invalid(f"bad interpolation {interpolation!r}")
        out.append(v)
    return out, nvalid, interpolation


def _quantile_exec(args, options: QuantileOptions, ctx):
    (col,) = args
    col = _drop_nan(_as_float_if_decimal(col))
    options = options or QuantileOptions()
    nvalid = _valid_count(col)
    if nvalid == 0 or nvalid < options.min_count:
        return Column(jnp.zeros(len(options.q), jnp.float64), dt.float64,
                      validity=jnp.zeros(len(options.q), jnp.bool_))
    vals, _, interp = _quantile_values(col, options.q, options.interpolation)
    # lower/higher/nearest return the input type (reference:
    # aggregate_quantile.cc output type logic); linear/midpoint float64
    if interp in ("lower", "higher", "nearest") and not col.dtype.is_floating:
        return Column(jnp.stack(vals).astype(col.dtype.physical_dtype()),
                      col.dtype)
    return Column(jnp.stack(vals), dt.float64)


register_function("quantile", "aggregate", 1, QuantileOptions)(_quantile_exec)


def _tdigest_exec(args, options: TDigestOptions, ctx):
    (col,) = args
    col = _drop_nan(_as_float_if_decimal(col))
    options = options or TDigestOptions()
    nvalid = _valid_count(col)
    if nvalid == 0:
        return Column(jnp.zeros(0, jnp.float64), dt.float64)
    vals, _, _ = _quantile_values(col, options.q, "linear")
    return Column(jnp.stack(vals), dt.float64)


register_function("tdigest", "aggregate", 1, TDigestOptions)(_tdigest_exec)


def _mode_exec(args, options: ModeOptions, ctx):
    """Returns RecordBatch{mode, count}: top-n most frequent values,
    ties -> smaller value first (reference: aggregate_mode.cc)."""
    (col,) = args
    options = options or ModeOptions()
    from .hash import grouping_by_keys
    from .selection import take_column
    from .sort import normalize_sort_key, sort_indices_device

    nvalid = _valid_count(col)
    if nvalid == 0:
        t = col.dtype
        return RecordBatch(
            (Column(jnp.zeros(0, t.physical_dtype()), t, dictionary=col.dictionary),
             Column(jnp.zeros(0, jnp.int64), dt.int64)), ("mode", "count"))
    keys = normalize_sort_key(col)
    gids, reps, ngroups = grouping_by_keys(keys)
    counts = jnp.zeros(ngroups, jnp.int64).at[gids].add(1)
    rep_valid = (col.validity[reps] if col.validity is not None
                 else jnp.ones(ngroups, jnp.bool_))
    # order: count desc, then value asc; exclude null group
    value_key = keys[-1][reps]
    order = sort_indices_device([
        jnp.where(rep_valid, jnp.uint8(0), jnp.uint8(1)),  # nulls last
        (~counts).astype(jnp.uint64),                       # count desc
        value_key,                                          # value asc
    ])
    top = order[: min(options.n, int(jnp.sum(rep_valid)))]
    mode_col = take_column(col, reps[top])
    count_col = Column(counts[top], dt.int64)
    return RecordBatch((mode_col, count_col), ("mode", "count"))


register_function("mode", "aggregate", 1, ModeOptions)(_mode_exec)


@dataclasses.dataclass
class IndexOptions:
    """Reference: api_aggregate.h IndexOptions (target value)."""
    value: object = None


def _index_exec(args, options, ctx):
    """index(values, value) or index(values, options=IndexOptions(value)):
    first occurrence position or -1
    (reference: aggregate kernel 'index', api_aggregate.h IndexOptions)."""
    if len(args) == 2:
        values, target = args
    elif len(args) == 1 and options is not None and \
            options.value is not None:
        from ..datum import as_datum
        values, target = args[0], as_datum(options.value)
    else:
        raise Invalid("index: needs a value argument or IndexOptions.value")
    from .common import value_of

    x = values.data
    if values.dtype.is_binary:
        sval = (target.dictionary.values[int(target.value)]
                if target.dictionary is not None else target.value)
        code = values.dictionary.index.get(sval, -1)
        hit = x == code
    else:
        hit = x == value_of(target, values.dtype)
    if values.validity is not None:
        hit = hit & values.validity
    any_hit = bool(jnp.any(hit))
    pos = int(jnp.argmax(hit)) if any_hit else -1
    return Scalar(pos, dt.int64)


register_function("index", "aggregate", -1, IndexOptions)(_index_exec)


def _first_last_idx(col: Column):
    """Indices of first/last valid rows (or -1)."""
    n = col.length
    if col.validity is None:
        return (0, n - 1) if n else (-1, -1)
    v = np.asarray(col.validity)
    idx = np.flatnonzero(v)
    if idx.size == 0:
        return -1, -1
    return int(idx[0]), int(idx[-1])


def _value_scalar(col: Column, i: int) -> Scalar:
    if i < 0:
        return Scalar(0, col.dtype, is_valid=False)
    if col.dictionary is not None:
        return Scalar(col.dictionary.values[int(col.data[i])], col.dtype)
    if col.data2 is not None:
        # decimal: surface via arrow for exact repr
        return Scalar(col.slice(i, 1).to_arrow()[0].as_py(), col.dtype)
    return Scalar(col.data[i], col.dtype)


def _first_exec(args, options: ScalarAggregateOptions, ctx):
    """Reference: "first" scalar aggregate (aggregate_basic.cc FirstLast)."""
    (col,) = args
    i, _ = _first_last_idx(col)
    return _value_scalar(col, i)


def _last_exec(args, options: ScalarAggregateOptions, ctx):
    (col,) = args
    _, j = _first_last_idx(col)
    return _value_scalar(col, j)


def _first_last_exec(args, options: ScalarAggregateOptions, ctx):
    """Returns a one-row RecordBatch{first, last} (reference returns a
    StructScalar)."""
    from ..table import RecordBatch

    (col,) = args
    i, j = _first_last_idx(col)

    def one_row(k):
        if k >= 0:
            return col.slice(k, 1)
        return Column(jnp.zeros(1, col.dtype.physical_dtype()), col.dtype,
                      validity=jnp.zeros(1, jnp.bool_),
                      dictionary=col.dictionary)

    return RecordBatch((one_row(i), one_row(j)), ("first", "last"))


register_function("first", "aggregate", 1, ScalarAggregateOptions)(
    _first_exec)
register_function("last", "aggregate", 1, ScalarAggregateOptions)(
    _last_exec)
register_function("first_last", "aggregate", 1, ScalarAggregateOptions)(
    _first_last_exec)


def _count_all_exec(args, options, ctx):
    """0-arg row count (reference: "count_all")."""
    if args:
        return Scalar(args[0].length, dt.int64)
    return Scalar(0, dt.int64)


register_function("count_all", "aggregate", -1)(_count_all_exec)


def _count_distinct_exec(args, options: CountOptions, ctx):
    (col,) = args
    options = options or CountOptions()
    from .hash import grouping_by_keys
    from .sort import normalize_sort_key

    keys = normalize_sort_key(col)
    _gids, _rep, ng = grouping_by_keys(keys)
    if options.mode == "all" or col.validity is None:
        return Scalar(ng, dt.int64)
    # only_valid: subtract 1 if a null group exists
    has_null = bool(jnp.any(~col.validity))
    return Scalar(ng - (1 if has_null else 0), dt.int64)


register_function("count_distinct", "aggregate", 1, CountOptions)(
    _count_distinct_exec)


@dataclasses.dataclass
class SkewOptions:
    skip_nulls: bool = True
    biased: bool = True
    min_count: int = 0


def _central_moments(col: Column):
    col = _as_float_if_decimal(col)
    x = _masked(col, 0).astype(jnp.float64)
    nv = _valid_count(col)
    if nv == 0:
        return 0, None, None, None
    mean = jnp.sum(x) / nv
    d = jnp.where(col.mask(), x - mean, 0.0)
    m2 = jnp.sum(d * d) / nv
    m3 = jnp.sum(d * d * d) / nv
    m4 = jnp.sum(d * d * d * d) / nv
    return nv, m2, m3, m4


def _skew_exec(args, options: SkewOptions, ctx):
    """Reference: "skew" aggregate — biased g1 = m3 / m2^1.5; unbiased
    multiplies by sqrt(n(n-1))/(n-2)."""
    (col,) = args
    options = options or SkewOptions()
    nv, m2, m3, _ = _central_moments(col)
    if nv < (2 if options.biased else 3):
        return Scalar(0.0, dt.float64, is_valid=False)
    g1 = m3 / jnp.maximum(m2, 1e-300) ** 1.5
    if not options.biased:
        g1 = g1 * jnp.sqrt(float(nv * (nv - 1))) / (nv - 2)
    return Scalar(g1, dt.float64)


def _kurtosis_exec(args, options: SkewOptions, ctx):
    """Biased g2 = m4/m2^2 - 3; unbiased Fisher correction."""
    (col,) = args
    options = options or SkewOptions()
    nv, m2, _, m4 = _central_moments(col)
    if nv < (2 if options.biased else 4):
        return Scalar(0.0, dt.float64, is_valid=False)
    g2 = m4 / jnp.maximum(m2 * m2, 1e-300) - 3.0
    if not options.biased:
        n = float(nv)
        g2 = ((n + 1) * g2 + 6) * (n - 1) / ((n - 2) * (n - 3))
    return Scalar(g2, dt.float64)


register_function("skew", "aggregate", 1, SkewOptions)(_skew_exec)
register_function("kurtosis", "aggregate", 1, SkewOptions)(_kurtosis_exec)


def _approximate_median_exec(args, options: ScalarAggregateOptions, ctx):
    """Reference: approximate_median (t-digest backed). The exact median
    is a valid approximation — we sort (a device primitive) instead of
    streaming a digest."""
    (col,) = args
    col = _drop_nan(_as_float_if_decimal(col))
    options = options or ScalarAggregateOptions()
    nvalid = _valid_count(col)
    if nvalid < max(options.min_count, 1):
        return Scalar(0.0, dt.float64, is_valid=False)
    (q,), _, _ = _quantile_values(col, [0.5], "linear")
    return Scalar(q, dt.float64)


register_function("approximate_median", "aggregate", 1,
                  ScalarAggregateOptions)(_approximate_median_exec)


@dataclasses.dataclass
class WinsorizeOptions:
    lower_limit: float = 0.0
    upper_limit: float = 1.0


def _winsorize_exec(args, options: WinsorizeOptions, ctx):
    """Clamp values to the [lower_limit, upper_limit] quantiles
    (reference: vector "winsorize" kernel)."""
    (col,) = args
    options = options or WinsorizeOptions()
    # nearest-rank bounds with asymmetric ties: the lower bound rounds
    # half *up*, the upper half *down* (both toward the interior) —
    # matches the reference winsorize exactly on tie positions
    data, nvalid = _sorted_valid(col)
    pos_lo = options.lower_limit * (nvalid - 1)
    pos_hi = options.upper_limit * (nvalid - 1)
    lo = data[int(np.floor(pos_lo + 0.5))]
    hi = data[int(np.ceil(pos_hi - 0.5))]
    x = col.data.astype(jnp.float64) if not col.dtype.is_floating \
        else col.data
    out = jnp.clip(x, lo, hi).astype(col.data.dtype)
    return Column(out, col.dtype, validity=col.validity)


register_function("winsorize", "vector", 1, WinsorizeOptions)(
    _winsorize_exec)

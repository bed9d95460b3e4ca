"""Set-lookup kernels: is_in / index_in.

Reference: cpp/src/arrow/compute/kernels/scalar_set_lookup.cc — MemoTable
built from the value set, probed per row. device redesign: the value set is
small and host-known, so normalize it to sorted device keys and probe with
vectorized binary search (searchsorted) — no hash table needed; dict-string
columns probe by code remap.

SetLookupOptions (reference: api_scalar.h:94): skip_nulls=False means a
null input matches a null in the value set.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Sequence

import jax.numpy as jnp
import numpy as np

from .. import dtypes as dt
from ..column import Column
from ..datum import Scalar
from ..errors import Invalid
from ..registry import register_function

__all__ = ["SetLookupOptions"]


@dataclasses.dataclass
class SetLookupOptions:
    """Reference: api_scalar.h:94."""

    value_set: Any = None
    skip_nulls: bool = False


def _value_set_list(value_set):
    """Accept list / numpy / pyarrow array / engine Column."""
    if isinstance(value_set, Column):
        return value_set.to_arrow().to_pylist()
    if hasattr(value_set, "to_pylist"):
        return value_set.to_pylist()
    return list(value_set)


def _set_members(col: Column, value_set):
    """(device sorted member keys, original positions sorted alike,
    set_has_null, nan_pos). NaN members are pulled out of the
    searchsorted table (NaN never compares equal) and reported by
    position — pa semantics: NaN in the set MATCHES NaN values."""
    if isinstance(value_set, Column) and col.dtype.is_temporal and \
            value_set.dtype.is_temporal and value_set.dtype == col.dtype:
        # storage-int fast path (meta_binary with a temporal set)
        raw = np.asarray(value_set.data, dtype=np.int64)
        ok = np.ones(len(raw), bool) if value_set.validity is None \
            else np.asarray(value_set.validity)
        vals = [int(v) if k else None for v, k in zip(raw, ok)]
    else:
        vals = _value_set_list(value_set)
    has_null = any(v is None for v in vals)
    nan_pos = -1
    if col.dtype.is_floating:
        for i, v in enumerate(vals):
            if isinstance(v, float) and v != v:
                nan_pos = i
                break
        if nan_pos >= 0:
            vals = [None if (isinstance(v, float) and v != v) else v
                    for v in vals]
    positions = [i for i, v in enumerate(vals) if v is not None]
    nonnull = [v for v in vals if v is not None]
    if col.dtype.is_binary:
        idx = col.dictionary.index if col.dictionary is not None else {}
        codes = [idx.get(v, -1 - i) for i, v in enumerate(nonnull)]
        member = np.asarray(codes, dtype=np.int64)
        x = col.data.astype(jnp.int64)
    elif col.dtype.is_temporal:
        member = np.asarray([_temporal_storage(v, col.dtype)
                             for v in nonnull], dtype=np.int64)
        x = col.data.astype(jnp.int64)
    else:
        member = np.asarray(nonnull, dtype=np.dtype(col.dtype.physical_dtype()))
        x = col.data
    order = np.argsort(member, kind="stable")
    member_sorted = jnp.asarray(member[order])
    pos_sorted = jnp.asarray(np.asarray(positions, dtype=np.int32)[order]) \
        if positions else jnp.zeros(0, jnp.int32)
    return x, member_sorted, pos_sorted, has_null, nan_pos


def _temporal_storage(v, t) -> int:
    """Python temporal object -> the column's storage integer."""
    if isinstance(v, (int, np.integer)):
        return int(v)
    import pyarrow as pa

    from .. import dtypes as _dt

    arr = pa.array([v], type=_dt.to_arrow(t))
    width = np.dtype(t.physical_dtype()).itemsize
    return int(np.asarray(
        arr.view(pa.int64() if width == 8 else pa.int32()))[0])


def _lookup_decimal(col: Column, options: SetLookupOptions):
    """Small-set broadcast equality over both limb planes (value sets
    are host-side literals; |set| comparisons per row)."""
    import decimal as _d

    vals = _value_set_list(options.value_set)
    has_null = any(v is None for v in vals)
    found = jnp.zeros(col.length, jnp.bool_)
    set_index = jnp.zeros(col.length, jnp.int32)
    ctx_ = _d.Context(prec=80)
    seen = set()
    lo = col.data
    hi = col.data2
    M = 0xFFFFFFFFFFFFFFFF
    for i, v in enumerate(vals):
        if v is None or v in seen:
            continue
        seen.add(v)
        uv = _d.Decimal(v).scaleb(col.dtype.scale, ctx_)
        if uv != uv.to_integral_value(context=ctx_):
            continue  # finer than the column scale: can never match
        u = int(uv)
        vlo = np.uint64(u & M).astype(np.int64)
        if col.dtype.kind == "decimal128":
            eq = (lo == jnp.int64(vlo)) & (hi == jnp.int64(u >> 64))
        else:
            limbs = [np.uint64((u >> (64 * (j + 1))) & M).astype(np.int64)
                     for j in range(3)]
            eq = lo == jnp.int64(vlo)
            for j in range(3):
                eq = eq & (hi[:, j] == jnp.int64(limbs[j]))
        set_index = jnp.where(eq & ~found, jnp.int32(i), set_index)
        found = found | eq
    return found, set_index, has_null


def _lookup(col: Column, options: SetLookupOptions):
    if col.dtype.is_decimal:
        return _lookup_decimal(col, options)
    x, members, pos, has_null, nan_pos = _set_members(col,
                                                      options.value_set)
    if members.shape[0]:
        loc = jnp.searchsorted(members, x)
        loc = jnp.clip(loc, 0, members.shape[0] - 1)
        found = members[loc] == x
        set_index = pos[loc]
    else:
        found = jnp.zeros(col.length, jnp.bool_)
        set_index = jnp.zeros(col.length, jnp.int32)
    if nan_pos >= 0:
        isnan = jnp.isnan(col.data)
        found = found | isnan
        set_index = jnp.where(isnan, jnp.int32(nan_pos), set_index)
    return found, set_index, has_null


def _first_null_index(value_set):
    for i, v in enumerate(_value_set_list(value_set)):
        if v is None:
            return i
    return -1


def _is_in_exec(args, options: SetLookupOptions, ctx):
    (col,) = args
    if options is None or options.value_set is None:
        raise Invalid("is_in requires value_set")
    if isinstance(col, Scalar):
        raise Invalid("is_in expects an array")
    found, _, has_null = _lookup(col, options)
    if col.validity is not None:
        if options.skip_nulls or not has_null:
            found = found & col.validity
        else:
            found = jnp.where(col.validity, found, True)
    return Column(found, dt.bool_)


register_function("is_in", "scalar", 1, SetLookupOptions)(_is_in_exec)


def _index_in_exec(args, options: SetLookupOptions, ctx):
    (col,) = args
    if options is None or options.value_set is None:
        raise Invalid("index_in requires value_set")
    found, set_index, has_null = _lookup(col, options)
    null_pos = _first_null_index(options.value_set)
    out = set_index.astype(jnp.int32)
    validity = found
    if col.validity is not None:
        if options.skip_nulls or not has_null:
            validity = validity & col.validity
        else:
            out = jnp.where(col.validity, out, jnp.int32(null_pos))
            validity = jnp.where(col.validity, validity, True)
    from .common import collapse_validity

    return Column(jnp.where(validity, out, 0), dt.int32,
                  validity=collapse_validity(validity))


register_function("index_in", "scalar", 1, SetLookupOptions)(_index_in_exec)


def _meta_binary(inner):
    """Binary-argument form: the value set rides as the second argument
    instead of options (reference: scalar_set_lookup.cc IsInMetaBinary /
    IndexInMetaBinary). pyarrow semantics: nulls in the haystack match a
    null in the value set (skip_nulls=False)."""

    def exec_fn(args, options, ctx):
        col, value_set = args
        return inner([col], SetLookupOptions(value_set=value_set,
                                             skip_nulls=False), ctx)

    return exec_fn


register_function("is_in_meta_binary", "scalar", 2)(
    _meta_binary(_is_in_exec))
register_function("index_in_meta_binary", "scalar", 2)(
    _meta_binary(_index_in_exec))

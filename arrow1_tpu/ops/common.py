"""Shared kernel infrastructure: broadcasting, promotion, null propagation.

The device analogue of the reference's codegen_internal.h machinery
(ArrayIterator/OutputArrayWriter, codegen_internal.h:196,248) plus the
executor's NullPropagator (compute/exec.cc:295): instead of per-type
template instantiation + bitmap AND at runtime, we resolve types at trace
time and emit `mask_a & mask_b` into the XLA graph — XLA fuses it with the
elementwise op, giving the NullHandling::INTERSECTION policy
(kernel.h:428,437) for free.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import jax.numpy as jnp
import numpy as np

from .. import dtypes as dt
from ..column import Column
from ..datum import Scalar

__all__ = [
    "collapse_validity",
    "promote_numeric",
    "common_type",
    "unpack",
    "intersect_validity",
    "result_column",
    "value_of",
    "broadcast_length",
]

_FLOAT_ORDER = {"float16": 0, "bfloat16": 0, "float32": 1, "float64": 2}
_INT_BITS = {"int8": 8, "int16": 16, "int32": 32, "int64": 64,
             "uint8": 8, "uint16": 16, "uint32": 32, "uint64": 64}


def promote_numeric(types: Sequence[dt.DataType]) -> dt.DataType:
    """Arrow-style common numeric type (reference: the implicit-cast
    promotion performed by DispatchBest / CommonNumeric in
    compute/kernels/codegen_internal.cc)."""
    assert types
    # null-typed args (untyped null scalars) adopt the promoted type of the
    # rest (reference: null scalars cast implicitly at dispatch)
    types = [t for t in types if not t.is_null] or [dt.null]
    if types == [dt.null]:
        return dt.null
    if any(not t.is_numeric and not t.is_boolean for t in types):
        raise TypeError(f"non-numeric types in promotion: {types}")
    ts = [t for t in types if not t.is_boolean]
    if not ts:
        return dt.bool_
    floats = [t for t in ts if t.is_floating]
    if floats:
        best = max(_FLOAT_ORDER[t.kind] for t in floats)
        return {0: dt.float16, 1: dt.float32, 2: dt.float64}[best]
    signed = [t for t in ts if t.is_signed_integer]
    unsigned = [t for t in ts if t.is_unsigned_integer]
    if not unsigned:
        bits = max(_INT_BITS[t.kind] for t in signed)
        return {8: dt.int8, 16: dt.int16, 32: dt.int32, 64: dt.int64}[bits]
    if not signed:
        bits = max(_INT_BITS[t.kind] for t in unsigned)
        return {8: dt.uint8, 16: dt.uint16, 32: dt.uint32, 64: dt.uint64}[bits]
    # mixed: need a signed type that can hold the unsigned range
    sbits = max(_INT_BITS[t.kind] for t in signed)
    ubits = max(_INT_BITS[t.kind] for t in unsigned)
    bits = max(sbits, min(ubits * 2, 64))
    return {8: dt.int8, 16: dt.int16, 32: dt.int32, 64: dt.int64}[bits]


def common_type(args: Sequence) -> dt.DataType:
    return promote_numeric([a.dtype for a in args])


def broadcast_length(args: Sequence) -> Optional[int]:
    """Common column length, or None if all args are scalars (the all-scalar
    execution mode of the reference executor, exec.cc:553)."""
    n = None
    for a in args:
        if isinstance(a, Column):
            if n is not None and a.length != n:
                raise ValueError(f"length mismatch: {a.length} vs {n}")
            n = a.length
    return n


def value_of(a, target: Optional[dt.DataType] = None):
    """Raw jnp value of a Column or Scalar, cast to the target physical type."""
    if isinstance(a, Column):
        v = a.data
    else:
        v = a.value
        if not isinstance(v, jnp.ndarray):
            v = jnp.asarray(v, dtype=(target or a.dtype).physical_dtype())
    if target is not None and v.dtype != np.dtype(target.physical_dtype()):
        v = v.astype(target.physical_dtype())
    return v


def unpack(args: Sequence, target: Optional[dt.DataType] = None):
    """Split args into (values, validities, length). Scalars stay 0-d and
    broadcast inside jnp ops; a null scalar poisons the whole output
    (matching the reference executor's scalar null handling)."""
    n = broadcast_length(args)
    values = [value_of(a, target) for a in args]
    validities = []
    for a in args:
        if isinstance(a, Column):
            validities.append(a.validity)
        else:
            validities.append(None if a.is_valid else False)
    return values, validities, n


def intersect_validity(validities: List, n: Optional[int]):
    """AND of input masks (NullHandling::INTERSECTION, kernel.h:437).

    Entries: None = all valid, False = all null (null scalar), or a bool
    array."""
    if any(v is False for v in validities):
        if n is None:
            return False
        return jnp.zeros(n, dtype=jnp.bool_)
    masks = [v for v in validities if v is not None]
    if not masks:
        return None
    out = masks[0]
    for m in masks[1:]:
        out = out & m
    return out


def result_column(data, out_type: dt.DataType, validity, n: Optional[int],
                  dictionary=None):
    """Wrap kernel output as Column (array mode) or Scalar (all-scalar mode)."""
    if n is None:
        if validity is False:
            return Scalar(data, out_type, is_valid=False, dictionary=dictionary)
        return Scalar(data, out_type, is_valid=True, dictionary=dictionary)
    if validity is False:
        validity = jnp.zeros(n, dtype=jnp.bool_)
    return Column(data, out_type, validity=validity, dictionary=dictionary)


def collapse_validity(mask):
    """Validity for a freshly computed mask: DEFERRED.

    The reference collapses all-valid bitmaps to "no bitmap" eagerly
    (NullPropagator, compute/exec.cc:295) — free on host. On a device
    the equivalent `bool(jnp.all(mask))` is a host sync that serializes
    every eager operator chain. Keep the mask on device; exports
    (to_arrow/null_count) collapse it where a host sync is inevitable
    anyway, and all-True masks behave identically through &/where.
    """
    return mask

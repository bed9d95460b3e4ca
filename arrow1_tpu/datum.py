"""Scalar and Datum: the universal kernel argument types.

Reference: cpp/src/arrow/scalar.h:52 (boxed single values per type) and
datum.h:105 (tagged union over Scalar/Array/ChunkedArray/RecordBatch/Table
used as the universal compute argument). The device design keeps the same
shape: kernels accept Datums so scalar/column broadcasting resolves at
trace time.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Union

import jax
import jax.numpy as jnp
import numpy as np

from . import dtypes as dt
from .column import (Column, Dictionary, ListColumn, StructColumn,
                     UnionColumn)
from .table import RecordBatch, Table

__all__ = ["Scalar", "Datum", "scalar", "as_datum"]


@jax.tree_util.register_pytree_node_class
class Scalar:
    """A typed single value, possibly null (reference: scalar.h:52).

    ``value`` may be a python number (static) or a 0-d jnp array (traced);
    keeping it a leaf lets scalar arguments flow through jit without
    recompiling per value.
    """

    __slots__ = ("value", "dtype", "is_valid", "dictionary")

    def __init__(self, value, dtype: dt.DataType, is_valid: bool = True,
                 dictionary: Optional[Dictionary] = None):
        self.value = value
        self.dtype = dtype
        self.is_valid = is_valid
        self.dictionary = dictionary

    def tree_flatten(self):
        return (self.value,), (self.dtype, self.is_valid, self.dictionary)

    @classmethod
    def tree_unflatten(cls, aux, children):
        dtype, is_valid, dictionary = aux
        return cls(children[0], dtype, is_valid, dictionary)

    @property
    def type(self):
        return self.dtype

    def cast(self, target_type, safe: bool = True):
        """Scalar cast (pyarrow.Scalar.cast shape)."""
        from .ops.cast import cast as _cast

        return _cast(self, target_type, safe=safe)

    def equals(self, other) -> bool:
        if not isinstance(other, Scalar):
            return False
        if self.is_valid != other.is_valid:
            return False
        return not self.is_valid or self.as_py() == other.as_py()

    def validate(self, full: bool = False):
        return None

    def as_py(self):
        if not self.is_valid:
            return None
        v = self.value
        if self.dictionary is not None:
            return self.dictionary.values[int(v)]
        if isinstance(v, (jnp.ndarray, np.ndarray)):
            v = v.item() if getattr(v, "ndim", 1) == 0 else v
        if self.dtype.is_boolean:
            return bool(v)
        if self.dtype.is_decimal:
            # value is the unscaled integer (reference: Decimal128Scalar);
            # decimal256 needs up to 77 digits
            from decimal import Context, Decimal

            return Decimal(int(v)).scaleb(-self.dtype.scale,
                                          Context(prec=80))
        if self.dtype.is_temporal:
            import pyarrow as pa

            return pa.scalar(int(v), type=dt.to_arrow(self.dtype)).as_py()
        return v

    def __repr__(self):
        return f"Scalar<{self.dtype!r}>({'null' if not self.is_valid else self.as_py()})"


def scalar(value, type: Optional[dt.DataType] = None) -> Scalar:
    """Build a Scalar with arrow-style type inference."""
    if isinstance(value, Scalar):
        return value
    if value is None:
        return Scalar(0, type or dt.null, is_valid=False)
    if type is not None and (type.is_string or type.kind in ("binary", "large_binary")):
        d = Dictionary(np.array([value], dtype=object))
        return Scalar(0, type, dictionary=d)
    if isinstance(value, bool):
        return Scalar(value, type or dt.bool_)
    if isinstance(value, (int, np.integer)):
        return Scalar(int(value), type or dt.int64)
    if isinstance(value, (float, np.floating)):
        return Scalar(float(value), type or dt.float64)
    import decimal as _dmod

    if isinstance(value, _dmod.Decimal):
        from decimal import Context

        t = type if type is not None and type.is_decimal else \
            dt.decimal128(38, max(0, -value.as_tuple().exponent))
        return Scalar(int(value.scaleb(t.scale, Context(prec=80))), t)
    if isinstance(value, (str, bytes)):
        d = Dictionary(np.array([value], dtype=object))
        return Scalar(0, type or (dt.string if isinstance(value, str) else dt.binary),
                      dictionary=d)
    if isinstance(value, (jnp.ndarray, np.ndarray)) and getattr(value, "ndim", 1) == 0:
        return Scalar(value, type or dt.from_numpy_dtype(value.dtype))
    raise TypeError(f"cannot build Scalar from {value.__class__.__name__}")


# Datum is a light union: kernels type-check with isinstance. The reference's
# Datum kinds (datum.h:118 NONE/SCALAR/ARRAY/CHUNKED_ARRAY/RECORD_BATCH/TABLE)
# map to Scalar / Column / Table-of-batches / RecordBatch / Table.
Datum = Union[Scalar, Column, ListColumn, RecordBatch, Table]


def as_datum(x) -> Datum:
    from .table import ChunkedColumn

    if isinstance(x, (Scalar, Column, ListColumn, StructColumn,
                      UnionColumn, RecordBatch, Table,
                      ChunkedColumn)):
        return x
    if isinstance(x, (list, np.ndarray, jnp.ndarray)) and getattr(x, "ndim", 1) != 0:
        from .column import column

        return column(x)
    try:
        import pyarrow as pa

        if isinstance(x, (pa.Array, pa.ChunkedArray)):
            from .column import column

            return column(x)
        if isinstance(x, (pa.RecordBatch, pa.Table)):
            from .interop import record_batch_from_arrow

            return record_batch_from_arrow(x)
        if isinstance(x, pa.Scalar):
            return scalar(x.as_py(), dt.from_arrow(x.type))
    except ImportError:
        pass
    return scalar(x)

"""Structural validation of columns and batches.

Reference: cpp/src/arrow/array/validate.cc — ValidateArray/ValidateFull
(buffer presence + cheap checks vs full data checks). The device layouts
have fewer invariants (no packed bitmaps, no offsets into shared
buffers); what remains: shape agreement, dictionary code ranges, list
offset monotonicity.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from .column import Column, ListColumn
from .errors import Invalid
from .table import RecordBatch

__all__ = ["validate_column", "validate_batch"]


def validate_column(col, full: bool = False) -> None:
    """Cheap structural checks; full=True adds data-dependent ones
    (reference: ValidateFull)."""
    if isinstance(col, ListColumn):
        if col.offsets.ndim != 1:
            raise Invalid("list offsets must be 1-D")
        if int(col.offsets.shape[0]) < 1:
            raise Invalid("list offsets must have length >= 1")
        if col.validity is not None and \
                col.validity.shape[0] != col.length:
            raise Invalid("list validity length mismatch")
        if full:
            if bool(jnp.any(col.offsets[1:] < col.offsets[:-1])):
                raise Invalid("list offsets must be monotonic")
            child_len = (col.values.num_rows
                         if isinstance(col.values, RecordBatch)
                         else col.values.length)
            if int(col.offsets[-1]) > child_len:
                raise Invalid("list offsets exceed child length")
        validate_column(col.values, full=full)
        return
    from .column import StructColumn, UnionColumn

    if isinstance(col, StructColumn):
        n = col.length
        for c in col.children:
            if c.length != n:
                raise Invalid("struct child length mismatch")
            validate_column(c, full=full)
        if col.validity is not None and col.validity.shape[0] != n:
            raise Invalid("struct validity length mismatch")
        return
    if isinstance(col, UnionColumn):
        if col.type_ids.ndim != 1:
            raise Invalid("union type_ids must be 1-D")
        n = col.length
        if col.is_dense:
            if col.offsets is None or col.offsets.shape[0] != n:
                raise Invalid("dense union offsets length mismatch")
        else:
            for c in col.children:
                if c.length != n:
                    raise Invalid("sparse union child length mismatch")
        if full:
            codes = set(np.asarray(col.type_ids).tolist())
            if not codes <= set(col.dtype.type_codes):
                raise Invalid("union type_ids outside declared type_codes")
        for c in col.children:
            validate_column(c, full=full)
        return
    if isinstance(col, RecordBatch):
        for c in col.columns:
            validate_column(c, full=full)
        return
    assert isinstance(col, Column)
    if col.data.ndim != 1:
        raise Invalid("column data must be 1-D")
    if col.validity is not None:
        if col.validity.dtype != jnp.bool_:
            raise Invalid("validity must be boolean")
        if col.validity.shape[0] != col.data.shape[0]:
            raise Invalid("validity length mismatch")
    if col.dtype.is_binary or col.dtype.is_dictionary:
        if col.dictionary is None:
            raise Invalid(f"{col.dtype} column requires a dictionary")
        if full and col.length:
            lo = int(jnp.min(col.data))
            hi = int(jnp.max(col.data))
            if lo < 0 or (len(col.dictionary) and
                          hi >= len(col.dictionary)):
                raise Invalid(
                    f"dictionary codes out of range [{lo},{hi}] for "
                    f"dictionary of {len(col.dictionary)}")
    if col.dtype.is_decimal and col.data2 is None:
        raise Invalid("decimal128 column requires the high-limb array")


def validate_batch(batch: RecordBatch, full: bool = False) -> None:
    n = batch.num_rows
    for name, col in zip(batch.names, batch.columns):
        if col.length != n:
            raise Invalid(f"column {name!r} length {col.length} != {n}")
        try:
            validate_column(col, full=full)
        except Invalid as e:
            raise Invalid(f"column {name!r}: {e}") from None

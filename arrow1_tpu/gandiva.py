"""Expression JIT: compiled projectors and filters.

Reference: cpp/src/gandiva/ (34.3 kLoC) — runtime LLVM codegen fusing a
whole expression tree into one per-batch loop (llvm_generator.h:93,
CodeGenExprValue :192), with Projector materializing outputs and Filter
emitting a SelectionVector of passing rows (projector.h:41, filter.h:66,
selection_vector.h:32).

On the device the entire Gandiva machinery collapses into `jax.jit`: an
Expression executed over a RecordBatch pytree traces to one XLA program,
and XLA's fusion pass plays the role of the LLVM loop fuser — including
the validity-bitmap locals Gandiva tracks explicitly (llvm_generator.h:
93-196), which here are just mask arrays inside the traced graph. What
this module adds is the Gandiva API shape: build once against a schema,
run many times with compiled-cache reuse (Gandiva's LRU module cache,
gandiva/cache.h, becomes XLA's compilation cache keyed on shapes).
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp

from . import dtypes as dt
from .column import Column
from .errors import Invalid
from .expr import Expression
from .table import RecordBatch

__all__ = ["Projector", "Filter", "SelectionVector", "make_projector",
           "make_filter"]


class SelectionVector:
    """Indices of passing rows (reference: gandiva/selection_vector.h:32).
    Padded device array + count, consumable by Projector.evaluate(...,
    selection=) without a host sync."""

    def __init__(self, indices: jnp.ndarray, count):
        self.indices = indices
        self.count = count

    def __len__(self):
        return int(self.count)

    def to_column(self) -> Column:
        n = int(self.count)
        return Column(self.indices[:n].astype(jnp.uint64), dt.uint64)


class Projector:
    """Compiled multi-expression projector (reference: projector.h:41)."""

    def __init__(self, schema: dt.Schema, exprs: Sequence[Expression],
                 names: Sequence[str]):
        self.schema = schema
        self.exprs = [e.bind(schema) for e in exprs]
        self.names = list(names)

        def run(batch: RecordBatch):
            cols = []
            for e in self.exprs:
                v = e.execute(batch)
                cols.append(v)
            return RecordBatch(tuple(cols), tuple(self.names))

        self._jitted = jax.jit(run)

    def evaluate(self, batch: RecordBatch,
                 selection: Optional[SelectionVector] = None) -> RecordBatch:
        if selection is not None:
            batch = _apply_selection(batch, selection)
        return self._jitted(batch)


class Filter:
    """Compiled predicate -> SelectionVector (reference: filter.h:66)."""

    def __init__(self, schema: dt.Schema, predicate: Expression):
        self.schema = schema
        self.predicate = predicate.bind(schema)

        def run(batch: RecordBatch):
            from .ops.padded import filter_padded

            mask = self.predicate.execute(batch)
            if not isinstance(mask, Column) or not mask.dtype.is_boolean:
                raise Invalid("filter expression must yield booleans")
            selected = mask.data if mask.validity is None else (
                mask.data & mask.validity)
            return filter_padded(selected)

        self._jitted = jax.jit(run)

    def evaluate(self, batch: RecordBatch) -> SelectionVector:
        idx, count = self._jitted(batch)
        return SelectionVector(idx, count)


def _apply_selection(batch: RecordBatch, sel: SelectionVector) -> RecordBatch:
    """Materialize selected rows (host-syncs the count, eager boundary)."""
    from .ops.selection import take_column

    n = int(sel.count)
    idx = sel.indices[:n]
    return RecordBatch(tuple(take_column(c, idx) for c in batch.columns),
                       batch.names)


def make_projector(schema: dt.Schema, exprs_and_names) -> Projector:
    """reference: Projector::Make (projector.h)."""
    exprs = [e for e, _ in exprs_and_names]
    names = [n for _, n in exprs_and_names]
    return Projector(schema, exprs, names)


def make_filter(schema: dt.Schema, predicate: Expression) -> Filter:
    """reference: Filter::Make (filter.h:66)."""
    return Filter(schema, predicate)

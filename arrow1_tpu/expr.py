"""Expression trees: literal | field_ref | call.

Reference: cpp/src/arrow/compute/exec/expression.h:42 and expression.cc —
Bind (kernel resolution), ExecuteScalarExpression (:513), constant folding
+ SimplifyWithGuarantee (:963, the partition-pruning engine).

Device notes: an expression executed against a RecordBatch is pure function
composition over pytrees, so `jax.jit(expr.execute)` gives whole-expression
fusion — the role Gandiva's LLVM codegen plays in the reference
(gandiva/llvm_generator.h:93: one fused per-batch loop) falls out of XLA
for free. The eager `execute` path is what the dataset scanner uses; the
streaming executor jits it.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Sequence, Tuple

from . import dtypes as dt
from .column import Column
from .datum import Datum, Scalar, scalar as make_scalar
from .errors import Invalid
from .registry import call_function
from .table import RecordBatch

__all__ = ["Expression", "call", "field", "literal",
           "simplify_with_guarantee"]


class Expression:
    """Base expression (reference: expression.h:42). Operator overloads
    build Call nodes with the registry's pyarrow-compatible names, so
    `(field("a") > 3) & field("b").is_valid()` mirrors the reference's
    expression combinators (and the pyarrow.dataset filter mini-language).
    """

    # -- combinators --
    def _bin(self, op, other, reverse=False):
        other = other if isinstance(other, Expression) else literal(other)
        args = [other, self] if reverse else [self, other]
        return Call(op, tuple(args))

    def __eq__(self, other):  # type: ignore[override]
        return self._bin("equal", other)

    def __ne__(self, other):  # type: ignore[override]
        return self._bin("not_equal", other)

    def __gt__(self, other):
        return self._bin("greater", other)

    def __ge__(self, other):
        return self._bin("greater_equal", other)

    def __lt__(self, other):
        return self._bin("less", other)

    def __le__(self, other):
        return self._bin("less_equal", other)

    def __add__(self, other):
        return self._bin("add", other)

    def __radd__(self, other):
        return self._bin("add", other, reverse=True)

    def __sub__(self, other):
        return self._bin("subtract", other)

    def __rsub__(self, other):
        return self._bin("subtract", other, reverse=True)

    def __mul__(self, other):
        return self._bin("multiply", other)

    def __rmul__(self, other):
        return self._bin("multiply", other, reverse=True)

    def __truediv__(self, other):
        return self._bin("divide", other)

    def __and__(self, other):
        return self._bin("and_kleene", other)

    def __or__(self, other):
        return self._bin("or_kleene", other)

    def __invert__(self):
        return Call("invert", (self,))

    def __neg__(self):
        return Call("negate", (self,))

    def __hash__(self):
        return hash(repr(self))

    def is_valid(self):
        return Call("is_valid", (self,))

    def is_null(self, nan_is_null: bool = False):
        from .ops.validity import NullOptions

        return Call("is_null", (self,),
                    options=NullOptions(nan_is_null=nan_is_null))

    def is_nan(self):
        return Call("is_nan", (self,))

    def equals(self, other) -> bool:
        """Structural equality (pyarrow Expression.equals)."""
        return isinstance(other, Expression) and repr(self) == repr(other)

    def to_substrait(self, schema=None):
        from .errors import NotImplementedError_

        raise NotImplementedError_(
            "substrait serialization is not supported")

    @classmethod
    def from_substrait(cls, message):
        from .errors import NotImplementedError_

        raise NotImplementedError_(
            "substrait deserialization is not supported")

    def isin(self, values):
        return Call("is_in", (self,), options={"value_set": list(values)})

    def cast(self, target: dt.DataType, safe: bool = True):
        from .ops.cast import CastOptions

        opts = (CastOptions.safe(target) if safe
                else CastOptions.unsafe(target))
        return Call("cast", (self,), options=opts)

    # -- interface --
    def fields(self) -> set:
        raise NotImplementedError

    def execute(self, batch: RecordBatch) -> Datum:
        """Reference: ExecuteScalarExpression expression.cc:513."""
        raise NotImplementedError

    def bind(self, schema: dt.Schema) -> "Expression":
        """Validate field refs against a schema (reference: Bind)."""
        raise NotImplementedError


@dataclasses.dataclass(frozen=True, eq=False)
class Literal(Expression):
    value: Any  # Scalar

    def fields(self):
        return set()

    def execute(self, batch):
        return self.value

    def bind(self, schema):
        return self

    def __repr__(self):
        return f"{self.value.as_py()!r}"


@dataclasses.dataclass(frozen=True, eq=False)
class FieldRef(Expression):
    name: str

    def fields(self):
        return {self.name}

    def execute(self, batch):
        return batch.column(self.name)

    def bind(self, schema):
        schema.field(self.name)  # raises KeyError if missing
        return self

    def __repr__(self):
        return self.name


@dataclasses.dataclass(frozen=True, eq=False)
class Call(Expression):
    function: str
    args: Tuple[Expression, ...]
    options: Any = None

    def fields(self):
        out = set()
        for a in self.args:
            out |= a.fields()
        return out

    def execute(self, batch):
        vals = [a.execute(batch) for a in self.args]
        if isinstance(self.options, dict):
            return call_function(self.function, vals, **self.options)
        return call_function(self.function, vals, options=self.options)

    def bind(self, schema):
        return Call(self.function, tuple(a.bind(schema) for a in self.args),
                    self.options)

    def __repr__(self):
        return f"{self.function}({', '.join(map(repr, self.args))})"


def field(name: str) -> FieldRef:
    return FieldRef(name)


def call(function: str, args, **options) -> Call:
    """Expression node invoking any registered compute function
    (reference: Expression::Call expression.h) — exposes the full
    297-function registry to the fluent Query API."""
    exprs = tuple(a if isinstance(a, Expression) else literal(a)
                  for a in args)
    return Call(function, exprs, options or None)


def literal(value) -> Literal:
    if isinstance(value, Literal):
        return value
    return Literal(make_scalar(value) if not isinstance(value, Scalar) else value)


def fold_constants(expr: Expression) -> Expression:
    """Evaluate calls whose arguments are all literals
    (reference: FoldConstants expression.cc)."""
    if not isinstance(expr, Call):
        return expr
    args = tuple(fold_constants(a) for a in expr.args)
    expr = Call(expr.function, args, expr.options)
    if all(isinstance(a, Literal) for a in args):
        try:
            result = expr.execute(RecordBatch((), ()))
        except Exception:
            return expr
        if isinstance(result, Scalar):
            return Literal(result)
    return expr


def simplify_with_guarantee(expr: Expression, guarantee: Expression
                            ) -> Expression:
    """Simplify `expr` under a partition guarantee like
    `field("year") == 2021` (reference: SimplifyWithGuarantee
    expression.cc:963 — the dataset partition-pruning engine).

    Strategy: extract field==literal facts from the guarantee conjunction,
    substitute them into expr, fold constants, and collapse boolean
    identities."""
    facts = {}

    def collect(g: Expression):
        if isinstance(g, Call):
            if g.function in ("and", "and_kleene"):
                for a in g.args:
                    collect(a)
            elif g.function == "equal":
                a, b = g.args
                if isinstance(a, FieldRef) and isinstance(b, Literal):
                    facts[a.name] = b
                elif isinstance(b, FieldRef) and isinstance(a, Literal):
                    facts[b.name] = a

    collect(guarantee)

    def substitute(e: Expression) -> Expression:
        if isinstance(e, FieldRef) and e.name in facts:
            return facts[e.name]
        if isinstance(e, Call):
            return Call(e.function, tuple(substitute(a) for a in e.args),
                        e.options)
        return e

    simplified = fold_constants(substitute(expr))
    return _simplify_boolean(simplified)


def _simplify_boolean(expr: Expression) -> Expression:
    """Collapse `x and true -> x`, `x and false -> false`, etc."""
    if not isinstance(expr, Call):
        return expr
    args = tuple(_simplify_boolean(a) for a in expr.args)
    expr = Call(expr.function, args, expr.options)

    def lit_bool(e):
        if isinstance(e, Literal) and e.value.dtype.is_boolean and e.value.is_valid:
            return bool(e.value.as_py())
        return None

    if expr.function in ("and", "and_kleene") and len(args) == 2:
        vals = [lit_bool(a) for a in args]
        if False in vals:
            return literal(False)
        if vals[0] is True:
            return args[1]
        if vals[1] is True:
            return args[0]
    if expr.function in ("or", "or_kleene") and len(args) == 2:
        vals = [lit_bool(a) for a in args]
        if True in vals:
            return literal(True)
        if vals[0] is False:
            return args[1]
        if vals[1] is False:
            return args[0]
    return expr

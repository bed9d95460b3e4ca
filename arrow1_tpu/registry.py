"""Function registry + eager call API.

Reference: cpp/src/arrow/compute/registry.h:45 (FunctionRegistry),
function.h:117 (Function with kernels + dispatch), exec.cc:972
(CallFunction). The device redesign collapses Arrow's
registry -> signature-dispatch -> SIMD-level-dispatch -> executor chain
(function.cc:84-201) into: registry -> python exec fn that dispatches on
logical dtype *at trace time* and emits an XLA graph. Arrow's SimdLevel
axis (kernel.h:422) has no device analogue — XLA targets the device
directly.

Each registered function mirrors one reference registry entry (the list in
SURVEY.md §2.3), keeping pyarrow-compatible names so the parity harness can
drive both engines with the same call specs.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Sequence

from .config import ExecContext, default_context
from .datum import Datum, as_datum

__all__ = [
    "Function",
    "FunctionRegistry",
    "function_registry",
    "register_function",
    "call_function",
    "list_functions",
]


@dataclasses.dataclass
class Function:
    """One compute function (reference: compute/function.h:117).

    ``kind`` in {"scalar", "vector", "aggregate", "hash_aggregate", "meta"}
    mirrors the reference kernel taxonomy (kernel.h:569,589,655,700;
    MetaFunction function.h:281).
    """

    name: str
    kind: str
    arity: int  # -1 = varargs
    exec: Callable  # (args: List[Datum], options, ctx) -> Datum
    options_class: Optional[type] = None
    doc: str = ""

    def __call__(self, *args, options=None, ctx: Optional[ExecContext] = None,
                 **kwargs):
        return call_function(self.name, list(args), options=options, ctx=ctx,
                             **kwargs)


class FunctionRegistry:
    """Name -> Function map (reference: registry.cc PIMPL unordered_map)."""

    def __init__(self):
        self._functions: Dict[str, Function] = {}
        self._aliases: Dict[str, str] = {}

    def add(self, fn: Function, aliases: Sequence[str] = ()):
        if fn.name in self._functions:
            raise KeyError(f"function {fn.name!r} already registered")
        self._functions[fn.name] = fn
        for a in aliases:
            self._aliases[a] = fn.name

    def get(self, name: str) -> Function:
        name = self._aliases.get(name, name)
        try:
            return self._functions[name]
        except KeyError:
            raise KeyError(
                f"no function registered with name {name!r}"
            ) from None

    def list_functions(self) -> List[str]:
        return sorted(self._functions)

    def __contains__(self, name: str) -> bool:
        return name in self._functions or name in self._aliases


function_registry = FunctionRegistry()


def register_function(name: str, kind: str, arity: int,
                      options_class: Optional[type] = None,
                      aliases: Sequence[str] = (), doc: str = ""):
    """Decorator registering an exec fn under a pyarrow-compatible name."""

    def deco(fn: Callable) -> Callable:
        function_registry.add(
            Function(name, kind, arity, fn, options_class, doc or fn.__doc__ or ""),
            aliases=aliases,
        )
        return fn

    return deco


def call_function(name: str, args: Sequence[Any], options=None,
                  ctx: Optional[ExecContext] = None, **kwargs) -> Datum:
    """Eager entry point (reference: compute::CallFunction exec.cc:972).

    Keyword arguments are folded into the function's options class, matching
    pyarrow's python-level convenience API (python/pyarrow/compute.py:190).
    """
    fn = function_registry.get(name)
    if fn.arity >= 0 and len(args) != fn.arity:
        raise ValueError(
            f"{name} expects {fn.arity} arguments, got {len(args)}"
        )
    ctx = ctx or default_context()
    datums = [as_datum(a) for a in args]
    # Table/ChunkedColumn datums: combine chunks first (the reference's
    # MetaFunctions iterate chunks, vector_selection.cc:1877; on the device a
    # combined HBM-resident batch is the natural execution unit and the
    # result rows are identical)
    from .table import ChunkedColumn, Table

    datums = [d.combine_chunks() if isinstance(d, (Table, ChunkedColumn))
              else d for d in datums]
    if kwargs:
        if fn.options_class is None:
            raise TypeError(f"{name} accepts no options, got {kwargs}")
        if options is not None:
            options = dataclasses.replace(options, **kwargs)
        else:
            options = fn.options_class(**kwargs)
    if options is None and fn.options_class is not None:
        options = fn.options_class()
    from .profiler import _current

    prof = _current()
    if prof is not None:
        return prof._measure(name, lambda: fn.exec(datums, options, ctx),
                             datums)
    return fn.exec(datums, options, ctx)


def list_functions() -> List[str]:
    return function_registry.list_functions()

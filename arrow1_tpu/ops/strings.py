"""String kernels (reference: cpp/src/arrow/compute/kernels/scalar_string.cc,
~40 registered functions — the full list in SURVEY.md §2.3).

Device design: per-row byte processing has no place on a data-parallel
device. Because every string column is dictionary-encoded at ingest, a
string kernel runs its transform ONCE PER UNIQUE VALUE — the ASCII/byte
family natively on device (strings_device.py padded byte matrices), the
unicode/regex tail on the host (strings_host.py, pure Python str/re/
unicodedata — no pyarrow in the compute path) — and broadcasts to rows
with a single device gather:

  transform ops (upper/trim/replace/...): new Dictionary, codes unchanged
  predicate ops (utf8_is_*, match_*):     bool LUT -> device gather
  measure ops (binary_length/utf8_length): int LUT -> device gather
  split ops:                               per-code piece pool -> ListColumn
                                           by offset expansion

Cost is O(unique values) host work + O(rows) device gather — for typical
cardinalities orders of magnitude less byte-crunching than the
reference's per-row loops.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import jax.numpy as jnp
from ..kernels.blockscan import cumsum_blocked, scan_blocked
import numpy as np

from .. import dtypes as dt
from ..column import Column, Dictionary, ListColumn
from ..datum import Scalar
from ..errors import Invalid
from ..registry import register_function
from ..table import RecordBatch

__all__ = ["MatchSubstringOptions", "SplitOptions", "SplitPatternOptions",
           "ReplaceSubstringOptions", "ExtractRegexOptions", "TrimOptions",
           "PadOptions", "SliceOptions"]


@dataclasses.dataclass
class MatchSubstringOptions:
    """Reference: api_scalar.h:45."""

    pattern: str = ""
    ignore_case: bool = False


@dataclasses.dataclass
class SplitOptions:
    """Reference: api_scalar.h SplitOptions."""

    max_splits: Optional[int] = None
    reverse: bool = False


@dataclasses.dataclass
class SplitPatternOptions:
    pattern: str = ""
    max_splits: Optional[int] = None
    reverse: bool = False


@dataclasses.dataclass
class ReplaceSubstringOptions:
    pattern: str = ""
    replacement: str = ""
    max_replacements: Optional[int] = None


@dataclasses.dataclass
class ExtractRegexOptions:
    pattern: str = ""


@dataclasses.dataclass
class TrimOptions:
    characters: str = ""


@dataclasses.dataclass
class PadOptions:
    width: int = 0
    padding: str = " "


@dataclasses.dataclass
class SliceOptions:
    start: int = 0
    stop: Optional[int] = None
    step: int = 1


def _require_string(col, name):
    if isinstance(col, Scalar) or not getattr(col.dtype, "is_binary", False):
        raise Invalid(f"{name}: expected a string/binary array")
    assert col.dictionary is not None


def _dict_transform(pc_name, out_is_string=True):
    """Transform on unique values -> new Dictionary, codes unchanged.

    The ASCII/byte family runs NATIVELY on device (strings_device.py
    padded byte matrices); only the unicode/regex tail goes to
    pyarrow's host kernels."""

    def exec_fn(args, options, ctx):
        (col,) = args
        _require_string(col, pc_name)
        from .strings_device import native_transform

        native = native_transform(pc_name, col.dictionary, options,
                                  col.dtype.is_string)
        if native is not None:
            return Column(col.data, col.dtype, validity=col.validity,
                          dictionary=Dictionary(native))
        from .strings_host import host_transform

        new_np = host_transform(pc_name, list(col.dictionary.values),
                                options)
        return Column(col.data, col.dtype, validity=col.validity,
                      dictionary=Dictionary(new_np))

    return exec_fn


def _dict_lut(pc_name, out_type: dt.DataType):
    """Predicate/measure on unique values -> device LUT gather. Native
    byte kernels (strings_device.py) serve the ASCII/byte family."""

    def exec_fn(args, options, ctx):
        (col,) = args
        _require_string(col, pc_name)
        phys = out_type.physical_dtype()
        from .strings_device import native_predicate_lut

        lut_native = native_predicate_lut(pc_name, col.dictionary, options)
        if lut_native is not None:
            lut = lut_native.astype(phys)
            data = lut[jnp.clip(col.data, 0,
                                len(col.dictionary.values) - 1)]
            return Column(data, out_type, validity=col.validity)
        from .strings_host import host_measure

        vals = list(col.dictionary.values)
        if len(vals):
            lut = jnp.asarray(np.asarray(host_measure(pc_name, vals,
                                                      options))
                              .astype(np.dtype(phys)))
            data = lut[jnp.clip(col.data, 0, len(vals) - 1)]
        else:
            data = jnp.zeros(col.length, phys)
        return Column(data, out_type, validity=col.validity)

    return exec_fn


# ---- transforms (reference: CaseMapping/trim kernels scalar_string.cc) ----
for _name in ["ascii_upper", "ascii_lower", "ascii_swapcase",
              "ascii_capitalize", "ascii_title", "ascii_reverse",
              "utf8_upper", "utf8_lower", "utf8_swapcase",
              "utf8_capitalize", "utf8_title", "utf8_reverse",
              "ascii_ltrim_whitespace", "ascii_rtrim_whitespace",
              "ascii_trim_whitespace", "utf8_ltrim_whitespace",
              "utf8_rtrim_whitespace", "utf8_trim_whitespace"]:
    register_function(_name, "scalar", 1)(_dict_transform(_name))

for _name in ["ascii_trim", "ascii_ltrim", "ascii_rtrim",
              "utf8_trim", "utf8_ltrim", "utf8_rtrim"]:
    register_function(_name, "scalar", 1, TrimOptions)(_dict_transform(_name))

for _name in ["replace_substring", "replace_substring_regex"]:
    register_function(_name, "scalar", 1, ReplaceSubstringOptions)(
        _dict_transform(_name))

for _name in ["utf8_slice_codeunits"]:
    register_function(_name, "scalar", 1, SliceOptions)(_dict_transform(_name))


# ---- predicates (reference: ~18 classification kernels) ----
for _name in ["ascii_is_alnum", "ascii_is_alpha", "ascii_is_decimal",
              "ascii_is_lower", "ascii_is_printable", "ascii_is_space",
              "ascii_is_title", "ascii_is_upper",
              "utf8_is_alnum", "utf8_is_alpha", "utf8_is_decimal",
              "utf8_is_digit", "utf8_is_lower", "utf8_is_numeric",
              "utf8_is_printable", "utf8_is_space", "utf8_is_title",
              "utf8_is_upper", "string_is_ascii"]:
    register_function(_name, "scalar", 1)(_dict_lut(_name, dt.bool_))

for _name in ["match_substring", "match_substring_regex", "starts_with",
              "ends_with"]:
    register_function(_name, "scalar", 1, MatchSubstringOptions)(
        _dict_lut(_name, dt.bool_))

register_function("match_like", "scalar", 1, MatchSubstringOptions)(
    _dict_lut("match_like", dt.bool_))

# ---- measures ----
register_function("binary_length", "scalar", 1)(
    _dict_lut("binary_length", dt.int32))
register_function("utf8_length", "scalar", 1)(
    _dict_lut("utf8_length", dt.int32))
register_function("count_substring", "scalar", 1, MatchSubstringOptions)(
    _dict_lut("count_substring", dt.int32))
register_function("find_substring", "scalar", 1, MatchSubstringOptions)(
    _dict_lut("find_substring", dt.int32))


# ---- split family: per-code piece pool -> ListColumn expansion ----

def _split_exec(pc_name):
    def exec_fn(args, options, ctx):
        from .strings_host import host_split

        (col,) = args
        _require_string(col, pc_name)
        vals = list(col.dictionary.values)
        if len(vals) == 0:
            empty = Column(jnp.zeros(0, jnp.int32), col.dtype,
                           dictionary=Dictionary(np.array([], dtype=object)))
            return ListColumn(jnp.zeros(col.length + 1, jnp.int64), empty,
                              dt.list_(col.dtype), validity=col.validity)
        pieces_per_code = host_split(pc_name, vals, options)
        # piece pool: all pieces across codes, dictionary-encoded
        pool: dict = {}
        pool_vals: list = []
        piece_codes: list = []
        piece_start = np.zeros(len(pieces_per_code) + 1, dtype=np.int64)
        for i, pieces in enumerate(pieces_per_code):
            pieces = pieces or []
            piece_start[i + 1] = piece_start[i] + len(pieces)
            for p in pieces:
                if p not in pool:
                    pool[p] = len(pool_vals)
                    pool_vals.append(p)
                piece_codes.append(pool[p])
        piece_codes = jnp.asarray(np.asarray(piece_codes, dtype=np.int32))
        piece_start_j = jnp.asarray(piece_start)
        code_len = jnp.asarray(piece_start[1:] - piece_start[:-1])

        codes = jnp.clip(col.data, 0, len(vals) - 1)
        lengths = code_len[codes]
        if col.validity is not None:
            lengths = jnp.where(col.validity, lengths, 0)
        offsets = jnp.concatenate(
            [jnp.zeros(1, jnp.int64), cumsum_blocked(lengths)])
        total = int(offsets[-1])
        parent = jnp.repeat(jnp.arange(col.length), lengths,
                            total_repeat_length=total)
        within = jnp.arange(total, dtype=jnp.int64) - offsets[parent]
        child_codes = piece_codes[piece_start_j[codes[parent]] + within] \
            if total else jnp.zeros(0, jnp.int32)
        child = Column(child_codes, col.dtype,
                       dictionary=Dictionary(np.asarray(pool_vals,
                                                        dtype=object)))
        return ListColumn(offsets, child, dt.list_(col.dtype),
                          validity=col.validity)

    return exec_fn


register_function("split_pattern", "scalar", 1, SplitPatternOptions)(
    _split_exec("split_pattern"))
register_function("split_pattern_regex", "scalar", 1, SplitPatternOptions)(
    _split_exec("split_pattern_regex"))
register_function("ascii_split_whitespace", "scalar", 1, SplitOptions)(
    _split_exec("ascii_split_whitespace"))
register_function("utf8_split_whitespace", "scalar", 1, SplitOptions)(
    _split_exec("utf8_split_whitespace"))


# ---- extract_regex: struct of capture groups -> StructColumn ----

def _extract_regex_exec(args, options: ExtractRegexOptions, ctx):
    """Non-matching rows are NULL STRUCTS (pyarrow parity); children carry
    the same validity so field access propagates nulls like struct_field."""
    from ..column import StructColumn
    from .strings_host import host_extract

    (col,) = args
    _require_string(col, "extract_regex")
    if not options or not options.pattern:
        raise Invalid("extract_regex requires pattern")
    vals = list(col.dictionary.values)
    names, rows = host_extract(options.pattern, vals)
    cols = []
    match_valid = np.asarray([r is not None for r in rows], dtype=bool)
    lut_valid = jnp.asarray(match_valid) if len(vals) else None
    out_validity = lut_valid[jnp.clip(col.data, 0, max(len(vals) - 1, 0))] \
        if len(vals) else jnp.zeros(col.length, jnp.bool_)
    if col.validity is not None:
        out_validity = out_validity & col.validity
    for name in names:
        d = Dictionary(np.asarray(
            [r[name] if r is not None else "" for r in rows], dtype=object))
        cols.append(Column(jnp.clip(col.data, 0, max(len(vals) - 1, 0)),
                           col.dtype, validity=out_validity, dictionary=d))
    out_dt = dt.struct([(n, col.dtype) for n in names])
    return StructColumn(tuple(cols), tuple(names), out_dt,
                        validity=out_validity)


register_function("extract_regex", "scalar", 1, ExtractRegexOptions)(
    _extract_regex_exec)


# ---- binary_join_element_wise / concatenation ----

@dataclasses.dataclass
class JoinOptions:
    """Reference: api_scalar.h JoinOptions (null_handling in
    {emit_null, skip, replace})."""
    null_handling: str = "emit_null"
    null_replacement: str = ""


def _binary_join_element_wise_exec(args, options: JoinOptions, ctx):
    """Concatenate string columns row-wise (last arg is the separator).
    Works on the cartesian code space: output dictionary built from the
    observed code tuples (host), gathered on device. A null separator
    always nulls the row; value nulls follow JoinOptions."""
    options = options or JoinOptions()
    nh = options.null_handling
    if nh not in ("emit_null", "skip", "replace"):
        raise Invalid(f"bad null_handling {nh!r}")
    cols = args[:-1]
    sep = args[-1]
    for c in cols:
        _require_string(c, "binary_join_element_wise")
    if isinstance(sep, Scalar):
        sep_vals = None
        sep_str = (None if not sep.is_valid else
                   sep.dictionary.values[int(sep.value)]
                   if sep.dictionary is not None else sep.value)
    else:
        sep_vals = sep.to_numpy()
        sep_str = None
    host_cols = [c.to_numpy() for c in cols]
    out = []
    n = cols[0].length
    for i in range(n):
        s = sep_vals[i] if sep_vals is not None else sep_str
        parts = [h[i] for h in host_cols]
        if s is None or (nh == "emit_null" and any(p is None
                                                   for p in parts)):
            out.append(None)
            continue
        if nh == "skip":
            parts = [p for p in parts if p is not None]
        elif nh == "replace":
            parts = [options.null_replacement if p is None else p
                     for p in parts]
        out.append(s.join(parts))
    import pyarrow as pa

    from ..interop import column_from_arrow

    return column_from_arrow(pa.array(out, type=pa.string()))


register_function("binary_join_element_wise", "scalar", -1, JoinOptions)(
    _binary_join_element_wise_exec)


# ---- padding family (reference: utf8_lpad/rpad/center in scalar_string.cc
# lineage; PadOptions) ----
for _name in ["utf8_lpad", "utf8_rpad", "utf8_center", "ascii_lpad",
              "ascii_rpad", "ascii_center"]:
    register_function(_name, "scalar", 1, PadOptions)(_dict_transform(_name))

register_function("binary_repeat", "scalar", 2)(
    lambda args, options, ctx: _binary_repeat(args))


def _binary_repeat(args):
    """binary_repeat(strings, n): per-row repeat; dictionary transform on
    the cartesian (value, n) pairs observed."""
    import pyarrow as pa

    col, n = args
    _require_string(col, "binary_repeat")
    from ..datum import Scalar as _S

    if isinstance(n, _S):
        k = int(n.as_py())
        new_vals = [None if v is None else v * k
                    for v in col.dictionary.values]
        return Column(col.data, col.dtype, validity=col.validity,
                      dictionary=Dictionary(
                          np.asarray(new_vals, dtype=object)))
    host = col.to_numpy()
    counts = np.asarray(jnp.asarray(n.data))
    out = [None if v is None else v * int(c) for v, c in zip(host, counts)]
    from ..interop import column_from_arrow

    return column_from_arrow(pa.array(out, type=dt.to_arrow(col.dtype)))


# ---- round 2: binary slice/reverse/replace-slice, normalize, zero-fill,
# regex counters, binary_join, extract_regex_span (reference:
# scalar_string.cc round-2 kernels) ----

@dataclasses.dataclass
class ReplaceSliceOptions:
    start: int = 0
    stop: int = 0
    replacement: str = ""


@dataclasses.dataclass
class NormalizeOptions:
    form: str = "NFC"


# pyarrow-compatible alias names
Utf8NormalizeOptions = NormalizeOptions
ExtractRegexSpanOptions = ExtractRegexOptions


@dataclasses.dataclass
class ZeroFillOptions:
    width: int = 0
    padding: str = "0"


for _name, _opts in [("binary_reverse", None),
                     ("binary_slice", SliceOptions),
                     ("binary_replace_slice", ReplaceSliceOptions),
                     ("utf8_replace_slice", ReplaceSliceOptions),
                     ("utf8_normalize", NormalizeOptions),
                     ("utf8_zero_fill", ZeroFillOptions)]:
    register_function(_name, "scalar", 1, _opts)(_dict_transform(_name))

for _name in ["count_substring_regex", "find_substring_regex"]:
    register_function(_name, "scalar", 1, MatchSubstringOptions)(
        _dict_lut(_name, dt.int32))


def _binary_join_exec(args, options, ctx):
    """binary_join(list<string>, separator): per-row join; null list,
    null separator, or any null element -> null (reference:
    scalar_string.cc BinaryJoin)."""
    import pyarrow as pa

    from ..interop import column_from_arrow

    lists, sep = args
    rows = lists.to_arrow().to_pylist()
    if isinstance(sep, Scalar):
        s = sep.as_py() if sep.is_valid else None
        seps = [s] * len(rows)
    else:
        seps = sep.to_arrow().to_pylist()
    out = [None if (l is None or s is None or any(e is None for e in l))
           else s.join(l) for l, s in zip(rows, seps)]
    val_t = getattr(lists.dtype, "fields", (("item", dt.string),))[0][1]
    return column_from_arrow(pa.array(out, type=dt.to_arrow(val_t)))


def _extract_regex_span_exec(args, options: ExtractRegexOptions, ctx):
    """Struct of fixed_size_list<int32>[2] = [byte offset, byte length]
    per named group (reference: scalar_string.cc ExtractRegexSpan)."""
    import pyarrow as pa

    from ..interop import column_from_arrow
    from .strings_host import host_extract_span

    (col,) = args
    _require_string(col, "extract_regex_span")
    if not options or not options.pattern:
        raise Invalid("extract_regex_span requires pattern")
    vals = list(col.dictionary.values)
    names, rows = host_extract_span(options.pattern, vals)
    codes = np.asarray(jnp.clip(col.data, 0, max(len(vals) - 1, 0)))
    valid = np.ones(col.length, bool) if col.validity is None else \
        np.asarray(col.validity)
    py = [rows[c] if v and len(vals) else None
          for c, v in zip(codes, valid)]
    t = pa.struct([(g, pa.list_(pa.int32(), 2)) for g in names])
    return column_from_arrow(pa.array(py, type=t))


register_function("binary_join", "scalar", 2)(_binary_join_exec)
register_function("extract_regex_span", "scalar", 1, ExtractRegexOptions)(
    _extract_regex_span_exec)

"""Device-native string byte kernels (the ASCII/byte family).

Reference: cpp/src/arrow/compute/kernels/scalar_string.cc — per-row byte
loops. device-native form: dictionary values become one padded uint8 matrix
[n_unique, max_len] + a length vector, and transforms/predicates run as
vectorized jnp ops over the whole matrix at once (lane-parallel byte
crunching, tiny gathers only for per-row shifts). pyarrow stays only for
the unicode/regex tail (utf8 case mapping tables, re2) — see
ops/strings.py for the routing.

Matrices are per-dictionary and cached on the Dictionary object, so the
encode cost is paid once per dictionary, not per op.
"""

from __future__ import annotations

from typing import Optional, Tuple

import jax.numpy as jnp
import numpy as np

from ..column import Dictionary

__all__ = ["byte_matrix", "NATIVE_TRANSFORMS", "NATIVE_PREDICATES",
           "native_transform", "native_predicate_lut"]

_WS = np.frombuffer(b" \t\n\r\x0b\x0c", np.uint8)


def byte_matrix(d: Dictionary) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """(bytes uint8[u, L], lengths int32[u]) for the dictionary values,
    cached on the Dictionary."""
    cached = getattr(d, "_byte_matrix", None)
    if cached is not None:
        return cached
    enc = [v.encode("utf8") if isinstance(v, str) else bytes(v)
           for v in d.values]
    lens = np.array([len(e) for e in enc], dtype=np.int32)
    L = max(1, int(lens.max()) if len(enc) else 1)
    mat = np.zeros((len(enc), L), dtype=np.uint8)
    for i, e in enumerate(enc):
        mat[i, : len(e)] = np.frombuffer(e, np.uint8)
    out = (jnp.asarray(mat), jnp.asarray(lens))
    d._byte_matrix = out
    return out


def _decode(mat: np.ndarray, lens: np.ndarray, is_string: bool) -> np.ndarray:
    out = np.empty(len(lens), dtype=object)
    m = np.asarray(mat)
    ln = np.asarray(lens)
    for i in range(len(ln)):
        raw = m[i, : ln[i]].tobytes()
        out[i] = raw.decode("utf8") if is_string else raw
    return out


def _valid(mat, lens):
    """Mask of real (non-padding) byte positions."""
    pos = jnp.arange(mat.shape[1], dtype=jnp.int32)[None, :]
    return pos < lens[:, None]


_LOWER = (ord("a"), ord("z"))
_UPPER = (ord("A"), ord("Z"))
_DIGIT = (ord("0"), ord("9"))


def _in(mat, lo_hi):
    return (mat >= lo_hi[0]) & (mat <= lo_hi[1])


def _is_ws(mat):
    w = jnp.zeros(mat.shape, jnp.bool_)
    for c in _WS:
        w = w | (mat == c)
    return w


def _to_upper(mat):
    return jnp.where(_in(mat, _LOWER), mat - 32, mat)


def _to_lower(mat):
    return jnp.where(_in(mat, _UPPER), mat + 32, mat)


def _shift_left(mat, lens, shift):
    """Per-row left shift by shift[r] (drops the leading prefix)."""
    L = mat.shape[1]
    pos = jnp.arange(L, dtype=jnp.int32)[None, :]
    src = jnp.minimum(pos + shift[:, None], L - 1)
    out = jnp.take_along_axis(mat, src, axis=1)
    newlen = jnp.maximum(lens - shift, 0)
    return jnp.where(pos < newlen[:, None], out, 0), newlen


# ---------------------------------------------------------------- transforms

def _t_upper(mat, lens, opts):
    return _to_upper(mat), lens


def _t_lower(mat, lens, opts):
    return _to_lower(mat), lens


def _t_swapcase(mat, lens, opts):
    up = _in(mat, _UPPER)
    lo = _in(mat, _LOWER)
    return jnp.where(up, mat + 32, jnp.where(lo, mat - 32, mat)), lens


def _t_capitalize(mat, lens, opts):
    first = jnp.arange(mat.shape[1])[None, :] == 0
    return jnp.where(first, _to_upper(mat), _to_lower(mat)), lens


def _t_title(mat, lens, opts):
    """Uppercase every alpha that follows a non-alpha (cased transition),
    lowercase the rest — pyarrow/ascii_title semantics."""
    alpha = _in(mat, _LOWER) | _in(mat, _UPPER)
    prev_alpha = jnp.concatenate(
        [jnp.zeros((mat.shape[0], 1), jnp.bool_), alpha[:, :-1]], axis=1)
    start = alpha & ~prev_alpha
    return jnp.where(start, _to_upper(mat),
                     jnp.where(alpha, _to_lower(mat), mat)), lens


def _t_reverse(mat, lens, opts):
    L = mat.shape[1]
    pos = jnp.arange(L, dtype=jnp.int32)[None, :]
    src = jnp.clip(lens[:, None] - 1 - pos, 0, L - 1)
    out = jnp.take_along_axis(mat, src, axis=1)
    return jnp.where(pos < lens[:, None], out, 0), lens


def _charset_mask(mat, chars: Optional[str]):
    if chars is None:
        return _is_ws(mat)
    cs = np.frombuffer(chars.encode("utf8"), np.uint8)
    m = jnp.zeros(mat.shape, jnp.bool_)
    for c in cs:
        m = m | (mat == c)
    return m


def _t_ltrim(mat, lens, opts):
    trim = _charset_mask(mat, getattr(opts, "characters", None)) \
        & _valid(mat, lens)
    # leading run length = first position where trim is False
    keep = ~trim & _valid(mat, lens)
    has = jnp.any(keep, axis=1)
    first_keep = jnp.argmax(keep, axis=1).astype(jnp.int32)
    shift = jnp.where(has, first_keep, lens)
    return _shift_left(mat, lens, shift)


def _t_rtrim(mat, lens, opts):
    trim = _charset_mask(mat, getattr(opts, "characters", None))
    keep = ~trim & _valid(mat, lens)
    has = jnp.any(keep, axis=1)
    L = mat.shape[1]
    last_keep = (L - 1) - jnp.argmax(keep[:, ::-1], axis=1).astype(jnp.int32)
    newlen = jnp.where(has, last_keep + 1, 0)
    pos = jnp.arange(L, dtype=jnp.int32)[None, :]
    return jnp.where(pos < newlen[:, None], mat, 0), newlen


def _t_trim(mat, lens, opts):
    mat, lens = _t_rtrim(mat, lens, opts)
    return _t_ltrim(mat, lens, opts)


NATIVE_TRANSFORMS = {
    "ascii_upper": _t_upper,
    "ascii_lower": _t_lower,
    "ascii_swapcase": _t_swapcase,
    "ascii_capitalize": _t_capitalize,
    "ascii_title": _t_title,
    "ascii_reverse": _t_reverse,
    "ascii_ltrim_whitespace": _t_ltrim,
    "ascii_rtrim_whitespace": _t_rtrim,
    "ascii_trim_whitespace": _t_trim,
    "ascii_ltrim": _t_ltrim,
    "ascii_rtrim": _t_rtrim,
    "ascii_trim": _t_trim,
}


def native_transform(name: str, d: Dictionary, options, is_string: bool
                     ) -> Optional[np.ndarray]:
    fn = NATIVE_TRANSFORMS.get(name)
    if fn is None or len(d.values) == 0:
        return None
    mat, lens = byte_matrix(d)
    if name == "ascii_reverse" and bool(jnp.any(mat >= 128)):
        # byte reversal breaks multi-byte utf8; the reference kernel
        # rejects it (scalar_string.cc AsciiReverse) and so do we
        from ..errors import Invalid

        raise Invalid("Non-ASCII sequence in input")
    out_mat, out_lens = fn(mat, lens, options)
    return _decode(np.asarray(out_mat), np.asarray(out_lens), is_string)


# ---------------------------------------------------------------- predicates

def _all_valid(mat, lens, pred):
    """True where every real byte satisfies pred AND the value is
    non-empty (scalar_string.cc is_* semantics)."""
    v = _valid(mat, lens)
    return jnp.all(jnp.where(v, pred, True), axis=1) & (lens > 0)


def _p_is_alpha(mat, lens, opts):
    return _all_valid(mat, lens, _in(mat, _LOWER) | _in(mat, _UPPER))


def _p_is_alnum(mat, lens, opts):
    return _all_valid(mat, lens,
                      _in(mat, _LOWER) | _in(mat, _UPPER) | _in(mat, _DIGIT))


def _p_is_decimal(mat, lens, opts):
    return _all_valid(mat, lens, _in(mat, _DIGIT))


def _p_is_space(mat, lens, opts):
    return _all_valid(mat, lens, _is_ws(mat))


def _p_is_printable(mat, lens, opts):
    # unlike the other is_* predicates, "" IS printable (python
    # str.isprintable / scalar_string.cc IsPrintable semantics)
    v = _valid(mat, lens)
    printable = (mat >= 32) & (mat < 127)
    return jnp.all(jnp.where(v, printable, True), axis=1)


def _p_is_lower(mat, lens, opts):
    """At least one cased char and no uppercase (ascii_is_lower)."""
    v = _valid(mat, lens)
    cased = (_in(mat, _LOWER) | _in(mat, _UPPER)) & v
    has_cased = jnp.any(cased, axis=1)
    no_upper = ~jnp.any(_in(mat, _UPPER) & v, axis=1)
    return has_cased & no_upper


def _p_is_upper(mat, lens, opts):
    v = _valid(mat, lens)
    cased = (_in(mat, _LOWER) | _in(mat, _UPPER)) & v
    has_cased = jnp.any(cased, axis=1)
    no_lower = ~jnp.any(_in(mat, _LOWER) & v, axis=1)
    return has_cased & no_lower


def _p_is_title(mat, lens, opts):
    """Title-cased: cased runs start upper, continue lower; at least one
    cased char."""
    v = _valid(mat, lens)
    up, lo = _in(mat, _UPPER) & v, _in(mat, _LOWER) & v
    alpha = up | lo
    prev_alpha = jnp.concatenate(
        [jnp.zeros((mat.shape[0], 1), jnp.bool_), alpha[:, :-1]], axis=1)
    start = alpha & ~prev_alpha
    ok = jnp.all(jnp.where(start, up, True), axis=1) \
        & jnp.all(jnp.where(alpha & ~start, lo, True), axis=1)
    return ok & jnp.any(alpha, axis=1)


def _p_is_ascii(mat, lens, opts):
    v = _valid(mat, lens)
    return jnp.all(jnp.where(v, mat < 128, True), axis=1)


def _match_positions(mat, lens, pattern: bytes, ignore_case: bool):
    """bool[u, L]: window starting at each position equals pattern."""
    if len(pattern) == 0:
        return _valid(mat, lens) | (
            jnp.arange(mat.shape[1])[None, :] == 0)
    pb = np.frombuffer(pattern, np.uint8)
    m = _to_lower(mat) if ignore_case else mat
    if ignore_case:
        pb = np.frombuffer(pattern.lower(), np.uint8)
    L = mat.shape[1]
    hit = jnp.ones(mat.shape, jnp.bool_)
    for j, c in enumerate(pb):
        shifted = jnp.concatenate(
            [m[:, j:], jnp.zeros((mat.shape[0], j), jnp.uint8)], axis=1) \
            if j else m
        hit = hit & (shifted == c)
    pos = jnp.arange(L, dtype=jnp.int32)[None, :]
    in_range = pos + len(pb) <= lens[:, None]
    return hit & in_range


def _p_match_substring(mat, lens, opts):
    pat = (opts.pattern or "").encode("utf8")
    ic = bool(getattr(opts, "ignore_case", False))
    if len(pat) == 0:
        return jnp.ones(mat.shape[0], jnp.bool_)
    return jnp.any(_match_positions(mat, lens, pat, ic), axis=1)


def _p_starts_with(mat, lens, opts):
    pat = (opts.pattern or "").encode("utf8")
    ic = bool(getattr(opts, "ignore_case", False))
    if len(pat) == 0:
        return jnp.ones(mat.shape[0], jnp.bool_)
    hits = _match_positions(mat, lens, pat, ic)
    return hits[:, 0]


def _p_ends_with(mat, lens, opts):
    pat = (opts.pattern or "").encode("utf8")
    ic = bool(getattr(opts, "ignore_case", False))
    if len(pat) == 0:
        return jnp.ones(mat.shape[0], jnp.bool_)
    hits = _match_positions(mat, lens, pat, ic)
    start = lens - len(pat)
    ok = start >= 0
    idx = jnp.clip(start, 0, mat.shape[1] - 1)
    return jnp.take_along_axis(hits, idx[:, None], axis=1)[:, 0] & ok


def _m_binary_length(mat, lens, opts):
    return lens.astype(jnp.int32)


def _m_utf8_length(mat, lens, opts):
    """Codepoints = bytes that are not utf8 continuations (0b10xxxxxx)."""
    v = _valid(mat, lens)
    cont = (mat & 0xC0) == 0x80
    return jnp.sum((v & ~cont).astype(jnp.int32), axis=1)


def _m_count_substring(mat, lens, opts):
    pat = (opts.pattern or "").encode("utf8")
    ic = bool(getattr(opts, "ignore_case", False))
    if len(pat) == 0:
        return (lens + 1).astype(jnp.int32)
    # non-overlapping count == overlapping count only when the pattern
    # cannot overlap itself; match pyarrow (non-overlapping) via a scan
    hits = np.asarray(_match_positions(mat, lens, pat, ic))
    counts = np.zeros(mat.shape[0], np.int32)
    for r in range(mat.shape[0]):
        i, c = 0, 0
        row = hits[r]
        L = row.shape[0]
        while i < L:
            if row[i]:
                c += 1
                i += len(pat)
            else:
                i += 1
        counts[r] = c
    return jnp.asarray(counts)


def _m_find_substring(mat, lens, opts):
    pat = (opts.pattern or "").encode("utf8")
    ic = bool(getattr(opts, "ignore_case", False))
    if len(pat) == 0:
        return jnp.zeros(mat.shape[0], jnp.int32)
    hits = _match_positions(mat, lens, pat, ic)
    any_ = jnp.any(hits, axis=1)
    first = jnp.argmax(hits, axis=1).astype(jnp.int32)
    return jnp.where(any_, first, -1)


NATIVE_PREDICATES = {
    "ascii_is_alpha": (_p_is_alpha, "bool"),
    "ascii_is_alnum": (_p_is_alnum, "bool"),
    "ascii_is_decimal": (_p_is_decimal, "bool"),
    "ascii_is_space": (_p_is_space, "bool"),
    "ascii_is_printable": (_p_is_printable, "bool"),
    "ascii_is_lower": (_p_is_lower, "bool"),
    "ascii_is_upper": (_p_is_upper, "bool"),
    "ascii_is_title": (_p_is_title, "bool"),
    "string_is_ascii": (_p_is_ascii, "bool"),
    "match_substring": (_p_match_substring, "bool"),
    "starts_with": (_p_starts_with, "bool"),
    "ends_with": (_p_ends_with, "bool"),
    "binary_length": (_m_binary_length, "int"),
    "utf8_length": (_m_utf8_length, "int"),
    "count_substring": (_m_count_substring, "int"),
    "find_substring": (_m_find_substring, "int"),
}


def native_predicate_lut(name: str, d: Dictionary, options):
    """LUT over unique values via the device byte kernels, or None
    (None routes to the pyarrow host path: unicode case folding for
    ignore_case, empty-pattern edge semantics for count/find)."""
    entry = NATIVE_PREDICATES.get(name)
    if entry is None or len(d.values) == 0:
        return None
    if options is not None and getattr(options, "ignore_case", False):
        return None  # unicode case folding: pyarrow/re2 path
    if name in ("count_substring", "find_substring") and \
            not getattr(options, "pattern", ""):
        return None
    fn, _ = entry
    mat, lens = byte_matrix(d)
    return fn(mat, lens, options)

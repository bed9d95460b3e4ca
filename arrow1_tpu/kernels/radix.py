"""Radix-key sort acceleration: minimal-width key normalization + packing.

Reference semantics: cpp/src/arrow/compute/kernels/vector_sort.cc
(stable; nulls last; NaN after values before null, :1556-1563). The
reference's counting/stable sort and the BASELINE's "radix sort" ask map
onto XLA's sort rather than onto hand-built passes:

**Why not scatter-based LSD radix here.** A radix pass is histogram +
rank + scatter, built in XLA from full-length scatters and gathers;
XLA's own sort (on the GPU: CUB's radix sort for keys alone or keys
with one value) does the whole argsort. Whether that holds at the
engine's shapes on the H100 is ROADMAP Speed 8.

**What radix thinking still buys: key bits.** The optimization kept
here is to sort the fewest possible bits:

1. *Minimal-width normalization* — each column maps to the narrowest
   order-preserving unsigned key its dtype/dictionary allows (int8 -> 8
   bits, dict codes -> ceil(log2(#unique)), float32 -> 32, ...), not a
   blanket uint64.
2. *Word packing* — consecutive sort keys (including the 2-bit
   null/NaN class key) are packed most-significant-first into as few
   uint64 words as fit. A (class, int32) sort becomes ONE sort pass
   instead of two; (class, dict, class, int32) multi-key becomes one
   pass instead of four.
3. *Row-id packing* — when total key bits + ceil(log2 n) <= 64, the row
   index rides in the low bits and a single VALUE sort (`jnp.sort`, no
   argsort bookkeeping) yields the permutation, with stability for free
   (equal keys order by the embedded row id).
4. *Variadic payload carriage* — when rows are to be MATERIALIZED in
   sorted order, payload columns ride XLA's variadic sort network
   directly (`lax.sort(keys + payloads, num_keys=k)`) instead of
   argsort + per-column gather (a random gather per column is the
   cost avoided; the sort moves the payload words as it goes).

Packing preserves exact lexicographic order and equality (it is a
bijection on the key tuple), so grouping/run-detection downstream is
unaffected.

Used by ops/sort.py (sort_indices / array_sort_indices / rank /
select_k) and exec/compiled.py order_by. Join/group-by key
normalization stays on the width-consistent 64-bit form in ops/sort.py
(cross-column/side comparability matters there).
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from .. import dtypes as dt
from ..column import Column
from ..errors import Invalid

__all__ = ["minimal_sort_keys", "pack_words", "radix_sort_indices",
           "keys_total_bits", "sort_rows", "pack_split",
           "sort_rows_with_keys"]


def _flip_desc(key: jnp.ndarray, bits: int) -> jnp.ndarray:
    mask = (1 << bits) - 1 if bits < 64 else 0xFFFFFFFFFFFFFFFF
    return key ^ jnp.asarray(mask, dtype=key.dtype)


def _float_bits_narrow(x) -> Tuple[jnp.ndarray, int]:
    """IEEE-754 total-order bits at native width (NaN via class key)."""
    width = np.dtype(x.dtype).itemsize
    if width == 8:
        # f64->u64 through two u32 halves rather than one direct
        # bitcast (the form the engine's first target could lower)
        halves = jax.lax.bitcast_convert_type(x, jnp.uint32)
        bits = (halves[..., 1].astype(jnp.uint64) << jnp.uint64(32)) | \
            halves[..., 0].astype(jnp.uint64)
        sign = jnp.uint64(1 << 63)
        return jnp.where((bits & sign) != 0, ~bits, bits | sign), 64
    if width == 2:
        x = x.astype(jnp.float32)
    bits = jax.lax.bitcast_convert_type(x, jnp.uint32)
    sign = jnp.uint32(1 << 31)
    return jnp.where((bits & sign) != 0, ~bits, bits | sign), 32


def minimal_sort_keys(col: Column, order: str = "ascending",
                      null_placement: str = "at_end"
                      ) -> List[Tuple[jnp.ndarray, int]]:
    """(key, nbits) list, most-significant first, minimal widths.

    Unsigned lexicographic order over the (masked-to-nbits) keys equals
    the required row order; equality equals row-key equality.
    null_placement: "at_end" orders (values, NaN, null); "at_start"
    orders (null, NaN, values) — the reference's NullPlacement
    (vector_sort.cc / RankOptions).
    """
    if null_placement not in ("at_end", "at_start"):
        raise Invalid(f"bad null_placement {null_placement!r}")
    if order not in ("ascending", "descending"):
        raise Invalid(f"bad sort order {order!r}")
    t = col.dtype
    desc = order == "descending"
    has_nan = False
    if t.is_binary:
        assert col.dictionary is not None
        nuniq = len(col.dictionary)
        kbits = max(1, (max(nuniq - 1, 0)).bit_length())
        if not nuniq:
            key = jnp.zeros_like(col.data, dtype=jnp.uint64)
        elif col.dictionary.rank_is_identity:
            # sorted value pool: codes ARE ranks — skip the per-row
            # rank gather
            key = col.data.astype(jnp.uint64)
        else:
            rank = jnp.asarray(col.dictionary.rank, dtype=jnp.uint64)
            key = rank[jnp.clip(col.data, 0, nuniq - 1)]
    elif t.is_floating:
        if np.dtype(col.data.dtype).itemsize == 8:
            # f64: the raw column sorts as its own operand instead of
            # a bit-packed word (the engine's first target could not
            # bitcast f64; ROADMAP Design 2); lax.sort's comparator is
            # already a total order over raw
            # f64 keys (-0.0 < +0.0, NaNs handled via the class plane
            # below). Emit the raw column as an unpackable operand
            # (nbits == 0); descending negates (order-exact: ties stay
            # ties, -0.0/+0.0 swap roles symmetrically).
            x = col.data
            if desc:
                x = -x
            nan = jnp.isnan(col.data)
            cls64 = jnp.full(col.length, jnp.uint64(0) if
                             null_placement == "at_end" else jnp.uint64(2))
            cls64 = jnp.where(nan, jnp.uint64(1), cls64)
            x = jnp.where(nan, jnp.float64(0.0), x)
            if col.validity is not None:
                nullc = jnp.uint64(2) if null_placement == "at_end" \
                    else jnp.uint64(0)
                cls64 = jnp.where(col.validity, cls64, nullc)
                x = jnp.where(col.validity, x, jnp.float64(0.0))
            return [(cls64, 2), (x, 0)]
        key, kbits = _float_bits_narrow(col.data)
        key = key.astype(jnp.uint64)
        has_nan = True
    elif t.is_boolean:
        key, kbits = col.data.astype(jnp.uint64), 1
    elif t.is_unsigned_integer:
        kbits = np.dtype(col.data.dtype).itemsize * 8
        key = col.data.astype(jnp.uint64)
    elif t.is_signed_integer or t.is_temporal:
        kbits = np.dtype(col.data.dtype).itemsize * 8
        if kbits >= 64:
            key = col.data.astype(jnp.int64).astype(jnp.uint64) \
                ^ jnp.uint64(1 << 63)
        else:
            # bias to unsigned at native width (order-preserving)
            key = (col.data.astype(jnp.int64)
                   + jnp.int64(1 << (kbits - 1))).astype(jnp.uint64)
    elif t.is_decimal:
        # full-width limbs: fall back to the 64-bit normalized form
        from ..ops.sort import normalize_sort_key

        keys = normalize_sort_key(col, order)
        pairs = [(k.astype(jnp.uint64), 2 if k.dtype == jnp.uint8 else 64)
                 for k in keys]
        if null_placement == "at_start" and col.validity is not None:
            cls, _ = pairs[0]
            pairs[0] = (jnp.uint64(2) - cls, 2)
        return pairs
    else:
        raise Invalid(f"sort: unsupported type {t}")

    if desc:
        key = _flip_desc(key, kbits)

    needs_class = has_nan or col.validity is not None
    if not needs_class:
        return [(key, kbits)]
    at_start = null_placement == "at_start"
    valid_cls, null_cls = (jnp.uint64(2), jnp.uint64(0)) if at_start \
        else (jnp.uint64(0), jnp.uint64(2))
    cls = jnp.full(col.length, valid_cls)
    if has_nan:
        nan = jnp.isnan(col.data)
        cls = jnp.where(nan, jnp.uint64(1), cls)
        key = jnp.where(nan, jnp.uint64(0), key)
    if col.validity is not None:
        cls = jnp.where(col.validity, cls, null_cls)
        key = jnp.where(col.validity, key, jnp.uint64(0))
    return [(cls, 2), (key, kbits)]


def keys_total_bits(pairs: Sequence[Tuple[jnp.ndarray, int]]) -> int:
    """Total packed width; raw operands (nbits == 0, e.g. f64 keys that
    cannot bitcast on this stack) count as unpackable full words."""
    return sum((b if b else 1000) for _, b in pairs)


def pack_operands(pairs: Sequence[Tuple[jnp.ndarray, int]]
                  ) -> Tuple[List[jnp.ndarray], List[int]]:
    """Greedy MSB-first packing of (key, nbits) into uint64 words, with
    raw operands (nbits == 0) passed through unpacked in priority order.

    Order/equality preserving: within a word, higher-significance keys
    occupy higher bits; across operands, earlier operands are more
    significant (the caller sorts lexicographically / LSD-composes).
    Returns (operands, used_bits) where used_bits[i] == 0 marks a raw
    operand and otherwise gives the occupied low bits of a u64 word.
    """
    operands: List[jnp.ndarray] = []
    used_bits: List[int] = []
    cur = None
    used = 0
    for key, bits in pairs:
        if bits == 0:
            if cur is not None:
                operands.append(cur)
                used_bits.append(used)
                cur, used = None, 0
            operands.append(key)
            used_bits.append(0)
            continue
        key = key.astype(jnp.uint64)
        if cur is not None and used + bits <= 64:
            cur = (cur << jnp.uint64(bits)) | key
            used += bits
        else:
            if cur is not None:
                operands.append(cur)
                used_bits.append(used)
            cur, used = key, bits
    if cur is not None:
        operands.append(cur)
        used_bits.append(used)
    return operands, used_bits


def pack_layout(pairs: Sequence[Tuple[jnp.ndarray, int]]
                ) -> List[Tuple[int, int, int]]:
    """Placement of each pair under pack_operands' greedy MSB-first
    packing: (word_index, low_bit_shift, nbits) per pair; raw operands
    (nbits == 0) get (word_index, 0, 0). Lets callers DECODE key values
    back out of the sorted words instead of carrying the raw planes as
    extra sort operands (lax.sort compile+run scale with operand
    count)."""
    word_members: List[List[int]] = []   # pair indices per operand
    cur: List[int] = []
    used = 0
    for i, (_, bits) in enumerate(pairs):
        if bits == 0:
            if cur:
                word_members.append(cur)
                cur, used = [], 0
            word_members.append([i])    # raw operand: its own slot
            continue
        if cur and used + bits > 64:
            word_members.append(cur)
            cur, used = [], 0
        cur.append(i)
        used += bits
    if cur:
        word_members.append(cur)
    placements: List[Tuple[int, int, int]] = [None] * len(pairs)
    for wi, members in enumerate(word_members):
        if len(members) == 1 and pairs[members[0]][1] == 0:
            placements[members[0]] = (wi, 0, 0)
            continue
        shift = 0
        for i in reversed(members):   # last-packed key sits in low bits
            bits = pairs[i][1]
            placements[i] = (wi, shift, bits)
            shift += bits
    return placements


def decode_packed_key(col: Column, vals: Sequence[jnp.ndarray],
                      order: str = "ascending"):
    """Inverse of minimal_sort_keys (at_end null placement): reconstruct
    (data, validity) from the pair values extracted out of the sorted
    packed words. `vals` holds one array per pair, in emit order —
    uint64 for packed pairs, the raw plane dtype for nbits==0 pairs.
    Only valid when sort_key_decodable(col); used by the compiled
    group_by to rebuild key output columns from G-sized word slices and
    by materialize_sorted to avoid carrying key planes as payloads.
    Descending keys un-flip (packed: XOR the width mask; raw f64:
    negate) before decoding."""
    t = col.dtype
    desc = order == "descending"
    has_cls = len(vals) == 2
    cls = vals[0].astype(jnp.uint64) if has_cls else None
    v = vals[-1]
    validity = None
    if has_cls and col.validity is not None:
        # at_end classes: valid=0, NaN=1, null=2
        validity = cls != jnp.uint64(2)
    if t.is_binary:
        assert col.dictionary is not None
        nuniq = len(col.dictionary)
        if desc and nuniq:
            kbits = max(1, (nuniq - 1).bit_length())
            v = v ^ jnp.uint64((1 << kbits) - 1)
        if nuniq and not col.dictionary.rank_is_identity:
            order_np = np.argsort(col.dictionary.values, kind="stable")
            data = jnp.asarray(order_np.astype(np.int64))[
                jnp.clip(v, 0, nuniq - 1).astype(jnp.int32)
            ].astype(col.data.dtype)
        else:
            data = v.astype(col.data.dtype)
        if validity is not None:
            # null rows packed key 0; desc-unflip made it kbits-max —
            # clamp back into the code domain so take/gather stay safe
            data = jnp.where(validity, data,
                             jnp.zeros((), dtype=col.data.dtype))
        return data, validity
    if t.is_floating and np.dtype(col.data.dtype).itemsize == 8:
        if desc:
            v = -v
        data = jnp.where(cls == jnp.uint64(1), jnp.float64(jnp.nan), v)
        return data, validity
    if t.is_floating:
        if desc:
            v = v ^ jnp.uint64(0xFFFFFFFF)
        y = v.astype(jnp.uint32)
        sign = jnp.uint32(1 << 31)
        bits = jnp.where((y & sign) != 0, y ^ sign, ~y)
        f = jax.lax.bitcast_convert_type(bits, jnp.float32)
        f = jnp.where(cls == jnp.uint64(1), jnp.float32(jnp.nan), f)
        return f.astype(col.data.dtype), validity
    if t.is_boolean:
        if desc:
            v = v ^ jnp.uint64(1)
        return v != 0, validity
    if t.is_unsigned_integer:
        if desc:
            kbits = np.dtype(col.data.dtype).itemsize * 8
            v = v ^ jnp.uint64((1 << kbits) - 1)
        return v.astype(col.data.dtype), validity
    kbits = np.dtype(col.data.dtype).itemsize * 8
    if desc:
        v = v ^ jnp.uint64((1 << kbits) - 1)
    if kbits >= 64:
        data = (v ^ jnp.uint64(1 << 63)).astype(jnp.int64)
    else:
        data = v.astype(jnp.int64) - jnp.int64(1 << (kbits - 1))
    return data.astype(col.data.dtype), validity


def sort_key_decodable(col: Column) -> bool:
    """Whether decode_packed_key can invert minimal_sort_keys for this
    column (everything but decimals, whose pairs ride normalize_sort_key
    with flips baked in)."""
    return not col.dtype.is_decimal


def pack_split(pairs: Sequence[Tuple[jnp.ndarray, int]]):
    """Greedy MSB-first packing that SPLITS keys across word boundaries.

    Unlike pack_operands (whole keys only), every word except possibly
    the last is completely full, so the word sequence is the exact
    concatenated key bitstream — lexicographic unsigned order over the
    words equals order over the key tuple (word boundaries merely cut
    the stream). Splitting matters for shapes like (dict10, cls2,
    int64): whole-key packing leaves word0 at 12/64 bits and word1 full,
    so no room for an embedded row id; split packing fills word0 with
    the int64's high 52 bits, leaving word1 at 12 used bits — the row id
    then rides word1's free low bits and the sort runs is_stable=False
    with one fewer operand (lax.sort compile AND run scale with operand
    count; stability costs extra comparator stages).

    Raw operands (nbits == 0, e.g. f64 keys that cannot bitcast on this
    stack) occupy their own slot unpacked, flushing the current word.

    Returns (words, used_bits, frags): used_bits[w] == 0 marks a raw
    operand, else the occupied low bits of word w. frags[i] lists pair
    i's fragments MSB-first as (word_idx, low_shift, nbits, src_shift):
    pair value == OR of ((word >> low_shift) & mask(nbits)) << src_shift
    (raw pairs: one (word_idx, 0, 0, 0) fragment; the word IS the value).
    """
    # plan word membership on (pair_idx, src_shift, take) triples
    words_spec: List[Tuple[List, int]] = []
    cur: List[Tuple] = []
    used = 0
    for i, (_, bits) in enumerate(pairs):
        if bits == 0:
            if cur:
                words_spec.append((cur, used))
                cur, used = [], 0
            words_spec.append(([("raw", i)], 0))
            continue
        rem = bits
        while rem:
            take = min(64 - used, rem)
            cur.append((i, rem - take, take))
            used += take
            rem -= take
            if used == 64:
                words_spec.append((cur, 64))
                cur, used = [], 0
    if cur:
        words_spec.append((cur, used))
    words: List[jnp.ndarray] = []
    used_bits: List[int] = []
    frags: List[List[Tuple[int, int, int, int]]] = [[] for _ in pairs]
    for wi, (members, u) in enumerate(words_spec):
        if members and members[0][0] == "raw":
            i = members[0][1]
            words.append(pairs[i][0])
            used_bits.append(0)
            frags[i].append((wi, 0, 0, 0))
            continue
        w = None
        shift = u
        for (i, src_shift, take) in members:
            shift -= take
            part = pairs[i][0].astype(jnp.uint64)
            if src_shift:
                part = part >> jnp.uint64(src_shift)
            if take < 64:
                part = part & jnp.uint64((1 << take) - 1)
            if shift:
                part = part << jnp.uint64(shift)
            w = part if w is None else w | part
            frags[i].append((wi, shift, take, src_shift))
        # (loop order appends each pair's fragments MSB-first)
        words.append(w)
        used_bits.append(u)
    return words, used_bits, frags


def _extract_pair_values(pairs, frags, sorted_words):
    """Reassemble each pair's value array out of (sorted) packed words
    per the pack_split fragment layout. Raw pairs return the word
    itself (original dtype); packed pairs return uint64."""
    vals: List[jnp.ndarray] = []
    for i, (_, bits) in enumerate(pairs):
        if bits == 0:
            vals.append(sorted_words[frags[i][0][0]])
            continue
        v = None
        for (wi, low, take, src) in frags[i]:
            part = sorted_words[wi]
            if low:
                part = part >> jnp.uint64(low)
            if take < 64:
                part = part & jnp.uint64((1 << take) - 1)
            if src:
                part = part << jnp.uint64(src)
            v = part if v is None else v | part
        vals.append(v)
    return vals


def pack_words(pairs: Sequence[Tuple[jnp.ndarray, int]]
               ) -> List[jnp.ndarray]:
    """pack_operands for all-packable pairs (legacy callers)."""
    operands, used = pack_operands(pairs)
    assert all(u > 0 for u in used), "raw operands need pack_operands"
    return operands


def radix_sort_indices(pairs: Sequence[Tuple[jnp.ndarray, int]]
                       ) -> jnp.ndarray:
    """Stable lexicographic argsort of minimal-width keys.

    Packs to uint64 words; if (total bits + row-id bits) <= 64 the row
    id rides the low bits and one VALUE sort produces the permutation
    (stability built in); otherwise stable LSD argsort passes per word.
    """
    if not pairs:
        raise Invalid("radix_sort_indices: no keys")
    n = int(pairs[0][0].shape[0])
    total = keys_total_bits(pairs)
    idbits = max(1, (max(n - 1, 0)).bit_length())
    if total + idbits <= 64:
        packed = pack_words(list(pairs) + [
            (jnp.arange(n, dtype=jnp.uint64), idbits)])
        assert len(packed) == 1
        s = jnp.sort(packed[0])
        idmask = jnp.uint64((1 << idbits) - 1)
        return (s & idmask).astype(jnp.int64)
    words, used, _ = pack_split(pairs)
    if used[-1] and used[-1] + idbits <= 64:
        # the row id rides the LAST word's free low bits: one fewer
        # sort operand AND is_stable=False (equal keys are already
        # disambiguated by the embedded id -> stable by construction).
        # lax.sort compile time is ~linear in operand count (~25 s per
        # operand at 1M rows measured on cpu), so this also halves the
        # 2-word compile. pack_split fills every non-final word to 64
        # bits, so the last word has free bits whenever the total key
        # width isn't an exact multiple of 64 — e.g. (dict10, cls2,
        # int64) = 76 bits packs to 64 + 12, leaving 52 for the id.
        iota = jnp.arange(n, dtype=jnp.uint64)
        last = (words[-1] << jnp.uint64(idbits)) | iota
        if len(words) == 1:
            s = jnp.sort(last)
        else:
            out = jax.lax.sort(tuple(words[:-1]) + (last,),
                               num_keys=len(words), is_stable=False)
            s = out[-1]
        idmask = jnp.uint64((1 << idbits) - 1)
        return (s & idmask).astype(jnp.int64)
    iota = jnp.arange(n, dtype=jnp.int64)
    out = jax.lax.sort(tuple(words) + (iota,), num_keys=len(words),
                       is_stable=True)
    return out[-1]


def sort_rows(pairs: Sequence[Tuple[jnp.ndarray, int]],
              payloads: Sequence[jnp.ndarray]) -> List[jnp.ndarray]:
    """Materialize payload arrays in stable sorted key order.

    Packs the minimal-width keys into uint64 words (split packing) and
    rides XLA's variadic sort with the payloads as extra operands — one
    fused sort network pass, no argsort, no gathers. When the
    last word has room, a row id embedded in its free bits replaces the
    is_stable=True comparator (ids break all key ties -> stable by
    construction, and the unstable network is cheaper)."""
    out, _, _ = _sort_rows_packed(pairs, payloads)
    return out


def _sort_rows_packed(pairs, payloads):
    """Shared core: returns (sorted_payloads, sorted_words, frags) with
    the embedded row id (if any) already stripped back out of the last
    word, so sorted_words match the pack_split fragment layout."""
    words, used, frags = pack_split(pairs)
    k = len(words)
    n = int(words[0].shape[0])
    idbits = max(1, (max(n - 1, 0)).bit_length())
    if used[-1] and used[-1] + idbits <= 64:
        iota = jnp.arange(n, dtype=jnp.uint64)
        last = (words[-1] << jnp.uint64(idbits)) | iota
        ops = tuple(words[:-1]) + (last,) + tuple(payloads)
        out = jax.lax.sort(ops, num_keys=k, is_stable=False)
        skeys = list(out[:k])
        skeys[-1] = skeys[-1] >> jnp.uint64(idbits)
        return list(out[k:]), skeys, frags
    ops = tuple(words) + tuple(payloads)
    out = jax.lax.sort(ops, num_keys=k, is_stable=True)
    return list(out[k:]), list(out[:k]), frags


def sort_rows_with_keys(pairs, payloads):
    """sort_rows + the sorted per-pair key values, so callers can DECODE
    sort-key columns back out of the packed words (via decode_packed_key)
    instead of carrying their planes as payload operands. Returns
    (sorted_payloads, pair_values): pair_values[i] is pairs[i]'s value
    array in sorted row order — uint64 for packed pairs, the raw plane
    dtype for nbits==0 pairs."""
    out, skeys, frags = _sort_rows_packed(pairs, payloads)
    return out, _extract_pair_values(pairs, frags, skeys)

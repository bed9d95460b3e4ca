"""Jit-composable padded-output primitives.

The reference sizes dynamic outputs in two phases with a host round-trip
(GetFilterOutputSize vector_selection.cc:61); inside a jitted pipeline
a host sync would break fusion and stall the device. These variants keep
everything on device with *static* output capacities + a valid-count
scalar (SURVEY.md §7: "padded-with-valid-count outputs threaded through
the pipeline"). The eager kernels in selection.py/hash.py/groupby.py are
the two-phase user-facing forms; these are the building blocks for
exec/streaming pipelines and the shard_map distributed operators, where
capacities are chosen once per plan.

All functions take/return plain jnp arrays (not Columns) so they can be
used inside shard_map bodies without pytree ceremony.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
from ..kernels.blockscan import cumsum_blocked, scan_blocked

__all__ = ["filter_padded", "grouping_padded", "join_padded", "PaddedGroups",
           "SortedGroups", "group_sort_padded", "seg_sum_sorted",
           "seg_minmax_sorted", "seg_sum_plane", "seg_minmax_plane",
           "seg_values_at_ends", "seg_diff_lo"]


def filter_padded(selected: jnp.ndarray):
    """mask -> (indices[n], count). First `count` index slots are the
    selected row positions in order; the rest point at row 0 (callers mask
    by position < count)."""
    n = selected.shape[0]
    count = jnp.sum(selected, dtype=jnp.int32)
    positions = cumsum_blocked(selected, dtype=jnp.int32) - 1
    rows = jnp.arange(n, dtype=jnp.int32)
    scatter_to = jnp.where(selected, positions, n)
    indices = jnp.zeros(n, dtype=jnp.int32)
    indices = indices.at[scatter_to].set(rows, mode="drop")
    return indices, count


def _as_sort_planes(key) -> list:
    """Normalize a join key to a list of equality planes.

    A single int64/uint64 array rides the order-preserving sign-flip
    bitcast (fast u64 sort path); a list/tuple of planes is taken as-is
    (exact lexicographic equality over ALL planes — the multi-column
    case; reference anchor: the Grouper matches serialized keys exactly,
    cpp/src/arrow/compute/kernels/hash_aggregate.cc:97-311)."""
    if isinstance(key, (list, tuple)):
        return list(key)
    if key.dtype in (jnp.int64,):
        return [jax.lax.bitcast_convert_type(key, jnp.uint64)
                ^ jnp.uint64(1 << 63)]
    return [key]


def probe_ranges_sortmerge(probe_key, build_key,
                           want_build_matched: bool = False):
    """Per-probe build match ranges via one merged stable sort.

    Replaces binary-search probing (searchsorted = ~log2(m) dependent
    gather passes) with: stable-argsort(concat(build,
    probe)); within an equal-key run, build entries precede probes (they
    come first in the concat) and keep build order. A probe's matching
    builds are then the count of build entries in its run before it, and
    the run's first build index — all cumsum/gather arithmetic.

    probe_key/build_key: single array OR a list of key planes — the
    multi-plane form matches EXACTLY over all planes (one fused variadic
    lax.sort; no probabilistic folding).

    Returns (build_order int[m] — build rows sorted by key,
             lo int[n] — start of each probe's match range in build_order,
             counts int32[n][, build_matched bool[m] when asked]).
    """
    pks = _as_sort_planes(probe_key)
    bks = _as_sort_planes(build_key)
    m = bks[0].shape[0]
    n = pks[0].shape[0]
    planes = [jnp.concatenate([b, p]) for b, p in zip(bks, pks)]
    # scatter-free formulation: everything below is sort / scan /
    # gather.
    iota = jnp.arange(n + m, dtype=jnp.int32)
    sorted_all = jax.lax.sort(tuple(planes) + (iota,),
                              num_keys=len(planes), is_stable=True)
    morder = sorted_all[-1]
    # inverse permutation via lax.sort with an int32 value operand
    # (argsort under x64 would carry an i64 iota = two extra planes)
    inv = jax.lax.sort(
        (morder, jnp.arange(n + m, dtype=jnp.int32)), num_keys=1,
        is_stable=True)[1]
    is_build = morder < m
    # run starts (adjacent compare over ALL planes)
    first = jnp.ones(n + m, jnp.bool_)
    if n + m > 1:
        neq = sorted_all[0][1:] != sorted_all[0][:-1]
        for s in sorted_all[1:-1]:
            neq = neq | (s[1:] != s[:-1])
        first = first.at[1:].set(neq)
    # builds strictly before position p
    b_excl = cumsum_blocked(is_build) - is_build
    # position of my run's start: running max of start positions
    pos = jnp.arange(n + m)
    run_start_pos = scan_blocked(
        jnp.maximum, jnp.where(first, pos, 0))
    run_base = b_excl[run_start_pos]            # builds before my run
    cnt_all = (b_excl - run_base).astype(jnp.int32)  # builds before me in run
    lo_all = run_base

    # per-probe results: gather at each probe's sorted position
    ppos = inv[m:]
    lo = lo_all[ppos]
    counts = cnt_all[ppos]

    # build rows sorted by key (same stable relative order as in merged)
    biota = jnp.arange(m, dtype=jnp.int32)
    build_order = jax.lax.sort(tuple(bks) + (biota,),
                               num_keys=len(bks), is_stable=True)[-1]
    if not want_build_matched:
        return build_order, lo, counts
    # a build row is matched iff its run contains >= 1 probe: probes
    # through my run's END minus probes before my run's start, from the
    # SAME merged sort (replaces two searchsorteds + an extra key sort)
    p_excl = pos - b_excl                       # probes strictly before p
    nxt = jnp.where(first, pos, n + m)
    nxt = jnp.concatenate([nxt[1:], jnp.full(1, n + m, nxt.dtype)])
    next_start = scan_blocked(jnp.minimum, nxt, reverse=True)
    p_excl_ext = jnp.concatenate(
        [p_excl, jnp.full(1, n, p_excl.dtype)])
    run_probe_cnt = p_excl_ext[next_start] - p_excl[run_start_pos]
    build_matched = (run_probe_cnt > 0)[inv[:m]]
    return build_order, lo, counts, build_matched


class SortedGroups(NamedTuple):
    """Sorted-space segment structure with a STATIC group capacity.

    Produced by group_sort_padded; consumed by seg_*_sorted and the
    compiled/distributed group_by operators. All fields are jit-traced.
    """

    live_sorted: jnp.ndarray   # bool[n]  rows in sorted order, dead last
    first: jnp.ndarray         # bool[n]  segment-start flags
    startpos: jnp.ndarray      # int32[G] sorted position of group start
    endpos: jnp.ndarray        # int32[G] sorted position of group end
    group_valid: jnp.ndarray   # bool[G]  slot < num_groups
    num_groups: jnp.ndarray    # int32 scalar (live groups only)
    overflow: jnp.ndarray      # bool scalar: num_groups > G


def _narrow_word(word: jnp.ndarray, bits: int) -> jnp.ndarray:
    """Downcast a packed uint64 key word to its minimal lane width —
    the sort network's cost scales with total operand bytes."""
    if bits <= 8:
        return word.astype(jnp.uint8)
    if bits <= 16:
        return word.astype(jnp.uint16)
    if bits <= 32:
        return word.astype(jnp.uint32)
    return word


def group_sort_padded(key_pairs: Sequence[Tuple[jnp.ndarray, int]],
                      live: Optional[jnp.ndarray],
                      payloads: Sequence[jnp.ndarray],
                      G: int
                      ) -> Tuple[SortedGroups, List[jnp.ndarray],
                                 List[jnp.ndarray],
                                 List[Tuple[int, int, int]]]:
    """Scatter-free grouping with static group capacity G.

    ONE variadic lax.sort over minimal-width packed key words (a dead-row
    bit leads, so shuffle padding sorts last and never merges with live
    groups) carrying `payloads` as extra operands; segment boundaries by
    adjacent-compare; per-slot positions by binary search over the
    monotone sorted group ids (searchsorted = log2(n) G-sized gathers)
    at small G, a stable sort of the segment-start flags at large G.
    No scatter: a full-length scatter-add per aggregate is the design
    this replaced.

    Group order is key order (dead-excluded); callers treat group-by
    output as unordered rows (hash_aggregate.cc GrouperImpl order is
    likewise insertion-dependent). Groups beyond G set `overflow`.

    Returns (SortedGroups, payloads in sorted order, key words in
    sorted order, placements): placements[i] = (word_idx, shift, bits)
    locates key_pairs[i] inside the sorted words so callers can DECODE
    key values at group starts (kernels/radix.py decode_packed_key)
    instead of carrying raw key planes as sort payloads.
    """
    sorted_words, sorted_payloads, used, placements = gsp_sort(
        key_pairs, live, payloads)
    sg = gsp_segments(sorted_words, used, live is not None, G)
    return sg, sorted_payloads, list(sorted_words), placements


def gsp_sort(key_pairs, live, payloads):
    """Stage 1 of group_sort_padded: minimal-width pack + ONE variadic
    lax.sort carrying the payloads. Split out so the staged driver
    (exec/staged_groupby.py) can dispatch it as its own cached program.

    Returns (sorted_words, sorted_payloads, used_bits, placements)."""
    from ..kernels.radix import pack_layout, pack_operands

    pairs = list(key_pairs)
    if live is not None:
        pairs = [((~live).astype(jnp.uint64), 1)] + pairs
    placements = pack_layout(pairs)
    if live is not None:
        placements = placements[1:]
    words, used = pack_operands(pairs)
    words = [w if b == 0 else _narrow_word(w, b)
             for w, b in zip(words, used)]
    k = len(words)
    out = jax.lax.sort(tuple(words) + tuple(payloads), num_keys=k,
                       is_stable=False)
    return list(out[:k]), list(out[k:]), used, placements


def gsp_flags(sorted_words, used, have_live):
    """Stage 2: live mask + segment-start flags + group count from the
    sorted key words (adjacent compares + one reduction)."""
    n = sorted_words[0].shape[0]
    if have_live:
        # the dead bit is the top bit of word 0
        top = jnp.uint64(1) << jnp.uint64(used[0] - 1)
        live_sorted = (sorted_words[0].astype(jnp.uint64) & top) == 0
    else:
        live_sorted = jnp.ones(n, jnp.bool_)
    first = jnp.ones(n, jnp.bool_)
    if n > 1:
        same = jnp.ones(n - 1, jnp.bool_)
        for w in sorted_words:
            same = same & (w[1:] == w[:-1])
        first = first.at[1:].set(~same)
    num_groups = jnp.sum(first & live_sorted).astype(jnp.int32)
    return live_sorted, first, num_groups


def gsp_segments(sorted_words, used, have_live, G) -> SortedGroups:
    """Stages 2+3 of group_sort_padded: flags, then slot positions
    (searchsorted at small G; a flag sort at large G)."""
    n = sorted_words[0].shape[0]
    live_sorted, first, num_groups = gsp_flags(sorted_words, used,
                                               have_live)
    overflow = num_groups > G
    slots = jnp.arange(G, dtype=jnp.int32)
    group_valid = slots < num_groups
    if G <= 65536:
        gid_sorted = (cumsum_blocked(first) - 1).astype(jnp.int32)
        right = jnp.searchsorted(gid_sorted, slots, side="right").astype(
            jnp.int32)
        left = jnp.concatenate([jnp.zeros(1, jnp.int32), right[:-1]])
        endpos = jnp.where(group_valid, jnp.maximum(right - 1, 0), 0)
        startpos = jnp.where(group_valid, left, 0)
    else:
        # searchsorted costs G*log(n) dependent gathers, so at large G
        # the start positions come from a stable sort of the first-flag
        # plane instead (segment starts sort first, in order)
        iota = jnp.arange(n, dtype=jnp.int32)
        _, pos = jax.lax.sort(
            ((~first).astype(jnp.uint8), iota), num_keys=1,
            is_stable=True)
        startpos = jnp.where(group_valid, pos[:G], 0)
        total_segs = jnp.sum(first).astype(jnp.int32)
        nxt = jnp.concatenate(
            [pos[1:G + 1],
             jnp.zeros(max(G + 1 - n, 0), jnp.int32)])
        nxt = jnp.where(slots + 1 < total_segs, nxt, n)
        endpos = jnp.where(group_valid, jnp.maximum(nxt - 1, 0), 0)
    return SortedGroups(live_sorted, first, startpos, endpos, group_valid,
                        num_groups, overflow)


def seg_sum_plane(xs: jnp.ndarray, mask_s: Optional[jnp.ndarray],
                  sg: SortedGroups, acc_dtype) -> jnp.ndarray:
    """Full-length inclusive cumsum plane for a segment sum; extract at
    segment ends (seg_values_at_ends) and diff (seg_diff_lo)."""
    m = sg.live_sorted if mask_s is None else (mask_s & sg.live_sorted)
    return cumsum_blocked(jnp.where(m, xs, 0).astype(acc_dtype))


def seg_diff_lo(hi: jnp.ndarray, sg: SortedGroups) -> jnp.ndarray:
    """Cumsum values at segment ends -> per-slot sums. Segments tile
    sorted space, so c[startpos_g - 1] == hi[g-1]: the low side is a
    slot SHIFT of the high side, not a second G-gather."""
    lo = jnp.concatenate([jnp.zeros(1, hi.dtype), hi[:-1]])
    return jnp.where(sg.group_valid, hi - lo, 0)


def seg_values_at_ends(sg: SortedGroups,
                       planes: Sequence[jnp.ndarray]) -> List[jnp.ndarray]:
    """Values of each full-length plane at segment END positions,
    slot-aligned to [G]. Slots past num_groups hold garbage — callers
    mask with sg.group_valid.

    At large G several f64 planes ride ONE packed [n, K] row gather;
    every other plane is a plain gather at the segment ends.
    """
    G = sg.startpos.shape[0]
    out: List[Optional[jnp.ndarray]] = [None] * len(planes)
    f64p = [i for i, p in enumerate(planes)
            if jnp.issubdtype(p.dtype, jnp.floating)]
    if G > 65536 and len(f64p) > 1:
        mat = jnp.stack([planes[i] for i in f64p], axis=1)
        rows = mat[sg.endpos]                      # [G, K] one gather
        for j, i in enumerate(f64p):
            out[i] = rows[:, j]
    for i, p in enumerate(planes):
        if out[i] is None:
            out[i] = p[sg.endpos]
    return out


def seg_sum_sorted(xs: jnp.ndarray, mask_s: Optional[jnp.ndarray],
                   sg: SortedGroups, acc_dtype) -> jnp.ndarray:
    """Per-slot sums via cumsum-diff (exact for integer acc dtypes).
    mask_s: sorted-order contribution mask (None = all live rows).
    One-plane form; the compiled engine batches many planes through
    seg_values_at_ends instead."""
    c = seg_sum_plane(xs, mask_s, sg, acc_dtype)
    hi = seg_values_at_ends(sg, [c])[0]
    return seg_diff_lo(hi, sg)


def seg_minmax_plane(xs: jnp.ndarray, mask_s: Optional[jnp.ndarray],
                     sg: SortedGroups, is_min: bool, init) -> jnp.ndarray:
    """Full-length flagged-scan plane for a segment min/max; extract at
    segment ends (seg_values_at_ends)."""
    m = sg.live_sorted if mask_s is None else (mask_s & sg.live_sorted)
    vals = jnp.where(m, xs, init)

    def combine(a, b):
        av, af = a
        bv, bf = b
        v = jnp.where(bf, bv,
                      jnp.minimum(av, bv) if is_min else jnp.maximum(av, bv))
        return v, af | bf

    out, _ = scan_blocked(combine, (vals, sg.first))
    return out


def seg_minmax_sorted(xs: jnp.ndarray, mask_s: Optional[jnp.ndarray],
                      sg: SortedGroups, is_min: bool,
                      init) -> jnp.ndarray:
    """Per-slot min/max via a flagged associative scan in sorted space.
    `init` is the identity sentinel masked rows contribute. One-plane
    form; the compiled engine batches through seg_values_at_ends."""
    out = seg_minmax_plane(xs, mask_s, sg, is_min, init)
    ends = seg_values_at_ends(sg, [out])[0]
    return jnp.where(sg.group_valid, ends, init)


class PaddedGroups(NamedTuple):
    group_ids: jnp.ndarray   # int32[n] dense id per row (appearance order)
    rep_rows: jnp.ndarray    # int32[n] first-occurrence row per group (padded)
    num_groups: jnp.ndarray  # int32 scalar
    group_valid: jnp.ndarray  # bool[n] slot < num_groups


def grouping_padded(keys: List[jnp.ndarray]) -> PaddedGroups:
    """Sort-based grouping with static shapes (groups padded to n).

    Device-only version of hash.grouping_by_keys: same semantics (dense
    ids in first-appearance order) with num_groups as a traced scalar
    instead of a host int."""
    from .sort import sort_indices_device

    n = keys[0].shape[0]
    order = sort_indices_device(keys)
    same = jnp.ones(n, dtype=jnp.bool_)
    for k in keys:
        ks = k[order]
        prev = jnp.concatenate([ks[:1], ks[:-1]])
        same = same & (ks == prev)
    first = ~same
    first = first.at[0].set(True) if n > 0 else first
    gid_sorted = cumsum_blocked(first) - 1
    group_sorted_ids = jnp.zeros(n, dtype=gid_sorted.dtype)
    group_sorted_ids = group_sorted_ids.at[order].set(gid_sorted)
    num_groups = (gid_sorted[-1] + 1).astype(jnp.int32) if n else jnp.int32(0)
    # first-occurrence row per sorted group, padded: scatter row of first
    # occurrence into slot gid
    rep_sorted = jnp.zeros(n, dtype=jnp.int32)
    rep_sorted = rep_sorted.at[jnp.where(first, gid_sorted, n)].set(
        order.astype(jnp.int32), mode="drop")
    # appearance order: rank groups by rep row
    slot_valid = jnp.arange(n, dtype=jnp.int32) < num_groups
    rep_key = jnp.where(slot_valid, rep_sorted, jnp.iinfo(jnp.int32).max)
    appearance = jnp.argsort(rep_key)  # valid groups first, by first row
    rep_rows = rep_key[appearance]
    rep_rows = jnp.where(jnp.arange(n, dtype=jnp.int32) < num_groups,
                         rep_rows, 0).astype(jnp.int32)
    rank = jnp.zeros(n, dtype=jnp.int32)
    rank = rank.at[appearance].set(jnp.arange(n, dtype=jnp.int32))
    group_ids = rank[group_sorted_ids]
    return PaddedGroups(group_ids.astype(jnp.int32), rep_rows, num_groups,
                        slot_valid)


def join_padded(probe_key: jnp.ndarray, build_key: jnp.ndarray,
                probe_valid: Optional[jnp.ndarray],
                build_valid: Optional[jnp.ndarray],
                capacity: int, outer: bool = False,
                probe_live: Optional[jnp.ndarray] = None):
    """Static-capacity equi-join core for fused/distributed pipelines.

    probe_valid/build_valid: key validity — a null-key probe row matches
    nothing but IS emitted (with nulls) under `outer`. probe_live: liveness
    — dead rows (shuffle padding) are never emitted at all.

    probe_key/build_key: single u64-comparable array OR a list of key
    planes. The plane-list form matches EXACTLY over every plane (fused
    variadic sort) — multi-column keys are never folded/hashed here.

    Returns (probe_idx[capacity], build_idx[capacity], pair_valid[capacity],
    build_matched_mask, total_matches, overflowed). Matches beyond
    `capacity` are dropped and flagged via `overflowed` — callers pick
    capacity from cardinality estimates and re-run on overflow (the
    host-sync eager join in join.py never overflows).
    """
    if isinstance(probe_key, (list, tuple)):
        pks, bks = list(probe_key), list(build_key)
        nl, nr = pks[0].shape[0], bks[0].shape[0]
        if probe_valid is not None or build_valid is not None:
            # null-class plane: null build keys (1) and null probe keys
            # (2) can never equal anything on the other side
            bcls = (jnp.zeros(nr, jnp.uint8) if build_valid is None
                    else jnp.where(build_valid, jnp.uint8(0),
                                   jnp.uint8(1)))
            pcls = (jnp.zeros(nl, jnp.uint8) if probe_valid is None
                    else jnp.where(probe_valid, jnp.uint8(0),
                                   jnp.uint8(2)))
            pks = [pcls] + pks
            bks = [bcls] + bks
        pk, bk = pks, bks
    else:
        nl, nr = probe_key.shape[0], build_key.shape[0]
        SENT = jnp.uint64(0xFFFFFFFFFFFFFFFF)
        bk = build_key if build_valid is None else jnp.where(
            build_valid, build_key, SENT)
        pk = probe_key if probe_valid is None else jnp.where(
            probe_valid, probe_key, SENT - jnp.uint64(1))
    build_order, lo, counts, build_matched = probe_ranges_sortmerge(
        pk, bk, want_build_matched=True)
    if probe_valid is not None:
        counts = jnp.where(probe_valid, counts, 0)
    matched = counts > 0
    emit = jnp.maximum(counts, 1) if outer else counts
    if probe_live is not None:
        emit = jnp.where(probe_live, emit, 0)
    offsets = cumsum_blocked(emit) - emit
    total = jnp.sum(emit)
    overflowed = total > capacity

    # expansion into fixed capacity: out slot j belongs to probe row
    # searchsorted(offsets, j, 'right')-1
    slots = jnp.arange(capacity, dtype=jnp.int32)
    probe_idx = jnp.clip(
        jnp.searchsorted(offsets, slots, side="right") - 1, 0, max(nl - 1, 0)
    ).astype(jnp.int32)
    within = slots - offsets[probe_idx].astype(jnp.int32)
    pair_valid = slots < total
    pos = lo[probe_idx].astype(jnp.int32) + jnp.minimum(
        within, jnp.maximum(counts[probe_idx] - 1, 0))
    build_idx = build_order[jnp.clip(pos, 0, max(nr - 1, 0))].astype(jnp.int32)
    if outer:
        pair_has_match = matched[probe_idx]
    else:
        pair_has_match = jnp.ones(capacity, jnp.bool_)
    # build-side matched mask (for right/full outer assembled by caller)
    # — computed inside probe_ranges_sortmerge from the same merged sort
    if build_valid is not None:
        build_matched = build_matched & build_valid
    return (probe_idx, build_idx, pair_valid, pair_has_match,
            build_matched, total, overflowed)

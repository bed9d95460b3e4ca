"""Hash-table kernels in plain JAX: bucketed build/probe.

Reference design inputs: cpp/src/arrow/util/hashing.h:198-370 — linear
probing with stored hashes, sentinel-empty slots, load factor < 0.75,
grow-by-doubling. A literal port (pointer-chasing per key) is the wrong
shape for XLA: data-dependent probe loops serialize. This module
re-designs the same contract around batched sorts, scatters and row
gathers:

**Bucketed (set-associative) table** — `hash_table_build` /
   `hash_table_probe`. 2^bits buckets x `ways` slots; a key lives
   somewhere in its bucket (no cross-bucket probing). Build is batched
   and scatter-light: sort keys by bucket, within-bucket rank = position
   minus run start (associative-scan max — the scatter-free pattern from
   ops/padded.py), one scatter to place every slot. Probe is ONE row
   gather of the bucket's [ways] slots + vectorized way-compare — no
   probe loop, no data-dependent control flow. The reference's load
   factor becomes bucket sizing: 2^bits ≈ D/(ways/2) keeps expected
   bucket load at ways/2; keys whose bucket overflows `ways` are
   reported (traced count) and the caller doubles `bits` and rebuilds —
   hashing.h's growth rule at batch granularity.

Payload convention: u64 payloads with 0 = empty slot (join payloads pack
(lo+1) << 32 | count, both nonzero for occupied slots).
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp
from .blockscan import cumsum_blocked, scan_blocked

__all__ = ["splitmix64", "HashTable", "PackedTable",
           "hash_table_build", "hash_table_probe", "join_build",
           "join_build_staged", "join_build_packed", "pack_table",
           "probe_packed", "join_probe"]


def splitmix64(x: jnp.ndarray) -> jnp.ndarray:
    """SplitMix64 finalizer — the scalar hash role of hashing.h:84-190
    (multiply-shift + xxhash there; one invertible mixer here)."""
    x = x.astype(jnp.uint64)
    x = (x ^ (x >> jnp.uint64(30))) * jnp.uint64(0xBF58476D1CE4E5B9)
    x = (x ^ (x >> jnp.uint64(27))) * jnp.uint64(0x94D049BB133111EB)
    return x ^ (x >> jnp.uint64(31))


class HashTable(NamedTuple):
    keys: jnp.ndarray        # u64[2^bits, ways]
    payload: jnp.ndarray     # u64[2^bits, ways], 0 = empty
    bits: int
    ways: int
    overflow: jnp.ndarray    # i32 scalar: # keys that did not fit


def _bucket_of(keys: jnp.ndarray, bits: int) -> jnp.ndarray:
    return (splitmix64(keys) >> jnp.uint64(64 - bits)).astype(jnp.int32)


def table_bits_for(n_distinct: int, ways: int = 8) -> int:
    """Bucket-count sizing: expected load ways/2 per bucket (the load-
    factor discipline of hashing.h:239 kLoadFactor, adapted to buckets)."""
    target = max(2 * n_distinct // ways, 1)
    bits = max(int(target - 1).bit_length(), 4)
    return min(bits, 28)


def _run_geometry(first: jnp.ndarray, bfirst: jnp.ndarray = None):
    """Run/bucket geometry over a sorted sequence WITHOUT max/min scans.

    Given `first[i]` (run-start flags), returns per-row
    (run_start i32, run_end i32, kcum i32, way i32) where run_end is
    the next run's start (or n), kcum the 1-based run index, and —
    when `bfirst` (bucket-start flags) is given — `way` the rank of
    the row's run within its bucket (else None).

    Construction: i32 cumsum -> run id, one scatter of the start
    positions into a [n+2] table, gathers back — in place of blocked
    i64 max/min scans, which compiled far slower on the engine's first
    target.
    """
    n = first.shape[0]
    pos = jnp.arange(n, dtype=jnp.int32)
    kcum = cumsum_blocked(first.astype(jnp.int32))
    seg = kcum - 1
    # starts[j] = position of run j's first row; untouched slots stay n
    # so starts[seg + 1] of the last run reads n. Non-first rows are
    # routed to the junk slot n + 1 (never read).
    starts = jnp.full(n + 2, n, jnp.int32).at[
        jnp.where(first, seg, n + 1)].set(pos, mode="drop")
    run_start = starts[seg]
    run_end = starts[seg + 1]
    way = None
    if bfirst is not None:
        bseg = cumsum_blocked(bfirst.astype(jnp.int32)) - 1
        # kcum at the bucket's first run, gathered back per row
        btab = jnp.zeros(n + 1, jnp.int32).at[
            jnp.where(bfirst, bseg, n)].set(kcum, mode="drop")
        way = kcum - btab[bseg]
    return run_start, run_end, kcum, way


def hash_table_build(keys: jnp.ndarray, payload: jnp.ndarray,
                     bits: int, ways: int = 8,
                     live=None) -> HashTable:
    """Batched build. `keys` u64 (distinct among live), `payload` u64
    nonzero; `live` (bool[n], optional) marks entries to insert — dead
    entries are routed past every real bucket so they cannot crowd one.

    Sort-by-bucket + run-rank placement: fully vectorized, one scatter.
    Keys whose within-bucket rank >= ways are dropped and counted in
    `overflow` (caller rebuilds with bits+1, cf. hashing.h grow-double).
    """
    n = keys.shape[0]
    nb = 1 << bits
    bucket = _bucket_of(keys, bits)
    if live is not None:
        bucket = jnp.where(live, bucket, jnp.int32(nb))
    # ONE fused variadic sort: keys/payload ride as payloads instead of
    # argsort + two [n] u64 gathers
    bs, ks, ps = jax.lax.sort((bucket, keys, payload), num_keys=1,
                              is_stable=True)
    pos = jnp.arange(n, dtype=jnp.int32)
    first = jnp.ones(n, jnp.bool_)
    if n > 1:
        first = first.at[1:].set(bs[1:] != bs[:-1])
    run_start, _, _, _ = _run_geometry(first)
    way = pos - run_start
    is_live = bs < nb
    fits = (way < ways) & is_live
    slot = jnp.where(fits, bs * ways + way, nb * ways)  # drop overflow/dead
    # one [n, 2] row scatter (rows move for free, like the row gather)
    tkp = jnp.zeros((nb * ways, 2), jnp.uint64).at[slot].set(
        jnp.stack([ks, ps], axis=1), mode="drop")
    overflow = jnp.sum(~fits & is_live).astype(jnp.int32)
    return HashTable(tkp[:, 0].reshape(nb, ways),
                     tkp[:, 1].reshape(nb, ways),
                     bits, ways, overflow)


def hash_table_probe(table: HashTable, probe: jnp.ndarray) -> jnp.ndarray:
    """Probe: returns payload u64[n] (0 where absent). One [ways]-wide
    row gather per probe + vectorized way compare."""
    b = _bucket_of(probe, table.bits)
    krows = table.keys[b]           # [n, ways] row gather
    prows = table.payload[b]        # [n, ways]
    hit = (krows == probe[:, None]) & (prows != jnp.uint64(0))
    # at most one way matches (keys distinct): sum collapses the way dim
    return jnp.sum(jnp.where(hit, prows, jnp.uint64(0)), axis=1)


class PackedTable(NamedTuple):
    """The probe-side table as ONE FLAT i32 word array.

    Entry (bucket b, way w) occupies words [4*(b*ways+w) ..+4):
    [key_lo, key_hi, pay_lo, pay_hi]. The layout was chosen for the
    engine's first target, whose 2-D tiling padded a [2^bits, ways]
    array 16x; 1-D arrays never pad, the probe needs ONE windowed
    gather per key, and the u64 keys/payload arrays can be freed after
    the pack. A GPU could gather 4-word rows directly (ROADMAP
    Speed 3)."""

    words: jnp.ndarray   # i32[(2^bits * ways) * 4] (+4 junk tail words)
    bits: int
    ways: int


def _interleave_words(slot, klo, khi, plo, phi, n_slots):
    """Four 1-D scatters into the flat interleaved layout."""
    words = jnp.zeros((n_slots + 1) * 4, jnp.int32)
    s4 = slot.astype(jnp.int32) * 4
    for j, w in enumerate((klo, khi, plo, phi)):
        words = words.at[s4 + j].set(w, mode="drop")
    return words


def _u64_words(x):
    u = x.astype(jnp.uint64)
    lo = (u & jnp.uint64(0xFFFFFFFF)).astype(jnp.uint32).astype(jnp.int32)
    hi = (u >> jnp.uint64(32)).astype(jnp.uint32).astype(jnp.int32)
    return lo, hi


def pack_table(table: HashTable) -> PackedTable:
    """Pack an existing HashTable's (keys, payload) into the flat
    PackedTable layout (compat shim; join_build_packed builds the flat
    form directly without ever materializing the u64 arrays)."""
    nb = 1 << table.bits
    k = table.keys.reshape(-1)
    p = table.payload.reshape(-1)
    klo, khi = _u64_words(k)
    plo, phi = _u64_words(p)
    slot = jnp.arange(nb * table.ways, dtype=jnp.int32)
    words = _interleave_words(slot, klo, khi, plo, phi,
                              nb * table.ways)
    return PackedTable(words, table.bits, table.ways)


def probe_packed(pt: PackedTable, probe: jnp.ndarray):
    """(lo, counts) against a PackedTable: ONE 128-word ROW gather per
    probe over the [n_slots*4/128, 128] view (one row gather per key
    instead of per-key dynamic slices). Each super-row holds 128//(4*ways) buckets; the probe's window is
    selected by lane masks, and all compare/select arithmetic stays in
    i32 (payload = (lo+1)<<32 | count, so pay_hi - 1 IS lo and pay_lo
    IS count)."""
    ways = pt.ways
    W = ways * 4
    G = max(128 // W, 1)                 # buckets per 128-lane super-row
    b = _bucket_of(probe, pt.bits)
    n_slots = (1 << pt.bits) * ways
    mat = pt.words[:n_slots * 4].reshape(-1, G * W)
    rows = mat[b // G]                   # [n, 128] one row gather
    off = (b % G) * W                    # [n] window start lane
    p_lo, p_hi = _u64_words(probe)
    lane = jnp.arange(G * W, dtype=jnp.int32)
    in_win = ((lane[None, :] >= off[:, None])
              & (lane[None, :] < off[:, None] + W))
    is_k = ((lane % 4) == 0)[None, :] & in_win
    r1 = jnp.roll(rows, -1, axis=1)      # key_hi aligned at key_lo lanes
    r2 = jnp.roll(rows, -2, axis=1)      # pay_lo (= count)
    r3 = jnp.roll(rows, -3, axis=1)      # pay_hi (= lo + 1)
    hit = (is_k & (rows == p_lo[:, None])
           & (r1 == p_hi[:, None]) & ((r2 != 0) | (r3 != 0)))
    hi32 = hit.astype(jnp.int32)
    counts = jnp.sum(hi32 * r2, axis=1)
    lo = jnp.maximum(jnp.sum(hi32 * r3, axis=1) - 1, 0)
    return lo, counts


# --- join adapter: payload packs the probe_ranges contract ---------------

def join_build(build_key: jnp.ndarray, ways: int = 8,
               bits: int = None,
               live=None) -> Tuple[jnp.ndarray, HashTable]:
    """Build from a (possibly duplicated) u64 build-key column.

    ONE bucket-major key-minor sort serves both the run detection and
    the table placement (not a key sort followed by hash_table_build's
    bucket sort — two full sort passes). Distinct keys enter the table with payload
    (lo+1)<<32 | count, where lo/count index the SORTED BUILD ORDER
    (bucket-major) — the contract only requires the caller to apply
    `order`, not any particular key order.

    `live` (bool[m], optional) marks rows eligible to match (null join
    keys are dead). Dead rows are NOT sentinel-painted — a real key
    could collide with any sentinel. Instead dead rows sort to bucket
    nb (past every real bucket) and, within equal keys, liveness is the
    minor sort key (live rows first) so payload ranges
    [run_start, run_start + live_count) index exactly the live rows and
    all-dead runs are never inserted.

    Returns (build_order, table)."""
    m = build_key.shape[0]
    if bits is None:
        bits = table_bits_for(m, ways)
    nb = 1 << bits
    bucket = _bucket_of(build_key, bits)
    # int32 iota: under x64 an i64 sort operand is TWO planes — the
    # sort network cost scales with operand bytes (r5 narrowing)
    iota = jnp.arange(m, dtype=jnp.int32)
    # iota rides as a SORT KEY (not payload): within an equal-key run
    # build_order then preserves original build-row order, which the
    # join contract documents ("matches in build order", ops/join.py)
    # and the engine-grade config-4 parity checks row-exactly
    if live is None:
        bs, ks, order = jax.lax.sort(
            (bucket, build_key, iota), num_keys=3, is_stable=False)
        live_sorted = None
    else:
        bucket = jnp.where(live, bucket, jnp.int32(nb))
        bs, ks, _, order, live_sorted = jax.lax.sort(
            (bucket, build_key,
             jnp.where(live, 0, 1).astype(jnp.int32), iota, live),
            num_keys=4, is_stable=False)
    first = jnp.ones(m, jnp.bool_)
    bfirst = jnp.ones(m, jnp.bool_)
    if m > 1:
        bchange = bs[1:] != bs[:-1]
        # bucket = f(key) so a key change within a bucket is ks-only;
        # dead rows share bucket nb with differing keys — the OR keeps
        # run detection exact there too
        first = first.at[1:].set((ks[1:] != ks[:-1]) | bchange)
        bfirst = bfirst.at[1:].set(bchange)
    run_start, run_end, _, way = _run_geometry(first, bfirst)
    if live_sorted is None:
        cnt = (run_end - run_start).astype(jnp.int64)
        ins = first
    else:
        lcum = jnp.concatenate([
            jnp.zeros(1, jnp.int64),
            cumsum_blocked(live_sorted.astype(jnp.int64))])
        cnt = lcum[run_end] - lcum[run_start]
        ins = first & live_sorted  # run's first row is live iff any live
    pay = ((run_start.astype(jnp.uint64) + jnp.uint64(1)) << jnp.uint64(32)) \
        | cnt.astype(jnp.uint64)
    is_live = bs < nb
    fits = ins & (way < ways) & is_live
    slot = jnp.where(fits, bs * ways + way, nb * ways)
    tkp = jnp.zeros((nb * ways + 1, 2), jnp.uint64).at[slot].set(
        jnp.stack([ks, pay], axis=1), mode="drop")
    overflow = jnp.sum(ins & is_live & (way >= ways)).astype(jnp.int32)
    table = HashTable(tkp[:-1, 0].reshape(nb, ways),
                      tkp[:-1, 1].reshape(nb, ways),
                      bits, ways, overflow)
    return order, table


@functools.partial(jax.jit, static_argnames=("bits",))
def _jb_sort(build_key, bits: int):
    bucket = _bucket_of(build_key, bits)
    m = build_key.shape[0]
    # iota as a sort key (matches join_build): within-key original
    # build order is the documented join match order. int32 iota —
    # an i64 operand is two planes under x64
    return jax.lax.sort((bucket, build_key,
                         jnp.arange(m, dtype=jnp.int32)),
                        num_keys=3, is_stable=False)


@jax.jit
def _jb_first(bs, ks):
    m = ks.shape[0]
    first = jnp.ones(m, jnp.bool_)
    bfirst = jnp.ones(m, jnp.bool_)
    if m > 1:
        bchange = bs[1:] != bs[:-1]
        first = first.at[1:].set((ks[1:] != ks[:-1]) | bchange)
        bfirst = bfirst.at[1:].set(bchange)
    return first, bfirst


@jax.jit
def _jb_geom(first, bfirst):
    run_start, run_end, _, way = _run_geometry(first, bfirst)
    return run_start, run_end, way


def _jb_runs(bs, ks):
    """Run detection as two host-driven dispatches (flag diff + the
    scatter/gather geometry), each compiled on its own to bound the
    compile time of a large build (ROADMAP Design 4)."""
    first, bfirst = _jb_first(bs, ks)
    run_start, run_end, way = _jb_geom(first, bfirst)
    return first, run_start, run_end, way


@functools.partial(jax.jit, static_argnames=("bits", "ways"))
def _jb_place(bs, ks, first, run_start, run_end, way,
              bits: int, ways: int):
    nb = 1 << bits
    cnt = (run_end - run_start).astype(jnp.int64)
    pay = ((run_start.astype(jnp.uint64) + jnp.uint64(1))
           << jnp.uint64(32)) | cnt.astype(jnp.uint64)
    is_live = bs < nb
    fits = first & (way < ways) & is_live
    slot = jnp.where(fits, bs * ways + way, nb * ways)
    tkp = jnp.zeros((nb * ways + 1, 2), jnp.uint64).at[slot].set(
        jnp.stack([ks, pay], axis=1), mode="drop")
    overflow = jnp.sum(first & is_live & (way >= ways)).astype(jnp.int32)
    return (tkp[:-1, 0].reshape(nb, ways),
            tkp[:-1, 1].reshape(nb, ways), overflow)


def join_build_staged(build_key: jnp.ndarray, ways: int = 8,
                      bits: int = None) -> Tuple[jnp.ndarray, HashTable]:
    """join_build split into THREE host-driven dispatches (sort /
    run-detection scans / table placement) for very large builds.

    Same contract and arithmetic as join_build (no `live` support —
    dead-row handling stays on the fused form), but each piece
    compiles standalone and lands in the persistent compile cache
    independently: the one-jit build graph was slow to compile on the
    engine's first target. Whether the H100 needs the split is ROADMAP
    Design 4/6."""
    m = build_key.shape[0]
    if bits is None:
        bits = table_bits_for(m, ways)
    bs, ks, order = _jb_sort(build_key, bits)
    first, run_start, run_end, way = _jb_runs(bs, ks)
    keys, payload, overflow = _jb_place(bs, ks, first, run_start,
                                        run_end, way, bits, ways)
    return order, HashTable(keys, payload, bits, ways, overflow)


def join_probe(table: HashTable, probe_key: jnp.ndarray, packed=None):
    """(lo, counts) per probe against the sorted build order.

    packed: an optional pack_table(table) PackedTable — the
    single-gather probe path (build it once, probe many)."""
    if packed is not None:
        lo, counts = probe_packed(packed, probe_key)
        return lo, counts.astype(jnp.int32)
    pay = hash_table_probe(table, probe_key)
    counts = (pay & jnp.uint64(0xFFFFFFFF)).astype(jnp.int32)
    lo = ((pay >> jnp.uint64(32)).astype(jnp.int32) - 1)
    lo = jnp.maximum(lo, 0)
    return lo, counts


@functools.partial(jax.jit, static_argnames=("bits", "ways"))
def _jb_place_packed(bs, ks, first, run_start, run_end, way,
                     bits: int, ways: int):
    nb = 1 << bits
    cnt = (run_end - run_start).astype(jnp.int64)
    pay = ((run_start.astype(jnp.uint64) + jnp.uint64(1))
           << jnp.uint64(32)) | cnt.astype(jnp.uint64)
    is_live = bs < nb
    fits = first & (way < ways) & is_live
    slot = jnp.where(fits, bs * ways + way, nb * ways)
    klo, khi = _u64_words(ks)
    plo, phi = _u64_words(pay)
    words = _interleave_words(slot, klo, khi, plo, phi, nb * ways)
    overflow = jnp.sum(first & is_live & (way >= ways)).astype(jnp.int32)
    return words, overflow


def join_build_packed(build_key: jnp.ndarray, ways: int = 8,
                      bits: int = None
                      ) -> Tuple[jnp.ndarray, PackedTable, jnp.ndarray]:
    """Staged build DIRECTLY into the flat PackedTable layout — the
    [2^bits, ways] u64 arrays are never materialized (see PackedTable).
    Returns (build_order, PackedTable, overflow)."""
    m = build_key.shape[0]
    if bits is None:
        bits = table_bits_for(m, ways)
    bs, ks, order = _jb_sort(build_key, bits)
    first, run_start, run_end, way = _jb_runs(bs, ks)
    words, overflow = _jb_place_packed(bs, ks, first, run_start,
                                       run_end, way, bits, ways)
    return order, PackedTable(words, bits, ways), overflow

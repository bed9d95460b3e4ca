"""Distributed operators: filter / group_by / join / sort over a mesh.

Composition pattern (one jitted shard_map program per operator):

    local prep -> all_to_all shuffle (shuffle.py) -> local padded kernel
    (ops/padded.py) -> padded per-shard outputs -> host compaction

The reference has no distributed planner (SURVEY.md §2: Flight ships
mechanism only); these operators are the BASELINE north-star design:
hash-partitioned tables, all-to-all exchange, per-shard vectorized
kernels, padded static shapes throughout so the entire distributed
pipeline is one XLA computation per operator.

Determinism/stability: dist_sort appends the global row id as a final
tiebreak key, making the distributed sort exactly as stable as the
single-chip kernel.
"""

from __future__ import annotations

from functools import partial
from typing import Dict, List, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

if hasattr(jax, "shard_map"):  # promoted API (jax >= 0.7)
    shard_map = jax.shard_map
else:  # pragma: no cover
    from jax.experimental.shard_map import shard_map

from .. import dtypes as dt
from ..column import Column
from ..errors import Invalid
from ..ops.padded import filter_padded, grouping_padded, join_padded
from ..ops.sort import normalize_sort_key, sort_indices_device
from ..table import RecordBatch
from .mesh import make_mesh, pad_to_multiple, shard_batch, unshard_batch
from .shuffle import FNV_MIX, partition_ids, shuffle_shard

__all__ = ["dist_filter", "dist_filter_padded", "dist_group_by", "dist_join",
           "dist_sort_indices", "dist_sort"]

AXIS = "x"


def _mix_keys(norm_keys: List[jnp.ndarray]) -> jnp.ndarray:
    """Combine normalized key components into one uint64 hash for
    partitioning (equal full keys -> equal hash)."""
    h = jnp.zeros(norm_keys[0].shape[0], jnp.uint64)
    for k in norm_keys:
        h = (h ^ k.astype(jnp.uint64)) * FNV_MIX
    return h


def _sharded(batch: RecordBatch, mesh: Mesh):
    """Shard rows + an explicit live-row mask (padding rows are dead)."""
    n = batch.num_rows
    d = mesh.shape[AXIS]
    padded = pad_to_multiple(batch, d)
    row_valid = jnp.arange(padded.num_rows) < n
    sharding = NamedSharding(mesh, P(AXIS))
    sb = shard_batch(batch, mesh)
    rv = jax.device_put(row_valid, sharding)
    return sb, rv


def _col_arrays(batch: RecordBatch, names) -> Dict[str, jnp.ndarray]:
    """Flatten the needed columns into a name->array dict (data + masks
    + the decimal high-limb plane when present)."""
    out = {}
    for name in names:
        c = batch.column(name)
        out[f"d:{name}"] = c.data
        out[f"m:{name}"] = c.mask()
        if c.data2 is not None:
            out[f"e:{name}"] = c.data2
    return out


def _rebuild_column(template: Column, data, mask, data2=None) -> Column:
    validity = None if bool(jnp.all(mask)) else mask
    return Column(data, template.dtype, validity=validity,
                  dictionary=template.dictionary, data2=data2)


# ---------------------------------------------------------------- filter

def _host_local(x) -> np.ndarray:
    """Bring a (possibly multi-process global) array to this host.

    Single-process: plain device_get. Multi-process (jax.distributed):
    shards live on other hosts, so device_get is illegal — allgather the
    value so every host materializes the same result (SURVEY §4.6: the
    result egress side of the multi-host pipeline)."""
    if isinstance(x, jax.Array) and not x.is_fully_addressable:
        from jax.experimental import multihost_utils

        return np.asarray(multihost_utils.process_allgather(x, tiled=True))
    return np.asarray(jax.device_get(x))


def _pull_prefixes(garr, counts: np.ndarray) -> np.ndarray:
    """Pull only each shard's live prefix to host and concatenate.

    `garr` is a global array sharded along axis 0 into len(counts) equal
    shards; shard s contributes its first counts[s] rows. Transfers are
    output-sized (per-shard prefixes), never input-sized. Multi-process
    falls back to a padded allgather (bounded by the padded output, still
    never the pre-filter input)."""
    shards = sorted(garr.addressable_shards,
                    key=lambda s: s.index[0].start or 0)
    if len(shards) != len(counts):  # multi-process: remote shards exist
        full = _host_local(garr)
        R = full.shape[0] // len(counts)
        return np.concatenate(
            [full[i * R: i * R + int(c)] for i, c in enumerate(counts)])
    parts = [np.asarray(sh.data)[: int(counts[i])]
             for i, sh in enumerate(shards)]
    return np.concatenate(parts)


def dist_filter_padded(batch: RecordBatch, mask_expr,
                       mesh: Optional[Mesh] = None):
    """Distributed filter, padded form: predicate + compaction run per
    shard inside ONE shard_map program — zero communication, no host
    gather of the input. Returns (result_dict, counts, names) where
    result_dict holds per-column ``d:name``/``m:name`` global arrays
    sharded along rows (each shard's first counts[s] rows live) plus
    ``__count__``. Pipeline stages can consume this without
    materializing."""
    from ..expr import Expression

    mesh = mesh or make_mesh()
    D = mesh.shape[AXIS]
    sharded, row_valid = _sharded(batch, mesh)
    if isinstance(mask_expr, Expression):
        mask = mask_expr.execute(sharded)
    else:
        mask = mask_expr
    selected = mask.data if mask.validity is None else \
        (mask.data & mask.validity)
    if selected.shape[0] != sharded.num_rows:  # eagerly-computed mask
        pad = sharded.num_rows - selected.shape[0]
        selected = jnp.concatenate(
            [jnp.asarray(selected), jnp.zeros(pad, jnp.bool_)])
        selected = jax.device_put(selected, NamedSharding(mesh, P(AXIS)))
    arrays = _col_arrays(sharded, batch.names)

    def body(arrays, selected, row_valid):
        sel = selected & row_valid
        idx, cnt = filter_padded(sel)
        out = {k: v[idx] for k, v in arrays.items()}
        out["__count__"] = cnt[None].astype(jnp.int32)
        return out

    mapped = shard_map(
        body, mesh=mesh,
        in_specs=({k: P(AXIS) for k in arrays}, P(AXIS), P(AXIS)),
        out_specs=P(AXIS), check_vma=False)
    result = jax.jit(mapped)(arrays, selected, row_valid)
    counts = _host_local(result["__count__"])
    assert counts.shape == (D,)
    return result, counts, batch.names


def dist_filter(batch: RecordBatch, mask_expr, mesh: Optional[Mesh] = None
                ) -> RecordBatch:
    """Distributed filter: embarrassingly parallel — the predicate AND the
    compaction run per shard inside one shard_map program with zero
    communication (ref semantics: `vector_selection.cc:570-830`). Only the
    compacted per-shard prefixes are pulled at final materialization;
    the input table is never gathered. `mask_expr` is an Expression or a
    bool Column."""
    result, counts, names = dist_filter_padded(batch, mask_expr, mesh)
    cols = []
    for name in names:
        data = _pull_prefixes(result[f"d:{name}"], counts)
        mask = _pull_prefixes(result[f"m:{name}"], counts)
        data2 = None
        if f"e:{name}" in result:
            data2 = jnp.asarray(_pull_prefixes(result[f"e:{name}"], counts))
        cols.append(_rebuild_column(batch.column(name), jnp.asarray(data),
                                    jnp.asarray(mask), data2))
    return RecordBatch(tuple(cols), tuple(names))


# ---------------------------------------------------------------- group_by

def _grouped_padded(value, mask, row_valid, fn: str, gids, cap: int):
    """Jit-safe grouped aggregate over padded groups.

    Returns (acc, valid_count) where acc dtype depends on fn."""
    live = mask & row_valid
    ones = live.astype(jnp.int64)
    vcount = jnp.zeros(cap, jnp.int64).at[gids].add(ones)
    if fn == "count":
        return vcount, vcount
    if fn in ("sum", "mean"):
        acc_dt = jnp.float64 if (fn == "mean" or
                                 jnp.issubdtype(value.dtype, jnp.floating)) \
            else jnp.int64
        x = jnp.where(live, value, 0).astype(acc_dt)
        acc = jnp.zeros(cap, acc_dt).at[gids].add(x)
        if fn == "mean":
            acc = acc / jnp.maximum(vcount, 1)
        return acc, vcount
    if fn in ("min", "max"):
        if jnp.issubdtype(value.dtype, jnp.floating):
            big = jnp.asarray(jnp.inf, value.dtype)
            small = jnp.asarray(-jnp.inf, value.dtype)
        else:
            info = jnp.iinfo(value.dtype)
            big, small = jnp.asarray(info.max, value.dtype), \
                jnp.asarray(info.min, value.dtype)
        if fn == "min":
            x = jnp.where(live, value, big)
            return jnp.full(cap, big, value.dtype).at[gids].min(x), vcount
        x = jnp.where(live, value, small)
        return jnp.full(cap, small, value.dtype).at[gids].max(x), vcount
    if fn in ("variance", "stddev"):
        x = jnp.where(live, value, 0).astype(jnp.float64)
        s1 = jnp.zeros(cap, jnp.float64).at[gids].add(x)
        s2 = jnp.zeros(cap, jnp.float64).at[gids].add(x * x)
        nv = vcount.astype(jnp.float64)
        mean = s1 / jnp.maximum(nv, 1)
        var = jnp.maximum(s2 / jnp.maximum(nv, 1) - mean * mean, 0.0)
        return (jnp.sqrt(var) if fn == "stddev" else var), vcount
    if fn in ("any", "all"):
        b = value != 0
        if fn == "any":
            return jnp.zeros(cap, jnp.bool_).at[gids].max(b & live), vcount
        return jnp.ones(cap, jnp.bool_).at[gids].min(b | ~live), vcount
    raise Invalid(f"dist_group_by: unsupported aggregate {fn!r}")


def dist_group_by(batch: RecordBatch, keys: Sequence[str],
                  aggregates: Sequence[Tuple[str, str]],
                  mesh: Optional[Mesh] = None,
                  capacity_per_dest: Optional[int] = None) -> RecordBatch:
    """Distributed hash aggregate: shuffle rows by key hash so each device
    owns a disjoint key subset, then aggregate locally — no merge step
    needed (vs. the two-level partial-aggregate plan; exact per-key
    ownership is what the BASELINE's "tables hash-partitioned per host"
    prescribes)."""
    for cname, fn in aggregates:
        if batch.column(cname).dtype.is_decimal and fn != "count":
            raise Invalid(f"dist_group_by: {fn} over decimal column "
                          f"{cname!r} is not supported — the grouped "
                          "reduction covers one limb plane")
    mesh = mesh or make_mesh()
    D = mesh.shape[AXIS]
    sharded, row_valid = _sharded(batch, mesh)
    R_local = sharded.num_rows // D
    cap = capacity_per_dest or R_local  # safe bound: all rows -> one dest
    agg_cols = sorted({c for c, _ in aggregates})

    # normalized keys computed on sharded arrays (local, no comm)
    norm: List[jnp.ndarray] = []
    for k in keys:
        norm.extend(normalize_sort_key(sharded.column(k)))
    mixed = _mix_keys(norm)

    arrays = _col_arrays(sharded, list(dict.fromkeys([*keys, *agg_cols])))
    for i, nk in enumerate(norm):
        arrays[f"k:{i}"] = nk
    nkeys = len(norm)

    def body(arrays, mixed, row_valid):
        part = partition_ids(mixed, D)
        shuffled, live, overflow = shuffle_shard(
            arrays, part, row_valid, AXIS, D, cap)
        G = D * cap
        gkeys = [jnp.where(live, shuffled[f"k:{i}"],
                           jnp.asarray(jnp.iinfo(jnp.uint8).max
                                       if shuffled[f"k:{i}"].dtype == jnp.uint8
                                       else jnp.uint64(0xFFFFFFFFFFFFFFFF),
                                       shuffled[f"k:{i}"].dtype))
                 for i in range(nkeys)]
        # dead rows cluster under sentinel keys; exclude their groups below
        groups = grouping_padded([(~live).astype(jnp.uint8)] + gkeys)
        out = {"__gvalid__": groups.group_valid & live[groups.rep_rows],
               "__rep__": groups.rep_rows}
        for cname, fn in aggregates:
            acc, vcount = _grouped_padded(
                shuffled[f"d:{cname}"], shuffled[f"m:{cname}"], live, fn,
                groups.group_ids, G)  # decimal guard enforced pre-trace
            out[f"a:{cname}:{fn}"] = acc
            out[f"n:{cname}:{fn}"] = vcount
        for k in keys:
            out[f"d:{k}"] = shuffled[f"d:{k}"][groups.rep_rows]
            out[f"m:{k}"] = shuffled[f"m:{k}"][groups.rep_rows]
            if f"e:{k}" in shuffled:
                out[f"e:{k}"] = shuffled[f"e:{k}"][groups.rep_rows]
        out["__overflow__"] = overflow[None]
        return out

    mapped = shard_map(
        body, mesh=mesh,
        in_specs=({k: P(AXIS) for k in arrays}, P(AXIS), P(AXIS)),
        out_specs=P(AXIS),
        check_vma=False,
    )
    result = jax.jit(mapped)(arrays, mixed, row_valid)
    if bool(_host_local(result["__overflow__"]).any()):
        raise Invalid("dist_group_by: shuffle capacity overflow — raise "
                      "capacity_per_dest")

    gvalid = jnp.asarray(_host_local(result["__gvalid__"]))
    ngroups = int(jnp.sum(gvalid))
    (gi,) = jnp.nonzero(gvalid, size=ngroups, fill_value=0)
    cols, names = [], []
    for cname, fn in aggregates:
        acc = jnp.asarray(_host_local(result[f"a:{cname}:{fn}"]))[gi]
        vcount = jnp.asarray(_host_local(result[f"n:{cname}:{fn}"]))[gi]
        out_t = {"count": dt.int64}.get(fn)
        if out_t is None:
            src = batch.column(cname).dtype
            if fn == "mean":
                out_t = dt.float64
            elif fn in ("variance", "stddev"):
                out_t = dt.float64
            elif fn in ("any", "all"):
                out_t = dt.bool_
            elif fn in ("min", "max"):
                out_t = src
            else:
                from ..ops.aggregate import _sum_output_type

                out_t = _sum_output_type(src)
        acc = acc.astype(out_t.physical_dtype())
        validity = None
        if fn != "count" and not bool(jnp.all(vcount > 0)):
            validity = vcount > 0
        cols.append(Column(acc, out_t, validity=validity,
                           dictionary=batch.column(cname).dictionary
                           if out_t.is_binary else None))
        names.append(f"{cname}_{fn}")
    for k in keys:
        data = jnp.asarray(_host_local(result[f"d:{k}"]))[gi]
        mask = jnp.asarray(_host_local(result[f"m:{k}"]))[gi]
        data2 = None
        if f"e:{k}" in result:
            data2 = jnp.asarray(_host_local(result[f"e:{k}"]))[gi]
        cols.append(_rebuild_column(batch.column(k), data, mask, data2))
        names.append(k)
    return RecordBatch(tuple(cols), tuple(names))


# ---------------------------------------------------------------- join

def _plan_salting(lids, rids, nl: int, D: int, max_salt: int):
    """Skew detection + salting plan (BASELINE: "skew detection and
    salted-repartitioning").

    A key whose probe-row count approaches the per-destination average
    concentrates its whole load on one device. Detection: host histogram
    of probe key ids; keys above `nl / D / 2` are "hot". Mitigation:
    probe rows of a hot key spread across S salted sub-partitions
    (salt = row_id % S); the build rows of hot keys are REPLICATED into
    all S sub-partitions, so every probe row still meets every matching
    build row exactly once.
    """
    import numpy as np

    l = np.asarray(lids)
    counts = np.bincount(l, minlength=int(l.max()) + 1 if l.size else 1)
    threshold = max(nl // D // 2, 8)
    hot = np.flatnonzero(counts > threshold)
    if hot.size == 0:
        return None, 1
    worst = int(counts[hot].max())
    S = min(max(2, (worst + threshold - 1) // threshold), max_salt)
    is_hot = np.zeros(len(counts), dtype=bool)
    is_hot[hot] = True
    return is_hot, S


def dist_join(left: RecordBatch, right: RecordBatch, keys,
              right_keys=None, join_type: str = "inner",
              mesh: Optional[Mesh] = None,
              capacity_per_dest: Optional[int] = None,
              output_capacity: Optional[int] = None,
              salt: bool = True) -> RecordBatch:
    """Distributed equi-join: both sides shuffled by key hash (co-partition),
    local padded join per shard, host compaction of padded pairs. Skewed
    keys are detected from the probe histogram and salted (build-side
    replication) so no destination overloads — `salt=False` disables.

    inner and "left outer" are supported distributed; other types fall back
    to the single-device eager join."""
    from ..ops.join import join as eager_join

    if join_type not in ("inner", "left outer"):
        return eager_join(left, right, keys, right_keys, join_type)
    if isinstance(keys, str):
        keys = [keys]
    right_keys = list(right_keys or keys)
    keys = list(keys)
    mesh = mesh or make_mesh()
    D = mesh.shape[AXIS]

    # dense key ids across both sides, computed globally (eager) so equal
    # keys share ids regardless of side — then ids are the shuffle keys
    from ..ops.join import _key_ids
    from ..ops.selection import take_column

    lids_g, rids_g, lkv, rkv, _ = _key_ids(left, right, keys, right_keys)

    # ---- skew salting (eager pre-pass) ----
    # The salt is folded INTO the join key id (key' = key*S + salt), so a
    # probe row matches exactly the build copy carrying its own salt even
    # if several salted sub-partitions hash to the same device.
    lids_g = lids_g.astype(jnp.int64)
    rids_g = jnp.asarray(rids_g).astype(jnp.int64)
    if salt:
        is_hot, S = _plan_salting(lids_g, rids_g, left.num_rows, D,
                                  max_salt=D)
        if is_hot is not None:
            hot_l = jnp.asarray(is_hot)[lids_g]
            lsalt_g = jnp.where(
                hot_l, jnp.arange(left.num_rows) % S, 0).astype(jnp.int64)
            lids_g = lids_g * S + lsalt_g
            hot_r = np.asarray(jnp.asarray(is_hot)[rids_g])
            hot_rows = np.flatnonzero(hot_r)
            rids_base = np.asarray(rids_g) * S
            if hot_rows.size:
                # replicate hot build rows into salts 1..S-1
                idx = jnp.asarray(hot_rows)
                extra_cols = []
                for c in right.columns:
                    extra_cols.append(take_column(c, idx))
                reps = [right]
                rids_parts = [rids_base]
                rkv_parts = [np.ones(right.num_rows, bool) if rkv is None
                             else np.asarray(rkv)]
                extra = RecordBatch(tuple(extra_cols), right.names)
                for s in range(1, S):
                    reps.append(extra)
                    rids_parts.append(rids_base[hot_rows] + s)
                    rkv_parts.append(rkv_parts[0][hot_rows])
                from ..table import concat_batches

                right = concat_batches(reps)
                rids_g = jnp.asarray(np.concatenate(rids_parts))
                rkv = jnp.asarray(np.concatenate(rkv_parts))
            else:
                rids_g = jnp.asarray(rids_base)

    lsh, lvalid_rows = _sharded(left, mesh)
    rsh, rvalid_rows = _sharded(right, mesh)
    Ll, Rl = lsh.num_rows // D, rsh.num_rows // D
    cap_l = capacity_per_dest or Ll
    cap_r = capacity_per_dest or Rl
    out_cap = output_capacity or max(4 * cap_l * D, 1024)

    def pad_to(x, n, fill=0):
        return jnp.concatenate(
            [x, jnp.full(n - x.shape[0], fill, x.dtype)]) \
            if x.shape[0] < n else x

    sharding = NamedSharding(mesh, P(AXIS))
    lids = jax.device_put(
        pad_to(lids_g.astype(jnp.uint64), lsh.num_rows), sharding)
    rids = jax.device_put(
        pad_to(rids_g.astype(jnp.uint64), rsh.num_rows), sharding)
    lkeyv = jax.device_put(pad_to(
        jnp.ones(left.num_rows, jnp.bool_) if lkv is None else lkv,
        lsh.num_rows, False), sharding)
    rkeyv = jax.device_put(pad_to(
        jnp.ones(right.num_rows, jnp.bool_) if rkv is None
        else jnp.asarray(rkv), rsh.num_rows, False), sharding)

    larr = _col_arrays(lsh, lsh.names)
    rarr = _col_arrays(rsh, rsh.names)
    larr["__key__"] = lids
    rarr["__key__"] = rids
    larr["__keyvalid__"] = lkeyv
    rarr["__keyvalid__"] = rkeyv
    outer = join_type == "left outer"

    def body(larr, rarr, lrow, rrow):
        lpart = partition_ids(larr["__key__"], D)
        rpart = partition_ids(rarr["__key__"], D)
        ls, llive, lovf = shuffle_shard(larr, lpart, lrow, AXIS, D, cap_l)
        rs, rlive, rovf = shuffle_shard(rarr, rpart, rrow, AXIS, D, cap_r)
        (pidx, bidx, pair_valid, pair_match, _, total, jovf) = join_padded(
            ls["__key__"], rs["__key__"],
            ls["__keyvalid__"], rlive & rs["__keyvalid__"],
            out_cap, outer=outer, probe_live=llive)
        out = {"__pvalid__": pair_valid,
               "__pmatch__": pair_match,
               "__overflow__": (lovf | rovf | jovf)[None]}
        for name, arr in ls.items():
            if name.startswith(("d:", "m:", "e:")):
                out[f"L{name}"] = arr[pidx]
        for name, arr in rs.items():
            if name.startswith(("d:", "m:", "e:")):
                out[f"R{name}"] = arr[bidx]
        return out

    mapped = shard_map(
        body, mesh=mesh,
        in_specs=({k: P(AXIS) for k in larr}, {k: P(AXIS) for k in rarr},
                  P(AXIS), P(AXIS)),
        out_specs=P(AXIS),
        check_vma=False,
    )
    res = jax.jit(mapped)(larr, rarr, lvalid_rows, rvalid_rows)
    if bool(_host_local(res["__overflow__"]).any()):
        raise Invalid("dist_join: capacity overflow — raise capacities")

    pv = jnp.asarray(_host_local(res["__pvalid__"]))
    pm = jnp.asarray(_host_local(res["__pmatch__"]))
    npairs = int(jnp.sum(pv))
    (pi,) = jnp.nonzero(pv, size=npairs, fill_value=0)
    match = pm[pi]

    cols, names = [], []
    lkeyset, rkeyset = set(keys), set(right_keys)
    def pull2(side, n):
        key = f"{side}e:{n}"
        return (jnp.asarray(_host_local(res[key]))[pi]
                if key in res else None)

    for lk in keys:
        data = jnp.asarray(_host_local(res[f"Ld:{lk}"]))[pi]
        mask = jnp.asarray(_host_local(res[f"Lm:{lk}"]))[pi]
        cols.append(_rebuild_column(left.column(lk), data, mask,
                                    pull2("L", lk)))
        names.append(lk)
    for n in left.names:
        if n in lkeyset:
            continue
        data = jnp.asarray(_host_local(res[f"Ld:{n}"]))[pi]
        mask = jnp.asarray(_host_local(res[f"Lm:{n}"]))[pi]
        cols.append(_rebuild_column(left.column(n), data, mask,
                                    pull2("L", n)))
        names.append(n)
    for n in right.names:
        if n in rkeyset:
            continue
        data = jnp.asarray(_host_local(res[f"Rd:{n}"]))[pi]
        mask = jnp.asarray(_host_local(res[f"Rm:{n}"]))[pi] & match
        cols.append(_rebuild_column(right.column(n), data, mask,
                                    pull2("R", n)))
        names.append(n)
    return RecordBatch(tuple(cols), tuple(names))


# ---------------------------------------------------------------- sort

def dist_sort(batch: RecordBatch, sort_keys: Sequence[Tuple[str, str]],
              mesh: Optional[Mesh] = None,
              capacity_per_dest: Optional[int] = None,
              sample_per_shard: int = 256) -> RecordBatch:
    """Distributed sort: splitter-based range partition + local sort.

    1. sample normalized primary keys -> D-1 splitters (host, tiny)
    2. shuffle rows to their key range's owner
    3. local multi-key stable sort per shard (+ global row id tiebreak ->
       exact stability)
    4. concat shard runs (range-disjoint) = total order
    """
    mesh = mesh or make_mesh()
    D = mesh.shape[AXIS]
    sharded, row_valid = _sharded(batch, mesh)
    n = batch.num_rows
    R_local = sharded.num_rows // D
    cap = capacity_per_dest or sharded.num_rows  # safe: all rows one dest

    norm: List[jnp.ndarray] = []
    for name, order in sort_keys:
        norm.extend(normalize_sort_key(sharded.column(name), order))
    # primary component for range partitioning: first key's (class,value)
    # folded to one uint64 (class dominates)
    if len(norm) and norm[0].dtype == jnp.uint8:
        primary = (norm[0].astype(jnp.uint64) << jnp.uint64(62)) | (
            norm[1] >> jnp.uint64(2))
    else:
        primary = norm[0]

    # sample on host
    host_primary = _host_local(primary)[_host_local(row_valid)]
    if len(host_primary) == 0:
        return unshard_batch(sharded).slice(0, 0)
    sample = np.sort(np.random.default_rng(0).choice(
        host_primary, size=min(len(host_primary), sample_per_shard * D)))
    splitters = jnp.asarray(
        sample[[int(len(sample) * i / D) for i in range(1, D)]]
    ) if D > 1 else jnp.zeros(0, jnp.uint64)

    rowid = jax.device_put(
        jnp.arange(sharded.num_rows, dtype=jnp.uint64),
        NamedSharding(mesh, P(AXIS)))

    arrays = _col_arrays(sharded, sharded.names)
    for i, nk in enumerate(norm):
        arrays[f"k:{i}"] = nk
    arrays["__rowid__"] = rowid
    arrays["__primary__"] = primary
    nkeys = len(norm)

    def body(arrays, row_valid):
        part = jnp.searchsorted(splitters, arrays["__primary__"],
                                side="right").astype(jnp.int32)
        shuffled, live, ovf = shuffle_shard(arrays, part, row_valid,
                                            AXIS, D, cap)
        skeys = [(~live).astype(jnp.uint8)]  # dead rows sort last
        skeys += [shuffled[f"k:{i}"] for i in range(nkeys)]
        skeys.append(shuffled["__rowid__"])  # stability tiebreak
        perm = sort_indices_device(skeys)
        out = {"__live__": live[perm], "__overflow__": ovf[None]}
        for name, arr in shuffled.items():
            if name.startswith(("d:", "m:", "e:")):
                out[name] = arr[perm]
        return out

    mapped = shard_map(
        body, mesh=mesh,
        in_specs=({k: P(AXIS) for k in arrays}, P(AXIS)),
        out_specs=P(AXIS),
        check_vma=False,
    )
    res = jax.jit(mapped)(arrays, row_valid)
    if bool(_host_local(res["__overflow__"]).any()):
        raise Invalid("dist_sort: capacity overflow — raise capacity_per_dest")
    live = jnp.asarray(_host_local(res["__live__"]))
    nlive = int(jnp.sum(live))
    (li,) = jnp.nonzero(live, size=nlive, fill_value=0)
    cols, names = [], []
    for name in batch.names:
        data = jnp.asarray(_host_local(res[f"d:{name}"]))[li]
        mask = jnp.asarray(_host_local(res[f"m:{name}"]))[li]
        data2 = None
        if f"e:{name}" in res:
            data2 = jnp.asarray(_host_local(res[f"e:{name}"]))[li]
        cols.append(_rebuild_column(batch.column(name), data, mask, data2))
        names.append(name)
    return RecordBatch(tuple(cols), tuple(names))


def dist_sort_indices(batch: RecordBatch, sort_keys, mesh=None, **kw):
    """Distributed sort returning the sorted batch's source row order is
    not meaningful across shards; provided for API parity by sorting a
    row-id column along with the data."""
    rb = batch.set_column("__rowid__", Column(
        jnp.arange(batch.num_rows, dtype=jnp.uint64), dt.uint64))
    sorted_rb = dist_sort(rb, sort_keys, mesh=mesh, **kw)
    return sorted_rb.column("__rowid__")

"""Distributed compiled pipeline: one shard_map program per query stage.

The eager distributed operators (parallel/distributed.py) each build
their own shard_map and materialize between operators — config 5 pays a
device dispatch + host sync per op. This module composes the same
shuffle + padded-kernel bodies into ONE jitted shard_map program, so a
  filter -> project -> join -> group_by -> sort -> limit
chain is a single XLA computation over the whole mesh: all_to_all
shuffles ride the device interconnect *inside* the program, per-shard kernels run between
them, and the host sees only padded outputs + counts at the end.

The reference has no distributed engine (SURVEY.md §2: Flight ships the
mechanism only); this is the BASELINE config-5 north star: scan ->
filter -> join -> agg -> sort as one program per stage, hash-partitioned
exchange, static capacities with on-device overflow flags (the compiled
analogue of GetFilterOutputSize's two-phase sizing,
vector_selection.cc:61).

Key exactness policy (same as exec/compiled.py's join): matching is
ALWAYS exact — the full normalized plane list rides join_padded's
variadic sort-merge. The u64 FNV fold is used only to pick shuffle
destinations, where a collision merely co-locates two distinct keys on
one shard. Group-by grouping likewise runs on the full component list.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
from ..kernels.blockscan import cumsum_blocked, scan_blocked
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

if hasattr(jax, "shard_map"):
    shard_map = jax.shard_map
else:  # pragma: no cover
    from jax.experimental.shard_map import shard_map

from .. import dtypes as dt
from ..column import Column
from ..errors import Invalid
from ..expr import Expression
from ..ops.padded import filter_padded, grouping_padded, join_padded
from ..ops.sort import normalize_sort_key, sort_indices_device
from ..table import RecordBatch
from ..parallel.mesh import make_mesh, pad_to_multiple
from ..parallel.shuffle import FNV_MIX, partition_ids, shuffle_shard

__all__ = ["DistPipelineBuilder", "DistCompiledPipeline"]

AXIS = "x"


@dataclasses.dataclass
class _ColTemplate:
    dtype: object
    dictionary: object
    has_data2: bool


def _flatten_batch(batch: RecordBatch):
    """RecordBatch -> (arrays dict, name->template). data2 (decimal high
    limb) rides along as ``e:name``."""
    arrays: Dict[str, jnp.ndarray] = {}
    templates: Dict[str, _ColTemplate] = {}
    for name in batch.names:
        c = batch.column(name)
        arrays[f"d:{name}"] = c.data
        arrays[f"m:{name}"] = c.mask()
        if c.data2 is not None:
            arrays[f"e:{name}"] = c.data2
        templates[name] = _ColTemplate(c.dtype, c.dictionary,
                                       c.data2 is not None)
    return arrays, templates


def _rebuild(arrays: Dict[str, jnp.ndarray],
             templates: Dict[str, _ColTemplate],
             names: Sequence[str], live=None) -> RecordBatch:
    """Per-shard Columns from the flat dict (trace-time only)."""
    cols = []
    for name in names:
        t = templates[name]
        validity = arrays[f"m:{name}"]
        if live is not None:
            validity = validity & live
        cols.append(Column(arrays[f"d:{name}"], t.dtype, validity=validity,
                           dictionary=t.dictionary,
                           data2=arrays.get(f"e:{name}")))
    return RecordBatch(tuple(cols), tuple(names))


def _norm_components(arrays, templates, name, order="ascending"):
    t = templates[name]
    col = Column(arrays[f"d:{name}"], t.dtype,
                 validity=arrays[f"m:{name}"],
                 dictionary=t.dictionary, data2=arrays.get(f"e:{name}"))
    return normalize_sort_key(col, order)


def _fold_u64(components: List[jnp.ndarray]) -> jnp.ndarray:
    h = None
    for comp in components:
        c = comp.astype(jnp.uint64)
        h = c if h is None else (h * FNV_MIX) ^ c
    return h


def _gather_arrays(arrays, idx, names_prefixes=("d:", "m:", "e:")):
    return {k: v[idx] for k, v in arrays.items()
            if k.startswith(names_prefixes)}


class DistPipelineBuilder:
    """Chainable builder for a distributed one-dispatch pipeline.

    Capacities are static (XLA shapes): `shuffle_cap` bounds rows any one
    device receives in a shuffle (default: the full per-shard row count —
    safe, memory-heavy), `join_fanout` multiplies probe capacity for the
    join output. Overflow is flagged on device and raised after the run.
    """

    def __init__(self, mesh: Optional[Mesh] = None):
        self.mesh = mesh or make_mesh()
        self._ops: List[Tuple] = []

    def filter(self, predicate: Expression) -> "DistPipelineBuilder":
        self._ops.append(("filter", predicate))
        return self

    def project(self, exprs: Sequence[Expression], names: Sequence[str],
                keep_existing: bool = True) -> "DistPipelineBuilder":
        self._ops.append(("project", list(exprs), list(names),
                          keep_existing))
        return self

    def join(self, build: RecordBatch, keys, right_keys=None,
             join_type: str = "inner", fanout: int = 2,
             shuffle_cap: Optional[int] = None) -> "DistPipelineBuilder":
        if join_type not in ("inner", "left outer"):
            raise Invalid("dist pipeline join: inner/'left outer' only")
        self._ops.append(("join", build,
                          [keys] if isinstance(keys, str) else list(keys),
                          right_keys, join_type, fanout, shuffle_cap))
        return self

    def group_by(self, keys: Sequence[str],
                 aggregates: Sequence[Tuple[str, str]],
                 shuffle_cap: Optional[int] = None) -> "DistPipelineBuilder":
        self._ops.append(("group_by", list(keys), list(aggregates),
                          shuffle_cap))
        return self

    def sort(self, sort_keys: Sequence[Tuple[str, str]]
             ) -> "DistPipelineBuilder":
        self._ops.append(("sort", list(sort_keys)))
        return self

    def limit(self, n: int) -> "DistPipelineBuilder":
        self._ops.append(("limit", n))
        return self

    def compile(self) -> "DistCompiledPipeline":
        return DistCompiledPipeline(self._ops, self.mesh)


class DistCompiledPipeline:
    def __init__(self, ops: List[Tuple], mesh: Mesh):
        self._ops = ops
        self.mesh = mesh
        self.D = mesh.shape[AXIS]
        self._cache: Dict[tuple, tuple] = {}  # input sig -> (jitted, names, templates)

    # ---------------- per-shard operator bodies (trace-time) ----------

    def _op_filter(self, st, predicate):
        arrays, templates, names, live = st
        batch = _rebuild(arrays, templates, names, live)
        mask = predicate.execute(batch)
        sel = mask.data if mask.validity is None else \
            (mask.data & mask.validity)
        return (arrays, templates, names, live & sel), jnp.zeros((), bool)

    def _op_project(self, st, exprs, out_names, keep):
        arrays, templates, names, live = st
        batch = _rebuild(arrays, templates, names, live)
        arrays = dict(arrays)
        templates = dict(templates)
        names = list(names) if keep else []
        if not keep:
            arrays = {k: v for k, v in arrays.items() if k == "__rowid__"}
        for e, name in zip(exprs, out_names):
            v = e.execute(batch)
            arrays[f"d:{name}"] = v.data
            arrays[f"m:{name}"] = v.mask()
            if v.data2 is not None:
                arrays[f"e:{name}"] = v.data2
            templates[name] = _ColTemplate(v.dtype, v.dictionary,
                                           v.data2 is not None)
            if name not in names:
                names.append(name)
        return (arrays, templates, names, live), jnp.zeros((), bool)

    def _op_join(self, st, build_arrays, build_templates, build_names,
                 build_live, keys, right_keys, join_type, fanout,
                 shuffle_cap):
        arrays, templates, names, live = st
        D = self.D
        right_keys = list(right_keys or keys)
        # full normalized plane lists: matching is EXACT (join_padded's
        # variadic sort-merge). The u64 fold below is used ONLY for
        # partitioning — a fold collision merely co-locates two distinct
        # keys on one shard, never equates them.
        pk_planes, bk_planes = [], []
        for lk, rk in zip(keys, right_keys):
            lkeys = _norm_components(arrays, templates, lk)
            rkeys = _norm_components(build_arrays, build_templates, rk)
            # align plane counts: a missing null/NaN class plane means
            # "all rows class 0" — pad with zeros (same as compiled.py)
            if len(lkeys) != len(rkeys):
                if len(lkeys) < len(rkeys):
                    lkeys = [jnp.zeros_like(lkeys[0], dtype=jnp.uint8)
                             ] * (len(rkeys) - len(lkeys)) + lkeys
                else:
                    rkeys = [jnp.zeros_like(rkeys[0], dtype=jnp.uint8)
                             ] * (len(lkeys) - len(rkeys)) + rkeys
            pk_planes.extend(lkeys)
            bk_planes.extend(rkeys)
        pk = _fold_u64(pk_planes)
        bk = _fold_u64(bk_planes)
        pvalid = jnp.ones_like(live)
        for k in keys:
            pvalid = pvalid & arrays[f"m:{k}"]
        bvalid = jnp.ones_like(build_live)
        for k in right_keys:
            bvalid = bvalid & build_arrays[f"m:{k}"]

        R = live.shape[0]
        Rb = build_live.shape[0]
        cap_p = shuffle_cap or R
        cap_b = shuffle_cap or Rb
        larr = _gather_arrays(arrays, slice(None))
        for i, p in enumerate(pk_planes):
            larr[f"__key{i}__"] = p
        larr["__keyvalid__"] = pvalid
        rarr = _gather_arrays(build_arrays, slice(None))
        for i, p in enumerate(bk_planes):
            rarr[f"__key{i}__"] = p
        rarr["__keyvalid__"] = bvalid

        ls, llive, lovf = shuffle_shard(larr, partition_ids(pk, D),
                                        live, AXIS, D, cap_p)
        rs, rlive, rovf = shuffle_shard(rarr, partition_ids(bk, D),
                                        build_live, AXIS, D, cap_b)
        out_cap = fanout * cap_p * D
        outer = join_type == "left outer"
        nk = len(pk_planes)
        pidx, bidx, pair_valid, pair_match, _, _, jovf = join_padded(
            [ls[f"__key{i}__"] for i in range(nk)],
            [rs[f"__key{i}__"] for i in range(nk)],
            ls["__keyvalid__"], rlive & rs["__keyvalid__"],
            out_cap, outer=outer, probe_live=llive)

        out_arrays: Dict[str, jnp.ndarray] = {}
        out_templates: Dict[str, _ColTemplate] = {}
        out_names: List[str] = []
        for name in names:
            out_arrays[f"d:{name}"] = ls[f"d:{name}"][pidx]
            out_arrays[f"m:{name}"] = ls[f"m:{name}"][pidx]
            if f"e:{name}" in ls:
                out_arrays[f"e:{name}"] = ls[f"e:{name}"][pidx]
            out_templates[name] = templates[name]
            out_names.append(name)
        rkeyset = set(right_keys)
        for name in build_names:
            if name in rkeyset:
                continue
            if name in out_templates:
                raise Invalid(f"dist pipeline join: duplicate column "
                              f"{name!r}")
            out_arrays[f"d:{name}"] = rs[f"d:{name}"][bidx]
            rmask = rs[f"m:{name}"][bidx]
            out_arrays[f"m:{name}"] = rmask & pair_match if outer else rmask
            if f"e:{name}" in rs:
                out_arrays[f"e:{name}"] = rs[f"e:{name}"][bidx]
            out_templates[name] = build_templates[name]
            out_names.append(name)
        return ((out_arrays, out_templates, out_names, pair_valid),
                lovf | rovf | jovf)

    _DECOMPOSABLE = ("sum", "count", "min", "max", "mean",
                     "variance", "stddev", "any", "all")

    def _op_group_by(self, st, keys, aggregates, shuffle_cap):
        """Hash aggregate with combine-before-shuffle.

        When every aggregate decomposes (sum/count/min/max/mean), each
        shard pre-aggregates its rows locally and ships only <= cap
        PARTIAL group rows — the all_to_all moves G-scale data instead
        of row-scale (the reference pattern is Acero's partial/final
        aggregate split; also 'Partial Partial Aggregates', PAPERS.md).
        `shuffle_cap` then bounds distinct groups per shard rather than
        rows per (src,dst) pair. Non-decomposable aggregates keep the
        row shuffle."""
        arrays, templates, names, live = st
        D = self.D
        R = live.shape[0]
        cap = shuffle_cap or R
        norm: List[jnp.ndarray] = []
        for k in keys:
            norm.extend(_norm_components(arrays, templates, k))

        decomposable = all(fn in self._DECOMPOSABLE
                           for _, fn in aggregates)
        if decomposable and cap < R:
            return self._op_group_by_partial(
                st, keys, aggregates, norm, min(cap, R))
        return self._op_group_by_rows(st, keys, aggregates, norm, cap)

    def _op_group_by_partial(self, st, keys, aggregates, norm, cap):
        from ..ops.padded import grouping_padded
        from ..parallel.distributed import _grouped_padded

        arrays, templates, names, live = st
        D = self.D
        R = live.shape[0]
        # ---- phase A: local partial aggregation to <= cap slots ------
        # dead rows carry arbitrary key bits: zero them so padding
        # collapses into ONE group instead of crowding the cap slots
        norm_l = [jnp.where(live, nk, 0) for nk in norm]
        lg = grouping_padded([(~live).astype(jnp.uint8)] + norm_l)
        slot_live_full = lg.group_valid & live[lg.rep_rows]
        # conservative: every slot (incl. the single dead group) must
        # fit, else a live group past cap would be silently dropped
        ovf = lg.num_groups > cap
        agg_cols = sorted({c for c, _ in aggregates})
        parr: Dict[str, jnp.ndarray] = {}
        for cname in agg_cols:
            d = arrays[f"d:{cname}"]
            m = arrays[f"m:{cname}"]
            for fn in sorted({f for c, f in aggregates if c == cname}):
                if fn in ("variance", "stddev"):
                    # (s1, s2, n) partials merge by plain sums (same
                    # two-moment form the eager dist path uses)
                    x = jnp.where(m & live, d, 0).astype(jnp.float64)
                    s1, vcount = _grouped_padded(x, m, live, "sum",
                                                 lg.group_ids, R)
                    s2, _ = _grouped_padded(x * x, m, live, "sum",
                                            lg.group_ids, R)
                    parr[f"p:{cname}:{fn}"] = s1[:cap]
                    parr[f"q:{cname}:{fn}"] = s2[:cap]
                    parr[f"n:{cname}:{fn}"] = vcount[:cap]
                    continue
                if fn in ("any", "all"):
                    b = (d != 0).astype(jnp.int64)
                    acc, vcount = _grouped_padded(
                        b, m, live, "max" if fn == "any" else "min",
                        lg.group_ids, R)
                    parr[f"p:{cname}:{fn}"] = acc[:cap]
                    parr[f"n:{cname}:{fn}"] = vcount[:cap]
                    continue
                part_fn = "sum" if fn == "mean" else fn
                acc, vcount = _grouped_padded(d, m, live, part_fn,
                                              lg.group_ids, R)
                parr[f"p:{cname}:{fn}"] = acc[:cap]
                parr[f"n:{cname}:{fn}"] = vcount[:cap]
        rep = lg.rep_rows[:cap]
        for k in keys:
            parr[f"d:{k}"] = arrays[f"d:{k}"][rep]
            parr[f"m:{k}"] = arrays[f"m:{k}"][rep]
            if f"e:{k}" in arrays:
                parr[f"e:{k}"] = arrays[f"e:{k}"][rep]
        for i, nk in enumerate(norm):
            parr[f"k:{i}"] = nk[rep]
        plive = slot_live_full[:cap]
        mixed = _fold_u64([parr[f"k:{i}"] for i in range(len(norm))])
        # ---- shuffle the partials (per-pair cap: all cap slots could
        # route to one dest) -------------------------------------------
        shuffled, slive, sovf = shuffle_shard(
            parr, partition_ids(mixed, D), plive, AXIS, D, cap)
        ovf = ovf | sovf
        # ---- phase B: final merge over D*cap partial rows ------------
        G = D * cap
        groups = grouping_padded(
            [(~slive).astype(jnp.uint8)]
            + [shuffled[f"k:{i}"] for i in range(len(norm))])
        gvalid = groups.group_valid & slive[groups.rep_rows]

        out_arrays: Dict[str, jnp.ndarray] = {}
        out_templates: Dict[str, _ColTemplate] = {}
        out_names: List[str] = []
        for cname, fn in aggregates:
            col_t = templates[cname]
            p = shuffled[f"p:{cname}:{fn}"]
            cnts = shuffled[f"n:{cname}:{fn}"]
            cnt_valid = (cnts > 0) & slive
            merged_n, _ = _grouped_padded(
                cnts, slive, slive, "sum", groups.group_ids, G)
            if fn == "count":
                acc = merged_n
            elif fn in ("sum", "mean"):
                acc, _ = _grouped_padded(p, cnt_valid, slive, "sum",
                                         groups.group_ids, G)
                if fn == "mean":
                    acc = acc.astype(jnp.float64) / jnp.maximum(
                        merged_n, 1).astype(jnp.float64)
            elif fn in ("variance", "stddev"):
                q = shuffled[f"q:{cname}:{fn}"]
                S, _ = _grouped_padded(p, cnt_valid, slive, "sum",
                                       groups.group_ids, G)
                Q, _ = _grouped_padded(q, cnt_valid, slive, "sum",
                                       groups.group_ids, G)
                nf = jnp.maximum(merged_n, 1).astype(jnp.float64)
                mean = S / nf
                acc = jnp.maximum(Q / nf - mean * mean, 0.0)
                if fn == "stddev":
                    acc = jnp.sqrt(acc)
            elif fn in ("any", "all"):
                acc, _ = _grouped_padded(
                    p, cnt_valid, slive,
                    "max" if fn == "any" else "min",
                    groups.group_ids, G)
                acc = acc > 0
            else:  # min / max over partials; empty partials masked out
                acc, _ = _grouped_padded(p, cnt_valid, slive, fn,
                                         groups.group_ids, G)
            out_t = {"count": dt.int64}.get(fn)
            if out_t is None:
                if fn in ("mean", "variance", "stddev"):
                    out_t = dt.float64
                elif fn in ("any", "all"):
                    out_t = dt.bool_
                elif fn in ("min", "max"):
                    out_t = col_t.dtype
                else:
                    from ..ops.aggregate import _sum_output_type

                    out_t = _sum_output_type(col_t.dtype)
            oname = f"{cname}_{fn}"
            out_arrays[f"d:{oname}"] = acc.astype(out_t.physical_dtype())
            out_arrays[f"m:{oname}"] = jnp.ones(G, jnp.bool_) \
                if fn == "count" else (merged_n > 0)
            out_templates[oname] = _ColTemplate(
                out_t, col_t.dictionary if out_t.is_binary else None,
                False)
            out_names.append(oname)
        for k in keys:
            out_arrays[f"d:{k}"] = shuffled[f"d:{k}"][groups.rep_rows]
            out_arrays[f"m:{k}"] = shuffled[f"m:{k}"][groups.rep_rows]
            if f"e:{k}" in shuffled:
                out_arrays[f"e:{k}"] = shuffled[f"e:{k}"][groups.rep_rows]
            out_templates[k] = templates[k]
            out_names.append(k)
        return (out_arrays, out_templates, out_names, gvalid), ovf

    def _op_group_by_rows(self, st, keys, aggregates, norm, cap):
        from ..parallel.distributed import _grouped_padded

        arrays, templates, names, live = st
        D = self.D
        mixed = _fold_u64(norm)

        agg_cols = sorted({c for c, _ in aggregates})
        need = list(dict.fromkeys([*keys, *agg_cols]))
        sarr = {}
        for name in need:
            sarr[f"d:{name}"] = arrays[f"d:{name}"]
            sarr[f"m:{name}"] = arrays[f"m:{name}"]
            if f"e:{name}" in arrays:
                sarr[f"e:{name}"] = arrays[f"e:{name}"]
        for i, nk in enumerate(norm):
            sarr[f"k:{i}"] = nk

        shuffled, slive, ovf = shuffle_shard(
            sarr, partition_ids(mixed, D), live, AXIS, D, cap)
        G = D * cap
        groups = grouping_padded(
            [(~slive).astype(jnp.uint8)]
            + [shuffled[f"k:{i}"] for i in range(len(norm))])
        gvalid = groups.group_valid & slive[groups.rep_rows]

        out_arrays: Dict[str, jnp.ndarray] = {}
        out_templates: Dict[str, _ColTemplate] = {}
        out_names: List[str] = []
        for cname, fn in aggregates:
            col_t = templates[cname]
            acc, vcount = _grouped_padded(
                shuffled[f"d:{cname}"], shuffled[f"m:{cname}"], slive, fn,
                groups.group_ids, G)
            out_t = {"count": dt.int64}.get(fn)
            if out_t is None:
                if fn in ("mean", "variance", "stddev"):
                    out_t = dt.float64
                elif fn in ("any", "all"):
                    out_t = dt.bool_
                elif fn in ("min", "max"):
                    out_t = col_t.dtype
                else:
                    from ..ops.aggregate import _sum_output_type

                    out_t = _sum_output_type(col_t.dtype)
            oname = f"{cname}_{fn}"
            out_arrays[f"d:{oname}"] = acc.astype(out_t.physical_dtype())
            out_arrays[f"m:{oname}"] = jnp.ones(G, jnp.bool_) \
                if fn == "count" else (vcount > 0)
            out_templates[oname] = _ColTemplate(
                out_t, col_t.dictionary if out_t.is_binary else None, False)
            out_names.append(oname)
        for k in keys:
            out_arrays[f"d:{k}"] = shuffled[f"d:{k}"][groups.rep_rows]
            out_arrays[f"m:{k}"] = shuffled[f"m:{k}"][groups.rep_rows]
            if f"e:{k}" in shuffled:
                out_arrays[f"e:{k}"] = shuffled[f"e:{k}"][groups.rep_rows]
            out_templates[k] = templates[k]
            out_names.append(k)
        return (out_arrays, out_templates, out_names, gvalid), ovf

    def _op_sort(self, st, sort_keys):
        """Global sort: all_gather rows (post-aggregation state is small),
        sort the replicated table, keep this shard's range — output rows
        end up globally range-partitioned in sorted order."""
        arrays, templates, names, live = st
        D = self.D
        g = {k: jax.lax.all_gather(v, AXIS, tiled=True)
             for k, v in arrays.items()}
        glive = jax.lax.all_gather(live, AXIS, tiled=True)
        skeys: List[jnp.ndarray] = [(~glive).astype(jnp.uint8)]
        for name, order in sort_keys:
            skeys.extend(_norm_components(g, templates, name, order))
        perm = sort_indices_device(skeys)
        R = live.shape[0]
        i = jax.lax.axis_index(AXIS)
        local = jax.lax.dynamic_slice_in_dim(perm, i * R, R)
        out = {k: v[local] for k, v in g.items()}
        return (out, templates, names, glive[local]), jnp.zeros((), bool)

    def _op_limit(self, st, n):
        arrays, templates, names, live = st
        local = cumsum_blocked(live.astype(jnp.int32))
        totals = jax.lax.all_gather(local[-1] if live.shape[0] else
                                    jnp.int32(0), AXIS)
        i = jax.lax.axis_index(AXIS)
        before = jnp.sum(jnp.where(jnp.arange(self.D) < i, totals, 0))
        rank = before + local - 1
        return ((arrays, templates, names, live & (rank < n)),
                jnp.zeros((), bool))

    # ---------------- program assembly ----------------------------

    def __call__(self, batch: RecordBatch, materialize: bool = True):
        mesh, D = self.mesh, self.D
        n = batch.num_rows
        padded = pad_to_multiple(batch, D)
        arrays, templates = _flatten_batch(padded)
        row_valid = np.arange(padded.num_rows) < n
        sharding = NamedSharding(mesh, P(AXIS))
        arrays = {k: jax.device_put(v, sharding) for k, v in arrays.items()}
        live0 = jax.device_put(row_valid, sharding)

        # pre-place build sides (static args to the traced body)
        placed_ops = []
        extra_inputs: List[Dict[str, jnp.ndarray]] = []
        extra_lives: List[jnp.ndarray] = []
        for op in self._ops:
            if op[0] == "join":
                _, build, keys, right_keys, join_type, fanout, cap = op
                bpad = pad_to_multiple(build, D)
                barr, btmpl = _flatten_batch(bpad)
                blive = np.arange(bpad.num_rows) < build.num_rows
                extra_inputs.append(
                    {k: jax.device_put(v, sharding) for k, v in barr.items()})
                extra_lives.append(jax.device_put(blive, sharding))
                placed_ops.append(("join", len(extra_inputs) - 1, btmpl,
                                   list(bpad.names), keys, right_keys,
                                   join_type, fanout, cap))
            else:
                placed_ops.append(op)

        names0 = list(padded.names)
        tmpl0 = templates

        sig = tuple(sorted((k, v.shape, str(v.dtype))
                           for k, v in arrays.items()))
        if sig in self._cache:
            jitted, out_names, out_templates = self._cache[sig]
        else:
            def body(arrays, live, extras, elives):
                st = (arrays, tmpl0, names0, live)
                overflow = jnp.zeros((), bool)
                for op in placed_ops:
                    if op[0] == "join":
                        (_, bi, btmpl, bnames, keys, right_keys, join_type,
                         fanout, cap) = op
                        st, ovf = self._op_join(st, extras[bi], btmpl,
                                                bnames, elives[bi], keys,
                                                right_keys, join_type,
                                                fanout, cap)
                    else:
                        st, ovf = getattr(self, "_op_" + op[0])(st, *op[1:])
                    overflow = overflow | ovf
                arrays, templates, names, live = st
                out = dict(arrays)
                out["__live__"] = live
                out["__overflow__"] = overflow[None]
                return out, templates, names

            out_templates = {}
            out_names = []

            def traced(arrays, live, extras, elives):
                out, templates, names = body(arrays, live, extras, elives)
                out_templates.update(templates)
                out_names[:] = names
                return out

            mapped = shard_map(
                traced, mesh=mesh,
                in_specs=({k: P(AXIS) for k in arrays}, P(AXIS),
                          [{k: P(AXIS) for k in e} for e in extra_inputs],
                          [P(AXIS)] * len(extra_lives)),
                out_specs=P(AXIS), check_vma=False)
            jitted = jax.jit(mapped)
            self._cache[sig] = (jitted, out_names, out_templates)
        result = jitted(arrays, live0, extra_inputs, extra_lives)

        from ..parallel.distributed import _host_local

        if bool(_host_local(result["__overflow__"]).any()):
            raise Invalid("distributed pipeline: capacity overflow — raise "
                          "shuffle_cap/fanout")
        if not materialize:
            return result, out_names, out_templates

        live = _host_local(result["__live__"]).astype(bool)
        cols, names = [], []
        for name in out_names:
            t = out_templates[name]
            data = _host_local(result[f"d:{name}"])[live]
            mask = _host_local(result[f"m:{name}"])[live]
            data2 = (_host_local(result[f"e:{name}"])[live]
                     if f"e:{name}" in result else None)
            validity = None if mask.all() else jnp.asarray(mask)
            cols.append(Column(jnp.asarray(data), t.dtype, validity=validity,
                               dictionary=t.dictionary,
                               data2=None if data2 is None
                               else jnp.asarray(data2)))
            names.append(name)
        return RecordBatch(tuple(cols), tuple(names))

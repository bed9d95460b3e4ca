"""Staged group-by: the compiled group_by split into cached dispatches.

The fused one-program group-by at G=1M was slow to compile on the
engine's first target, so this module runs the sorted-space group-by
(BASELINE config 2) as a handful of HOST-DRIVEN stages, each its own
jitted program that caches independently (in-process and in the
persistent compile cache). Whether the H100 still needs the split is
an open question (ROADMAP Design 4):

  1. pack+sort      minimal-width key pack + ONE variadic lax.sort
                    carrying aggregate payloads (ops/padded.py gsp_sort)
  2+3. segments     segment-start flags, group count and slot positions
                    (gsp_segments: searchsorted at small G, a flag sort
                    at large G)
  4. scan planes    one blocked cumsum / flagged scan PER PROGRAM
  5. ends+assemble  segment-end extraction + G-sized output arithmetic

Outputs are bit-identical to the fused pipeline's group_by (test-
enforced: tests/test_staged_groupby.py) except variance/stddev, where
the separately-compiled assembly may FMA-contract `s2/n - mean**2`
differently than the fused program (<= 1 ULP). Scope: non-decimal,
non-binary GROUP KEYS (the BASELINE config-2 shape); anything else
raises Invalid and belongs to the fused path or eager group_by.

Reference semantics: hash_aggregate.cc:890-966 driver loop (consume /
merge / finalize); group order is key order, dead rows excluded.
"""

from __future__ import annotations

import functools
from typing import Dict, List, Optional, Tuple

import jax
import jax.numpy as jnp

from .. import dtypes as dt
from ..column import Column
from ..errors import Invalid
from ..table import RecordBatch

__all__ = ["staged_group_by"]


# --------------------------------------------------------------------
# plan cache: jitted stage closures are built ONCE per (schema, spec)
# signature — closure identity is what jax.jit caches on
# --------------------------------------------------------------------

_PLANS: Dict[Tuple, "_GBPlan"] = {}


class _GBPlan:
    def __init__(self, meta, keys, aggregates, G, n):
        from ..kernels.radix import minimal_sort_keys

        self.G, self.n = G, n
        self.keys, self.aggregates = keys, aggregates
        self.meta = meta            # name -> (dtype, has_validity)

        # ---- payload slot planning (mirrors exec/compiled.py) ----
        self.pay_cols: List[Tuple[str, str]] = []  # (colname, part)

        def add(cname, part) -> int:
            self.pay_cols.append((cname, part))
            return len(self.pay_cols) - 1

        agg_slots = []
        seen: Dict[str, Tuple] = {}
        for cname, fn in aggregates:
            dtype, has_v = meta[cname]
            if dtype.is_decimal or dtype.is_binary:
                raise Invalid("staged group_by: decimal/binary aggregate "
                              f"inputs ({cname!r}) — use the fused "
                              "pipeline or eager group_by")
            if cname not in seen:
                seen[cname] = (add(cname, "data"),
                               add(cname, "validity") if has_v else None)
            agg_slots.append(seen[cname])
        self.agg_slots = agg_slots

        for k in keys:
            dtype, _ = meta[k]
            if dtype.is_decimal or dtype.is_binary:
                raise Invalid("staged group_by: decimal/binary group "
                              f"keys ({k!r}) — use the fused pipeline "
                              "or eager group_by")

        # ---- stage 1: pack + sort (closure rebuilds Columns) ----
        def _sort(key_arrays, pay_arrays):
            from ..ops.padded import gsp_sort

            pairs = []
            for kname, (kd, kv) in zip(keys, key_arrays):
                col = Column(kd, meta[kname][0], validity=kv)
                pairs.extend(minimal_sort_keys(col))
            sw, sp, used, placements = gsp_sort(pairs, None,
                                                list(pay_arrays))
            return tuple(sw), tuple(sp)

        self.sort_jit = jax.jit(_sort)

        # static pack layout/bits (host-side dry planning on metadata)
        import numpy as np

        dummy_pairs = []
        self.key_spans = []
        for k in keys:
            dtype, has_v = meta[k]
            col = Column(jnp.zeros(1, dtype.physical_dtype()), dtype,
                         validity=jnp.ones(1, jnp.bool_)
                         if has_v else None)
            prs = minimal_sort_keys(col)
            self.key_spans.append((len(dummy_pairs), len(prs)))
            dummy_pairs.extend(prs)
        from ..kernels.radix import pack_layout, pack_operands

        self.placements = pack_layout(dummy_pairs)
        _, self.used_bits = pack_operands(dummy_pairs)
        del np

        # ---- stages 2+3: one-program segments ----
        def _segments(sorted_words):
            from ..ops.padded import gsp_segments

            return gsp_segments(list(sorted_words), self.used_bits,
                                False, G)

        self.segments_jit = jax.jit(_segments)

        # ---- stage 4: one scan plane per program ----
        def _sum_plane(xs, mask_s, live_sorted, acc_name, pre=None):
            acc_dtype = jnp.dtype(acc_name)
            if pre == "f64":
                xs = xs.astype(jnp.float64)
            elif pre == "sq":
                xs = xs.astype(jnp.float64)
                xs = xs * xs
            elif pre == "ones":
                xs = jnp.ones(live_sorted.shape[0], jnp.int64)
            m = live_sorted if mask_s is None else (mask_s & live_sorted)
            from ..kernels.blockscan import cumsum_blocked

            return cumsum_blocked(
                jnp.where(m, xs, 0).astype(acc_dtype))

        self.sum_plane_jit = jax.jit(_sum_plane,
                                     static_argnames=("acc_name", "pre"))

        def _minmax_plane(xs, mask_s, live_sorted, first, init, is_min,
                          pre=None):
            from ..kernels.blockscan import scan_blocked

            if pre == "neq0":
                xs = xs != 0
            m = live_sorted if mask_s is None else (mask_s & live_sorted)
            vals = jnp.where(m, xs, init)

            def combine(a, b):
                av, af = a
                bv, bf = b
                v = jnp.where(bf, bv,
                              jnp.minimum(av, bv) if is_min
                              else jnp.maximum(av, bv))
                return v, af | bf

            out, _ = scan_blocked(combine, (vals, first))
            return out

        self.minmax_plane_jit = jax.jit(_minmax_plane,
                                        static_argnames=("is_min", "pre"))

        # ---- stage 5a: f64 ends (packed row gather) ----
        def _ends_f64(planes, endpos):
            if len(planes) > 1 and G > 65536:
                mat = jnp.stack(list(planes), axis=1)
                rows = mat[endpos]
                return tuple(rows[:, j] for j in range(len(planes)))
            return tuple(p[endpos] for p in planes)

        self.ends_f64_jit = jax.jit(_ends_f64)

        def _ends_gather(planes, endpos):
            return tuple(p[endpos] for p in planes)

        self.ends_gather_jit = jax.jit(_ends_gather)

        # ---- stage 5b: assembly (built after recipes are planned) ----
        self.assemble_jit = None     # set by _finish_plan

    # -----------------------------------------------------------------
    def _finish_plan(self, recipes, key_slots):
        """recipes: list of (kind, cname, fn, out_dtype, vc, extra).
        key_slots: per key, None (decode from words) — binary/decimal
        keys are rejected up front, so decode always applies."""
        G, keys, meta = self.G, self.keys, self.meta
        placements, key_spans = self.placements, self.key_spans

        def _assemble(ends, startpos, endpos, group_valid, num_groups,
                      swords):
            from ..kernels.radix import decode_packed_key
            from ..ops.padded import SortedGroups, seg_diff_lo

            sg = SortedGroups(None, None, startpos, endpos, group_valid,
                              num_groups, num_groups > G)
            arith_vcount = jnp.where(
                group_valid, (endpos - startpos + 1).astype(jnp.int64),
                0)

            def vcount_of(vc):
                kind, idx = vc
                if kind == "arith":
                    return arith_vcount
                return seg_diff_lo(ends[idx], sg)

            outs = []
            for kind, cname, fn, out_t, vc, extra in recipes:
                vcount = vcount_of(vc)
                if kind == "count":
                    acc = vcount
                elif kind == "sum":
                    acc = seg_diff_lo(ends[extra[0]], sg)
                elif kind == "mean":
                    s = seg_diff_lo(ends[extra[0]], sg)
                    acc = s.astype(jnp.float64) / jnp.maximum(
                        vcount, 1).astype(jnp.float64)
                elif kind == "minmax":
                    pi, init = extra
                    acc = jnp.where(group_valid, ends[pi], init)
                elif kind == "var":
                    s1 = seg_diff_lo(ends[extra[0]], sg)
                    s2 = seg_diff_lo(ends[extra[1]], sg)
                    nv = jnp.maximum(vcount, 1).astype(jnp.float64)
                    mean = s1 / nv
                    acc = jnp.maximum(s2 / nv - mean * mean, 0.0)
                    if fn == "stddev":
                        acc = jnp.sqrt(acc)
                else:   # anyall
                    acc = jnp.where(group_valid, ends[extra[0]],
                                    fn == "all")
                validity = (None if fn == "count"
                            else ((vcount > 0) & group_valid))
                outs.append((acc.astype(out_t.physical_dtype()),
                             validity))

            key_outs = []
            for k, (p0, pcnt) in zip(keys, key_spans):
                dtype, has_v = meta[k]
                vals = []
                for pi in range(p0, p0 + pcnt):
                    wi, shift, bits = placements[pi]
                    w = swords[wi][startpos]
                    if bits == 0:
                        vals.append(w)
                    else:
                        m = jnp.uint64((1 << bits) - 1)
                        vals.append((w.astype(jnp.uint64)
                                     >> jnp.uint64(shift)) & m)
                col = Column(jnp.zeros(0, dtype.physical_dtype()),
                             dtype,
                             validity=jnp.zeros(0, jnp.bool_)
                             if has_v else None)
                data, validity = decode_packed_key(col, vals)
                key_outs.append((
                    data, None if validity is None
                    else (validity & group_valid)))
            return tuple(outs), tuple(key_outs)

        self.assemble_jit = jax.jit(_assemble)


def _plan_for(batch: RecordBatch, keys, aggregates, G):
    need = list(dict.fromkeys(
        [*keys, *[c for c, _ in aggregates]]))
    meta = {}
    for name in need:
        c = batch.column(name)
        meta[name] = (c.dtype, c.validity is not None)
    sig = (tuple(sorted((k, str(v[0]), v[1]) for k, v in meta.items())),
           tuple(keys), tuple(aggregates), G, batch.num_rows)
    plan = _PLANS.get(sig)
    if plan is None:
        plan = _GBPlan(meta, list(keys), list(aggregates), G,
                       batch.num_rows)
        _PLANS[sig] = plan
    return plan


def staged_group_by(batch: RecordBatch, keys, aggregates,
                    max_groups: int = 65536):
    """Host-driven staged group-by; output matches the compiled
    pipeline's group_by bit-for-bit (same stages, separate programs).

    Returns (RecordBatch[G padded], group_valid bool[G], overflow) —
    the same padded contract as the compiled pipeline; slice with
    ``num_groups`` (= group_valid.sum()) for exact rows."""
    if isinstance(keys, str):
        keys = [keys]
    keys = list(keys)
    aggregates = [tuple(a) for a in aggregates]
    n = batch.num_rows
    G = max(min(int(max_groups), n), 1)
    plan = _plan_for(batch, keys, aggregates, G)

    # ---- recipes (host planning; mirrors exec/compiled.py) ----
    end_planes_spec: List = []     # (kind, slot_di, slot_vi, extra)

    def want(spec) -> int:
        end_planes_spec.append(spec)
        return len(end_planes_spec) - 1

    vcount_plane: Dict = {}

    def vcount_ref(vi):
        if vi is None:
            return ("arith", None)
        if vi not in vcount_plane:
            vcount_plane[vi] = want(("count", None, vi, None))
        return ("plane", vcount_plane[vi])

    recipes = []
    for (cname, fn), (di, vi) in zip(aggregates, plan.agg_slots):
        col = batch.column(cname)
        out_t = {"count": dt.int64}.get(fn)
        if out_t is None:
            if fn in ("mean", "variance", "stddev"):
                out_t = dt.float64
            elif fn in ("any", "all"):
                out_t = dt.bool_
            elif fn in ("min", "max"):
                out_t = col.dtype
            else:
                from ..ops.aggregate import _sum_output_type

                out_t = _sum_output_type(col.dtype)
        vc = vcount_ref(vi)
        if fn == "count":
            recipes.append(("count", cname, fn, out_t, vc, ()))
        elif fn == "sum":
            acc_dt = (jnp.float64 if col.dtype.is_floating
                      else jnp.uint64
                      if col.dtype.kind == "uint64" else jnp.int64)
            pi = want(("sum", di, vi, str(jnp.dtype(acc_dt))))
            recipes.append(("sum", cname, fn, out_t, vc, (pi,)))
        elif fn == "mean":
            acc_dt = (jnp.float64 if col.dtype.is_floating
                      else jnp.int64)
            pi = want(("sumf" if col.dtype.is_floating else "sum",
                       di, vi, str(jnp.dtype(acc_dt))))
            recipes.append(("mean", cname, fn, out_t, vc, (pi,)))
        elif fn in ("min", "max"):
            if col.dtype.is_floating:
                init = float(jnp.inf if fn == "min" else -jnp.inf)
            elif col.dtype.is_boolean:
                init = bool(fn == "min")
            else:
                info = jnp.iinfo(col.dtype.physical_dtype())
                init = int(info.max if fn == "min" else info.min)
            pi = want(("minmax", di, vi, (fn == "min", init)))
            recipes.append(("minmax", cname, fn, out_t, vc, (pi, init)))
        elif fn in ("variance", "stddev"):
            p1 = want(("sumf", di, vi, "float64"))
            p2 = want(("sumsq", di, vi, "float64"))
            recipes.append(("var", cname, fn, out_t, vc, (p1, p2)))
        elif fn in ("any", "all"):
            pi = want(("anyall", di, vi, fn == "all"))
            recipes.append(("anyall", cname, fn, out_t, vc, (pi,)))
        else:
            raise Invalid(f"staged group_by: unsupported aggregate "
                          f"{fn!r}")
    if plan.assemble_jit is None:
        plan._finish_plan(recipes, None)

    # ---- stage 1: pack + sort ----
    key_arrays = tuple((batch.column(k).data, batch.column(k).validity)
                       for k in keys)
    pay_arrays = tuple(
        batch.column(c).data if part == "data"
        else batch.column(c).validity
        for c, part in plan.pay_cols)
    sorted_words, sorted_p = plan.sort_jit(key_arrays, pay_arrays)

    # ---- stages 2+3: segment structure ----
    (live_sorted, first, startpos, endpos, group_valid, num_groups,
     overflow) = plan.segments_jit(sorted_words)

    # ---- stage 4: scan planes (one dispatch each) ----
    planes = []
    for kind, di, vi, extra in end_planes_spec:
        xs = None if di is None else sorted_p[di]
        mask_s = None if vi is None else sorted_p[vi]
        if kind == "count":
            planes.append(plan.sum_plane_jit(
                live_sorted, mask_s, live_sorted,
                acc_name="int64", pre="ones"))
        elif kind == "sum":
            planes.append(plan.sum_plane_jit(
                xs, mask_s, live_sorted, acc_name=extra))
        elif kind == "sumf":
            planes.append(plan.sum_plane_jit(
                xs, mask_s, live_sorted, acc_name="float64",
                pre="f64"))
        elif kind == "sumsq":
            planes.append(plan.sum_plane_jit(
                xs, mask_s, live_sorted, acc_name="float64",
                pre="sq"))
        elif kind == "minmax":
            is_min, init = extra
            planes.append(plan.minmax_plane_jit(
                xs, mask_s, live_sorted, first,
                jnp.asarray(init, xs.dtype), is_min=is_min))
        else:   # anyall
            is_all = extra
            planes.append(plan.minmax_plane_jit(
                xs, mask_s, live_sorted, first,
                jnp.asarray(bool(is_all)), is_min=bool(is_all),
                pre="neq0"))

    # ---- stage 5a: segment-end extraction ----
    f64p = [i for i, p in enumerate(planes)
            if jnp.issubdtype(p.dtype, jnp.floating)]
    intp = [i for i in range(len(planes)) if i not in f64p]
    ends: List[Optional[jnp.ndarray]] = [None] * len(planes)
    for idx, ends_jit in ((f64p, plan.ends_f64_jit),
                          (intp, plan.ends_gather_jit)):
        if idx:
            got = ends_jit(tuple(planes[i] for i in idx), endpos)
            for j, i in enumerate(idx):
                ends[i] = got[j]

    # ---- stage 5b: assembly ----
    outs, key_outs = plan.assemble_jit(
        tuple(ends), startpos, endpos, group_valid, num_groups,
        sorted_words)

    cols, names = [], []
    for (kind, cname, fn, out_t, vc, extra), (data, validity) in zip(
            recipes, outs):
        cols.append(Column(data, out_t, validity=validity))
        names.append(f"{cname}_{fn}")
    for k, (data, validity) in zip(keys, key_outs):
        col = batch.column(k)
        cols.append(Column(data, col.dtype, validity=validity,
                           dictionary=col.dictionary))
        names.append(k)
    return (RecordBatch(tuple(cols), tuple(names)), group_valid,
            overflow)

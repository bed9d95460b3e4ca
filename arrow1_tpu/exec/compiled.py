"""Compiled pipeline executor: a whole query as ONE XLA program.

This replaces the reference's per-kernel eager pipeline (CallFunction per
op, ExecBatchIterator chunking — compute/exec.cc:158-230) with the
BASELINE's "fixed-shape tiled batch executor": every operator works on
padded, statically-shaped state with a live-row mask, so an entire
   filter -> project -> join -> group_by -> sort -> limit
chain traces to a single jitted computation — one device dispatch, zero
host round-trips between operators.

Late materialization: filter only updates the live mask (no compaction
gather); group_by/sort consume the mask directly. Rows are physically
moved only where an operator requires it (sort reorder, join expansion) —
the selection-vector future Arrow sketched with `SelectionVector`
(exec.h:124-139) and never shipped.

State between operators: {name: (data, mask)} column arrays + a live
bool vector, all capacity-padded. Capacities are chosen at build time
(join fanout, group bound), with on-device overflow flags surfaced after
execution like the distributed operators.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
from ..kernels.blockscan import cumsum_blocked, scan_blocked

from .. import dtypes as dt
from ..column import Column
from ..errors import Invalid
from ..expr import Expression
from ..ops.padded import filter_padded, grouping_padded, join_padded
from ..ops.sort import normalize_sort_key, sort_indices_device
from ..table import RecordBatch

__all__ = ["PipelineBuilder", "CompiledPipeline"]


@dataclasses.dataclass
class _State:
    batch: RecordBatch           # capacity-padded columns
    live: jnp.ndarray            # bool[capacity]
    overflow: jnp.ndarray       # bool scalar accumulator
    all_live: bool = False       # STATIC: no op so far creates dead rows

    @property
    def capacity(self) -> int:
        return self.batch.num_rows


def _masked_batch(batch: RecordBatch, live) -> RecordBatch:
    """Fold the live mask into column validities (for expression eval)."""
    cols = tuple(
        Column(c.data, c.dtype,
               validity=live if c.validity is None else (c.validity & live),
               dictionary=c.dictionary, data2=c.data2)
        for c in batch.columns)
    return RecordBatch(cols, batch.names)


class PipelineBuilder:
    """Chainable builder; `.compile()` returns a CompiledPipeline."""

    def __init__(self):
        self._ops: List[Tuple] = []

    def filter(self, predicate: Expression) -> "PipelineBuilder":
        self._ops.append(("filter", predicate))
        return self

    def project(self, exprs: Sequence[Expression],
                names: Sequence[str], keep_existing: bool = True
                ) -> "PipelineBuilder":
        self._ops.append(("project", list(exprs), list(names),
                          keep_existing))
        return self

    def join(self, build: RecordBatch, keys, right_keys=None,
             fanout: int = 4, join_type: str = "inner"
             ) -> "PipelineBuilder":
        """Equi-join against a (small, pre-built) build side.
        join_type: "inner" | "left outer". Output capacity =
        probe_capacity * fanout."""
        if join_type not in ("inner", "left outer"):
            raise Invalid(f"compiled join: unsupported join_type "
                          f"{join_type!r} (inner / left outer)")
        self._ops.append(("join", build,
                          [keys] if isinstance(keys, str) else list(keys),
                          right_keys, fanout, join_type))
        return self

    def group_by(self, keys: Sequence[str],
                 aggregates: Sequence[Tuple[str, str]],
                 max_groups: int = 65536) -> "PipelineBuilder":
        """Hash aggregate. `max_groups` is the STATIC output capacity:
        downstream operators run at this width (sort after group_by costs
        O(max_groups log max_groups), not O(input rows)); more distinct
        groups than max_groups sets the overflow flag — re-run with a
        larger bound."""
        self._ops.append(("group_by", list(keys), list(aggregates),
                          int(max_groups)))
        return self

    def sort(self, sort_keys: Sequence[Tuple[str, str]]) -> "PipelineBuilder":
        self._ops.append(("sort", list(sort_keys)))
        return self

    def limit(self, n: int) -> "PipelineBuilder":
        self._ops.append(("limit", n))
        return self

    def compile(self) -> "CompiledPipeline":
        return CompiledPipeline(self._ops)


class CompiledPipeline:
    def __init__(self, ops: List[Tuple]):
        self._ops = ops
        self._jitted = jax.jit(self._trace)

    # ---- operator implementations (trace-time) ----
    def _trace(self, batch: RecordBatch):
        n = batch.num_rows
        state = _State(batch, jnp.ones(n, jnp.bool_), jnp.zeros((), jnp.bool_),
                       all_live=True)
        for op in self._ops:
            state = getattr(self, "_op_" + op[0])(state, *op[1:])
        return state.batch, state.live, state.overflow

    def _op_filter(self, state: _State, predicate: Expression) -> _State:
        mask = predicate.execute(_masked_batch(state.batch, state.live))
        sel = mask.data if mask.validity is None else (mask.data & mask.validity)
        return _State(state.batch, state.live & sel, state.overflow,
                      all_live=False)

    def _op_project(self, state: _State, exprs, names, keep) -> _State:
        src = _masked_batch(state.batch, state.live)
        cols, out_names = ([], [])
        if keep:
            cols = list(state.batch.columns)
            out_names = list(state.batch.names)
        for e, name in zip(exprs, names):
            v = e.execute(src)
            if name in out_names:
                cols[out_names.index(name)] = v
            else:
                cols.append(v)
                out_names.append(name)
        return _State(RecordBatch(tuple(cols), tuple(out_names)),
                      state.live, state.overflow,
                      all_live=state.all_live)

    def _op_join(self, state: _State, build: RecordBatch, keys,
                 right_keys, fanout, join_type="inner") -> _State:
        right_keys = list(right_keys or keys)
        probe = state.batch
        # normalized single-key id space over both sides (trace-time concat)
        pk_parts, bk_parts = [], []
        for lk, rk in zip(keys, right_keys):
            lc, rc = probe.column(lk), build.column(rk)
            if lc.dtype.is_binary and rc.dtype.is_binary and \
                    lc.dictionary is not rc.dictionary:
                from ..ops.dictionary import unify_dictionaries

                merged, d = unify_dictionaries([lc, rc])
                lc = Column(merged[: lc.length], lc.dtype,
                            validity=lc.validity, dictionary=d)
                rc = Column(merged[lc.length:], rc.dtype,
                            validity=rc.validity, dictionary=d)
            lkeys = normalize_sort_key(lc)
            rkeys = normalize_sort_key(rc)
            if len(lkeys) != len(rkeys):
                if len(lkeys) == 1:
                    lkeys = [jnp.zeros(lc.length, jnp.uint8)] + lkeys
                else:
                    rkeys = [jnp.zeros(rc.length, jnp.uint8)] + rkeys
            pk_parts.append(lkeys)
            bk_parts.append(rkeys)
        # exact multi-component matching: the full normalized plane list
        # rides join_padded's variadic sort-merge (no folding — the
        # reference's Grouper matches serialized keys exactly,
        # compute/kernels/hash_aggregate.cc:97-311, and BASELINE parity
        # is bit-exact; a fold collision would emit a wrong join row
        # with no error flag)
        if len(keys) == 1 and len(pk_parts[0]) == 1:
            pk, bk = pk_parts[0][0], bk_parts[0][0]
        else:
            pk = [c for comp_list in pk_parts for c in comp_list]
            bk = [c for comp_list in bk_parts for c in comp_list]
        bvalid = None
        for rk in right_keys:
            c = build.column(rk)
            if c.validity is not None:
                bvalid = c.validity if bvalid is None else (bvalid & c.validity)
        pvalid = None
        for lk in keys:
            c = probe.column(lk)
            if c.validity is not None:
                pvalid = c.validity if pvalid is None else (pvalid & c.validity)
        capacity = state.capacity * fanout
        outer = join_type == "left outer"
        pidx, bidx, pair_valid, pair_has_match, _, total, ovf = \
            join_padded(pk, bk, pvalid, bvalid, capacity, outer=outer,
                        probe_live=state.live)
        # materialize both sides via the packed row gather (one [n, W]
        # matrix gather per side; carries data2/bits/validity planes)
        from ..ops.selection import gather_batch_packed

        left = gather_batch_packed(probe, pidx)
        rkeyset = set(right_keys)
        rpay = [(n, c) for n, c in zip(build.names, build.columns)
                if n not in rkeyset]
        cols = list(left.columns)
        names = list(left.names)
        if rpay:
            right = gather_batch_packed(
                RecordBatch(tuple(c for _, c in rpay),
                            tuple(n for n, _ in rpay)), bidx,
                pair_has_match if outer else None)
            cols += list(right.columns)
            names += list(right.names)
        return _State(RecordBatch(tuple(cols), tuple(names)),
                      pair_valid, state.overflow | ovf,
                      all_live=False)

    def _op_group_by(self, state: _State, keys, aggregates,
                     max_groups: int = 65536) -> _State:
        """Sorted-space hash aggregate with static output capacity.

        One variadic sort (minimal-width packed keys; raw key planes and
        aggregate inputs ride as payloads) + flagged-scan/cumsum-diff
        segment reductions + searchsorted compaction to `max_groups`
        slots (ops/padded.py group_sort_padded). Replaces an earlier
        design of full-capacity grouping + one full-length scatter per
        aggregate.

        Reference semantics: hash_aggregate.cc:890-966 driver loop;
        group order here is key order (dead rows excluded) — the
        reference's insertion order is likewise plan-internal.
        """
        from ..kernels.radix import (decode_packed_key, minimal_sort_keys,
                                     sort_key_decodable)
        from ..ops.padded import (group_sort_padded, seg_diff_lo,
                                  seg_minmax_plane, seg_sum_plane,
                                  seg_values_at_ends)

        n = state.capacity
        G = max(min(int(max_groups), n), 1)
        key_pairs: List = []
        key_spans: List[Tuple[int, int]] = []  # (first pair idx, count)
        for k in keys:
            prs = minimal_sort_keys(state.batch.column(k))
            key_spans.append((len(key_pairs), len(prs)))
            key_pairs.extend(prs)

        # payload planes: aggregate inputs + raw key planes (for output
        # reconstruction via G-sized gathers at segment starts)
        payloads: List[jnp.ndarray] = []

        def add(x) -> int:
            payloads.append(x)
            return len(payloads) - 1

        agg_slots = []   # (data_i, valid_i or None, data2_i or None)
        seen: Dict[str, Tuple] = {}
        for cname, fn in aggregates:
            col = state.batch.column(cname)
            if col.dtype.is_decimal and fn not in ("count",):
                raise Invalid(f"compiled group_by: {fn} over decimal "
                              f"column {cname!r} is not supported — "
                              "use the eager group_by")
            if cname not in seen:
                seen[cname] = (
                    add(col.data),
                    None if col.validity is None else add(col.validity),
                    None)
            agg_slots.append(seen[cname])
        # key output columns: decoded from the sorted packed words when
        # possible (no extra sort operands — lax.sort compile AND run
        # scale with operand count); decimals fall back to raw planes.
        key_slots = []   # (data_i, valid_i or None, data2 slot list) or None
        for k in keys:
            col = state.batch.column(k)
            if sort_key_decodable(col):
                key_slots.append(None)
                continue
            if col.data2 is None:
                d2 = None
            elif col.data2.ndim == 2:
                # decimal256 limbs: one rank-1 sort payload per limb
                d2 = [add(col.data2[:, j])
                      for j in range(col.data2.shape[1])]
            else:
                d2 = [add(col.data2)]
            key_slots.append((
                add(col.data),
                None if col.validity is None else add(col.validity),
                d2))

        sg, sorted_p, swords, places = group_sort_padded(
            key_pairs, None if state.all_live else state.live,
            payloads, G)

        # ---- aggregate tails, two-phase: (1) full-length cumsum/scan
        # planes per aggregate, (2) ONE batched extraction at segment
        # ends (seg_values_at_ends), then G-sized arithmetic to assemble
        # the outputs.
        end_planes: List = []

        def want(p) -> int:
            end_planes.append(p)
            return len(end_planes) - 1

        arith_vcount = None
        if state.all_live:
            # no dead rows: count of a no-null column = segment length
            arith_vcount = jnp.where(
                sg.group_valid,
                (sg.endpos - sg.startpos + 1).astype(jnp.int64), 0)
        vcount_plane: Dict = {}   # vi (validity slot) -> plane idx

        def vcount_ref(vi, mask_s):
            """-> ("arith", None) | ("plane", idx) for this aggregate's
            valid-count; deduped per distinct validity plane."""
            if mask_s is None and arith_vcount is not None:
                return ("arith", None)
            if vi not in vcount_plane:
                vcount_plane[vi] = want(seg_sum_plane(
                    jnp.ones(n, jnp.int64), mask_s, sg, jnp.int64))
            return ("plane", vcount_plane[vi])

        recipes = []
        for (cname, fn), (di, vi, _) in zip(aggregates, agg_slots):
            col = state.batch.column(cname)
            xs = sorted_p[di]
            mask_s = None if vi is None else sorted_p[vi]
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
            vc = vcount_ref(vi, mask_s)
            if fn == "count":
                recipes.append(("count", cname, fn, out_t, col, vc, ()))
            elif fn == "sum":
                acc_dt = (jnp.float64 if col.dtype.is_floating
                          else jnp.uint64
                          if col.dtype.kind == "uint64" else jnp.int64)
                pi = want(seg_sum_plane(xs, mask_s, sg, acc_dt))
                recipes.append(("sum", cname, fn, out_t, col, vc, (pi,)))
            elif fn == "mean":
                acc_dt = (jnp.float64 if col.dtype.is_floating
                          else jnp.int64)
                pi = want(seg_sum_plane(
                    xs.astype(jnp.float64) if col.dtype.is_floating
                    else xs, mask_s, sg, acc_dt))
                recipes.append(("mean", cname, fn, out_t, col, vc, (pi,)))
            elif fn in ("min", "max"):
                if col.dtype.is_floating:
                    init = jnp.asarray(
                        jnp.inf if fn == "min" else -jnp.inf, xs.dtype)
                elif col.dtype.is_boolean:
                    init = jnp.asarray(fn == "min")
                else:
                    info = jnp.iinfo(xs.dtype)
                    init = jnp.asarray(
                        info.max if fn == "min" else info.min, xs.dtype)
                pi = want(seg_minmax_plane(xs, mask_s, sg,
                                           fn == "min", init))
                recipes.append(("minmax", cname, fn, out_t, col, vc,
                                (pi, init)))
            elif fn in ("variance", "stddev"):
                x = xs.astype(jnp.float64)
                p1 = want(seg_sum_plane(x, mask_s, sg, jnp.float64))
                p2 = want(seg_sum_plane(x * x, mask_s, sg, jnp.float64))
                recipes.append(("var", cname, fn, out_t, col, vc,
                                (p1, p2)))
            elif fn in ("any", "all"):
                pi = want(seg_minmax_plane(
                    xs != 0, mask_s, sg, fn == "all",
                    jnp.asarray(fn == "all")))
                recipes.append(("anyall", cname, fn, out_t, col, vc,
                                (pi,)))
            else:
                raise Invalid(f"compiled group_by: unsupported "
                              f"aggregate {fn!r}")

        ends = seg_values_at_ends(sg, end_planes) if end_planes else []

        def vcount_of(vc):
            kind, idx = vc
            if kind == "arith":
                return arith_vcount
            return seg_diff_lo(ends[idx], sg)

        cols, names = [], []
        for kind, cname, fn, out_t, col, vc, extra in recipes:
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
                acc = jnp.where(sg.group_valid, ends[pi], init)
            elif kind == "var":
                s1 = seg_diff_lo(ends[extra[0]], sg)
                s2 = seg_diff_lo(ends[extra[1]], sg)
                nv = jnp.maximum(vcount, 1).astype(jnp.float64)
                mean = s1 / nv
                acc = jnp.maximum(s2 / nv - mean * mean, 0.0)
                if fn == "stddev":
                    acc = jnp.sqrt(acc)
            else:  # anyall
                acc = jnp.where(sg.group_valid, ends[extra[0]],
                                fn == "all")
            validity = None if fn == "count" else \
                ((vcount > 0) & sg.group_valid)
            cols.append(Column(acc.astype(out_t.physical_dtype()), out_t,
                               validity=validity,
                               dictionary=col.dictionary
                               if out_t.is_binary else None))
            names.append(f"{cname}_{fn}")
        for k, slot, (p0, pcnt) in zip(keys, key_slots, key_spans):
            col = state.batch.column(k)
            if slot is None:
                vals = []
                for pi in range(p0, p0 + pcnt):
                    wi, shift, bits = places[pi]
                    w = swords[wi][sg.startpos]     # G-sized gather
                    if bits == 0:
                        vals.append(w)              # raw plane (f64)
                    else:
                        mask = jnp.uint64((1 << bits) - 1)
                        vals.append((w.astype(jnp.uint64)
                                     >> jnp.uint64(shift)) & mask)
                data, validity = decode_packed_key(col, vals)
                cols.append(Column(
                    data, col.dtype,
                    validity=None if validity is None
                    else (validity & sg.group_valid),
                    dictionary=col.dictionary))
                names.append(k)
                continue
            di, vi, d2i = slot
            if d2i is None:
                data2 = None
            elif len(d2i) == 1:
                data2 = sorted_p[d2i[0]][sg.startpos]
            else:
                data2 = jnp.stack(
                    [sorted_p[j][sg.startpos] for j in d2i], axis=1)
            cols.append(Column(
                sorted_p[di][sg.startpos], col.dtype,
                validity=None if vi is None
                else (sorted_p[vi][sg.startpos] & sg.group_valid),
                data2=data2,
                dictionary=col.dictionary))
            names.append(k)
        return _State(RecordBatch(tuple(cols), tuple(names)),
                      sg.group_valid, state.overflow | sg.overflow)

    def _op_sort(self, state: _State, sort_keys) -> _State:
        # minimal-width packed sort (kernels/radix.py): the dead-row
        # plane (live-last) packs with the key bits -> fewest passes.
        # Rows are MATERIALIZED here, so every column plane rides the
        # variadic sort network (no argsort + per-column gathers).
        from ..kernels.radix import minimal_sort_keys, sort_rows

        pairs = [((~state.live).astype(jnp.uint64), 1)]
        for name, order in sort_keys:
            pairs.extend(minimal_sort_keys(state.batch.column(name), order))
        payloads = [state.live]
        layout = []  # (has_validity, has_data2) per column
        for c in state.batch.columns:
            payloads.append(c.data)
            if c.validity is not None:
                payloads.append(c.validity)
            if c.data2 is not None:
                payloads.append(c.data2)
            layout.append((c.validity is not None, c.data2 is not None))
        sorted_ = sort_rows(pairs, payloads)
        live = sorted_[0]
        cols = []
        i = 1
        for c, (has_v, has_d2) in zip(state.batch.columns, layout):
            data = sorted_[i]
            i += 1
            validity = data2 = None
            if has_v:
                validity = sorted_[i]
                i += 1
            if has_d2:
                data2 = sorted_[i]
                i += 1
            cols.append(Column(data, c.dtype, validity=validity,
                               data2=data2, dictionary=c.dictionary))
        return _State(RecordBatch(tuple(cols), state.batch.names),
                      live, state.overflow, all_live=state.all_live)

    def _op_limit(self, state: _State, n: int) -> _State:
        # keep the first n LIVE rows
        live_rank = cumsum_blocked(state.live) - 1
        keep = state.live & (live_rank < n)
        return _State(state.batch, keep, state.overflow,
                      all_live=False)

    # ---- execution ----
    def __call__(self, batch: RecordBatch, materialize: bool = True):
        out_batch, live, overflow = self._jitted(batch)
        if bool(overflow):
            raise Invalid("compiled pipeline: capacity overflow — raise "
                          "join fanout")
        if not materialize:
            return out_batch, live
        # materialize through the eager filter
        from ..ops.selection import _filter_exec

        mask = Column(live, dt.bool_)
        return _filter_exec([out_batch, mask], None, None)

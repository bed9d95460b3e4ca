"""Streaming (chunked) execution: consume/merge/finalize across batches.

Reference: the ScalarAggregator state machine (aggregate_internal.h:52) and
HashAggregateKernel consume/merge/finalize (kernel.h:637-676) — the
mechanism that lets arbitrary-length inputs reduce in bounded memory
(SURVEY.md §5 "row-count scaling via chunked streaming").

Device shape: each consume() is one fused device computation over a
HBM-resident batch; merge algebra runs on tiny per-chunk partials:

    sum:   total = sum(partial_sums)
    count: total = sum(partial_counts)
    min/max: reduce over partials
    mean:  sum/count over partials
    var:   Chan et al. pairwise merge (matches Welford+merge in
           aggregate_var_std.cc)
    group_by: concat partial group tables -> re-group (exact, since the
           partial table is itself keyed)
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import jax.numpy as jnp

from ..column import Column
from ..errors import Invalid
from ..table import RecordBatch, concat_batches

__all__ = ["StreamingAggregator", "StreamingGroupBy",
           "run_streaming_aggregate"]


class StreamingAggregator:
    """Chunked scalar aggregates: consume(batch) per chunk, finalize() once.

    aggregates: [(column, fn)] with fn in {sum, count, min, max, mean,
    variance, stddev}."""

    def __init__(self, aggregates: Sequence[Tuple[str, str]]):
        self.aggregates = list(aggregates)
        # per-aggregate partial state: list of (sum, count, min, max, m2)
        self._partials: List[List] = [[] for _ in self.aggregates]
        self._dtypes: List = [None] * len(self.aggregates)

    def consume(self, batch: RecordBatch):
        for i, (cname, fn) in enumerate(self.aggregates):
            col = batch.column(cname)
            self._dtypes[i] = col.dtype
            live = col.mask()
            x = jnp.where(live, col.data, 0)
            n = jnp.sum(live)
            s = jnp.sum(x.astype(jnp.float64))
            if fn in ("min", "max"):
                from ..ops.aggregate import _min_max_exec

                mm = _min_max_exec([col], None, None)
                self._partials[i].append(
                    (mm["min"].data[0], mm["max"].data[0], n,
                     mm["min"].validity))
            elif fn in ("variance", "stddev"):
                mean = s / jnp.maximum(n, 1)
                m2 = jnp.sum(jnp.where(
                    live, (col.data.astype(jnp.float64) - mean) ** 2, 0.0))
                self._partials[i].append((s, n, m2))
            else:
                self._partials[i].append((s, n))

    def finalize(self) -> Dict[str, object]:
        from ..datum import Scalar
        from .. import dtypes as dt
        from ..ops.aggregate import _sum_output_type

        out = {}
        for i, (cname, fn) in enumerate(self.aggregates):
            parts = self._partials[i]
            name = f"{cname}_{fn}"
            if not parts:
                out[name] = Scalar(0, dt.int64, is_valid=False)
                continue
            if fn in ("min", "max"):
                total_n = sum(int(p[2]) for p in parts)
                vals = [p[0] if fn == "min" else p[1] for p in parts
                        if p[3] is None or bool(p[3][0])]
                if total_n == 0 or not vals:
                    out[name] = Scalar(0, self._dtypes[i], is_valid=False)
                else:
                    arr = jnp.stack(vals)
                    v = jnp.min(arr) if fn == "min" else jnp.max(arr)
                    out[name] = Scalar(v, self._dtypes[i])
            elif fn in ("variance", "stddev"):
                # Chan/parallel merge of (sum, n, M2) partials
                S = sum(float(p[0]) for p in parts)
                N = sum(int(p[1]) for p in parts)
                if N == 0:
                    out[name] = Scalar(0.0, dt.float64, is_valid=False)
                    continue
                mean = S / N
                m2 = 0.0
                for s_i, n_i, m2_i in parts:
                    n_i = int(n_i)
                    if n_i:
                        d = float(s_i) / n_i - mean
                        m2 += float(m2_i) + n_i * d * d
                var = m2 / N
                out[name] = Scalar(var ** 0.5 if fn == "stddev" else var,
                                   dt.float64)
            elif fn == "count":
                out[name] = Scalar(sum(int(p[1]) for p in parts), dt.int64)
            elif fn == "mean":
                N = sum(int(p[1]) for p in parts)
                S = sum(float(p[0]) for p in parts)
                out[name] = (Scalar(S / N, dt.float64) if N
                             else Scalar(0.0, dt.float64, is_valid=False))
            elif fn == "sum":
                N = sum(int(p[1]) for p in parts)
                if N == 0:
                    out[name] = Scalar(0, _sum_output_type(self._dtypes[i]),
                                       is_valid=False)
                else:
                    t = _sum_output_type(self._dtypes[i])
                    S = sum(float(p[0]) for p in parts)
                    val = S if t.is_floating else int(S)
                    out[name] = Scalar(val, t)
            else:
                raise Invalid(f"streaming aggregate {fn!r} unsupported")
        return out


class StreamingGroupBy:
    """Chunked hash aggregate: per-chunk partial group tables merged by
    re-grouping (exact because partials are keyed; the merge algebra per
    aggregate matches GroupedAggregator::Merge, hash_aggregate.cc:606)."""

    MERGEABLE = {"sum", "count", "min", "max", "count_all"}

    def __init__(self, keys: Sequence[str],
                 aggregates: Sequence[Tuple[str, str]]):
        self.keys = list(keys)
        self.aggregates = list(aggregates)
        self._partials: List[RecordBatch] = []
        self._mean_requested = [(c, f) for c, f in self.aggregates
                                if f == "mean"]
        # mean decomposes to sum+count partials
        expanded = []
        for c, f in self.aggregates:
            if f == "mean":
                expanded += [(c, "sum"), (c, "count")]
            elif f in self.MERGEABLE:
                expanded.append((c, f))
            else:
                raise Invalid(f"streaming group_by: {f!r} not mergeable")
        self._expanded = list(dict.fromkeys(expanded))

    def consume(self, batch: RecordBatch):
        from ..ops.groupby import group_by

        self._partials.append(group_by(batch, self.keys, self._expanded))

    def finalize(self) -> RecordBatch:
        from ..ops.groupby import group_by
        from .. import dtypes as dt

        if not self._partials:
            raise Invalid("no input batches")
        merged = concat_batches(self._partials)
        # merge: sum->sum, count->sum, min->min, max->max over partial rows
        merge_aggs = []
        for c, f in self._expanded:
            pname = f"{c}_{f}"
            merge_fn = "sum" if f in ("sum", "count", "count_all") else f
            merge_aggs.append((pname, merge_fn))
        result = group_by(merged, self.keys, merge_aggs)
        # rename "{c}_{f}_{merge_fn}" back to "{c}_{f}"
        mapping = {}
        for c, f in self._expanded:
            merge_fn = "sum" if f in ("sum", "count", "count_all") else f
            mapping[f"{c}_{f}_{merge_fn}"] = f"{c}_{f}"
        result = result.rename(mapping)
        # counts must be int64 (sum of counts is already int64); derive means
        for c, f in self._mean_requested:
            s = result.column(f"{c}_sum")
            n = result.column(f"{c}_count")
            mean = s.data.astype(jnp.float64) / jnp.maximum(n.data, 1)
            validity = None
            if s.validity is not None or bool(jnp.any(n.data == 0)):
                validity = (n.data > 0)
            result = result.set_column(f"{c}_mean",
                                       Column(mean, dt.float64,
                                              validity=validity))
        # drop helper columns not requested
        requested = {f"{c}_{f}" for c, f in self.aggregates} | set(self.keys)
        result = result.drop([n for n in result.names if n not in requested])
        # order: aggregates then keys (group_by convention)
        names = [f"{c}_{f}" for c, f in self.aggregates] + self.keys
        return result.select(names)


def run_streaming_aggregate(batches, keys, aggregates) -> RecordBatch:
    """Convenience: stream a batch iterable through StreamingGroupBy."""
    gb = StreamingGroupBy(keys, aggregates)
    for b in batches:
        gb.consume(b)
    return gb.finalize()

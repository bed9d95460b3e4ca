"""Smoke run of the engine's main path on the GPU, checked against numpy.

    python chip_smoke.py                # one GPU: every single-card phase
    python chip_smoke.py --devices 4    # four GPUs: the distributed phase only
    python chip_smoke.py --rehearse [--devices 4]   # the same on CPU, tiny

Data is generated with numpy from ``--seed`` and ingested through the
numpy path (no pyarrow). Every phase runs its engine call twice (the
first call includes compilation; the second is timed to
``block_until_ready``) and compares the result with a plain numpy
reference written below, independent of the engine. Each phase prints one
``PHASE {...}`` line; the last line is ``{"ok": true, "device": {...}}``,
printed only when every phase passed. Without ``--rehearse`` a run that
finds no GPU exits non-zero.

Tolerances: row counts, group keys, counts and integer sums must match
exactly; float64 sums to a relative 1e-9 (the device adds in another
order than numpy, and with atomics in an order that varies by run).
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import subprocess
import time

import numpy as np

F64_RTOL = 1e-9

RETURNFLAGS = np.array(["A", "N", "R"], dtype=object)
PRIORITIES = np.array(["1-URGENT", "2-HIGH", "3-MEDIUM", "4-NOT SPECIFIED",
                       "5-LOW"], dtype=object)
# TPC-H dates as days since 1970-01-01: 1992-01-02 .. 1998-12-01, and the
# Q1 cutoff 1998-12-01 minus 90 days
SHIPDATE_LO, SHIPDATE_HI = 8036, 10561
Q1_CUTOFF = 10471


@dataclasses.dataclass(frozen=True)
class Sizes:
    sf: float                  # TPC-H scale factor of Q1/Q3/Q6
    pipeline_rows: int         # compiled pipeline (BASELINE config 2 range)
    pipeline_groups: tuple
    filter_rows: int           # BASELINE config 1
    groupby_rows: int          # BASELINE config 2
    groupby_groups: tuple
    sort_rows: int             # BASELINE config 3
    join_probe: int            # BASELINE config 4
    join_build: int
    dist_eager_rows: int       # eager distributed chain and salted join


FULL = Sizes(sf=10, pipeline_rows=10_000_000,
             pipeline_groups=(1_000, 1_000_000),
             filter_rows=10_000_000, groupby_rows=10_000_000,
             groupby_groups=(1_000, 1_000_000), sort_rows=100_000_000,
             join_probe=100_000_000, join_build=10_000_000,
             dist_eager_rows=2_000_000)
# large enough that the G > 65536 group-by branch still runs
REHEARSE = Sizes(sf=0.002, pipeline_rows=140_000,
                 pipeline_groups=(100, 70_000), filter_rows=20_000,
                 groupby_rows=140_000, groupby_groups=(100, 70_000),
                 sort_rows=50_000, join_probe=50_000, join_build=5_000,
                 dist_eager_rows=8_000)


# ---------------------------------------------------------------- timing

def _block(x):
    import jax

    jax.block_until_ready([leaf for leaf in jax.tree_util.tree_leaves(x)
                           if hasattr(leaf, "block_until_ready")])
    return x


@contextlib.contextmanager
def count_host_syncs():
    """Counts device-to-host value fetches (``int()``, ``bool()``,
    ``np.asarray`` of a ``jax.Array``) made inside the block. Yields a
    one-element list; None in it when this JAX has no hook to count."""
    try:
        from jax._src import array as jarray

        prop = jarray.ArrayImpl._value
        fget = prop.fget
    except (ImportError, AttributeError):
        yield [None]
        return
    counter = [0]

    def counting(self):
        if self._npy_value is None:
            counter[0] += 1
        return fget(self)

    jarray.ArrayImpl._value = property(counting)
    try:
        yield counter
    finally:
        jarray.ArrayImpl._value = prop


def _peak_bytes():
    import jax

    stats = jax.devices()[0].memory_stats()
    return None if stats is None else stats.get("peak_bytes_in_use")


def run_phase(name, rows, fn, check, **extra):
    """Run ``fn`` twice (compile, then steady state), check the second
    result with ``check`` (raises on mismatch, returns the largest
    relative float error) and print the phase line."""
    t0 = time.perf_counter()
    _block(fn())
    first = time.perf_counter() - t0
    with count_host_syncs() as syncs:
        t0 = time.perf_counter()
        out = _block(fn())
        steady = time.perf_counter() - t0
    err = check(out)
    line = {"phase": name, "rows": rows, "first_s": first,
            "steady_s": steady, "peak_bytes_in_use": _peak_bytes(),
            "max_rel_err": err, "host_syncs": syncs[0], **extra}
    print("PHASE " + json.dumps(line), flush=True)
    return out


def _rel_err(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    err = np.abs(got - want) / np.maximum(np.abs(want), 1e-300)
    worst = float(err.max()) if err.size else 0.0
    assert worst <= F64_RTOL, f"float64 relative error {worst} > {F64_RTOL}"
    return worst


def _exact(got, want, what):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, f"{what}: shape {got.shape} != {want.shape}"
    bad = np.flatnonzero(got != want)
    assert bad.size == 0, (f"{what}: {bad.size} mismatches, first at "
                           f"{bad[0]}: {got[bad[0]]} != {want[bad[0]]}")


# ---------------------------------------------------------------- data

def tpch_arrays(sf, seed):
    """lineitem and orders as numpy columns, TPC-H cardinalities
    (SF x 6,000,000 lines, SF x 1,500,000 orders), only the columns Q1,
    Q3 and Q6 read. Prices are float64, not decimal(15,2)."""
    rng = np.random.default_rng(seed)
    n_o = int(sf * 1_500_000)
    n_l = int(sf * 6_000_000)
    okey = np.repeat(np.arange(n_o, dtype=np.int64),
                     rng.integers(1, 8, n_o))           # 1-7 lines/order
    if okey.size < n_l:
        okey = np.concatenate([okey, rng.integers(0, n_o, n_l - okey.size)])
    qty = rng.integers(1, 51, n_l)
    retail = rng.integers(90_000, 210_000, n_l) / 100.0
    lineitem = {
        "l_orderkey": okey[:n_l],
        "l_quantity": qty,
        "l_extendedprice": np.round(qty * retail, 2),
        "l_discount": rng.integers(0, 11, n_l) / 100.0,
        "l_returnflag": rng.integers(0, 3, n_l).astype(np.int32),
        "l_shipdate_days": rng.integers(SHIPDATE_LO, SHIPDATE_HI + 1, n_l),
    }
    orders = {
        "o_orderkey": np.arange(n_o, dtype=np.int64),
        "o_custkey": rng.integers(1, max(int(sf * 150_000), 2), n_o),
        "o_orderpriority": rng.integers(0, 5, n_o).astype(np.int32),
    }
    return lineitem, orders


def ingest(arrays, dictionaries):
    """numpy columns -> engine RecordBatch; ``dictionaries`` maps a
    column name to its host value pool (the column holds codes)."""
    import arrow1_tpu as a1t

    return a1t.record_batch({
        k: a1t.column(v, dictionary=dictionaries.get(k))
        for k, v in arrays.items()})


def ingest_tpch(sf, seed):
    li, od = tpch_arrays(sf, seed)
    return (li, od, ingest(li, {"l_returnflag": RETURNFLAGS}),
            ingest(od, {"o_orderpriority": PRIORITIES}))


def zipf_keys(rng, n, support):
    """n draws of a finite Zipf law with s = 1 over ranks 1..support,
    returned as 0-based ranks (numpy's zipf needs s > 1)."""
    cdf = np.cumsum(1.0 / np.arange(1, support + 1))
    cdf /= cdf[-1]
    return np.minimum(np.searchsorted(cdf, rng.random(n)), support - 1)


# ------------------------------------------------- numpy reference queries

def ref_q1(li):
    m = li["l_shipdate_days"] <= Q1_CUTOFF
    rows = []
    for code in np.argsort(RETURNFLAGS):
        sel = m & (li["l_returnflag"] == code)
        rows.append((RETURNFLAGS[code], int(li["l_quantity"][sel].sum()),
                     float(li["l_extendedprice"][sel].sum()),
                     int(sel.sum())))
    return rows


def ref_q3(li, od):
    prio = od["o_orderpriority"][li["l_orderkey"]]
    sums = np.bincount(prio, weights=li["l_extendedprice"],
                       minlength=len(PRIORITIES))
    counts = np.bincount(prio, minlength=len(PRIORITIES))
    order = np.argsort(-sums, kind="stable")
    return [(PRIORITIES[p], float(sums[p]), int(counts[p])) for p in order]


def ref_q6(li):
    d, q = li["l_discount"], li["l_quantity"]
    m = (d >= 0.02) & (d <= 0.09) & (q < 24)
    return {RETURNFLAGS[c]: float(li["l_extendedprice"][
        m & (li["l_returnflag"] == c)].sum()) for c in range(3)
        if (m & (li["l_returnflag"] == c)).any()}


def ref_group(keys, cols):
    """Per distinct key (ascending): {name: (fn, values)} -> arrays."""
    order = np.argsort(keys, kind="stable")
    ks = keys[order]
    starts = np.flatnonzero(np.r_[True, ks[1:] != ks[:-1]])
    out = {"__keys__": ks[starts],
           "__count__": np.diff(np.r_[starts, ks.size])}
    for name, (fn, vals) in cols.items():
        v = vals[order]
        out[name] = {"sum": np.add, "min": np.minimum,
                     "max": np.maximum}[fn].reduceat(v, starts)
    return out


# ---------------------------------------------------------------- phases

def _check_q1(li):
    want = ref_q1(li)

    def check(out):
        got = out.to_pydict()
        assert got["l_returnflag"] == [w[0] for w in want], got
        _exact(got["l_quantity_sum"], [w[1] for w in want], "q1 qty sum")
        _exact(got["l_quantity_count"], [w[3] for w in want], "q1 count")
        return _rel_err(got["l_extendedprice_sum"], [w[2] for w in want])
    return check


def _check_q3(li, od):
    want = ref_q3(li, od)

    def check(out):
        got = out.to_pydict()
        assert got["o_orderpriority"] == [w[0] for w in want], got
        _exact(got["l_orderkey_count"], [w[2] for w in want], "q3 count")
        return _rel_err(got["l_extendedprice_sum"], [w[1] for w in want])
    return check


def _check_q6(li):
    want = ref_q6(li)

    def check(out):
        got = out.to_pydict()
        assert sorted(got["l_returnflag"]) == sorted(want), got
        return _rel_err(got["l_extendedprice_sum"],
                        [want[f] for f in got["l_returnflag"]])
    return check


def phase_tpch(sizes, seed):
    """Q1, Q3 and Q6 from models/tpch.py through ``a1t.query``."""
    from arrow1_tpu.models.tpch import (q1_pricing_summary,
                                        q3_shipping_priority, q6_forecast)

    li, od, lb, ob = ingest_tpch(sizes.sf, seed)
    n = len(li["l_orderkey"])
    dev_bytes = sum(c.nbytes for c in lb.columns) + sum(
        c.nbytes for c in ob.columns)
    print(f"tpch: sf={sizes.sf} lineitem={n} orders={len(od['o_orderkey'])}"
          f" device_bytes={dev_bytes}; cut from the spec: only the columns"
          f" Q1/Q3/Q6 read, prices float64 not decimal(15,2)", flush=True)
    run_phase("tpch_q1", n, lambda: q1_pricing_summary(lb, Q1_CUTOFF),
              _check_q1(li))
    run_phase("tpch_q3", n, lambda: q3_shipping_priority(lb, ob),
              _check_q3(li, od))
    run_phase("tpch_q6", n, lambda: q6_forecast(lb), _check_q6(li))


def phase_pipeline(sizes, seed):
    """filter -> project -> group_by -> sort as one compiled program."""
    import arrow1_tpu as a1t
    from arrow1_tpu.exec.compiled import PipelineBuilder

    rng = np.random.default_rng(seed + 1)
    n = sizes.pipeline_rows
    v = rng.integers(-(1 << 30), 1 << 30, n)
    f = rng.standard_normal(n)
    for G in sizes.pipeline_groups:
        k = rng.integers(0, G, n)
        batch = ingest({"k": k, "v": v, "f": f}, {})
        pipe = (PipelineBuilder()
                .filter(a1t.field("f") > 0.0)
                .project([a1t.field("v") * 2 + 1], ["proj"])
                .group_by(["k"], [("proj", "sum"), ("v", "count")],
                          max_groups=G)
                .sort([("proj_sum", "descending")])
                .compile())
        m = f > 0
        want = ref_group(k[m], {"proj_sum": ("sum", v[m] * 2 + 1)})

        def check(out, want=want):
            got = out.to_pydict()
            order = np.argsort(got["k"])
            _exact(np.asarray(got["k"])[order], want["__keys__"], "keys")
            _exact(np.asarray(got["proj_sum"])[order], want["proj_sum"],
                   "proj sum")
            _exact(np.asarray(got["v_count"])[order], want["__count__"],
                   "count")
            s = np.asarray(got["proj_sum"])
            assert (s[1:] <= s[:-1]).all(), "not sorted descending"
            return 0.0

        run_phase(f"pipeline_G{G}", n, lambda: pipe(batch), check,
                  groups=G)


def phase_filter(sizes, seed):
    """BASELINE config 1 through ``ac.filter`` on an expression mask,
    timed beside a plain device copy of the same bytes."""
    import jax
    import jax.numpy as jnp

    import arrow1_tpu as a1t
    import arrow1_tpu.compute as ac

    rng = np.random.default_rng(seed + 2)
    n = sizes.filter_rows
    cols = {"k": rng.integers(0, 1 << 40, n),
            "v": rng.integers(-(1 << 30), 1 << 30, n),
            "f": rng.standard_normal(n)}
    batch = ingest(cols, {})
    pred = a1t.field("f") > 0.0
    proj = a1t.field("v") * 2 + a1t.field("f")

    def run():
        hot = ac.filter(batch, pred.execute(batch))
        return hot, proj.execute(hot)

    m = cols["f"] > 0

    def check(out):
        hot, p = out
        for name in cols:
            _exact(np.asarray(hot.column(name).data), cols[name][m], name)
        _exact(np.asarray(p.data), cols["v"][m] * 2 + cols["f"][m], "proj")
        return 0.0

    arrays = tuple(c.data for c in batch.columns)
    copy = jax.jit(lambda xs: tuple(jnp.copy(x) for x in xs))
    _block(copy(arrays))
    t0 = time.perf_counter()
    _block(copy(arrays))
    copy_s = time.perf_counter() - t0
    nbytes = sum(int(x.nbytes) for x in arrays)
    run_phase("filter_project", n, run, check, selectivity=float(m.mean()),
              copy_s=copy_s, copy_bytes_read=nbytes)


def phase_group_by(sizes, seed):
    """BASELINE config 2 through ``a1t.group_by``."""
    import arrow1_tpu as a1t

    rng = np.random.default_rng(seed + 3)
    n = sizes.groupby_rows
    v = rng.integers(-(1 << 40), 1 << 40, n)
    f = np.round(rng.uniform(0.0, 100.0, n), 2)
    aggs = [("v", "sum"), ("v", "count"), ("v", "min"), ("v", "max"),
            ("f", "sum")]
    for G in sizes.groupby_groups:
        k = rng.integers(0, G, n)
        batch = ingest({"k": k, "v": v, "f": f}, {})
        want = ref_group(k, {"v_sum": ("sum", v), "v_min": ("min", v),
                             "v_max": ("max", v), "f_sum": ("sum", f)})

        def check(out, want=want):
            got = out.to_pydict()
            order = np.argsort(got["k"])
            _exact(np.asarray(got["k"])[order], want["__keys__"], "keys")
            _exact(np.asarray(got["v_count"])[order], want["__count__"],
                   "count")
            for name in ("v_sum", "v_min", "v_max"):
                _exact(np.asarray(got[name])[order], want[name], name)
            return _rel_err(np.asarray(got["f_sum"])[order], want["f_sum"])

        run_phase(f"group_by_G{G}", n,
                  lambda: a1t.group_by(batch, ["k"], aggs), check, groups=G)


def phase_sort(sizes, seed):
    """BASELINE config 3: ``ac.sort_indices`` on (int64, dict-string)."""
    import arrow1_tpu.compute as ac

    rng = np.random.default_rng(seed + 4)
    n = sizes.sort_rows
    a = rng.integers(0, 1 << 20, n)             # many ties on the first key
    words = np.array([f"w{i:03d}" for i in rng.permutation(100)],
                     dtype=object)              # pool not in sorted order
    s = rng.integers(0, len(words), n).astype(np.int32)
    batch = ingest({"a": a, "s": s}, {"s": words})
    rank = np.argsort(np.argsort(words))[s]

    def check(out):
        idx = np.asarray(out.data).astype(np.int64)
        assert idx.shape == (n,), idx.shape
        assert (np.bincount(idx, minlength=n) == 1).all(), "not a permutation"
        a1, r1 = a[idx], rank[idx]
        gt = (a1[1:] > a1[:-1]) | ((a1[1:] == a1[:-1]) & (
            (r1[1:] > r1[:-1]) | ((r1[1:] == r1[:-1]) & (idx[1:] > idx[:-1]))))
        assert gt.all(), f"order broken at {np.flatnonzero(~gt)[:5]}"
        return 0.0

    run_phase("sort_indices", n,
              lambda: ac.sort_indices(batch, sort_keys=[("a", "ascending"),
                                                        ("s", "ascending")]),
              check)


def _pair_checksum(a, b):
    """Order-independent checksum of (a, b) row pairs (uint64 wrap)."""
    a = np.asarray(a).astype(np.uint64)
    b = np.asarray(b).astype(np.uint64)
    with np.errstate(over="ignore"):
        h = a * np.uint64(0x9E3779B97F4A7C15) ^ (b * np.uint64(0xBF58476D1CE4E5B9)
                                                + np.uint64(1))
        return int(h.sum(dtype=np.uint64))


def phase_join(sizes, seed):
    """BASELINE config 4: ``a1t.join``, probe keys Zipf (s = 1) over the
    build keys, inner and left outer."""
    import arrow1_tpu as a1t

    rng = np.random.default_rng(seed + 5)
    nb, npr = sizes.join_build, sizes.join_probe
    bkey = rng.permutation(nb).astype(np.int64)
    bpay = rng.integers(0, 1 << 40, nb)
    pkey = zipf_keys(rng, npr, nb).astype(np.int64)
    ppay = rng.integers(0, 1 << 40, npr)
    probe = ingest({"k": pkey, "p": ppay}, {})
    build = ingest({"k": bkey, "b": bpay}, {})
    bpay_of = np.empty(nb, np.int64)
    bpay_of[bkey] = bpay
    hot_share = float(np.mean(pkey == 0))
    want = _pair_checksum(ppay, bpay_of[pkey])

    def check(out):
        assert out.num_rows == npr, (out.num_rows, npr)
        got_b = out.column("b")
        if got_b.validity is not None:
            assert bool(np.asarray(got_b.validity).all()), "unmatched rows"
        _exact(_pair_checksum(out.column("p").data, got_b.data), want,
               "pair checksum")
        _exact(np.sort(np.asarray(out.column("k").data)), np.sort(pkey),
               "keys")
        return 0.0

    for how in ("inner", "left outer"):
        run_phase(f"join_{how.replace(' ', '_')}", npr,
                  lambda how=how: a1t.join(probe, build, keys=["k"],
                                           join_type=how),
                  check, build_rows=nb, hottest_key_share=hot_share)


SINGLE_PHASES = (phase_tpch, phase_pipeline, phase_filter, phase_group_by,
                 phase_sort, phase_join)


# ----------------------------------------------------- four-card phase

def _rows(batch, key):
    d = batch.to_pydict()
    order = np.argsort(np.asarray(d[key]), kind="stable")
    return {k: np.asarray(v)[order] for k, v in d.items()}


def _same(a, b, what, float_cols=()):
    assert a.keys() == b.keys(), (what, a.keys(), b.keys())
    err = 0.0
    for k in a:
        if k in float_cols:
            err = max(err, _rel_err(a[k], b[k]))
        else:
            _exact(a[k], b[k], f"{what}.{k}")
    return err


def phase_distributed(sizes, seed, mesh):
    """q1/q3 through exec/dist_compiled.py, the eager dist_filter ->
    dist_join -> dist_group_by -> dist_sort chain and the skew-salted
    dist_join, each compared with the one-device engine and with numpy."""
    import arrow1_tpu as a1t
    from arrow1_tpu.models.tpch import (q1_distributed, q1_pricing_summary,
                                        q3_distributed, q3_shipping_priority)
    from arrow1_tpu.parallel import (dist_filter, dist_group_by, dist_join,
                                     shard_batch)
    from arrow1_tpu.parallel.distributed import dist_sort

    D = mesh.devices.size
    li, od, lb, ob = ingest_tpch(sizes.sf, seed)
    n = len(li["l_orderkey"])
    lbs = shard_batch(lb, mesh)
    spread = {name: len(c.data.sharding.device_set)
              for name, c in zip(lbs.names, lbs.columns)}
    print(f"distributed: {D} devices, lineitem={n} rows; devices holding "
          f"each column: {spread}", flush=True)
    assert set(spread.values()) == {D}, spread

    # q1: one shard_map program
    one_q1 = _rows(q1_pricing_summary(lb, Q1_CUTOFF), "l_returnflag")
    check_q1 = _check_q1(li)

    def q1_check(out):
        err = check_q1(out)
        return max(err, _same(_rows(out, "l_returnflag"), one_q1, "q1",
                              ("l_extendedprice_sum",)))

    # group partials per (src, dst) pair: 3 return flags
    run_phase("dist_q1", n, lambda: q1_distributed(lbs, mesh, Q1_CUTOFF,
                                                   shuffle_cap=64),
              q1_check, devices=D)

    # q3: both sides shuffled by key; ~1/D of a shard per (src, dst) pair
    one_q3 = _rows(q3_shipping_priority(lb, ob), "o_orderpriority")
    check_q3 = _check_q3(li, od)
    cap = int(1.25 * n / D / D) + 1024

    def q3_check(out):
        err = check_q3(out)
        return max(err, _same(_rows(out, "o_orderpriority"), one_q3, "q3",
                              ("l_extendedprice_sum",)))

    run_phase("dist_q3", n, lambda: q3_distributed(
        lbs, ob, mesh, fanout=1, shuffle_cap=cap), q3_check, devices=D)

    # eager chain on a slice: filter -> join -> group_by -> sort
    m = min(sizes.dist_eager_rows, n)
    print(f"cut: the eager chain and the salted join read the first {m} "
          f"of {n} lineitem rows (run time)", flush=True)
    sub = {k: v[:m] for k, v in li.items()}
    sb = lb.slice(0, m)
    pred = a1t.field("l_quantity") < 24
    aggs = [("l_quantity", "sum"), ("l_extendedprice", "sum"),
            ("l_orderkey", "count")]

    def chain():
        hot = dist_filter(sb, pred, mesh)
        joined = dist_join(hot, ob, keys=["l_orderkey"],
                           right_keys=["o_orderkey"], mesh=mesh)
        agg = dist_group_by(joined, ["o_orderpriority"], aggs, mesh)
        return dist_sort(agg, [("l_extendedprice_sum", "descending")], mesh)

    one = a1t.compute.filter(sb, pred.execute(sb))
    one = a1t.group_by(a1t.join(one, ob, keys=["l_orderkey"],
                                right_keys=["o_orderkey"]),
                       ["o_orderpriority"], aggs)
    one_chain = _rows(one, "o_orderpriority")
    keep = sub["l_quantity"] < 24
    prio = od["o_orderpriority"][sub["l_orderkey"][keep]]
    ref = {"o_orderpriority": PRIORITIES[np.unique(prio)].astype(object),
           "l_quantity_sum": np.bincount(prio, sub["l_quantity"][keep]),
           "l_extendedprice_sum": np.bincount(
               prio, sub["l_extendedprice"][keep]),
           "l_orderkey_count": np.bincount(prio)}

    def chain_check(out):
        got = _rows(out, "o_orderpriority")
        s = out.to_pydict()["l_extendedprice_sum"]
        assert all(x >= y for x, y in zip(s, s[1:])), "not sorted"
        err = _same(got, one_chain, "chain", ("l_extendedprice_sum",))
        _exact(got["o_orderpriority"], ref["o_orderpriority"], "chain keys")
        _exact(got["l_orderkey_count"], ref["l_orderkey_count"][
            np.unique(prio)], "chain count")
        _exact(got["l_quantity_sum"], ref["l_quantity_sum"][
            np.unique(prio)].astype(np.int64), "chain qty")
        return max(err, _rel_err(got["l_extendedprice_sum"],
                                 ref["l_extendedprice_sum"][np.unique(prio)]))

    run_phase("dist_eager_chain", m, chain, chain_check, devices=D)

    # skew-salted join: 10% of probe rows on 4 hot order keys
    rng = np.random.default_rng(seed + 6)
    hot_keys = sub["l_orderkey"].copy()
    hot = rng.random(m) < 0.10
    hot_keys[hot] = rng.integers(0, 4, int(hot.sum()))
    probe = ingest({"l_orderkey": hot_keys,
                    "l_quantity": sub["l_quantity"]}, {})
    want = _pair_checksum(sub["l_quantity"],
                          od["o_custkey"][hot_keys])

    def salted_check(out):
        assert out.num_rows == m, (out.num_rows, m)
        _exact(_pair_checksum(out.column("l_quantity").data,
                              out.column("o_custkey").data), want,
               "salted pair checksum")
        return 0.0

    one_salted = a1t.join(probe, ob, keys=["l_orderkey"],
                          right_keys=["o_orderkey"])
    salted_check(one_salted)
    run_phase("dist_salted_join", m, lambda: dist_join(
        probe, ob, keys=["l_orderkey"], right_keys=["o_orderkey"],
        mesh=mesh), salted_check, devices=D, hot_row_share=float(hot.mean()))


# ----------------------------------------------------------------- main

def _setup(rehearse, devices):
    """Environment before JAX starts: the CPU and virtual devices for a
    rehearsal; nothing for the card."""
    if rehearse:
        os.environ["JAX_PLATFORMS"] = "cpu"
        if devices > 1:
            os.environ["XLA_FLAGS"] = (
                os.environ.get("XLA_FLAGS", "")
                + f" --xla_force_host_platform_device_count={devices}")


def _card_line():
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60)
        return out.stdout.strip() or out.stderr.strip()
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi unavailable ({type(e).__name__})"


def check_devices(rehearse, devices):
    """The first JAX call: the platform and device count asked for."""
    import jax

    devs = jax.devices()
    want = "cpu" if rehearse else "gpu"
    if devs[0].platform != want:
        raise SystemExit(f"chip_smoke: expected platform {want!r}, JAX "
                         f"found {devs[0].platform!r} "
                         f"({devs[0].device_kind}); use --rehearse on CPU")
    if len(devs) < devices:
        raise SystemExit(f"chip_smoke: asked for {devices} devices, JAX "
                         f"found {len(devs)}")
    return devs[:devices]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--devices", type=int, default=1, choices=(1, 4),
                    help="4 runs the distributed phase alone")
    ap.add_argument("--rehearse", action="store_true",
                    help="CPU at tiny sizes (tests)")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    _setup(args.rehearse, args.devices)
    print(_card_line(), flush=True)
    devs = check_devices(args.rehearse, args.devices)

    import jax

    import arrow1_tpu
    from arrow1_tpu.config import enable_compile_cache
    from arrow1_tpu.native import native_available

    print(f"jax {jax.__version__}; XLA_FLAGS={os.environ.get('XLA_FLAGS')!r};"
          f" compile cache {enable_compile_cache()}; native_available="
          f"{native_available()}; devices {[d.device_kind for d in devs]}",
          flush=True)
    sizes = REHEARSE if args.rehearse else FULL
    if args.devices > 1:
        from arrow1_tpu.parallel import make_mesh

        phase_distributed(sizes, args.seed, make_mesh(args.devices))
    else:
        for phase in SINGLE_PHASES:
            phase(sizes, args.seed)
    del arrow1_tpu
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}))


if __name__ == "__main__":
    main()

"""Staged group-by (exec/staged_groupby.py) vs the fused compiled
pipeline: BIT-identical outputs on both position paths (VERDICT r4 #4 —
the staged driver exists to kill the 1552 s fused compile at G=1M
without changing results)."""

import numpy as np
import pyarrow as pa
import pytest

import jax.numpy as jnp

import arrow1_tpu as a1t
from arrow1_tpu.errors import Invalid
from arrow1_tpu.exec.compiled import PipelineBuilder
from arrow1_tpu.exec.staged_groupby import staged_group_by


def _batch(n, G, seed, with_nulls=True):
    rng = np.random.default_rng(seed)
    vals = rng.standard_normal(n)
    return a1t.record_batch(pa.record_batch({
        "k": pa.array(rng.integers(0, G, n), pa.int64()),
        "k2": pa.array(rng.integers(0, 7, n), pa.int64()),
        "v": pa.array([None if with_nulls and rng.random() < 0.07
                       else float(x) for x in vals], pa.float64()),
        "w": pa.array(rng.integers(-100, 100, n), pa.int64()),
        "b": pa.array(rng.random(n) < 0.5),
    }))


AGGS = [("v", "sum"), ("v", "count"), ("v", "min"), ("w", "max"),
        ("v", "mean"), ("w", "sum"), ("v", "variance"),
        ("v", "stddev"), ("b", "any"), ("b", "all")]


def _check_identical(batch, keys, aggs, G):
    out, gv, ovf = staged_group_by(batch, keys, aggs, max_groups=G)
    pipe = PipelineBuilder().group_by(keys, aggs, max_groups=G).compile()
    st, live, o2 = pipe._trace(batch)
    ng, ng2 = int(jnp.sum(gv)), int(jnp.sum(live))
    assert ng == ng2
    assert bool(ovf) == bool(o2)
    for name in st.names:
        a = np.asarray(out.column(name).data)[:ng]
        c = np.asarray(st.column(name).data)[:ng]
        assert a.dtype == c.dtype, name
        if name.endswith(("_variance", "_stddev")):
            # separately-compiled programs may FMA-contract the
            # s2/n - mean^2 expression differently: allow 1 ULP
            ulp = np.abs(a.view(np.int64) - c.view(np.int64))
            assert ulp.max(initial=0) <= 1, (name, ulp.max())
        else:
            assert np.array_equal(a, c, equal_nan=True), \
                (name, a[:5], c[:5])
        va, vb = out.column(name).validity, st.column(name).validity
        assert (va is None) == (vb is None), name
        if va is not None:
            assert np.array_equal(np.asarray(va)[:ng],
                                  np.asarray(vb)[:ng]), name


class TestStagedGroupBy:
    def test_small_g_identical(self):
        _check_identical(_batch(20_000, 300, 1), ["k"], AGGS, 512)

    def test_multikey_identical(self):
        _check_identical(_batch(8_000, 40, 2), ["k", "k2"], AGGS, 512)

    def test_big_g_compact_path_identical(self):
        _check_identical(_batch(140_000, 70_000, 3),
                         ["k"], [("v", "sum"), ("v", "count"),
                                 ("v", "min"), ("v", "max")], 70_000)

    def test_oracle_parity_pyarrow(self):
        import pyarrow.compute as pc  # noqa: F401

        b = _batch(30_000, 1_000, 4)
        out, gv, _ = staged_group_by(
            b, ["k"], [("v", "sum"), ("v", "count"), ("w", "min")],
            max_groups=2_000)
        ng = int(jnp.sum(gv))
        t = pa.table(b.to_arrow())
        exp = t.group_by("k", use_threads=False).aggregate(
            [("v", "sum"), ("v", "count"), ("w", "min")])
        got_k = np.asarray(out.column("k").data)[:ng]
        g = {int(k): i for i, k in enumerate(got_k)}
        e = {int(k): i for i, k in enumerate(exp["k"].to_pylist())}
        assert set(g) == set(e)
        vs = np.asarray(out.column("v_sum").data)[:ng]
        ev = exp["v_sum"].to_pylist()
        for k in g:
            assert vs[g[k]] == pytest.approx(ev[e[k]], rel=1e-9,
                                             abs=1e-9)
        wc = np.asarray(out.column("w_min").data)[:ng]
        ew = exp["w_min"].to_pylist()
        for k in g:
            assert wc[g[k]] == ew[e[k]]

    def test_rejects_binary_keys(self):
        b = a1t.record_batch(pa.record_batch({
            "s": pa.array(["a", "b", "a"]),
            "v": pa.array([1.0, 2.0, 3.0])}))
        with pytest.raises(Invalid):
            staged_group_by(b, ["s"], [("v", "sum")])

    def test_plan_cache_reuse(self):
        from arrow1_tpu.exec.staged_groupby import _PLANS

        b1 = _batch(4_000, 100, 5)
        b2 = _batch(4_000, 100, 6)
        before = len(_PLANS)
        staged_group_by(b1, ["k"], [("v", "sum")], max_groups=128)
        mid = len(_PLANS)
        staged_group_by(b2, ["k"], [("v", "sum")], max_groups=128)
        assert len(_PLANS) == mid  # second call reuses the plan
        assert mid == before + 1

"""TPC-H-style end-to-end pipelines (BASELINE config 5, single-host form).

scan -> filter -> join -> aggregate -> sort, through three execution
styles: eager ops, the exec-plan graph, and the distributed operators on
the 8-device mesh — all cross-checked against a pyarrow/Acero oracle.
"""

import numpy as np
import pyarrow as pa
import pyarrow.compute as pc
import pytest

import arrow1_tpu as a1t
import arrow1_tpu.compute as ac
from arrow1_tpu.parallel import (dist_filter, dist_group_by, dist_join,
                                 make_mesh)
from arrow1_tpu.parallel.distributed import dist_sort
from arrow1_tpu.testing import RandomDataGenerator
from test_groupby_join import assert_same_rows


def make_lineitem(n=600, seed=1):
    gen = RandomDataGenerator(seed)
    rng = gen.rng
    return pa.record_batch({
        "l_orderkey": pa.array(rng.integers(0, n // 4, n).astype(np.int64)),
        "l_quantity": pa.array(rng.integers(1, 51, n).astype(np.int64)),
        "l_extendedprice": pa.array(
            np.round(rng.uniform(1.0, 1000.0, n), 2)),
        "l_discount": pa.array(np.round(rng.uniform(0.0, 0.1, n), 2)),
        "l_returnflag": pa.array(
            rng.choice(["A", "N", "R"], n).tolist()),
        "l_shipdate_days": pa.array(
            rng.integers(8000, 11000, n).astype(np.int64)),
    })


def make_orders(n=150, seed=2):
    gen = RandomDataGenerator(seed)
    rng = gen.rng
    return pa.record_batch({
        "o_orderkey": pa.array(np.arange(n, dtype=np.int64)),
        "o_custkey": pa.array(rng.integers(0, 30, n).astype(np.int64)),
        "o_orderpriority": pa.array(
            rng.choice(["1-URGENT", "2-HIGH", "3-NORMAL"], n).tolist()),
    })


def q1_oracle(li):
    """Q1-like: filter by shipdate, group by returnflag, sum/avg."""
    filtered = li.filter(pc.less_equal(li.column("l_shipdate_days"),
                                       pa.scalar(10000)))
    t = pa.Table.from_batches([filtered])
    return t.group_by(["l_returnflag"]).aggregate(
        [("l_quantity", "sum"), ("l_extendedprice", "sum"),
         ("l_quantity", "count")])


class TestQ1:
    def test_eager(self):
        li = make_lineitem()
        b = a1t.record_batch(li)
        mask = (a1t.field("l_shipdate_days") <= 10000).execute(b)
        hot = ac.filter(b, mask)
        got = a1t.group_by(hot, ["l_returnflag"],
                           [("l_quantity", "sum"), ("l_extendedprice", "sum"),
                            ("l_quantity", "count")])
        g = sorted(got.to_arrow().to_pylist(), key=lambda r: r["l_returnflag"])
        e = sorted(q1_oracle(li).to_pylist(), key=lambda r: r["l_returnflag"])
        assert len(g) == len(e)
        for a, b_ in zip(g, e):
            assert a["l_returnflag"] == b_["l_returnflag"]
            assert a["l_quantity_sum"] == b_["l_quantity_sum"]
            assert a["l_quantity_count"] == b_["l_quantity_count"]
            assert a["l_extendedprice_sum"] == pytest.approx(
                b_["l_extendedprice_sum"])

    def test_exec_plan(self):
        from arrow1_tpu.exec import Declaration

        li = make_lineitem()
        b = a1t.record_batch(li)
        decl = Declaration("aggregate", {
            "keys": ["l_returnflag"],
            "aggregates": [("l_quantity", "sum"), ("l_quantity", "count")],
        }, [Declaration("filter",
                        {"predicate": a1t.field("l_shipdate_days") <= 10000},
                        [Declaration("source", {"batches": [b]})])])
        got = decl.to_table().combine_chunks()
        e = {r["l_returnflag"]: r for r in q1_oracle(li).to_pylist()}
        for row in got.to_arrow().to_pylist():
            assert row["l_quantity_sum"] == e[row["l_returnflag"]][
                "l_quantity_sum"]

    def test_distributed(self):
        mesh = make_mesh(8)
        li = make_lineitem()
        b = a1t.record_batch(li)
        hot = dist_filter(b, a1t.field("l_shipdate_days") <= 10000, mesh)
        got = dist_group_by(hot, ["l_returnflag"],
                            [("l_quantity", "sum"), ("l_quantity", "count")],
                            mesh)
        e = {r["l_returnflag"]: r for r in q1_oracle(li).to_pylist()}
        rows = got.to_arrow().to_pylist()
        assert len(rows) == len(e)
        for row in rows:
            assert row["l_quantity_sum"] == e[row["l_returnflag"]][
                "l_quantity_sum"]


def q3_oracle(li, orders):
    lt = pa.Table.from_batches([li])
    ot = pa.Table.from_batches([orders])
    joined = lt.join(ot, keys=["l_orderkey"], right_keys=["o_orderkey"])
    agg = joined.group_by(["o_orderpriority"]).aggregate(
        [("l_extendedprice", "sum"), ("l_orderkey", "count")])
    return agg.sort_by([("l_extendedprice_sum", "descending")])


class TestQ3:
    def test_eager_full_pipeline(self):
        li, orders = make_lineitem(), make_orders()
        lb, ob = a1t.record_batch(li), a1t.record_batch(orders)
        joined = a1t.join(lb, ob, keys=["l_orderkey"],
                          right_keys=["o_orderkey"])
        agg = a1t.group_by(joined, ["o_orderpriority"],
                           [("l_extendedprice", "sum"),
                            ("l_orderkey", "count")])
        idx = ac.sort_indices(
            agg, sort_keys=[("l_extendedprice_sum", "descending")])
        got = ac.take(agg, ac.cast(idx, a1t.int64))
        exp = q3_oracle(li, orders)
        g = got.to_arrow().to_pylist()
        e = exp.to_pylist()
        assert len(g) == len(e)
        for a, b_ in zip(g, e):
            assert a["o_orderpriority"] == b_["o_orderpriority"]
            assert a["l_orderkey_count"] == b_["l_orderkey_count"]
            assert a["l_extendedprice_sum"] == pytest.approx(
                b_["l_extendedprice_sum"])

    def test_distributed_full_pipeline(self):
        mesh = make_mesh(8)
        li, orders = make_lineitem(seed=5), make_orders(seed=6)
        lb, ob = a1t.record_batch(li), a1t.record_batch(orders)
        joined = dist_join(lb, ob, keys=["l_orderkey"],
                           right_keys=["o_orderkey"], mesh=mesh)
        agg = dist_group_by(joined, ["o_orderpriority"],
                            [("l_extendedprice", "sum"),
                             ("l_orderkey", "count")], mesh)
        result = dist_sort(agg,
                           [("l_extendedprice_sum", "descending")], mesh)
        exp = q3_oracle(li, orders)
        g = result.to_arrow().to_pylist()
        e = exp.to_pylist()
        assert len(g) == len(e)
        for a, b_ in zip(g, e):
            assert a["o_orderpriority"] == b_["o_orderpriority"]
            assert a["l_orderkey_count"] == b_["l_orderkey_count"]
            assert a["l_extendedprice_sum"] == pytest.approx(
                b_["l_extendedprice_sum"])

    def test_one_dispatch_distributed(self):
        """models.tpch.q3_distributed: the whole join->agg->sort->limit
        pipeline as ONE shard_map program (VERDICT r1 next #8)."""
        from arrow1_tpu.models.tpch import q3_distributed

        mesh = make_mesh(8)
        li, orders = make_lineitem(seed=5), make_orders(seed=6)
        lb, ob = a1t.record_batch(li), a1t.record_batch(orders)
        result = q3_distributed(lb, ob, mesh=mesh, fanout=4, top_n=3)
        exp = q3_oracle(li, orders).to_pylist()[:3]
        g = result.to_arrow().to_pylist()
        assert len(g) == len(exp)
        for a, b_ in zip(g, exp):
            assert a["o_orderpriority"] == b_["o_orderpriority"]
            assert a["l_orderkey_count"] == b_["l_orderkey_count"]
            assert a["l_extendedprice_sum"] == pytest.approx(
                b_["l_extendedprice_sum"])

    def test_q1_one_dispatch_distributed(self):
        from arrow1_tpu.models.tpch import q1_distributed

        mesh = make_mesh(8)
        li = make_lineitem(seed=8)
        result = q1_distributed(a1t.record_batch(li), mesh=mesh)
        e = {r["l_returnflag"]: r for r in q1_oracle(li).to_pylist()}
        rows = result.to_arrow().to_pylist()
        assert len(rows) == len(e)
        flags = [r["l_returnflag"] for r in rows]
        assert flags == sorted(flags)
        for row in rows:
            o = e[row["l_returnflag"]]
            assert row["l_quantity_sum"] == o["l_quantity_sum"]
            assert row["l_quantity_count"] == o["l_quantity_count"]
            assert row["l_extendedprice_sum"] == pytest.approx(
                o["l_extendedprice_sum"])

    def test_scan_from_parquet_dataset(self, tmp_path):
        from arrow1_tpu import io as aio
        from arrow1_tpu.dataset import ScannerBuilder, dataset

        li = make_lineitem()
        aio.write_parquet(a1t.record_batch(li), str(tmp_path / "li.parquet"))
        ds = dataset(str(tmp_path / "li.parquet"))
        scanner = ScannerBuilder(ds).filter(
            a1t.field("l_quantity") > 25).finish()
        tbl = scanner.to_table().combine_chunks()
        exp = li.filter(pc.greater(li.column("l_quantity"), pa.scalar(25)))
        assert tbl.num_rows == exp.num_rows


class TestQ1PallasPath:
    def test_eager_with_kernel_filter(self):
        """Q1 through the eager filter on a second seed — the filter
        composes inside real pipelines, not just unit tests."""
        li = make_lineitem(seed=21)
        b = a1t.record_batch(li)
        mask = (a1t.field("l_shipdate_days") <= 10000).execute(b)
        hot = ac.filter(b, mask)
        got = a1t.group_by(hot, ["l_returnflag"],
                           [("l_quantity", "sum"), ("l_quantity", "count")])
        e = {r["l_returnflag"]: r for r in q1_oracle(li).to_pylist()}
        rows = got.to_arrow().to_pylist()
        assert len(rows) == len(e)
        for row in rows:
            assert row["l_quantity_sum"] == e[row["l_returnflag"]][
                "l_quantity_sum"]
            assert row["l_quantity_count"] == e[row["l_returnflag"]][
                "l_quantity_count"]


def test_distributed_matches_eager_at_scale(mesh_or_none=None):
    """Config-5 de-risk: q1/q3 distributed == eager at 200K rows."""
    import pyarrow as pa

    from arrow1_tpu.models.tpch import (q1_distributed, q1_pricing_summary,
                                        q3_distributed,
                                        q3_shipping_priority)
    from arrow1_tpu.parallel import make_mesh

    mesh = make_mesh(8)
    N = 100_000
    rng = np.random.default_rng(0)
    lineitem = a1t.record_batch(pa.record_batch({
        "l_orderkey": pa.array(rng.integers(0, 10_000, N).astype(np.int64)),
        "l_shipdate_days": pa.array(rng.integers(0, 5000, N)
                                    .astype(np.int64)),
        "l_returnflag": pa.array(rng.integers(0, 3, N).astype(np.int64)),
        "l_quantity": pa.array(rng.integers(1, 50, N).astype(np.int64)),
        "l_extendedprice": pa.array(rng.standard_normal(N) * 100),
    }))
    orders = a1t.record_batch(pa.record_batch({
        "o_orderkey": pa.array(np.arange(10_000, dtype=np.int64)),
        "o_orderpriority": pa.array(rng.integers(0, 5, 10_000)
                                    .astype(np.int64)),
    }))
    e1 = q1_pricing_summary(lineitem, 2500).to_arrow()
    d1 = q1_distributed(lineitem, mesh, 2500).to_arrow()
    assert e1.num_rows == d1.num_rows
    np.testing.assert_allclose(
        np.array(e1["l_quantity_sum"].to_pylist(), float),
        np.array(d1["l_quantity_sum"].to_pylist(), float))
    e3 = q3_shipping_priority(lineitem, orders, top_n=5).to_arrow()
    d3 = q3_distributed(lineitem, orders, mesh, fanout=2,
                        top_n=5).to_arrow()
    np.testing.assert_allclose(
        np.array(e3["l_extendedprice_sum"].to_pylist(), float),
        np.array(d3["l_extendedprice_sum"].to_pylist(), float),
        rtol=1e-9)

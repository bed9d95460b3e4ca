"""TPC-H-style query templates (simplified schemas).

Each builder takes engine tables and returns the result batch; shapes
follow the classic queries (filter -> [join] -> aggregate -> sort), the
same pipeline family as BASELINE config 5.
"""

from __future__ import annotations

from ..expr import field
from ..query import query

__all__ = ["q1_pricing_summary", "q3_shipping_priority", "q6_forecast",
           "q1_distributed", "q3_distributed"]


def q1_pricing_summary(lineitem, ship_cutoff_days: int = 10000):
    """Q1: pricing summary report.

    select returnflag, sum(qty), sum(extendedprice), count(*)
    where shipdate <= cutoff group by returnflag order by returnflag
    """
    return (query(lineitem)
            .filter(field("l_shipdate_days") <= ship_cutoff_days)
            .group_by(["l_returnflag"],
                      [("l_quantity", "sum"), ("l_extendedprice", "sum"),
                       ("l_quantity", "count")])
            .order_by([("l_returnflag", "ascending")])
            .to_batch())


def q3_shipping_priority(lineitem, orders, top_n: int = 10):
    """Q3: shipping priority — join lineitem x orders, revenue per
    priority, descending."""
    return (query(lineitem)
            .join(orders, keys=["l_orderkey"], right_keys=["o_orderkey"])
            .group_by(["o_orderpriority"],
                      [("l_extendedprice", "sum"), ("l_orderkey", "count")])
            .order_by([("l_extendedprice_sum", "descending")])
            .limit(top_n)
            .to_batch())


def q6_forecast(lineitem, min_discount: float = 0.02,
                max_discount: float = 0.09, max_quantity: int = 24):
    """Q6: forecasting revenue change — pure filter + aggregate."""
    return (query(lineitem)
            .filter((field("l_discount") >= min_discount)
                    & (field("l_discount") <= max_discount)
                    & (field("l_quantity") < max_quantity))
            .group_by(["l_returnflag"], [("l_extendedprice", "sum")])
            .to_batch())


def q1_distributed(lineitem, mesh=None, ship_cutoff_days: int = 10000,
                   shuffle_cap=None):
    """Q1 as ONE distributed shard_map program over the mesh (config 5:
    the whole filter -> group_by -> sort stage is a single dispatch;
    shuffles are all_to_alls inside the program). ``shuffle_cap`` bounds
    the partial groups one shard sends another."""
    from ..exec.dist_compiled import DistPipelineBuilder

    pipe = (DistPipelineBuilder(mesh)
            .filter(field("l_shipdate_days") <= ship_cutoff_days)
            .group_by(["l_returnflag"],
                      [("l_quantity", "sum"), ("l_extendedprice", "sum"),
                       ("l_quantity", "count")],
                      shuffle_cap=shuffle_cap)
            .sort([("l_returnflag", "ascending")])
            .compile())
    return pipe(lineitem)


def q3_distributed(lineitem, orders, mesh=None, fanout: int = 2,
                   shuffle_cap=None, top_n: int = 10):
    """Q3 as one distributed program: join + group_by + sort + limit all
    inside a single shard_map dispatch (the distributed join's both-side
    shuffle and the aggregation shuffle are internal all_to_alls)."""
    from ..exec.dist_compiled import DistPipelineBuilder

    pipe = (DistPipelineBuilder(mesh)
            .join(orders, keys=["l_orderkey"], right_keys=["o_orderkey"],
                  fanout=fanout, shuffle_cap=shuffle_cap)
            .group_by(["o_orderpriority"],
                      [("l_extendedprice", "sum"), ("l_orderkey", "count")])
            .sort([("l_extendedprice_sum", "descending")])
            .limit(top_n)
            .compile())
    return pipe(lineitem)


def q5_local_supplier_volume(lineitem, orders, customers, top_n: int = 10):
    """Q5-like: multi-join (lineitem x orders x customers) -> revenue per
    customer segment, descending."""
    step1 = (query(lineitem)
             .join(orders, keys=["l_orderkey"], right_keys=["o_orderkey"])
             .to_batch())
    return (query(step1)
            .join(customers, keys=["o_custkey"], right_keys=["c_custkey"])
            .group_by(["c_segment"], [("l_extendedprice", "sum")])
            .order_by([("l_extendedprice_sum", "descending")])
            .limit(top_n)
            .to_batch())

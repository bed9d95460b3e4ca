"""Engine-level group-by parity on dense-range integer and dictionary keys
(the shapes a dense-key grouped sum would serve), through a1t.group_by.
Oracle: pyarrow TableGroupBy.aggregate."""

import numpy as np
import pyarrow as pa
import pytest

import arrow1_tpu as a1t


def _sorted_pylist(tbl):
    if isinstance(tbl, pa.RecordBatch):
        tbl = pa.Table.from_batches([tbl])
    rows = [tuple(sorted(d.items())) for d in tbl.to_pylist()]
    return sorted(rows, key=repr)


def _assert_same(got, expected):
    g = _sorted_pylist(got.to_arrow())
    e = _sorted_pylist(expected)
    assert len(g) == len(e)
    for a, b in zip(g, e):
        assert a == b, (a, b)


def _run(rb, keys, aggs):
    got = a1t.group_by(a1t.record_batch(rb), keys, aggs)
    oracle = pa.Table.from_batches([rb]).group_by(keys).aggregate(aggs)
    _assert_same(got, oracle)


class TestMxuGroupBy:
    @pytest.mark.parametrize("aggs", [
        [("v", "sum"), ("v", "count"), ("v", "mean")],
        [("v", "sum"), ("v", "count")],
    ])
    def test_int_key_sum_count_mean(self, rng, aggs):
        n = 4000
        rb = pa.record_batch({
            "k": pa.array(rng.integers(-50, 50, n), type=pa.int64()),
            "v": pa.array(rng.integers(-(1 << 40), 1 << 40, n),
                          type=pa.int64()),
        })
        _run(rb, ["k"], aggs)

    def test_null_key_and_values(self, rng):
        n = 2000
        k = rng.integers(0, 20, n).astype(float)
        k[rng.random(n) < 0.1] = np.nan
        v = rng.integers(0, 1000, n).astype(float)
        v[rng.random(n) < 0.3] = np.nan
        rb = pa.record_batch({
            "k": pa.array([None if np.isnan(x) else int(x) for x in k],
                          type=pa.int32()),
            "v": pa.array([None if np.isnan(x) else int(x) for x in v],
                          type=pa.int16()),
        })
        _run(rb, ["k"], [("v", "sum"), ("v", "count"), ("v", "mean")])

    def test_dict_key(self, rng):
        n = 1000
        codes = rng.integers(0, 5, n)
        words = ["aa", "bb", "cc", "dd", "ee"]
        rb = pa.record_batch({
            "k": pa.array([words[c] for c in codes]).dictionary_encode(),
            "v": pa.array(rng.integers(0, 100, n), type=pa.int64()),
        })
        _run(rb, ["k"], [("v", "sum")])

    def test_uint_and_small_dtypes(self, rng):
        n = 3000
        rb = pa.record_batch({
            "k": pa.array(rng.integers(0, 300, n), type=pa.uint16()),
            "a": pa.array(rng.integers(0, 250, n), type=pa.uint8()),
            "b": pa.array(rng.integers(-128, 127, n), type=pa.int8()),
        })
        _run(rb, ["k"], [("a", "sum"), ("b", "sum"), ("b", "mean"),
                         ("a", "count")])

    def test_int64_extremes_wraparound(self):
        # pyarrow sum wraps mod 2^64 (C++ int64 accumulate); match it
        rb = pa.record_batch({
            "k": pa.array([0, 0, 1], type=pa.int64()),
            "v": pa.array([(1 << 62), (1 << 62), -5], type=pa.int64()),
        })
        _run(rb, ["k"], [("v", "sum")])

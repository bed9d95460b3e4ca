"""Grouped sum/count/min/max grids against numpy, through ``a1t.group_by``
and the compiled pipeline's group_by. The grids cover group count, value
bit width, nulls in keys and values, int64 wraparound, float sums of
small groups, and dead (filtered) rows."""

import jax.numpy as jnp
import numpy as np
import pytest

import arrow1_tpu as a1t
from arrow1_tpu.exec.compiled import PipelineBuilder


def _ref(keys, vals, valid=None):
    """{key: (sum wrapping mod 2^64, count, min, max)} over valid rows."""
    out = {}
    for k in np.unique(keys):
        sel = keys == k
        if valid is not None:
            sel &= valid
        v = vals[sel]
        with np.errstate(over="ignore"):
            s = v.sum() if v.size else None
        out[k] = (s, int(sel.sum()),
                  v.min() if v.size else None, v.max() if v.size else None)
    return out


def _values(c):
    """Host values of a column, None where null."""
    data = np.asarray(c.data).tolist()
    if c.validity is None:
        return data
    return [x if ok else None
            for x, ok in zip(data, np.asarray(c.validity).tolist())]


def _got(batch, key="k", col="v"):
    keys = _values(batch.column(key))
    cols = [_values(batch.column(f"{col}_{fn}"))
            for fn in ("sum", "count", "min", "max")]
    return {k: tuple(c[i] for c in cols) for i, k in enumerate(keys)}


AGGS = [("v", "sum"), ("v", "count"), ("v", "min"), ("v", "max")]


@pytest.mark.parametrize("G", [1, 7, 300, 5000, 70_000])
def test_group_count_grid(G):
    rng = np.random.default_rng(G)
    n = max(2 * G, 2000)
    k = rng.integers(0, G, n)
    v = rng.integers(-(1 << 40), 1 << 40, n)
    got = _got(a1t.group_by(a1t.record_batch({"k": k, "v": v}), ["k"],
                            AGGS))
    want = _ref(k, v)
    assert got.keys() == want.keys()
    for key in want:
        assert got[key] == tuple(int(x) for x in want[key]), key


@pytest.mark.parametrize("bits", [7, 8, 15, 16, 31, 32, 39, 63])
def test_value_bit_width_grid(bits):
    rng = np.random.default_rng(bits)
    n = 3000
    k = rng.integers(0, 128, n)
    v = rng.integers(0, 1 << bits, n, dtype=np.uint64).astype(np.int64)
    got = _got(a1t.group_by(a1t.record_batch({"k": k, "v": v}), ["k"],
                            AGGS))
    want = _ref(k, v)
    for key in want:
        assert got[key] == tuple(int(x) for x in want[key]), key


@pytest.mark.parametrize("dtype", [np.int8, np.int16, np.int32, np.uint8,
                                   np.uint16, np.uint32])
def test_narrow_value_dtypes(dtype):
    rng = np.random.default_rng(3)
    n = 4000
    info = np.iinfo(dtype)
    k = rng.integers(0, 50, n)
    v = rng.integers(info.min, info.max, n, endpoint=True).astype(dtype)
    got = _got(a1t.group_by(a1t.record_batch({"k": k, "v": v}), ["k"],
                            AGGS))
    want = _ref(k, v.astype(np.int64))
    for key in want:
        assert got[key] == tuple(int(x) for x in want[key]), key


@pytest.mark.parametrize("extreme", ["max", "min", "mixed"])
def test_int64_wraparound(extreme):
    """Sums wrap mod 2^64 like the reference's int64 accumulator."""
    rng = np.random.default_rng(5)
    n = 1000
    k = rng.integers(0, 4, n)
    lim = np.iinfo(np.int64)
    if extreme == "max":
        v = np.full(n, lim.max, np.int64)
    elif extreme == "min":
        v = np.full(n, lim.min, np.int64)
    else:
        v = np.where(rng.random(n) < 0.5, lim.max, lim.min).astype(np.int64)
    got = _got(a1t.group_by(a1t.record_batch({"k": k, "v": v}), ["k"],
                            AGGS))
    want = _ref(k, v)
    for key in want:
        assert got[key] == tuple(int(x) for x in want[key]), key


@pytest.mark.parametrize("null_share", [0.0, 0.3, 1.0])
def test_null_values(null_share):
    rng = np.random.default_rng(7)
    n = 3000
    k = rng.integers(0, 40, n)
    v = rng.integers(-1000, 1000, n)
    valid = rng.random(n) >= null_share
    batch = a1t.RecordBatch(
        (a1t.column(k), a1t.column(v).with_validity(jnp.asarray(valid))),
        ("k", "v"))
    got = _got(a1t.group_by(batch, ["k"], AGGS))
    want = _ref(k, v, valid)
    for key, (s, c, lo, hi) in want.items():
        assert got[key][1] == c
        if c:
            assert got[key] == (int(s), c, int(lo), int(hi)), key
        else:
            assert got[key] == (None, 0, None, None), key


def test_null_keys_form_one_group():
    rng = np.random.default_rng(8)
    n = 2000
    k = rng.integers(0, 10, n)
    kvalid = rng.random(n) >= 0.1
    v = rng.integers(0, 100, n)
    batch = a1t.RecordBatch(
        (a1t.column(k).with_validity(jnp.asarray(kvalid)), a1t.column(v)),
        ("k", "v"))
    out = a1t.group_by(batch, ["k"], [("v", "sum"), ("v", "count")])
    got = dict(zip(_values(out.column("k")),
                   zip(_values(out.column("v_sum")),
                       _values(out.column("v_count")))))
    assert got[None] == (int(v[~kvalid].sum()), int((~kvalid).sum()))
    for key in np.unique(k[kvalid]):
        sel = kvalid & (k == key)
        assert got[key] == (int(v[sel].sum()), int(sel.sum()))


@pytest.mark.parametrize("G", [3, 1000, 70_000])
def test_float_sums_of_small_groups(G):
    """Each group's float sum carries only its own rounding error, not
    that of the running total of every earlier row."""
    rng = np.random.default_rng(G)
    n = 150_000
    k = rng.integers(0, G, n)
    v = np.round(rng.uniform(0.0, 1000.0, n), 2)
    d = a1t.group_by(a1t.record_batch({"k": k, "v": v}), ["k"],
                     [("v", "sum")]).to_pydict()
    order = np.argsort(k, kind="stable")
    ks = k[order]
    starts = np.flatnonzero(np.r_[True, ks[1:] != ks[:-1]])
    want = dict(zip(ks[starts], np.add.reduceat(v[order], starts)))
    for key, s in zip(d["k"], d["v_sum"]):
        assert s == pytest.approx(want[key], rel=1e-12)


@pytest.mark.parametrize("G", [16, 70_000])
@pytest.mark.parametrize("dead_share", [0.0, 0.5, 0.99])
def test_compiled_group_by_dead_rows(G, dead_share):
    """Rows filtered out before the group_by never reach a group."""
    rng = np.random.default_rng(11)
    n = 140_000
    k = rng.integers(0, G, n)
    v = rng.integers(-(1 << 40), 1 << 40, n)
    u = rng.random(n)
    batch = a1t.record_batch({"k": k, "v": v, "u": u})
    out = (PipelineBuilder().filter(a1t.field("u") >= dead_share)
           .group_by(["k"], AGGS, max_groups=G).compile())(batch)
    live = u >= dead_share
    got = _got(out)
    want = _ref(k[live], v[live])
    assert got.keys() == want.keys()
    for key in want:
        assert got[key] == tuple(int(x) for x in want[key]), key

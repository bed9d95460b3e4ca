"""Filter exactness grids against numpy boolean indexing, on the three
filter forms that run on the device: the jit-composable
``filter_indices_padded``, the eager ``ac.filter`` and the compiled
pipeline's filter. The grids cover length, selectivity, blocky masks,
int64 / float64 / narrow / dictionary columns, validity, and empty and
full selections."""

import jax.numpy as jnp
import numpy as np
import pytest

import arrow1_tpu as a1t
import arrow1_tpu.compute as ac
from arrow1_tpu.exec.compiled import PipelineBuilder
from arrow1_tpu.ops.selection import filter_indices_padded

SELECTIVITIES = (0.0, 0.01, 0.5, 0.99, 1.0)


def _mask(n, sel, seed):
    rng = np.random.default_rng(seed)
    if sel in (0.0, 1.0):
        return np.full(n, bool(sel))
    return rng.random(n) < sel


# lengths straddle the blocked-scan switch (NATIVE_SCAN_MAX = 262144)
@pytest.mark.parametrize("n", [1, 7, 1000, 4097, 300_000])
@pytest.mark.parametrize("sel", SELECTIVITIES)
def test_filter_indices_padded(n, sel):
    m = _mask(n, sel, n)
    idx, count = filter_indices_padded(jnp.asarray(m))
    count = int(count)
    assert count == int(m.sum())
    np.testing.assert_array_equal(np.asarray(idx)[:count], np.flatnonzero(m))
    assert (np.asarray(idx)[count:] == n).all()     # OOB pad sentinel


@pytest.mark.parametrize("run", [1, 3, 64, 1000, 5000])
def test_filter_indices_padded_blocky(run):
    """Alternating runs of selected / unselected rows."""
    n = 20_000
    m = (np.arange(n) // run) % 2 == 0
    idx, count = filter_indices_padded(jnp.asarray(m))
    count = int(count)
    np.testing.assert_array_equal(np.asarray(idx)[:count], np.flatnonzero(m))


def _column(kind, n, rng, nulls):
    valid = rng.random(n) >= 0.2 if nulls else None
    if kind == "int64":
        data = rng.integers(-(1 << 62), 1 << 62, n)
        col = a1t.column(data)
    elif kind == "float64":
        data = rng.standard_normal(n)
        col = a1t.column(data)
    elif kind == "int32":
        data = rng.integers(-(1 << 31), 1 << 31, n).astype(np.int32)
        col = a1t.column(data)
    elif kind == "bool":
        data = rng.random(n) < 0.5
        col = a1t.column(data)
    else:  # dictionary string
        words = np.array(["x", "yy", "zzz", "w"], dtype=object)
        data = words[rng.integers(0, 4, n)]
        col = a1t.column(rng.integers(0, 4, n), dictionary=words)
        data = col.to_numpy()
    if valid is not None:
        col = col.with_validity(jnp.asarray(valid))
    return col, data, valid


@pytest.mark.parametrize("kind", ["int64", "float64", "int32", "bool",
                                  "string"])
@pytest.mark.parametrize("sel", [0.0, 0.5, 1.0])
@pytest.mark.parametrize("nulls", [False, True], ids=["dense", "nulls"])
def test_ac_filter_column(kind, sel, nulls):
    rng = np.random.default_rng(hash((kind, sel, nulls)) % (1 << 32))
    n = 3000
    col, data, valid = _column(kind, n, rng, nulls)
    m = _mask(n, sel, 5)
    out = ac.filter(col, a1t.column(m))
    assert out.length == int(m.sum())
    got_valid = (np.ones(out.length, bool) if out.validity is None
                 else np.asarray(out.validity))
    want_valid = np.ones(n, bool)[m] if valid is None else valid[m]
    np.testing.assert_array_equal(got_valid, want_valid)
    got = out.to_numpy() if kind == "string" else np.asarray(out.data)
    np.testing.assert_array_equal(got[want_valid], np.asarray(data)[m][
        want_valid])


@pytest.mark.parametrize("behavior", ["drop", "emit_null"])
def test_ac_filter_null_mask(behavior):
    """A null mask slot drops the row, or emits it as a null row."""
    rng = np.random.default_rng(9)
    n = 2000
    v = rng.integers(0, 1 << 40, n)
    m = rng.random(n) < 0.5
    mvalid = rng.random(n) >= 0.3
    mask = a1t.column(m).with_validity(jnp.asarray(mvalid))
    out = ac.filter(a1t.column(v), mask,
                    null_selection_behavior=behavior)
    if behavior == "drop":
        keep = m & mvalid
        np.testing.assert_array_equal(np.asarray(out.data), v[keep])
    else:
        keep = m | ~mvalid
        np.testing.assert_array_equal(np.asarray(out.data)[mvalid[keep]],
                                      v[keep & mvalid])
        np.testing.assert_array_equal(np.asarray(out.validity),
                                      mvalid[keep])


@pytest.mark.parametrize("sel", SELECTIVITIES)
def test_ac_filter_record_batch(sel):
    """int64 + float64 + dictionary columns filtered together."""
    rng = np.random.default_rng(21)
    n = 5000
    cols = {"k": rng.integers(0, 1 << 40, n), "f": rng.standard_normal(n),
            "s": np.array(["a", "b", "c"])[rng.integers(0, 3, n)]}
    batch = a1t.record_batch(cols)
    m = _mask(n, sel, 22)
    out = ac.filter(batch, a1t.column(m))
    assert out.num_rows == int(m.sum())
    got = out.to_pydict()
    for name, want in cols.items():
        np.testing.assert_array_equal(np.asarray(got[name], dtype=want.dtype),
                                      want[m])


@pytest.mark.parametrize("kind", ["int64", "float64"])
@pytest.mark.parametrize("sel", SELECTIVITIES)
def test_compiled_pipeline_filter(kind, sel):
    rng = np.random.default_rng(31)
    n = 4000
    v = (rng.integers(-(1 << 62), 1 << 62, n) if kind == "int64"
         else rng.standard_normal(n))
    u = rng.random(n)
    thresh = 1.0 - sel if sel < 1.0 else -1.0
    batch = a1t.record_batch({"u": u, "v": v})
    pipe = PipelineBuilder().filter(a1t.field("u") >= thresh).compile()
    out = pipe(batch)
    m = u >= thresh
    assert out.num_rows == int(m.sum())
    np.testing.assert_array_equal(np.asarray(out.column("v").data), v[m])


@pytest.mark.parametrize("nulls_in", ["values", "predicate"])
def test_compiled_pipeline_filter_validity(nulls_in):
    """Null predicate slots drop the row; null values ride through."""
    rng = np.random.default_rng(41)
    n = 3000
    v = rng.integers(0, 1 << 40, n)
    u = rng.random(n)
    valid = rng.random(n) >= 0.25
    vcol, ucol = a1t.column(v), a1t.column(u)
    if nulls_in == "values":
        vcol = vcol.with_validity(jnp.asarray(valid))
        keep = u < 0.5
    else:
        ucol = ucol.with_validity(jnp.asarray(valid))
        keep = (u < 0.5) & valid
    batch = a1t.RecordBatch((ucol, vcol), ("u", "v"))
    out = PipelineBuilder().filter(a1t.field("u") < 0.5).compile()(batch)
    assert out.num_rows == int(keep.sum())
    got = out.column("v")
    if nulls_in == "values":
        np.testing.assert_array_equal(np.asarray(got.validity), valid[keep])
        np.testing.assert_array_equal(np.asarray(got.data)[valid[keep]],
                                      v[keep & valid])
    else:
        np.testing.assert_array_equal(np.asarray(got.data), v[keep])

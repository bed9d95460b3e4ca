"""Per-kernel roofline profiler (arrow1_tpu/profiler.py)."""

import numpy as np
import pytest

import arrow1_tpu as a1t
import arrow1_tpu.compute as ac
from arrow1_tpu.profiler import (KernelProfiler, KernelRecord,
                                 hbm_peak_bytes_per_sec)


def test_records_eager_dispatches():
    a = a1t.column(np.arange(10000, dtype=np.int64))
    b = a1t.column(np.ones(10000, dtype=np.int64))
    with KernelProfiler() as prof:
        ac.add(a, b)
        ac.add(a, b)
        ac.multiply(a, b)
    names = [r.name for r in prof.records]
    assert names == ["add", "add", "multiply"]
    r = prof.records[0]
    # two 80 KB inputs + one 80 KB output
    assert r.bytes_in == 2 * 80000
    assert r.bytes_out >= 80000
    assert r.wall_s > 0


def test_no_overhead_when_inactive():
    a = a1t.column([1, 2, 3])
    with KernelProfiler() as prof:
        pass
    ac.add(a, a)  # outside the context
    assert prof.records == []


def test_nesting_restores_outer():
    a = a1t.column([1, 2, 3])
    with KernelProfiler() as outer:
        ac.add(a, a)
        with KernelProfiler() as inner:
            ac.negate(a)
        ac.add(a, a)
    assert [r.name for r in outer.records] == ["add", "add"]
    assert [r.name for r in inner.records] == ["negate"]


def test_summary_and_report():
    a = a1t.column(np.arange(4096, dtype=np.float64))
    with KernelProfiler() as prof:
        for _ in range(3):
            ac.add(a, a)
        ac.sum(a)
    rows = prof.summary()
    by_name = {r["kernel"]: r for r in rows}
    assert by_name["add"]["calls"] == 3
    assert by_name["add"]["mb_moved"] > 0
    # the CPU has no roofline: the share is "not measured", not a guess
    assert by_name["add"]["best_roofline_frac"] is None
    text = prof.report()
    assert "add" in text and "roof%" in text and "n/a" in text


def test_roofline_math():
    r = KernelRecord("x", wall_s=0.001, bytes_in=40_000_000,
                     bytes_out=10_000_000)
    # 50 MB in 1 ms = 50 GB/s; at a 50 GB/s nominal peak -> frac 1.0
    assert abs(r.roofline_frac(50e9) - 1.0) < 1e-9


def test_peak_lookup_cpu():
    assert hbm_peak_bytes_per_sec() is None
    assert KernelRecord("x", 0.001, 1, 1).roofline_frac(None) is None


def _fake_device(kind, platform="gpu"):
    from types import SimpleNamespace

    return SimpleNamespace(platform=platform, device_kind=kind)


@pytest.mark.parametrize("kind,peak", [
    ("NVIDIA H100 80GB HBM3", 3.35e12),
    ("NVIDIA H100 SXM5 80GB", 3.35e12),
    ("NVIDIA H100 PCIe", 2.0e12),
])
def test_peak_lookup_h100(kind, peak):
    assert hbm_peak_bytes_per_sec(_fake_device(kind)) == peak


@pytest.mark.parametrize("kind", ["NVIDIA A100-SXM4-80GB", "AMD Instinct MI300X",
                                  "NVIDIA H100 NVL"])
def test_peak_lookup_unknown_kind_raises(kind):
    with pytest.raises(ValueError, match="no published memory bandwidth"):
        hbm_peak_bytes_per_sec(_fake_device(kind))


def test_batch_datums_accounted():
    rb = a1t.record_batch({"x": np.arange(1000, dtype=np.int64),
                           "y": np.arange(1000, dtype=np.float64)})
    mask = a1t.column(np.arange(1000) % 2 == 0)
    with KernelProfiler() as prof:
        ac.filter(rb, mask)
    (r,) = prof.records
    assert r.name == "filter"
    assert r.bytes_in >= 16000 + 1000  # two 8 KB columns + bool mask
    assert r.bytes_out > 0

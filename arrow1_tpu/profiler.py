"""Per-kernel roofline profiler for the eager compute path.

Reference: the tracing/metrics subsystem (SURVEY.md §5; the reference's
util/tracing_internal.h spans + benchmark counters). The number that
matters for a memory-bound columnar engine is each kernel's achieved
device-memory bandwidth as a fraction of the device roofline — this
module records exactly that for every `call_function` dispatch inside
the context:

    with KernelProfiler() as prof:
        ac.add(a, b)
        ac.filter(batch, mask)
    prof.report()        # per-kernel: calls, ms, MB moved, roofline %
                         # (roofline "n/a" where the device has none)

Bytes are accounted from the pytree leaves of the input/output datums
(device-array nbytes — the engine's columns are pytrees). Wall time
blocks on the result, so profiled runs serialize dispatch (same caveat
as the reference's benchmark counters).
"""

from __future__ import annotations

import functools
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

__all__ = ["KernelProfiler", "KernelRecord", "hbm_peak_bytes_per_sec"]

# Published peak device-memory bandwidth, matched on the device_kind
# that JAX reports (NVIDIA H100 data sheet: SXM5 80 GB HBM3 3.35 TB/s,
# PCIe 80 GB HBM2e 2.0 TB/s). First match wins, so the PCIe entry leads.
HBM_PEAK = (
    ("H100 PCIe", 2.0e12),
    ("H100 80GB HBM3", 3.35e12),
    ("H100 SXM", 3.35e12),
)


def hbm_peak_bytes_per_sec(device=None) -> Optional[float]:
    """Roofline denominator for a device, in bytes/s.

    None on the CPU (no roofline: "not measured"); an accelerator whose
    device_kind is not in HBM_PEAK raises rather than guessing."""
    import jax

    dev = device if device is not None else jax.devices()[0]
    if dev.platform == "cpu":
        return None
    kind = str(dev.device_kind)
    for key, peak in HBM_PEAK:
        if key in kind:
            return peak
    raise ValueError(f"no published memory bandwidth for device kind "
                     f"{kind!r}; add it to profiler.HBM_PEAK with its "
                     f"source")


def _tree_nbytes(x) -> int:
    import jax

    total = 0
    for leaf in jax.tree_util.tree_leaves(x):
        nb = getattr(leaf, "nbytes", None)
        if nb is not None:
            total += int(nb)
    return total


@dataclass
class KernelRecord:
    name: str
    wall_s: float
    bytes_in: int
    bytes_out: int

    @property
    def bytes_moved(self) -> int:
        return self.bytes_in + self.bytes_out

    def roofline_frac(self, peak: Optional[float]) -> Optional[float]:
        if peak is None:
            return None
        if self.wall_s <= 0:
            return 0.0
        return (self.bytes_moved / self.wall_s) / peak


@dataclass
class _Agg:
    calls: int = 0
    wall_s: float = 0.0
    bytes_moved: int = 0
    best_frac: Optional[float] = None


_active = threading.local()


def _current() -> Optional["KernelProfiler"]:
    return getattr(_active, "profiler", None)


class KernelProfiler:
    """Context manager collecting one KernelRecord per eager dispatch."""

    def __init__(self, device=None):
        self.records: List[KernelRecord] = []
        self._device = device
        self._prev = None

    @functools.cached_property
    def peak(self) -> Optional[float]:
        return hbm_peak_bytes_per_sec(self._device)

    def __enter__(self):
        self._prev = _current()
        _active.profiler = self
        return self

    def __exit__(self, *exc):
        _active.profiler = self._prev
        return False

    # called from registry.call_function
    def _measure(self, name: str, runner, datums):
        import jax

        bytes_in = sum(_tree_nbytes(d) for d in datums)
        jax.block_until_ready(
            [leaf for d in datums
             for leaf in jax.tree_util.tree_leaves(d)
             if hasattr(leaf, "block_until_ready")])
        t0 = time.perf_counter()
        out = runner()
        jax.block_until_ready(
            [leaf for leaf in jax.tree_util.tree_leaves(out)
             if hasattr(leaf, "block_until_ready")])
        wall = time.perf_counter() - t0
        self.records.append(KernelRecord(
            name, wall, bytes_in, _tree_nbytes(out)))
        return out

    # -- reporting --
    def by_kernel(self) -> Dict[str, _Agg]:
        out: Dict[str, _Agg] = {}
        for r in self.records:
            agg = out.setdefault(r.name, _Agg())
            agg.calls += 1
            agg.wall_s += r.wall_s
            agg.bytes_moved += r.bytes_moved
            frac = r.roofline_frac(self.peak)
            if frac is not None:
                agg.best_frac = max(agg.best_frac or 0.0, frac)
        return out

    def summary(self) -> List[dict]:
        rows = []
        for name, a in sorted(self.by_kernel().items(),
                              key=lambda kv: -kv[1].wall_s):
            rows.append({
                "kernel": name,
                "calls": a.calls,
                "total_ms": round(a.wall_s * 1e3, 3),
                "mb_moved": round(a.bytes_moved / 1e6, 3),
                "avg_gbps": round(
                    a.bytes_moved / a.wall_s / 1e9, 2) if a.wall_s else 0.0,
                "best_roofline_frac": None if a.best_frac is None
                else round(a.best_frac, 4),
            })
        return rows

    def report(self) -> str:
        lines = [f"{'kernel':<24}{'calls':>6}{'ms':>10}{'MB':>10}"
                 f"{'GB/s':>8}{'roof%':>7}"]
        for row in self.summary():
            frac = row["best_roofline_frac"]
            roof = "n/a" if frac is None else f"{100 * frac:.1f}%"
            lines.append(
                f"{row['kernel']:<24}{row['calls']:>6}"
                f"{row['total_ms']:>10.3f}{row['mb_moved']:>10.3f}"
                f"{row['avg_gbps']:>8.2f}{roof:>7}")
        return "\n".join(lines)

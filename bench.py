"""Flagship benchmark: fused filter+project throughput (BASELINE config 1).

Prints ONE JSON line:
  {"metric": ..., "value": rows/sec, "unit": "rows/s", "vs_baseline": frac,
   "device": {"platform", "kind", "count"}}

vs_baseline = achieved_bytes_per_sec / (0.80 * published peak) — 1.0
means the operator meets the BASELINE target of 80% of the memory
roofline on this device. It is null where the device has no published
peak (the CPU): "not measured".

Method: one jitted step (predicate -> plain XLA compaction -> gathers ->
projection -> a full reduction that consumes the projection), compiled
once, then timed per call to ``block_until_ready``; the median of the
timed calls is reported.

Traffic accounting per row (roofline denominator):
  read  key int64 (8) + v int64 (8) + f float64 (8)       = 24 B
  write compacted key+proj at selectivity s (16 * s)
"""

import json
import os
import statistics
import time

import numpy as np


def main():
    import jax
    import jax.numpy as jnp

    import arrow1_tpu  # noqa: F401  (x64 on)
    from arrow1_tpu.config import enable_compile_cache
    from arrow1_tpu.ops.padded import filter_padded
    from arrow1_tpu.profiler import hbm_peak_bytes_per_sec

    enable_compile_cache()
    N = int(os.environ.get("A1T_BENCH_ROWS", 10_000_000))
    REPS = int(os.environ.get("A1T_BENCH_ITERS", 5))
    # selectivity grid knob (reference harness shape: selectivity x size
    # grids, vector_selection_benchmark.cc:157)
    SEL = float(os.environ.get("A1T_BENCH_SEL", 0.5))

    rng = np.random.default_rng(0)
    key = jnp.asarray(rng.integers(0, 1 << 40, N).astype(np.int64))
    v = jnp.asarray(rng.integers(-(1 << 30), 1 << 30, N).astype(np.int64))
    f = jnp.asarray(rng.standard_normal(N))
    thresh = float(np.quantile(np.asarray(f), 1.0 - SEL))

    @jax.jit
    def step(thresh, key, v, f):
        idx, count = filter_padded(f > thresh)
        out_key, out_v, out_f = key[idx], v[idx], f[idx]
        proj = out_v.astype(jnp.float64) * 2.0 + out_f
        live = jnp.arange(N) < count
        return count, out_key, jnp.sum(jnp.where(live, proj, 0.0))

    z = jnp.float64(thresh)
    jax.block_until_ready(step(z, key, v, f))  # compile + warm
    times = []
    for _ in range(REPS):
        t0 = time.perf_counter()
        count, _, _ = jax.block_until_ready(step(z, key, v, f))
        times.append(time.perf_counter() - t0)
    per_call = statistics.median(times)

    sel = int(count) / N
    rows_per_sec = N / per_call
    achieved_bw = rows_per_sec * (24 + 16 * sel)
    dev = jax.devices()[0]
    peak = hbm_peak_bytes_per_sec(dev)
    print(json.dumps({
        "metric": "filter_project_rows_per_sec",
        "value": rows_per_sec,
        "unit": "rows/s",
        "selectivity": sel,
        "vs_baseline": None if peak is None else achieved_bw / (0.80 * peak),
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
    }))


if __name__ == "__main__":
    main()

"""Operator benchmark harness.

Replicates the *shape* of the reference's benchmark infrastructure
(SURVEY.md §6): Google-Benchmark-style grids (size x selectivity x
null-proportion, cf. vector_selection_benchmark.cc:157-263 and
util/benchmark_util.h RegressionArgs) emitting rows/sec + bytes/sec per
case, as JSON consumable by compare.py (the `archery benchmark diff`
analogue, dev/archery/archery/benchmark/).

Usage:
  python benchmarks/run_benchmarks.py [--rows N] [--out results.json]
        [--ops filter,take,sort,groupby,join,unique,aggregate]

Each case is one jitted program on the plain XLA path, compiled once
and then timed over a few calls to ``block_until_ready``; the median is
reported. The output names the device it ran on.
"""

from __future__ import annotations

import argparse
import json
import os
import platform
import statistics
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _timed(fn, args, reps=5):
    """Median seconds per call of jit(fn)(*args), compile excluded."""
    import jax

    f = jax.jit(fn)
    jax.block_until_ready(f(*args))  # compile + warm
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(f(*args))
        ts.append(time.perf_counter() - t0)
    return statistics.median(ts)


def bench_filter(n, results):
    import jax.numpy as jnp

    from arrow1_tpu.ops.selection import filter_indices_padded

    rng = np.random.default_rng(0)
    v = jnp.asarray(rng.integers(-(1 << 30), 1 << 30, n).astype(np.int64))
    f = jnp.asarray(rng.standard_normal(n))
    for sel in (0.01, 0.5, 0.99):
        thresh = float(np.quantile(np.asarray(f), 1 - sel))

        def fn(v, f, thresh=thresh):
            idx, count = filter_indices_padded(f > thresh)
            return v[idx], count

        per = _timed(fn, (v, f))
        results.append({
            "benchmark": f"FilterInt64/sel={sel}", "rows_per_sec": n / per,
            "bytes_per_sec": n * (16 + 8 * sel) / per, "rows": n})


def bench_take(n, results):
    import jax.numpy as jnp

    rng = np.random.default_rng(1)
    v = jnp.asarray(rng.integers(0, 1 << 40, n).astype(np.int64))
    idx = jnp.asarray(rng.integers(0, n, n).astype(np.int32))

    per = _timed(lambda v, idx: v[idx], (v, idx))
    results.append({"benchmark": "TakeInt64/random", "rows_per_sec": n / per,
                    "bytes_per_sec": n * 20 / per, "rows": n})


def bench_sort(n, results):
    import jax.numpy as jnp

    rng = np.random.default_rng(2)
    narrow = jnp.asarray(rng.integers(0, 100, n).astype(np.int64))
    wide = jnp.asarray(rng.integers(0, 1 << 60, n).astype(np.int64))
    for name, arr in [("narrow", narrow), ("wide", wide)]:
        per = _timed(jnp.argsort, (arr,))
        results.append({"benchmark": f"ArraySortIndicesInt64/{name}",
                        "rows_per_sec": n / per,
                        "bytes_per_sec": n * 16 / per, "rows": n})


def bench_groupby(n, results):
    import jax.numpy as jnp

    rng = np.random.default_rng(3)
    for ngroups in (1_000, 1_000_000):
        gid = jnp.asarray(rng.integers(0, ngroups, n).astype(np.int32))
        v = jnp.asarray(rng.integers(-100, 100, n).astype(np.int64))

        def fn(gid, v, ngroups=ngroups):
            s = jnp.zeros(ngroups, jnp.int64).at[gid].add(v)
            c = jnp.zeros(ngroups, jnp.int64).at[gid].add(1)
            return s, c

        per = _timed(fn, (gid, v))
        results.append({"benchmark": f"GroupBySum/groups={ngroups}",
                        "rows_per_sec": n / per,
                        "bytes_per_sec": n * 12 / per, "rows": n})


def bench_join(n, results):
    import jax.numpy as jnp

    rng = np.random.default_rng(4)
    nb = max(n // 10, 1)
    probe = jnp.asarray(rng.integers(0, nb, n).astype(np.int64))
    build = jnp.asarray(rng.permutation(nb).astype(np.int64))

    def fn(probe, build):
        order = jnp.argsort(build)
        return order, jnp.searchsorted(build[order], probe)

    per = _timed(fn, (probe, build))
    results.append({"benchmark": f"HashJoinProbe/build={nb}",
                    "rows_per_sec": n / per,
                    "bytes_per_sec": n * 16 / per, "rows": n})


def bench_unique(n, results):
    import jax.numpy as jnp

    rng = np.random.default_rng(5)
    v = jnp.asarray(rng.integers(0, 10_000, n).astype(np.int64))

    def fn(v):
        s = jnp.sort(v)
        return jnp.sum(s[1:] != s[:-1]) + 1

    per = _timed(fn, (v,))
    results.append({"benchmark": "UniqueInt64", "rows_per_sec": n / per,
                    "bytes_per_sec": n * 8 / per, "rows": n})


def bench_aggregate(n, results):
    import jax.numpy as jnp

    rng = np.random.default_rng(6)
    v = jnp.asarray(rng.integers(-100, 100, n).astype(np.int64))
    f = jnp.asarray(rng.standard_normal(n))
    for name, arr in [("SumKernelInt64", v), ("SumKernelDouble", f)]:
        per = _timed(jnp.sum, (arr,))
        results.append({"benchmark": name, "rows_per_sec": n / per,
                        "bytes_per_sec": n * 8 / per, "rows": n})


BENCHES = {
    "filter": bench_filter, "take": bench_take, "sort": bench_sort,
    "groupby": bench_groupby, "join": bench_join, "unique": bench_unique,
    "aggregate": bench_aggregate,
}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--rows", type=int, default=10_000_000)
    ap.add_argument("--out", default=None)
    ap.add_argument("--ops", default=",".join(BENCHES))
    args = ap.parse_args()

    import jax

    import arrow1_tpu  # noqa: F401  (x64)
    from arrow1_tpu.config import enable_compile_cache

    enable_compile_cache()

    results = []
    for op in args.ops.split(","):
        BENCHES[op.strip()](args.rows, results)
        print(f"[{op}] done", file=sys.stderr)

    payload = {
        "context": {
            "platform": jax.devices()[0].platform,
            "device_kind": jax.devices()[0].device_kind,
            "device_count": len(jax.devices()),
            "hostname": platform.node(),
            "timestamp": time.time(),
        },
        "benchmarks": results,
    }
    text = json.dumps(payload, indent=2)
    if args.out:
        with open(args.out, "w") as fh:
            fh.write(text)
    print(text)


if __name__ == "__main__":
    main()

"""Two-process jax.distributed worker (spawned by test_multiprocess.py).

Runs the config-5 style pipeline (filter -> join -> group_by -> sort)
through the distributed operators on a 2-process x 4-local-device CPU
topology (8 global devices), exercising exactly the code paths a real
multi-host accelerator job runs: jax.distributed init, global mesh spanning
non-addressable devices, gloo collectives under shard_map, and
allgather-based result egress (SURVEY.md §4.6 multi-node-without-a-
cluster; reference analogue: Flight client+server in one process,
flight/flight_test.cc).

Usage: python multiproc_worker.py <pid> <nproc> <port> <out.feather>
Process 0 writes the pipeline result for the parent to compare.
"""

import os
import sys


def main():
    pid, nproc, port, out = (int(sys.argv[1]), int(sys.argv[2]),
                             sys.argv[3], sys.argv[4])
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_num_cpu_devices", 4)
    os.environ["COORDINATOR_ADDRESS"] = f"localhost:{port}"
    os.environ["NUM_PROCESSES"] = str(nproc)
    os.environ["PROCESS_ID"] = str(pid)

    from arrow1_tpu.parallel import multihost

    multihost.initialize()
    info = multihost.process_info()
    assert info["process_count"] == nproc, info
    assert info["global_devices"] == 4 * nproc, info

    import numpy as np
    import pyarrow as pa

    import arrow1_tpu as a1t
    from arrow1_tpu.parallel import dist_filter, dist_group_by, dist_join
    from arrow1_tpu.parallel.distributed import dist_sort

    mesh = multihost.global_mesh()

    # multihost helper surface: broadcast + barrier round-trip
    token = multihost.broadcast_from_host0(np.asarray([42], np.int32))
    assert int(token[0]) == 42
    multihost.barrier("pipeline-start")

    facts_rb, dims_rb = make_tables()
    facts = a1t.record_batch(facts_rb)
    dims = a1t.record_batch(dims_rb)

    hot = dist_filter(facts, a1t.field("v") > -60, mesh)
    joined = dist_join(hot, dims, "k", join_type="inner", mesh=mesh)
    agg = dist_group_by(joined, ["cat"],
                        [("v", "sum"), ("v", "count"), ("w", "min")], mesh)
    result = dist_sort(agg, [("cat", "ascending")], mesh)

    multihost.barrier("pipeline-done")
    if pid == 0:
        import pyarrow.feather as feather

        feather.write_feather(pa.Table.from_batches([result.to_arrow()]),
                              out)
    print(f"[p{pid}] pipeline ok: {result.num_rows} groups", flush=True)


def make_tables(n=1600, m=40, seed=7):
    """Deterministic tables, identical in every process (range-ingest via
    local_row_range is exercised separately in the parent test)."""
    import numpy as np
    import pyarrow as pa

    rng = np.random.default_rng(seed)
    facts = pa.record_batch({
        "k": pa.array(rng.integers(0, m, n)),
        "v": pa.array(rng.integers(-100, 100, n)),
        "w": pa.array(rng.normal(size=n)),
    })
    dims = pa.record_batch({
        "k": pa.array(np.arange(m, dtype=np.int64)),
        "cat": pa.array((np.arange(m) % 5).astype(np.int64)),
    })
    return facts, dims


if __name__ == "__main__":
    main()

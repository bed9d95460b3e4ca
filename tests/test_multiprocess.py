"""Two-process jax.distributed validation (VERDICT r1 missing #4 / next #7).

Spawns two OS processes, each owning 4 CPU devices, joined into one
8-device global mesh via jax.distributed + gloo. The full distributed
pipeline (filter -> join -> group_by -> sort) must produce exactly the
single-process engine's rows. SURVEY.md §4.6 prescribes this
multi-process-on-one-host strategy as the stand-in for N-host pods."""

import os
import socket
import subprocess
import sys

import pyarrow as pa
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "multiproc_worker.py")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.mark.slow
def test_two_process_pipeline(tmp_path):
    out = str(tmp_path / "result.feather")
    port = _free_port()
    env = {k: v for k, v in os.environ.items()
           if k not in ("XLA_FLAGS", "JAX_PLATFORMS")}
    # scripts run by path don't put the repo on sys.path; preserve the
    # existing PYTHONPATH
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    procs = [subprocess.Popen(
        [sys.executable, WORKER, str(pid), "2", str(port), out],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for pid in range(2)]
    outputs = []
    for p in procs:
        try:
            stdout, _ = p.communicate(timeout=600)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        outputs.append(stdout.decode(errors="replace"))
    for pid, (p, text) in enumerate(zip(procs, outputs)):
        assert p.returncode == 0, f"worker {pid} failed:\n{text[-4000:]}"

    # single-process oracle: the eager engine on the same data
    import arrow1_tpu as a1t
    from multiproc_worker import make_tables
    from test_groupby_join import assert_same_rows

    facts_rb, dims_rb = make_tables()
    facts = a1t.record_batch(facts_rb)
    dims = a1t.record_batch(dims_rb)
    mask = (a1t.field("v") > -60).execute(facts)
    hot = a1t.compute.filter(facts, mask)
    joined = a1t.join(hot, dims, "k", join_type="inner")
    agg = a1t.group_by(joined, ["cat"],
                       [("v", "sum"), ("v", "count"), ("w", "min")])

    import pyarrow.feather as feather

    got = feather.read_table(out)
    exp = agg.to_arrow()
    assert got.num_rows == exp.num_rows
    assert_same_rows(a1t.record_batch(got.combine_chunks().to_batches()[0]),
                     exp)
    # dist_sort already ordered by cat ascending
    cats = got.column("cat").to_pylist()
    assert cats == sorted(cats)


@pytest.mark.slow
def test_local_row_range_partition():
    """local_row_range covers [0, n) exactly once across processes."""
    from arrow1_tpu.parallel import multihost

    # single-process here: the helper is pure arithmetic over
    # process_index/count; simulate both ranks
    import arrow1_tpu.parallel.multihost as mh

    class _Fake:
        index, count = 0, 2

    seen = []
    orig_idx, orig_cnt = mh.jax.process_index, mh.jax.process_count
    try:
        for idx in range(2):
            mh.jax.process_index = lambda i=idx: i
            mh.jax.process_count = lambda: 2
            seen.extend(list(multihost.local_row_range(101)))
    finally:
        mh.jax.process_index, mh.jax.process_count = orig_idx, orig_cnt
    assert sorted(seen) == list(range(101))

"""Host-plane benchmarks: native IO/RPC stacks vs the pyarrow C++ stack.

These run on CPU (no accelerator involved): IPC wire serialize/parse,
Flight DoGet over loopback, CSV/NDJSON parse, LZ4/snappy codecs. Results
land in benchmarks/host_results.json.

Usage: python benchmarks/host_bench.py [ipc flight csv json codec]
"""

import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

RESULTS = os.path.join(os.path.dirname(__file__), "host_results.json")


def _record(name, **kv):
    try:
        with open(RESULTS) as f:
            d = json.load(f)
    except Exception:
        d = {}
    kv["at"] = time.strftime("%H:%M:%S")
    d[name] = kv
    with open(RESULTS, "w") as f:
        json.dump(d, f, indent=1, sort_keys=True)
    print(name, json.dumps(kv), flush=True)


def _best(fn, reps=5):
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        ts.append(time.perf_counter() - t0)
    return min(ts)


def make_batch(n=2_000_000):
    import arrow1_tpu as a1t

    rng = np.random.default_rng(0)
    return a1t.record_batch({
        "k": rng.integers(0, 1 << 40, n),
        "v": rng.integers(-(1 << 30), 1 << 30, n),
        "f": rng.standard_normal(n),
        "s": rng.choice(np.array(["alpha", "beta", "gamma", "delta"]), n),
    })


def nbytes(rb):
    return sum(int(getattr(l, "nbytes", 0))
               for l in jax.tree_util.tree_leaves(rb))


def bench_ipc():
    import io

    import pyarrow as pa

    from arrow1_tpu.io import ipc_native

    rb = make_batch()
    size = nbytes(rb)

    def ser():
        buf = io.BytesIO()
        ipc_native.write_stream(buf, rb)
        return buf

    buf = ser().getvalue()
    t = _best(ser)
    _record("ipc_native_write_2M", mb=round(size / 1e6, 1),
            gbs=round(size / t / 1e9, 2))

    def de():
        ipc_native.read_stream(io.BytesIO(buf))

    t = _best(de)
    _record("ipc_native_read_2M", gbs=round(size / t / 1e9, 2))

    # pyarrow reference on the same logical data
    pab = rb.to_arrow()

    def pser():
        sink = pa.BufferOutputStream()
        w = pa.ipc.new_stream(sink, pab.schema)
        w.write_batch(pab)
        w.close()
        return sink

    t = _best(pser)
    _record("ipc_pyarrow_write_2M", gbs=round(size / t / 1e9, 2))


def bench_flight():
    from arrow1_tpu.flight_native import (NativeFlightClient,
                                          serve_tables_native)
    from arrow1_tpu.table import Table

    rb = make_batch()
    size = nbytes(rb)
    with serve_tables_native({"t": Table([rb])}) as server:
        with NativeFlightClient(server.location) as client:
            client.do_get(b"t")  # warm

            t = _best(lambda: client.do_get(b"t"), reps=3)
            _record("flight_native_doget_2M", mb=round(size / 1e6, 1),
                    gbs=round(size / t / 1e9, 2))

    # pyarrow.flight reference
    try:
        from arrow1_tpu.flight import FlightClient, serve_tables

        with serve_tables({"t": rb}) as server:
            client = FlightClient(server.location)
            client.get("t")
            t = _best(lambda: client.get("t"), reps=3)
            _record("flight_pyarrow_doget_2M", gbs=round(size / t / 1e9, 2))
    except Exception as e:
        print("pyarrow flight reference failed:", e)


def bench_csv():
    import io

    import pyarrow.csv as pacsv

    from arrow1_tpu.io.csv import read_csv, write_csv

    rb = make_batch(500_000)
    buf = io.StringIO()
    write_csv(rb, buf)
    data = buf.getvalue().encode()
    size = len(data)

    t = _best(lambda: read_csv(io.BytesIO(data)))
    _record("csv_native_read", mb=round(size / 1e6, 1),
            mbs=round(size / t / 1e6, 1))
    t = _best(lambda: pacsv.read_csv(io.BytesIO(data)))
    _record("csv_pyarrow_read", mbs=round(size / t / 1e6, 1))


def bench_json():
    import io

    import pyarrow.json as pajson

    from arrow1_tpu.io.json import read_json

    rng = np.random.default_rng(0)
    lines = []
    for i in range(200_000):
        lines.append('{"a": %d, "f": %.6f, "s": "%s"}' % (
            rng.integers(0, 1 << 30), rng.standard_normal(),
            ["alpha", "beta", "gamma"][i % 3]))
    data = ("\n".join(lines)).encode()
    size = len(data)

    t = _best(lambda: read_json(io.BytesIO(data)))
    _record("json_native_read", mb=round(size / 1e6, 1),
            mbs=round(size / t / 1e6, 1))
    t = _best(lambda: pajson.read_json(io.BytesIO(data)))
    _record("json_pyarrow_read", mbs=round(size / t / 1e6, 1))


def bench_codec():
    import pyarrow as pa

    from arrow1_tpu.native import lz4_frame_compress, lz4_frame_decompress

    rng = np.random.default_rng(0)
    data = (rng.integers(0, 50, 20_000_000).astype(np.int64)).tobytes()
    size = len(data)

    comp = lz4_frame_compress(data)
    t = _best(lambda: lz4_frame_compress(data), reps=3)
    _record("lz4_native_compress", mb=round(size / 1e6, 1),
            ratio=round(len(comp) / size, 3),
            mbs=round(size / t / 1e6, 1))
    t = _best(lambda: lz4_frame_decompress(comp, size), reps=3)
    _record("lz4_native_decompress", mbs=round(size / t / 1e6, 1))
    codec = pa.Codec("lz4")
    t = _best(lambda: codec.compress(data), reps=3)
    _record("lz4_pyarrow_compress", mbs=round(size / t / 1e6, 1))
    pcomp = codec.compress(data).to_pybytes()
    t = _best(lambda: codec.decompress(pcomp, size), reps=3)
    _record("lz4_pyarrow_decompress", mbs=round(size / t / 1e6, 1))


ALL = {"ipc": bench_ipc, "flight": bench_flight, "csv": bench_csv,
       "json": bench_json, "codec": bench_codec}

if __name__ == "__main__":
    for name in (sys.argv[1:] or list(ALL)):
        ALL[name]()

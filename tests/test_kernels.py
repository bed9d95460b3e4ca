"""Device kernel unit tests (kernels/*.py) on the CPU mesh, each against
an independent oracle."""

import numpy as np
import pytest

import jax.numpy as jnp

import arrow1_tpu  # noqa: F401  (x64)


class TestHashTable:
    """Bucketed hash table (kernels/hashtable.py) vs the sort-merge oracle."""

    def _oracle(self, probe, build):
        from arrow1_tpu.ops.padded import probe_ranges_sortmerge
        return probe_ranges_sortmerge(probe, build)

    @pytest.mark.parametrize("m,n,key_hi", [(100, 257, 50), (1000, 4096, 200),
                                            (7, 31, 4)])
    def test_join_build_probe_matches_sortmerge(self, m, n, key_hi):
        import numpy as np
        from arrow1_tpu.kernels import hashtable as ht

        rng = np.random.default_rng(m + n)
        build = rng.integers(0, key_hi, m).astype(np.uint64)
        probe = rng.integers(0, key_hi * 2, n).astype(np.uint64)
        bj = jnp.asarray(build)
        pj = jnp.asarray(probe)

        order, table = ht.join_build(bj)
        assert int(table.overflow) == 0
        lo, cnt = ht.join_probe(table, pj)

        o_order, o_lo, o_cnt = self._oracle(
            jnp.asarray(probe.view(np.int64)), jnp.asarray(build.view(np.int64)))
        np.testing.assert_array_equal(np.asarray(cnt), np.asarray(o_cnt))
        # where there are matches, the (order, lo) pairs must address the
        # same multiset of build rows
        bs = np.asarray(bj)[np.asarray(order)]
        obs = np.asarray(build)[np.asarray(o_order)]
        cnt_np = np.asarray(cnt)
        lo_np = np.asarray(lo)
        olo_np = np.asarray(o_lo)
        for i in range(n):
            if cnt_np[i]:
                np.testing.assert_array_equal(
                    np.sort(bs[lo_np[i]:lo_np[i] + cnt_np[i]]),
                    np.sort(obs[olo_np[i]:olo_np[i] + cnt_np[i]]))

    def test_overflow_counted(self):
        import numpy as np
        from arrow1_tpu.kernels import hashtable as ht

        # 64 distinct keys into a 16-slot table (bits=1, ways=8): at
        # least 48 must overflow and be counted, none silently dropped.
        keys = jnp.arange(64, dtype=jnp.uint64)
        pay = jnp.arange(1, 65, dtype=jnp.uint64)
        t = ht.hash_table_build(keys, pay, bits=1, ways=8)
        assert int(t.overflow) == 64 - int(
            np.sum(np.asarray(t.payload) != 0))
        assert int(t.overflow) >= 48

    def test_probe_misses_return_zero(self):
        import numpy as np
        from arrow1_tpu.kernels import hashtable as ht

        keys = jnp.asarray(np.array([3, 9, 27], np.uint64))
        pay = jnp.asarray(np.array([1, 2, 3], np.uint64))
        t = ht.hash_table_build(keys, pay, bits=4, ways=4)
        got = ht.hash_table_probe(t, jnp.asarray(
            np.array([3, 4, 9, 26, 27], np.uint64)))
        np.testing.assert_array_equal(np.asarray(got), [1, 0, 2, 0, 3])

    def test_live_mask_routes_dead_entries_out(self):
        import numpy as np
        from arrow1_tpu.kernels import hashtable as ht

        keys = jnp.asarray(np.array([5, 5, 5, 7], np.uint64))
        pay = jnp.asarray(np.array([10, 11, 12, 13], np.uint64))
        live = jnp.asarray(np.array([True, False, False, True]))
        t = ht.hash_table_build(keys, pay, bits=4, ways=2, live=live)
        assert int(t.overflow) == 0
        got = ht.hash_table_probe(t, jnp.asarray(np.array([5, 7], np.uint64)))
        np.testing.assert_array_equal(np.asarray(got), [10, 13])


class TestRunGeometry:
    """The scatter/gather run geometry (config-4 compile-wall fix) must
    be bit-identical to the blocked max/min scan form it replaced, and
    the staged build must stay equal to the fused one."""

    def test_matches_scan_form(self):
        import numpy as np
        from arrow1_tpu.kernels.blockscan import (cumsum_blocked,
                                                  scan_blocked)
        from arrow1_tpu.kernels.hashtable import _run_geometry

        rng = np.random.default_rng(11)
        for n in (1, 2, 129, 4096, 300_000):
            first = rng.random(n) < 0.3
            first[0] = True
            bfirst = first & (rng.random(n) < 0.5)
            bfirst[0] = True
            f, bf = jnp.asarray(first), jnp.asarray(bfirst)
            pos = jnp.arange(n)
            rs_old = scan_blocked(jnp.maximum, jnp.where(f, pos, 0))
            suf = scan_blocked(jnp.minimum, jnp.where(f, pos, n),
                               reverse=True)
            re_old = jnp.concatenate([suf[1:],
                                      jnp.full(1, n, suf.dtype)])
            kc_old = cumsum_blocked(f.astype(jnp.int32))
            brun0 = scan_blocked(jnp.maximum, jnp.where(bf, kc_old, 0))
            rs, re, kc, way = _run_geometry(f, bf)
            np.testing.assert_array_equal(np.asarray(rs), rs_old)
            np.testing.assert_array_equal(np.asarray(re), re_old)
            np.testing.assert_array_equal(np.asarray(kc), kc_old)
            np.testing.assert_array_equal(np.asarray(way),
                                          kc_old - brun0)

    def test_staged_equals_fused(self):
        import numpy as np
        from arrow1_tpu.kernels.hashtable import (join_build,
                                                  join_build_staged)

        rng = np.random.default_rng(12)
        for m, lo in ((1000, 1000), (5000, 1000), (200_000, 4000)):
            bk = jnp.asarray(rng.integers(0, lo, m).astype(np.uint64))
            o1, t1 = join_build(bk)
            o2, t2 = join_build_staged(bk)
            np.testing.assert_array_equal(np.asarray(o1), np.asarray(o2))
            np.testing.assert_array_equal(np.asarray(t1.keys),
                                          np.asarray(t2.keys))
            np.testing.assert_array_equal(np.asarray(t1.payload),
                                          np.asarray(t2.payload))
            assert int(t1.overflow) == int(t2.overflow)


class TestPackedTable:
    """Flat padding-free probe table (r5): parity vs the u64-table
    probe and the chunked eager-join path."""

    def test_packed_parity_and_retry(self):
        import numpy as np
        from arrow1_tpu.kernels.hashtable import (
            join_build_packed, join_build_staged, join_probe,
            pack_table, probe_packed, table_bits_for)

        rng = np.random.default_rng(5)
        NB, NP = 40_000, 150_000
        build = jnp.asarray(rng.integers(0, NB, NB).astype(np.uint64))
        probe = jnp.asarray(
            rng.integers(0, NB + 500, NP).astype(np.uint64))
        bits = table_bits_for(NB)
        while True:
            order3, pt, ovf = join_build_packed(build, bits=bits)
            if int(ovf) == 0:
                break
            bits += 1
        order, tbl = join_build_staged(build, bits=bits)
        np.testing.assert_array_equal(np.asarray(order),
                                      np.asarray(order3))
        lo1, c1 = join_probe(tbl, probe)
        lo2, c2 = probe_packed(pt, probe)
        np.testing.assert_array_equal(np.asarray(c1), np.asarray(c2))
        np.testing.assert_array_equal(np.asarray(lo1), np.asarray(lo2))
        # the compat pack path agrees too
        lo3, c3 = probe_packed(pack_table(tbl), probe)
        np.testing.assert_array_equal(np.asarray(c1), np.asarray(c3))

    def test_eager_join_chunked_probe(self, monkeypatch):
        import numpy as np
        import pyarrow as pa

        import arrow1_tpu as a1t

        monkeypatch.setenv("A1T_JOIN_PROBE_CHUNK", "7000")  # force chunks
        rng = np.random.default_rng(6)
        NP, NB = 20_000, 3_000
        probe = pa.record_batch({
            "k": pa.array(rng.integers(0, NB + 100, NP).astype(np.int64)),
            "pv": pa.array(np.arange(NP, dtype=np.int64))})
        build = pa.record_batch({
            "k": pa.array(rng.integers(0, NB, NB).astype(np.int64)),
            "w": pa.array(np.arange(NB, dtype=np.int64))})
        got = a1t.join(a1t.record_batch(probe), a1t.record_batch(build),
                       keys=["k"])
        exp = pa.table(probe).join(pa.table(build), keys=["k"],
                                   join_type="inner")
        assert got.num_rows == exp.num_rows
        gs = sorted(zip(got.column("k").to_pylist(),
                        got.column("pv").to_pylist(),
                        got.column("w").to_pylist()))
        es = sorted(zip(exp["k"].to_pylist(), exp["pv"].to_pylist(),
                        exp["w"].to_pylist()))
        assert gs == es

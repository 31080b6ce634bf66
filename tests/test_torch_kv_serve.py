"""The port's disaggregated KV serving (``serve.kv_cache``) against the
JAX package's, on the CPU.

Every case of ``tests/test_kv_serve.py`` is written once as
``scenario(side)`` and run on both packages (``_torch_sides``): the JAX
package with its Pallas kernels in interpret mode, the port on
``device="cpu"`` engines with its kernels' plain versions. Each side
passes the reference test's own assertions, and then the two sides'
pools, per-QP CQEs (in order), ``engine.stats`` — the ``kv_serve``
ledger included — and fetched payloads must be equal byte for byte.
The KV wr_id counter of each package is reset at the start of a
scenario so that CQE wr_ids compare too. The decode handoff runs on the
port alone (the JAX side's is a slow test) and its greedy tokens are
held against the JAX package's local decode on the same weights.
"""
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_sides import TORCH, run_both, snapshot

PE = 64           # page elems used throughout (one pow2 bucket)


def _jain(xs):
    """Jain's fairness index (sum x)^2 / (n * sum x^2); the port has no
    cost model yet, so it is computed here."""
    xs = np.asarray(xs, np.float64)
    return float(xs.sum() ** 2 / (len(xs) * (xs * xs).sum()))


def _eng(side, **kw):
    side.kv._wr_tokens = itertools.count(0x4B560000)
    return side.RDMAEngine(n_peers=2, pool_size=1 << 14, **kw)


def _filled_pool(side, eng, peer, n_pages, seq_id=7, seed=0, **kw):
    pool = side.kv.PagedKVPool(eng, peer, page_elems=PE, max_pages=n_pages,
                               **kw)
    data = np.random.default_rng(seed).standard_normal(
        (n_pages, PE)).astype(np.float32)
    for row in data:
        pool.write_page(pool.append_page(seq_id), row)
    return pool, data


def _np(x):
    return np.asarray(x.numpy() if isinstance(x, torch.Tensor) else x)


def _wqe(side, qp, mr, i):
    return side.rdma.WQE(side.rdma.Opcode.READ, qp.qp_num, wr_id=100 + i,
                         local_addr=1024 + 4 * i, remote_addr=4 * i,
                         length=4, rkey=mr.rkey)


class TestCoalescerExceptionPath:
    def test_clean_exit_flushes_tail(self):
        def scenario(s):
            eng = _eng(s)
            qp = eng.create_qp(0, 1)
            mr = eng.register_mr(1, 0, 256)
            eng.write_buffer(1, 0, np.arange(16, dtype=np.float32))
            d0 = eng.transport.dispatch_count
            with s.rdma.DoorbellCoalescer(eng, qp, flush_threshold=50) as db:
                for i in range(3):
                    db.post(_wqe(s, qp, mr, i))
            assert eng.transport.dispatch_count - d0 == 1
            return snapshot(eng)
        assert len(run_both(scenario)["cqes"][0]) == 3

    def test_exception_aborts_unrung_tail(self):
        def scenario(s):
            eng = _eng(s)
            qp = eng.create_qp(0, 1)
            mr = eng.register_mr(1, 0, 256)
            eng.write_buffer(1, 0, np.arange(16, dtype=np.float32))
            eng.write_buffer(0, 1024, np.zeros(12, np.float32))
            pidx0, d0 = qp.sq_pidx, eng.transport.dispatch_count
            with pytest.raises(RuntimeError, match="mid-batch"):
                with s.rdma.DoorbellCoalescer(eng, qp,
                                              flush_threshold=50) as db:
                    for i in range(3):
                        db.post(_wqe(s, qp, mr, i))
                    raise RuntimeError("mid-batch failure")
            assert len(qp.sq) == 0 and qp.sq_pidx == pidx0
            eng.flush_doorbells()
            assert eng.transport.dispatch_count == d0
            assert eng.poll_cq(qp, 8) == []
            np.testing.assert_array_equal(eng.read_buffer(0, 1024, 12),
                                          np.zeros(12, np.float32))
            return snapshot(eng)
        run_both(scenario)

    def test_threshold_flushed_wqes_survive_abort(self):
        def scenario(s):
            eng = _eng(s)
            qp = eng.create_qp(0, 1)
            mr = eng.register_mr(1, 0, 256)
            eng.write_buffer(1, 0, np.arange(16, dtype=np.float32))
            with pytest.raises(RuntimeError):
                with s.rdma.DoorbellCoalescer(eng, qp,
                                              flush_threshold=2) as db:
                    for i in range(3):          # 2 flushed, 1 pending
                        db.post(_wqe(s, qp, mr, i))
                    raise RuntimeError("after threshold crossing")
            cqes = eng.poll_cq(qp, 8)
            assert [c.wr_id for c in cqes] == [100, 101]
            assert all(c.status is s.rdma.CQEStatus.SUCCESS for c in cqes)
            assert len(qp.sq) == 0
            return snapshot(eng)
        run_both(scenario)

    def test_explicit_abort(self):
        def scenario(s):
            eng = _eng(s)
            qp = eng.create_qp(0, 1)
            mr = eng.register_mr(1, 0, 256)
            db = s.rdma.DoorbellCoalescer(eng, qp, flush_threshold=50)
            for i in range(4):
                db.post(_wqe(s, qp, mr, i))
            assert db.abort() == 4
            assert len(qp.sq) == 0 and db._pending == 0
            db.flush()                          # no-op after abort
            assert eng.poll_cq(qp, 8) == []
            return snapshot(eng)
        run_both(scenario)


class TestDtypeBilling:
    def test_page_nbytes_by_dtype(self):
        def scenario(s):
            eng = _eng(s)
            out = []
            for dt, per_elem in ((np.int8, 1), (s.bf16, 2),
                                 (np.float32, 4)):
                pool = s.kv.PagedKVPool(eng, 0, page_elems=PE, max_pages=1,
                                        dtype=dt)
                assert pool.page_nbytes == PE * per_elem
                assert pool.append_page(0).nbytes == PE * per_elem
                out.append(pool.evict(0))
            return out
        run_both(scenario)

    def test_compressed_bills_packed_payload(self):
        def scenario(s):
            pool = s.kv.PagedKVPool(_eng(s), 0, page_elems=PE, max_pages=1,
                                    compressed=True)
            assert pool.page_words == s.kv.packed_page_words(PE) \
                == PE // 64 + PE // 2
            assert pool.page_nbytes == PE + 4 * (PE // 64)
            return pool.page_words, pool.page_nbytes
        run_both(scenario)

    def test_migration_routes_dtype_true_bytes(self):
        def scenario(s):
            eng = _eng(s)
            src, _ = _filled_pool(s, eng, 0, 3, dtype=np.int8)
            dst = s.kv.PagedKVPool(eng, 1, page_elems=PE, max_pages=3,
                                   dtype=np.int8)
            router = s.TrafficRouter()
            qp = eng.create_qp(1, 0)
            assert s.kv.migrate_sequence(eng, router, src, dst, 7, qp) == 3
            kv = router.counters[s.S.TrafficClass.KV_PAGE]
            assert kv["count"] == 3 and kv["bytes"] == 3 * PE
            return snapshot(eng), dict(kv)
        run_both(scenario)


class TestMigration:
    def test_no_loss_under_seeded_drop(self):
        def scenario(s):
            eng = _eng(s)
            eng.install_fault_injector(s.rdma.FaultInjector(seed=13,
                                                            drop=0.10))
            src, data = _filled_pool(s, eng, 0, 5)
            dst = s.kv.PagedKVPool(eng, 1, page_elems=PE, max_pages=5)
            qp = eng.create_qp(1, 0)
            moved = s.kv.migrate_sequence(eng, s.TrafficRouter(), src, dst,
                                          7, qp, max_flushes=128)
            assert moved == 5 and src.seq_len_pages(7) == 0
            assert src.allocated == 0 and dst.allocated == 5
            got = np.stack([_np(dst.read_page(p)) for p in dst.pages[7]])
            np.testing.assert_array_equal(got, data)
            led = eng.stats["kv_serve"]
            assert led["pages_migrated"] == 5
            assert led["pages_rolled_back"] == 0
            return snapshot(eng), got
        run_both(scenario)

    def test_stalled_peer_rolls_back_and_surfaces_errored_qp(self):
        def scenario(s):
            eng = _eng(s)
            inj = eng.install_fault_injector(
                s.rdma.FaultInjector(seed=3),
                s.rdma.ReliabilityConfig(retry_cnt=1, timeout_flushes=1))
            inj.stall_peer(0)
            src, data = _filled_pool(s, eng, 0, 3)
            dst = s.kv.PagedKVPool(eng, 1, page_elems=PE, max_pages=3)
            qp = eng.create_qp(1, 0)
            moved = s.kv.migrate_sequence(eng, s.TrafficRouter(), src, dst,
                                          7, qp, max_flushes=32)
            assert moved == 0
            assert src.seq_len_pages(7) == 3 and dst.allocated == 0
            got = np.stack([_np(src.read_page(p)) for p in src.pages[7]])
            np.testing.assert_array_equal(got, data)
            assert qp.state is s.rdma.QPState.ERROR
            mid = snapshot(eng)
            inj.unstall_peer(0)
            eng.recover_qp(qp)
            assert s.kv.migrate_sequence(eng, s.TrafficRouter(), src, dst,
                                         7, qp, max_flushes=64) == 3
            assert src.allocated == 0 and dst.seq_len_pages(7) == 3
            return mid, snapshot(eng)
        run_both(scenario)

    def test_partial_failure_keeps_failed_page_at_source(self):
        def scenario(s):
            eng = _eng(s)
            src, data = _filled_pool(s, eng, 0, 5)
            bad = src.pages[7][-1]
            eng.invalidate_mr(bad.mr.rkey)
            dst = s.kv.PagedKVPool(eng, 1, page_elems=PE, max_pages=5)
            qp = eng.create_qp(1, 0)
            moved = s.kv.migrate_sequence(eng, s.TrafficRouter(), src, dst,
                                          7, qp)
            assert 0 < moved < 5
            assert src.seq_len_pages(7) + dst.seq_len_pages(7) == 5
            assert src.allocated + dst.allocated == 5
            assert bad in src.pages[7]
            for p in dst.pages[7]:
                np.testing.assert_array_equal(_np(dst.read_page(p)),
                                              data[p.page_idx])
            led = eng.stats["kv_serve"]
            assert led["pages_migrated"] == moved
            assert led["pages_rolled_back"] == 5 - moved
            return snapshot(eng), moved
        run_both(scenario)

    def test_memory_error_aborts_doorbell_and_rolls_back(self):
        def scenario(s):
            eng = _eng(s)
            src, data = _filled_pool(s, eng, 0, 4)
            dst = s.kv.PagedKVPool(eng, 1, page_elems=PE, max_pages=2)
            qp = eng.create_qp(1, 0)
            d0 = eng.transport.dispatch_count
            with pytest.raises(MemoryError):
                s.kv.migrate_sequence(eng, s.TrafficRouter(), src, dst, 7,
                                      qp)
            assert eng.transport.dispatch_count == d0
            assert eng.poll_cq(qp, 16) == []
            assert dst.allocated == 0 and len(qp.sq) == 0
            assert src.seq_len_pages(7) == 4
            got = np.stack([_np(src.read_page(p)) for p in src.pages[7]])
            np.testing.assert_array_equal(got, data)
            return snapshot(eng)
        run_both(scenario)


class TestRemoteFetch:
    def test_fetch_parity_and_zero_warm_compiles(self):
        def scenario(s):
            eng = _eng(s)
            pool, data = _filled_pool(s, eng, 0, 3, seq_id=0)
            pool.max_pages = 6
            rows2 = np.random.default_rng(9).standard_normal(
                (3, PE)).astype(np.float32)
            for row in rows2:
                pool.write_page(pool.append_page(1), row)
            client = s.kv.RemoteKVClient(eng, 1, pool)
            t = client.register_tenant("gold", weight=2)
            first = _np(client.complete(client.fetch_sequence(t, 0)))
            np.testing.assert_array_equal(first, data)
            c0 = eng.stats["transport"]["compiles"]
            q0 = eng.stats["transport"]["qdma_compiles"]
            got = _np(client.complete(client.fetch_sequence(t, 1)))
            assert eng.stats["transport"]["compiles"] == c0
            assert eng.stats["transport"]["qdma_compiles"] == q0
            np.testing.assert_array_equal(got, rows2)
            assert client.staging.utilization() == 0.0
            led = eng.stats["kv_serve"]
            assert led["fetches"] == led["completed"] == 2
            assert led["pages_fetched"] == 6 and led["failed"] == 0
            return snapshot(eng), first, got
        run_both(scenario)

    def test_compressed_fetch_matches_quant_oracle(self):
        from repro.kernels import ref
        x = np.random.default_rng(0).standard_normal(
            (2, PE)).astype(np.float32)          # same rows as seed 0
        q, sc = ref.ref_quantize(jnp.asarray(x.reshape(-1, 64)))
        want = np.asarray(ref.ref_dequantize(q, sc)).reshape(2, PE)

        def scenario(s):
            eng = _eng(s)
            pool, _ = _filled_pool(s, eng, 0, 2, seq_id=0, compressed=True)
            client = s.kv.RemoteKVClient(eng, 1, pool)
            t = client.register_tenant("bulk")
            got = _np(client.complete(client.fetch_sequence(t, 0)))
            np.testing.assert_array_equal(got, want)
            assert pool.page_words == s.kv.packed_page_words(PE)
            return snapshot(eng), got
        run_both(scenario)

    def test_pack_roundtrip_is_exact_in_pool_words(self):
        from repro.kernels import ref
        x = np.random.default_rng(4).standard_normal(PE).astype(np.float32)
        q, sc = ref.ref_quantize(jnp.asarray(x.reshape(-1, 64)))
        want = np.asarray(ref.ref_dequantize(q, sc)).reshape(-1)

        def scenario(s):
            words = _np(s.kv.quant_pack_page(x))
            assert words.shape == (s.kv.packed_page_words(PE),)
            back = _np(s.kv.quant_unpack_page(words, PE))
            np.testing.assert_array_equal(back, want)
            return words, back
        run_both(scenario)

    def test_unknown_sequence_raises_keyerror(self):
        def scenario(s):
            eng = _eng(s)
            pool, _ = _filled_pool(s, eng, 0, 1, seq_id=0)
            client = s.kv.RemoteKVClient(eng, 1, pool)
            t = client.register_tenant("t")
            with pytest.raises(KeyError, match="seq 99"):
                client.fetch_sequence(t, 99)
            return snapshot(eng)
        run_both(scenario)

    def test_staging_exhaustion_is_admission_control(self):
        def scenario(s):
            eng = _eng(s)
            pool, _ = _filled_pool(s, eng, 0, 2, seq_id=0)
            client = s.kv.RemoteKVClient(eng, 1, pool, staging_size=PE)
            t = client.register_tenant("t")
            with pytest.raises(MemoryError):
                client.fetch_sequence(t, 0)
            assert len(t.qp.sq) == 0
            return snapshot(eng)
        run_both(scenario)

    def test_failed_fetch_surfaces_then_recovers(self):
        def scenario(s):
            eng = _eng(s)
            inj = eng.install_fault_injector(
                s.rdma.FaultInjector(seed=3),
                s.rdma.ReliabilityConfig(retry_cnt=1, timeout_flushes=1))
            pool, data = _filled_pool(s, eng, 0, 2, seq_id=0)
            client = s.kv.RemoteKVClient(eng, 1, pool)
            t = client.register_tenant("t")
            inj.stall_peer(0)
            tk = client.fetch_sequence(t, 0)
            for _ in range(16):
                eng.flush_doorbells()
                client.advance(t)
                if tk.outstanding == 0:
                    break
            assert tk.outstanding == 0 and tk.data is None
            assert t.qp.state is s.rdma.QPState.ERROR
            with pytest.raises(s.kv.KVFetchError):
                client.complete(tk)
            inj.unstall_peer(0)
            got = _np(client.complete(tk, recover=True))
            np.testing.assert_array_equal(got, data)
            led = eng.stats["kv_serve"]
            assert led["recoveries"] == 1 and led["failed"] == 1
            assert led["completed"] == 1 and pool.seq_len_pages(0) == 2
            return snapshot(eng), got
        run_both(scenario)


class TestTenantIsolation:
    def test_innocents_stay_jain_one_under_adversary(self):
        def scenario(s):
            eng = _eng(s, scheduler="drr", flush_budget=8)
            pool, data = _filled_pool(s, eng, 0, 4, seq_id=0)
            client = s.kv.RemoteKVClient(eng, 1, pool)
            inn1 = client.register_tenant("inn1", weight=2)
            inn2 = client.register_tenant("inn2", weight=2)
            adv = client.register_tenant("adv", weight=1)
            eng.install_fault_injector(s.rdma.FaultInjector(
                seed=11, drop=0.10, only_qps=[adv.qp.qp_num]))
            tickets = []
            for _ in range(3):
                tickets.append(client.fetch_sequence(inn1, 0, defer=True))
                tickets.append(client.fetch_sequence(inn2, 0, defer=True))
                for _ in range(5):
                    tickets.append(client.fetch_sequence(adv, 0,
                                                         defer=True))
            for _ in range(400):
                eng.flush_doorbells()
                for t in (inn1, inn2, adv):
                    client.advance(t)
                if all(tk.outstanding == 0 for tk in tickets):
                    break
            assert all(tk.outstanding == 0 for tk in tickets)
            for tk in tickets:
                np.testing.assert_array_equal(_np(tk.data), data)
            svc = [eng.stats["qp_service"][t.qp.qp_num]
                   for t in (inn1, inn2)]
            assert svc[0] == svc[1] and _jain(svc) == 1.0
            return snapshot(eng), [tk.done_flush for tk in tickets]
        run_both(scenario)


def _random_caches(side, cfg, b, max_seq, seed):
    """A filled cache pytree of the side's package (values from numpy)."""
    rng = np.random.default_rng(seed)
    n, hkv, hd = cfg.num_layers, cfg.num_kv_heads, cfg.resolved_head_dim()
    k = rng.standard_normal((n, b, max_seq, hkv, hd)).astype(np.float32)
    v = rng.standard_normal((n, b, max_seq, hkv, hd)).astype(np.float32)
    pos = np.full((n,), max_seq - 3, np.int32)
    arr = side.array
    return {"scan": {"k": arr(k), "v": arr(v), "pos": arr(pos)}}


class TestCacheHandoffParity:
    def test_flatten_order_and_bytes_equal(self):
        from repro.configs.registry import get_config
        cfg = get_config("tiny")

        def scenario(s):
            caches = _random_caches(s, cfg, 2, 10, seed=5)
            flat = _np(s.kv.flatten_cache_leaves(caches))
            back = s.kv.unflatten_cache_leaves(flat, caches)
            for key in ("k", "v", "pos"):
                np.testing.assert_array_equal(_np(back["scan"][key]),
                                              _np(caches["scan"][key]))
                assert _np(back["scan"][key]).dtype == \
                    _np(caches["scan"][key]).dtype
            return flat
        flat = run_both(scenario)
        n_kv = 2 * 2 * 10 * 2 * 16
        assert flat.shape == (2 * n_kv + 2,)
        assert flat[n_kv:n_kv + 2].tolist() == [7.0, 7.0]   # k, pos, v

    @pytest.mark.parametrize("compressed", [False, True])
    def test_publish_fetch_pools_and_ledger_equal(self, compressed):
        from repro.configs.registry import get_config
        cfg = get_config("tiny")

        def scenario(s):
            eng = _eng(s)
            caches = _random_caches(s, cfg, 1, 12, seed=6)
            n_words = int(_np(s.kv.flatten_cache_leaves(caches)).size)
            n_pages = -(-n_words // PE)
            pool = s.kv.PagedKVPool(eng, 0, page_elems=PE,
                                    max_pages=n_pages, compressed=compressed)
            client = s.kv.RemoteKVClient(eng, 1, pool, router=s.TrafficRouter())
            t = client.register_tenant("decode", weight=2)
            assert client.publish_caches(3, caches) == n_pages
            published = snapshot(eng)
            got = client.fetch_caches(3, caches, t)
            out = {k: _np(got["scan"][k]) for k in ("k", "v", "pos")}
            if not compressed:
                for key in out:
                    np.testing.assert_array_equal(out[key],
                                                  _np(caches["scan"][key]))
            led = eng.stats["kv_serve"]
            assert led["pages_fetched"] == n_pages and led["failed"] == 0
            return published, snapshot(eng), out
        run_both(scenario)


def test_greedy_decode_bit_identical_through_remote_pool():
    """prefill -> publish_caches -> one-sided-READ fetch -> decode gives
    the same tokens as keeping the caches local, and the JAX package's
    local decode on the same weights gives them too."""
    import repro.models as JM
    import repro.serve as JS
    from repro.configs.registry import get_config as jax_config
    from repro_torch.configs.registry import get_config
    from repro_torch.models import init_caches, params_from_jax
    from repro_torch.serve import greedy_generate

    jc, cfg = jax_config("tiny"), get_config("tiny")
    jp = JM.init_params(jc, jax.random.PRNGKey(0))
    params = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    prompt = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (1, 8)).astype(np.int32)
    tp = torch.from_numpy(prompt)
    base = greedy_generate(params, cfg, tp, max_new=4, max_seq=32)
    want = JS.greedy_generate(jp, jc, jnp.asarray(prompt), max_new=4,
                              max_seq=32)
    np.testing.assert_array_equal(base.numpy(), np.asarray(want))

    kv = TORCH.kv
    n_words = kv.flatten_cache_leaves(
        init_caches(cfg, 1, 32, torch.float32, device="cpu")).numel()
    n_pages = -(-int(n_words) // PE)
    eng = TORCH.RDMAEngine(n_peers=2, pool_size=4 * n_pages * PE)
    pool = kv.PagedKVPool(eng, 0, page_elems=PE, max_pages=n_pages)
    client = kv.RemoteKVClient(eng, 1, pool)
    t = client.register_tenant("decode", weight=2)
    out = greedy_generate(params, cfg, tp, max_new=4, max_seq=32,
                          kv_client=client, kv_seq_id=0, kv_tenant=t)
    np.testing.assert_array_equal(out.numpy(), base.numpy())
    assert pool.allocated == 0
    led = eng.stats["kv_serve"]
    assert led["pages_fetched"] == n_pages and led["failed"] == 0


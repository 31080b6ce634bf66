"""The port's RDMA engine against the JAX package's, verb for verb.

Each case runs the same verb script on ``repro.core.rdma.RDMAEngine`` and
on ``repro_torch``'s engine (``device="cpu"``), both starting from the
same random pool bytes (``load_pool``). Afterwards the pools must be
byte-identical, every QP's CQEs equal in order and status, and
``engine.stats`` equal. QPs are matched by creation order (qp_nums come
from a per-package counter); ``qp_latency_us`` is wall-clock, so only its
per-QP counts are compared.
"""
import copy

import jax.numpy as jnp
import numpy as np
import pytest

import repro.core.rdma as J
import repro_torch.core.rdma as T

POOL = 1 << 14


def _pair(**kw):
    kw.setdefault("n_peers", 2)
    kw.setdefault("pool_size", POOL)
    je = J.RDMAEngine(**kw)
    te = T.RDMAEngine(device="cpu", **kw)
    init = np.random.default_rng(5).standard_normal(
        (kw["n_peers"], kw["pool_size"])).astype(np.float32)
    je.transport.pool = jnp.asarray(init)
    te.load_pool(np.asarray(je.pool))
    return je, te


def _snapshot(eng):
    idx = {q: i for i, q in enumerate(eng.qps)}
    cqes = [[(c.wr_id, idx.get(c.qp_num), c.opcode.value, c.status.value,
              c.byte_len, c.imm) for c in eng.poll_cq(qp, 1 << 20)]
            for qp in eng.qps.values()]
    stats = copy.deepcopy(eng.stats)
    for key in ("qp_service", "lc_service", "qp_bytes"):
        stats[key] = {idx[q]: v for q, v in stats[key].items()}
    stats["qp_latency_us"] = {idx[q]: sum(h.values())
                              for q, h in stats["qp_latency_us"].items()}
    return np.asarray(eng.pool), cqes, stats


def _run_both(script, **kw):
    """Run ``script(engine, package)`` on both engines; assert parity.
    Returns both scripts' results for extra checks."""
    je, te = _pair(**kw)
    jr = script(je, J)
    tr = script(te, T)
    jpool, jcqes, jstats = _snapshot(je)
    tpool, tcqes, tstats = _snapshot(te)
    np.testing.assert_array_equal(tpool, jpool)
    assert tcqes == jcqes
    assert tstats == jstats
    return jr, tr


def _drain(eng, qps, cap=400):
    for _ in range(cap):
        relia = eng._reliability
        if not any(q.pending_count for q in qps) and (
                relia is None or relia.outstanding() == 0):
            return
        eng.flush_doorbells()
    raise AssertionError("engine did not drain")


def test_verbs_read_write_imm_send_rnr_bad_rkey():
    def script(eng, m):
        mr1 = eng.register_mr(1, 0, 4096)
        eng.register_mr(0, 8192, 4096)
        qa = eng.create_qp(0, 1)
        qb = eng.create_qp(1, 0)
        W, O = m.WQE, m.Opcode
        eng.post_recv(qb, W(O.RECV, qb.qp_num, 10, local_addr=3000,
                            length=128))
        posts = [
            W(O.READ, qa.qp_num, 1, local_addr=8192, remote_addr=100,
              length=300, rkey=mr1.rkey),
            W(O.WRITE, qa.qp_num, 2, local_addr=0, remote_addr=1000,
              length=200, rkey=mr1.rkey),
            W(O.WRITE_IMM, qa.qp_num, 3, local_addr=50, remote_addr=2000,
              length=64, rkey=mr1.rkey, imm=7),
            W(O.SEND, qa.qp_num, 4, local_addr=500, length=100),
            W(O.SEND_IMM, qa.qp_num, 5, local_addr=600, length=10,
              imm=9),                                    # RQ empty: RNR
            W(O.READ, qa.qp_num, 6, local_addr=0, remote_addr=0,
              length=16, rkey=0xBAD),                    # bad rkey
            W(O.READ, qa.qp_num, 7, local_addr=0, remote_addr=4000,
              length=200, rkey=mr1.rkey),                # past the MR
        ]
        for i, w in enumerate(posts):
            eng.post_send(qa, w)
            if i < 2:
                eng.ring_sq_doorbell(qa)   # single-request mode
        eng.ring_sq_doorbell(qa)           # then one batch doorbell
        return [eng.read_buffer(0, 8192, 300), eng.read_buffer(1, 3000, 128)]

    jr, tr = _run_both(script)
    for a, b in zip(jr, tr):
        assert isinstance(b, np.ndarray)
        np.testing.assert_array_equal(b, a)


@pytest.mark.parametrize("coalesce", [True, False])
def test_coalescing_and_prewarm(coalesce):
    def script(eng, m):
        mr = eng.register_mr(1, 0, POOL)
        qp = eng.create_qp(0, 1)
        eng.create_qp(1, 0)
        for i in range(16):              # contiguous: merge into one
            eng.post_send(qp, m.WQE(m.Opcode.READ, qp.qp_num, i,
                                    local_addr=4096 + 64 * i,
                                    remote_addr=64 * i, length=64,
                                    rkey=mr.rkey))
        for i in range(5):               # strided: stay apart
            eng.post_send(qp, m.WQE(m.Opcode.WRITE, qp.qp_num, 100 + i,
                                    local_addr=200 * i,
                                    remote_addr=9000 + 300 * i,
                                    length=100 + i, rkey=mr.rkey))
        eng.ring_sq_doorbell(qp)
        eng.transport.prewarm()
        eng.transport.prewarm(["16x64", (8, 1 << 20)])
        for i in range(3):
            eng.post_send(qp, m.WQE(m.Opcode.READ, qp.qp_num, 200 + i,
                                    local_addr=12000 + 40 * i,
                                    remote_addr=40 * i, length=40,
                                    rkey=mr.rkey))
            eng.ring_sq_doorbell(qp)

    _run_both(script, coalesce=coalesce)


@pytest.mark.parametrize("scheduler,budget,window,promote", [
    ("rr", None, None, None), ("rr", 5, 3, None),
    ("drr", None, 2, None), ("drr", 6, None, None),
    ("fifo", None, None, None), ("fifo", 4, 3, 2)])
def test_schedulers_budget_and_window(scheduler, budget, window, promote):
    def script(eng, m):
        mr = eng.register_mr(1, 0, POOL)
        qps = [eng.create_qp(0, 1, weight=w) for w in (1, 2, 3)]
        eng.create_qp(1, 0)
        base = 0
        for q, depth in zip(qps, (7, 4, 9)):
            for i in range(depth):
                eng.post_send(q, m.WQE(
                    m.Opcode.READ if i % 2 else m.Opcode.WRITE, q.qp_num,
                    i, local_addr=base, remote_addr=POOL // 2 + base,
                    length=17 + 3 * i, rkey=mr.rkey))
                base += 97
            eng.ring_sq_doorbell(q, defer=True)
        order = {q.qp_num: i for i, q in enumerate(qps)}
        served = []
        for _ in range(50):
            counts = eng.flush_doorbells()
            if not counts:
                break
            served.append(sorted((order[k], v) for k, v in counts.items()))
        return served

    jr, tr = _run_both(script, scheduler=scheduler, flush_budget=budget,
                       qp_window=window, promote_after=promote)
    assert tr == jr


@pytest.mark.parametrize("shift", [10, -10, 0])
def test_overlapping_same_row_transfer(shift):
    """A loopback READ whose source and destination overlap in one row
    copies the source as it was before the transfer (gather before
    scatter), in both directions."""
    def script(eng, m):
        mr = eng.register_mr(0, 0, 4096)
        qp = eng.create_qp(0, 0)
        eng.create_qp(0, 0)
        eng.post_send(qp, m.WQE(m.Opcode.READ, qp.qp_num, 1,
                                local_addr=1000 + shift, remote_addr=1000,
                                length=300, rkey=mr.rkey))
        # two contiguous overlapping WQEs in one table: coalescing must
        # not merge them, and the second sees the first's writes
        eng.post_send(qp, m.WQE(m.Opcode.READ, qp.qp_num, 2,
                                local_addr=2005, remote_addr=2000,
                                length=8, rkey=mr.rkey))
        eng.post_send(qp, m.WQE(m.Opcode.READ, qp.qp_num, 3,
                                local_addr=2013, remote_addr=2008,
                                length=8, rkey=mr.rkey))
        eng.ring_sq_doorbell(qp)

    _run_both(script)


def test_local_address_overrun_is_dropped():
    """``_check_mr`` checks only the remote side: a READ whose local
    range runs past the pool drops its tail, a WRITE whose local source
    runs past it reads clipped lanes, and negative local lanes wrap once
    — as the JAX executor does."""
    def script(eng, m):
        mr = eng.register_mr(1, 0, POOL)
        qp = eng.create_qp(0, 1)
        eng.create_qp(1, 0)
        eng.post_send(qp, m.WQE(m.Opcode.READ, qp.qp_num, 1,
                                local_addr=POOL - 10, remote_addr=0,
                                length=50, rkey=mr.rkey))
        eng.post_send(qp, m.WQE(m.Opcode.WRITE, qp.qp_num, 2,
                                local_addr=POOL - 20, remote_addr=500,
                                length=64, rkey=mr.rkey))
        # a negative local address: the reference's scatter wraps the
        # negative lanes to the row's end once, and so does the port
        eng.post_send(qp, m.WQE(m.Opcode.READ, qp.qp_num, 3,
                                local_addr=-5, remote_addr=700,
                                length=20, rkey=mr.rkey))
        eng.post_send(qp, m.WQE(m.Opcode.READ, qp.qp_num, 4,
                                local_addr=-POOL - 3, remote_addr=900,
                                length=9, rkey=mr.rkey))
        eng.ring_sq_doorbell(qp)
        return eng.read_buffer(1, 500, 64)

    jr, tr = _run_both(script)
    np.testing.assert_array_equal(tr, jr)
    assert np.all(tr[20:] == tr[19])        # clipped source lanes


def test_seeded_fault_injection_at_10pct_drop():
    def script(eng, m):
        mr = eng.register_mr(1, 0, POOL)
        qps = [eng.create_qp(0, 1, weight=w) for w in (1, 2)]
        eng.create_qp(1, 0)
        eng.install_fault_injector(m.FaultInjector(seed=3, drop=0.1))
        for j, q in enumerate(qps):
            for i in range(20):
                op = m.Opcode.WRITE if (i + j) % 3 else m.Opcode.READ
                eng.post_send(q, m.WQE(op, q.qp_num, i,
                                       local_addr=3000 * j + 50 * i,
                                       remote_addr=8000 + 3000 * j + 50 * i,
                                       length=50, rkey=mr.rkey))
            eng.ring_sq_doorbell(q, defer=True)
        _drain(eng, qps)
        return dict(eng.transport.fault_injector.stats)

    jr, tr = _run_both(script, scheduler="drr", flush_budget=8)
    assert tr == jr and jr["drop"] > 0


def test_host_mem_placement_and_sync_host_to_dev():
    def script(eng, m):
        host = m.Placement.HOST_MEM
        data = np.arange(300, dtype=np.float32) * 0.5
        eng.write_buffer(0, 100, data, placement=host)
        eng.sync_host_to_dev(0, 100, 300)
        eng.write_buffer(1, 7, np.arange(33, dtype=np.int64))
        mr = eng.register_mr(0, 0, 1024, host)
        qp = eng.create_qp(1, 0, placement=host)
        eng.create_qp(0, 1, placement=host)
        eng.post_send(qp, m.WQE(m.Opcode.READ, qp.qp_num, 1,
                                local_addr=5000, remote_addr=100,
                                length=300, rkey=mr.rkey))
        eng.ring_sq_doorbell(qp)
        with pytest.raises(ValueError, match="out of bounds"):
            eng.write_buffer(0, POOL - 4, np.ones(8, np.float32))
        return [eng.read_buffer(0, 90, 320, placement=host),
                eng.read_buffer(1, 5000, 300)]

    jr, tr = _run_both(script)
    for a, b in zip(jr, tr):
        np.testing.assert_array_equal(b, a)
    np.testing.assert_array_equal(tr[1], np.arange(300) * 0.5)


def test_load_pool_rejects_wrong_shape():
    _, te = _pair()
    with pytest.raises(ValueError, match="shape"):
        te.load_pool(np.zeros((3, POOL), np.float32))

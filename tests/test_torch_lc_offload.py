"""The whole slice on both packages: engine → Lookaside block → offload
kernels, from the same pool bytes.

Each case drives the same ControlMsgs through ``repro``'s and
``repro_torch``'s ``RDMAEngine`` + ``LookasideBlock`` +
``register_default_kernels`` (the port on ``device="cpu"``, so its
wrappers run their plain versions; the JAX kernels run in interpret
mode). Asserted: equal ``StatusMsg``s; pool bytes equal — exactly for the
parser and the quantizer, within ``1e-5 * k / 128`` for the matmul (the
two CPU dots may sum in another order); equal ``lc_service``,
``lc_pipeline`` and ``transport`` stats (QPs matched by creation order).
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.lookaside as JL
import repro.core.memory as JM
import repro.core.rdma as J
import repro.kernels.lc_offload as JK
import repro.kernels.ops as JO
import repro_torch.core.lookaside as TL
import repro_torch.core.memory as TM
import repro_torch.core.rdma as T
import repro_torch.kernels.lc_offload as TK
import repro_torch.kernels.ops as TO

POOL = 1 << 14
DATA_PEER, LC_PEER = 1, 0
JAX_SIDE = (J, JL, JK)
TORCH_SIDE = (T, TL, TK)


def _engines(pipeline_depth=None, **kw):
    kw.setdefault("n_peers", 2)
    kw.setdefault("pool_size", POOL)
    init = np.random.default_rng(9).standard_normal(
        (kw["n_peers"], kw["pool_size"])).astype(np.float32)
    out = []
    for (rdma, lk, kern) in (JAX_SIDE, TORCH_SIDE):
        eng = (rdma.RDMAEngine(**kw) if rdma is J
               else rdma.RDMAEngine(device="cpu", **kw))
        if rdma is J:
            eng.transport.pool = jnp.asarray(init)
        else:
            eng.load_pool(init)
        blk = lk.LookasideBlock(eng, peer=LC_PEER, scratch_base=1 << 13,
                                pipeline_depth=pipeline_depth)
        kern.register_default_kernels(blk)
        out.append((eng, blk, lk, kern))
    return out


def _ledgers(eng):
    idx = {q: i for i, q in enumerate(eng.qps)}
    s = eng.stats
    return {"lc_service": {idx[q]: v for q, v in s["lc_service"].items()},
            "lc_wqes": s["lc_wqes"], "lc_pipeline": dict(s["lc_pipeline"]),
            "transport": s["transport"], "flushes": s["flushes"],
            "wqes": s["wqes"], "errors": s["errors"]}


def _statuses(blk, wid):
    out = []
    while (st := blk.poll(wid)) is not None:
        out.append(dataclasses.astuple(st))
    return out


def _assert_parity(sides, wids, exact=True, tol=0.0):
    (je, jb, _, _), (te, tb, _, _) = sides
    for wid in wids:
        assert _statuses(tb, wid) == _statuses(jb, wid)
    jpool, tpool = np.asarray(je.pool), te.pool.numpy()
    if exact:
        np.testing.assert_array_equal(tpool, jpool)
    else:
        np.testing.assert_allclose(tpool, jpool, rtol=tol, atol=tol)
    assert _ledgers(te) == _ledgers(je)


@pytest.mark.parametrize("m,k,n", [(8, 16, 12), (16, 32, 8), (4, 128, 4)])
def test_lc_systolic_mm(m, k, n):
    sides = _engines()
    rng = np.random.default_rng(m * k * n)
    A = rng.standard_normal((m, k)).astype(np.float32)
    B = rng.standard_normal((k, n)).astype(np.float32)
    out = m * k + k * n
    for eng, blk, lk, kern in sides:
        mr = eng.register_mr(DATA_PEER, 0, out + m * n)
        eng.write_buffer(DATA_PEER, 0, A.ravel())
        eng.write_buffer(DATA_PEER, m * k, B.ravel())
        assert blk.dispatch(lk.ControlMsg(
            kern.MM_WORKLOAD, (DATA_PEER, mr.rkey, 0, m * k, out, m, k, n),
            tag=3)) is None
    _assert_parity(sides, [JK.MM_WORKLOAD], exact=False, tol=1e-5 * k / 128)
    te = sides[1][0]
    got = te.read_buffer(DATA_PEER, out, m * n).reshape(m, n)
    np.testing.assert_allclose(got, A.astype(np.float64) @ B,
                               rtol=1e-5 * k / 128, atol=1e-5 * k / 128)


def test_lc_bad_rkey_status_matches():
    sides = _engines()
    for eng, blk, lk, kern in sides:
        blk.dispatch(lk.ControlMsg(
            kern.MM_WORKLOAD, (DATA_PEER, 0xBAD, 0, 128, 256, 8, 16, 8),
            tag=8))
    (_, jb, _, _), (_, tb, _, _) = sides
    st = _statuses(tb, TK.MM_WORKLOAD)
    assert st == _statuses(jb, JK.MM_WORKLOAD)
    assert st[0][2] is False and "remote_access_error" in st[0][4]


def _roce_packets(rng, n_pkts):
    pkts = rng.integers(0, 256, size=(n_pkts, 64)).astype(np.uint8)
    pkts[::2, 12:14] = [0x08, 0x00]      # IPv4
    pkts[::2, 23] = 17                   # UDP
    pkts[::2, 36:38] = [18, 183]         # dport 4791 (RoCEv2)
    return pkts


def test_lc_packet_parser():
    sides = _engines()
    n_pkts = 32
    pkts = _roce_packets(np.random.default_rng(4), n_pkts)
    out_addr = n_pkts * 64
    for eng, blk, lk, kern in sides:
        mr = eng.register_mr(DATA_PEER, 0, out_addr + n_pkts * 4)
        eng.write_buffer(DATA_PEER, 0, pkts.astype(np.float32).ravel())
        blk.dispatch(lk.ControlMsg(
            kern.PARSER_WORKLOAD, (DATA_PEER, mr.rkey, 0, n_pkts, out_addr),
            tag=4))
    _assert_parity(sides, [JK.PARSER_WORKLOAD])


@pytest.mark.parametrize("depth", [1, 4])
def test_stream_handlers_dispatched_over_a_pool_region(depth):
    """The stream handlers dispatched by ControlMsgs whose spans address
    a pool region of 64-word slots (no RX ring), several messages queued
    before one service pass — with ``pipeline_depth=4`` and armed
    write-backs, fetches overlap earlier write-backs."""
    sides = _engines(pipeline_depth=depth)
    rng = np.random.default_rng(21)
    n_slots, per_msg = 32, 8
    base, qout, mout = 0, 4096, 7000
    payload = (rng.standard_normal((n_slots, 64))
               * rng.uniform(0.1, 10, (n_slots, 1))).astype(np.float32)
    payload[5] = 0.0
    pkts = _roce_packets(rng, n_slots).astype(np.float32)
    hbase = 2048
    for eng, blk, lk, kern in sides:
        # a deep pipeline leaves write-backs armed, so they ride the
        # next round's flush beside the next fetches
        blk.eager_writeback = depth == 1
        mr = eng.register_mr(DATA_PEER, 0, 8192)
        eng.write_buffer(DATA_PEER, base, payload.ravel())
        eng.write_buffer(DATA_PEER, hbase, pkts.ravel())
        for i in range(n_slots // per_msg):
            spans = ((base + i * per_msg * 64, per_msg),)
            assert blk.dispatch(lk.ControlMsg(
                kern.STREAM_QUANT_WORKLOAD,
                (DATA_PEER, mr.rkey, base, DATA_PEER, mr.rkey, qout,
                 spans), tag=i), service=False) is None
        # a two-span burst (a wrapped ring claim) for the parser
        spans = ((hbase + 24 * 64, 8), (hbase, 4))
        blk.dispatch(lk.ControlMsg(
            kern.STREAM_PARSER_WORKLOAD,
            (DATA_PEER, mr.rkey, hbase, DATA_PEER, mr.rkey, mout, spans),
            tag=9), service=False)
        blk.service_group([kern.STREAM_QUANT_WORKLOAD,
                           kern.STREAM_PARSER_WORKLOAD])
    _assert_parity(sides, [JK.STREAM_QUANT_WORKLOAD,
                           JK.STREAM_PARSER_WORKLOAD])
    te = sides[1][0]
    rows = te.read_buffer(DATA_PEER, qout, n_slots * TK.QUANT_ROW
                          ).reshape(n_slots, TK.QUANT_ROW)
    back = rows[:, :64] * rows[:, 64:]
    assert np.all(np.abs(back - payload) <= rows[:, 64:] * 0.5 + 1e-7)
    if depth == 4:
        assert te.stats["lc_pipeline"]["overlapped_flushes"] > 0


def _fig6(rdma, lk, memory, ops, matmul_fn, **engine_kw):
    """The Fig 6 workflow of ``examples/networked_matmul.py``: READ A, B
    to the NIC peer, compute C there with a registered lookaside kernel,
    poll its status."""
    M = 32
    data_peer, nic_peer = 0, 1
    eng = rdma.RDMAEngine(n_peers=2, pool_size=4 * M * M + 1024,
                          **engine_kw)
    lc = lk.LookasideBlock(eng, peer=nic_peer)
    data_pool = memory.BufferPool(eng, data_peer)
    nic_pool = memory.BufferPool(eng, nic_peer)
    rng = np.random.default_rng(0)
    A = rng.normal(size=(M, M)).astype(np.float32)
    B = rng.normal(size=(M, M)).astype(np.float32)
    a_src, b_src = data_pool.alloc(M * M), data_pool.alloc(M * M)
    data_pool.write(a_src, A.reshape(-1))
    data_pool.write(b_src, B.reshape(-1))
    a_dst, b_dst, c_dst = (nic_pool.alloc(M * M) for _ in range(3))
    qp = eng.create_qp(nic_peer, data_peer)
    eng.create_qp(data_peer, nic_peer)
    for wr, (dst, src) in enumerate(((a_dst, a_src), (b_dst, b_src)), 1):
        eng.post_send(qp, rdma.WQE(rdma.Opcode.READ, qp.qp_num, wr,
                                   local_addr=dst.base, remote_addr=src.base,
                                   length=M * M, rkey=src.rkey))
    eng.ring_sq_doorbell(qp)
    cqes = [(c.wr_id, c.status.value) for c in eng.poll_cq(qp)]

    def kernel(ctx, a_addr, b_addr, c_addr, m):
        x = ctx.load(a_addr, m * m).reshape(m, m)
        y = ctx.load(b_addr, m * m).reshape(m, m)
        ctx.store(c_addr, matmul_fn(ops, x, y).reshape(-1))
        return c_addr

    lc.register(1, kernel, "systolic_mm")
    lc.dispatch(lk.ControlMsg(1, (a_dst.base, b_dst.base, c_dst.base, M),
                              tag=99))
    status = dataclasses.astuple(lc.poll(1))
    C = nic_pool.read(c_dst).reshape(M, M)
    return eng, cqes, status, C, A @ B


def test_networked_matmul_fig6():
    j = _fig6(J, JL, JM, JO, lambda ops, x, y: np.asarray(
        ops.matmul(jnp.asarray(x), jnp.asarray(y))))
    t = _fig6(T, TL, TM, TO, lambda ops, x, y: ops.matmul(x, y),
              device="cpu")
    (je, jc, js, jC, _), (te, tc, ts, tC, want) = j, t
    assert tc == jc == [(1, "success"), (2, "success")]
    assert ts == js and ts[2] is True
    tol = 1e-5 * 32 / 128
    np.testing.assert_allclose(tC, jC, rtol=tol, atol=tol)
    np.testing.assert_allclose(tC, want, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(te.pool.numpy(), np.asarray(je.pool),
                               rtol=tol, atol=tol)
    assert _ledgers(te) == _ledgers(je)


def test_lc_context_load_stays_on_the_pool_device():
    """``LCContext.load`` hands the kernel a tensor on the pool's device
    (not a host array), and ``store`` of one keeps the QDMA ledger."""
    eng = T.RDMAEngine(n_peers=2, pool_size=1024, device="cpu")
    blk = TL.LookasideBlock(eng, peer=0)
    seen = []

    def kernel(ctx, addr):
        x = ctx.load(addr, 16)
        seen.append(x)
        ctx.store(addr + 16, x * 2)

    blk.register(1, kernel)
    eng.write_buffer(0, 600, np.arange(16, dtype=np.float32))
    q0 = eng.stats["transport"]["qdma_writes"]
    blk.dispatch(TL.ControlMsg(1, (600,)))
    assert isinstance(seen[0], torch.Tensor)
    assert seen[0].device == eng.pool.device
    assert eng.stats["transport"]["qdma_writes"] == q0 + 1
    np.testing.assert_array_equal(eng.read_buffer(0, 616, 16),
                                  np.arange(16) * 2.0)

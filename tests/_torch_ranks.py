"""Rank programs of the port's multi-process tests.

Each function runs in one process of a gloo group started by
``repro_torch.launch.mesh.run_peers`` (every rank the same program on
the same inputs, SPMD) and returns host data for the test to check
against the JAX package, which runs in the test's own process. Nothing
here imports JAX: the ranks are the port alone, on the CPU.
"""
import numpy as np
import torch
import torch.distributed as dist

from repro_torch.configs.base import TrainConfig
from repro_torch.configs.registry import get_config
from repro_torch.core.rdma import (FaultInjector, Opcode, RDMAEngine,
                                   ReliabilityConfig, WQE)
from repro_torch.core.rdma import transport as TT
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import params_from_jax

DEV = "cpu"


def _one_thread():
    """One intra-op thread a rank: the ranks of a spawn share the host."""
    torch.set_num_threads(1)


def _np_tree(tree):
    if isinstance(tree, dict):
        return {k: _np_tree(v) for k, v in tree.items()}
    return tree.detach().cpu().numpy()


def random_plan(rng, n_peers, pool, n_wqes):
    """The reference tests' random transfers (loopback and overlapping
    ranges included)."""
    plan = []
    for _ in range(n_wqes):
        ln = int(rng.integers(1, 9))
        plan.append(("xfer", int(rng.integers(0, n_peers)),
                     int(rng.integers(0, n_peers)),
                     int(rng.integers(0, pool - ln)),
                     int(rng.integers(0, pool - ln)), ln))
    return plan


# the seed executors' overrunning addresses: clamped and shifted there,
# clipped or dropped by the descriptor executor
OVERRUN_PLAN = [("xfer", 0, 1, 60, 61, 8), ("xfer", 2, 2, -3, 40, 5),
                ("xfer", 1, 3, 10, -7, 6), ("xfer", 3, 0, 2, 62, 4),
                ("xfer", 0, 2, -70, 5, 4)]
# a 9-word transfer of eight -0.0 words and one 1.5, across rows and
# within one row
NEG_ZERO_PLAN = [("xfer", 0, 1, 0, 16, 9), ("xfer", 2, 2, 0, 32, 9)]


def neg_zero_pool(n_peers=4, pool=64):
    init = np.ones((n_peers, pool), np.float32)
    init[:, :8] = -0.0
    init[:, 8] = 1.5
    return init


def fault_run(eng, WQE=WQE, Opcode=Opcode):
    """The reference's lossy-fabric conformance workload
    (``test_transport_conformance.py``: 2 QPs of 10 random WRITEs,
    ``flush_budget`` 6) on ``eng``, with the verbs of ``eng``'s package;
    returns the engine."""
    eng.flush_budget = 6
    rng = np.random.default_rng(11)
    eng.write_buffer(0, 0, rng.standard_normal(1024).astype(np.float32))
    qps = []
    for q in range(2):
        qp = eng.create_qp(0, q + 1)
        mr = eng.register_mr(q + 1, 0, 512)
        qps.append(qp)
        for i in range(10):
            ln = int(rng.integers(1, 32))
            eng.post_send(qp, WQE(Opcode.WRITE, qp.qp_num, wr_id=i,
                                  local_addr=int(rng.integers(0, 1024 - ln)),
                                  remote_addr=int(rng.integers(0, 512 - ln)),
                                  length=ln, rkey=mr.rkey))
        eng.ring_sq_doorbell(qp, defer=True)
    for _ in range(300):
        eng.flush_doorbells()
        relia = eng._reliability
        if not any(qp.pending_count for qp in qps) and (
                relia is None or relia.outstanding() == 0):
            break
    return eng


def transport_cases(rank):
    """Four peers: the reference's ICI cases and the seed executors."""
    _one_thread()
    out = {}
    # cache helpers first, in this fresh process: one new descriptor key
    # for 20 batches of one shape with fresh addresses, none after
    rng = np.random.default_rng(0)
    d0 = TT.descriptor_cache_size()
    t = TT.LocalTransport(torch.from_numpy(
        rng.standard_normal((2, 256)).astype(np.float32)))
    sizes = []
    for _ in range(20):
        sa, da = int(rng.integers(0, 96)), int(rng.integers(128, 224))
        t.execute_batch([("xfer", 0, 1, sa, da, 30)])
        sizes.append(TT.descriptor_cache_size() - d0)
    out["descriptor_keys"] = sizes
    out["local_stats"] = {k: t.stats[k] for k in (
        "dispatches", "cache_misses", "cache_hits", "compiles")}

    # ICITransport against LocalTransport (test_transport_cache.py)
    rng = np.random.default_rng(0)
    init = rng.standard_normal((4, 64)).astype(np.float32)
    ici = TT.make_transport(4, 64, device=DEV)
    out["ici_type"] = type(ici).__name__
    out["ici_row_shape"] = tuple(ici.pool.shape)
    out["small_type"] = type(TT.make_transport(2, 64, device=DEV)).__name__
    loc = TT.LocalTransport(torch.from_numpy(init.copy()))
    ici.load_pool(init)
    plans = []
    for _ in range(10):
        plan = random_plan(rng, 4, 64, int(rng.integers(1, 6)))
        plans.append(plan)
        ici.execute_batch(plan)
        loc.execute_batch(plan)
    out["plans"] = plans
    out["ici_pool"] = ici.gather_pool()
    out["local_pool"] = loc.pool.numpy().copy()
    out["ici_stats"] = {k: ici.stats[k] for k in ("dispatches", "compiles")}

    # the seed executors on both transports, overrunning addresses too
    sici = TT.make_transport(4, 64, device=DEV)
    sici.load_pool(init)
    sloc = TT.LocalTransport(torch.from_numpy(init.copy()))
    for plan in plans + [OVERRUN_PLAN]:
        sici.execute_batch_static(plan)
        sloc.execute_batch_static(plan)
    h0 = TT.host_write_cache_size()
    for peer, addr, ln in ((1, 60, 8), (7, -5, 3), (2, 3, 8)):
        data = np.arange(ln, dtype=np.float32) + 100 * peer
        sici.host_write_static(peer, addr, data)
        sloc.host_write_static(peer, addr, data)
    out["static_host_keys"] = TT.host_write_cache_size() - h0
    out["static_ici_pool"] = sici.gather_pool()
    out["static_local_pool"] = sloc.pool.numpy().copy()
    dloc = TT.LocalTransport(torch.from_numpy(init.copy()))
    dloc.execute_batch(OVERRUN_PLAN)
    out["overrun_descriptor_pool"] = dloc.pool.numpy().copy()

    # -0.0 moves as bytes
    nz = TT.make_transport(4, 64, device=DEV)
    nz.load_pool(neg_zero_pool())
    nz.execute_batch(NEG_ZERO_PLAN)
    nzl = TT.LocalTransport(torch.from_numpy(neg_zero_pool()))
    nzl.execute_batch(NEG_ZERO_PLAN)
    out["neg_zero_ici"] = nz.gather_pool()
    out["neg_zero_local"] = nzl.pool.numpy().copy()

    # staged host_write round trip (test_transport_conformance.py:427)
    q = TT.make_transport(4, 256, device=DEV)
    s0 = TT.staging_cache_size()
    reads = []
    for i, ln in enumerate([17, 20, 25, 31, 70, 100, 127]):
        data = np.arange(ln, dtype=np.float32) + i
        q.host_write(i % 4, i, data)
        reads.append(bool(np.array_equal(q.host_read(i % 4, i, ln), data)))
    out["qdma_reads"] = reads
    out["qdma_stats"] = {k: q.stats[k] for k in ("qdma_compiles",
                                                 "qdma_writes")}
    out["staging_keys"] = TT.staging_cache_size() - s0
    errors = []
    for peer, addr in ((0, 252), (3, -1)):
        try:
            q.host_write(peer, addr, np.zeros(8, np.float32))
        except ValueError as e:
            errors.append(str(e))
    out["oob_errors"] = errors
    out["oob_qdma_writes"] = q.stats["qdma_writes"]

    # lossy fabric: 10% drop + dup + corrupt, byte parity with clean
    clean = fault_run(RDMAEngine(n_peers=4, pool_size=1024, device=DEV))
    eng = RDMAEngine(n_peers=4, pool_size=1024, device=DEV)
    eng.install_fault_injector(
        FaultInjector(3, drop=0.10, duplicate=0.05, corrupt=0.03),
        ReliabilityConfig())
    faulted = fault_run(eng)
    out["fault_type"] = type(faulted.transport).__name__
    out["fault_clean_pool"] = clean.transport.gather_pool()
    out["fault_pool"] = faulted.transport.gather_pool()
    rel = faulted.stats["reliability"]
    out["fault_rel"] = {k: rel[k] for k in ("retransmits", "retx_pressure",
                                            "dropped", "acks")}

    # batched READs fanning in to peer 0 (test_distributed.py, 4 peers)
    eng = RDMAEngine(n_peers=4, pool_size=256, device=DEV)
    for p in range(4):
        eng.write_buffer(p, 0, np.full(4, float(p + 1), np.float32))
    mrs = [eng.register_mr(p, 0, 16) for p in range(4)]
    qps = {}
    for p in range(1, 4):
        qps[p] = eng.create_qp(0, p)
        eng.create_qp(p, 0)
    for p in range(1, 4):
        eng.post_send(qps[p], WQE(Opcode.READ, qps[p].qp_num, p,
                                  local_addr=32 + 4 * p, remote_addr=0,
                                  length=4, rkey=mrs[p].rkey))
        eng.ring_sq_doorbell(qps[p])
    out["fanin"] = [float(eng.read_buffer(0, 32 + 4 * p, 1)[0])
                    for p in range(1, 4)]

    # RDMACollective on the twin (test_collectives.py, 4 peers)
    from repro_torch.train.collectives import RDMACollective
    rng = np.random.default_rng(0)
    eng = RDMAEngine(n_peers=4, pool_size=1 << 12, device=DEV)
    coll = RDMACollective(eng, 4)
    shards = [rng.integers(-8, 9, 96).astype(np.float32) for _ in range(4)]
    out["allreduce_type"] = type(eng.transport).__name__
    out["allreduce"] = [g[:96].numpy() for g in coll.all_reduce(shards)]
    out["allreduce_want"] = np.sum(shards, axis=0)
    return out


def lookaside_case(rank):
    """Two peers: the Lookaside block's MM and parser workloads on the
    twin (test_lc_offload.py), K5 and K3 through their plain versions."""
    _one_thread()
    from repro_torch.core.lookaside import ControlMsg, LookasideBlock
    from repro_torch.kernels import lc_offload as lco
    eng = RDMAEngine(n_peers=2, pool_size=1 << 14, device=DEV)
    return lookaside_traffic(eng, ControlMsg, LookasideBlock, lco) | {
        "type": type(eng.transport).__name__}


def lookaside_traffic(eng, ControlMsg, LookasideBlock, lco):
    """The reference case's traffic on ``eng``; the results as numpy."""
    blk = LookasideBlock(eng, peer=0, scratch_base=1 << 13)
    lco.register_default_kernels(blk)
    rng = np.random.default_rng(11)
    m, k, n = 8, 16, 12
    A = rng.standard_normal((m, k)).astype(np.float32)
    B = rng.standard_normal((k, n)).astype(np.float32)
    mr = eng.register_mr(1, 0, 4096)
    eng.write_buffer(1, 0, A.ravel())
    eng.write_buffer(1, m * k, B.ravel())
    out = m * k + k * n
    blk.dispatch(ControlMsg(lco.MM_WORKLOAD,
                            (1, mr.rkey, 0, m * k, out, m, k, n)))
    st = blk.poll(lco.MM_WORKLOAD)
    mm = eng.read_buffer(1, out, m * n).reshape(m, n)
    n_pkts = 16
    pkts = rng.integers(0, 256, size=(n_pkts, 64)).astype(np.uint8)
    pkts[::2, 12:14] = [8, 0]
    pkts[::2, 23] = 17
    pkts[::2, 36:38] = [18, 183]
    base = 2048
    mr2 = eng.register_mr(1, base, n_pkts * 68)
    eng.write_buffer(1, base, pkts.astype(np.float32).ravel())
    blk.dispatch(ControlMsg(lco.PARSER_WORKLOAD,
                            (1, mr2.rkey, base, n_pkts, base + n_pkts * 64)))
    st2 = blk.poll(lco.PARSER_WORKLOAD)
    parsed = eng.read_buffer(1, base + n_pkts * 64, n_pkts * 4).reshape(
        n_pkts, 4)
    return {"mm_ok": bool(st is not None and st.ok),
            "parse_ok": bool(st2 is not None and st2.ok),
            "A": A, "B": B, "pkts": pkts, "mm": mm, "parsed": parsed,
            "lc_wqes": eng.stats["lc_wqes"],
            "pool": eng.transport.gather_pool()}


# ---------------------------------------------------------------------------
# training over a mesh
# ---------------------------------------------------------------------------

def _tiny(np_params):
    return get_config("tiny"), params_from_jax(np_params, device=DEV)


def _torch_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def mesh_train_cases(rank, np_params, batch, steps):
    """(2, 2) ("data", "model"): the psum bucketed step (step 1's loss,
    synced grads and params; the losses of ``steps`` steps), its
    collective counts at two bucket sizes, and make_train_step(mesh)
    with and without ZeRO-1."""
    _one_thread()
    from repro_torch.train import (init_adam, make_bucketed_train_step,
                                   zero1_init)
    from repro_torch.train.train_step import _bucketize, make_train_step
    cfg, params0 = _tiny(np_params)
    mesh = make_mesh((2, 2), ("data", "model"))
    tb = _torch_batch(batch)
    out = {}
    kw = dict(learning_rate=3e-3, warmup_steps=1, total_steps=20,
              remat=False, zero1=False, sequence_parallel=False)
    step = make_bucketed_train_step(
        cfg, TrainConfig(grad_bucket_mb=0.125, **kw), mesh)
    step.keep_grads = True
    params, opt, losses = params0, init_adam(params0), []
    for i in range(steps):
        loss, params, opt, _ = step(params, opt, tb, None)
        losses.append(float(loss))
        if i == 0:
            out["grads1"] = _np_tree(step.last_grads)
            out["params1"] = _np_tree(params)
            step.keep_grads = False
    out["losses"] = losses
    counts = {}
    for mb in (0.125, 100.0):
        s = make_bucketed_train_step(cfg, TrainConfig(grad_bucket_mb=mb,
                                                      **kw), mesh)
        s(params0, init_adam(params0), tb, None)
        _, buckets = _bucketize(params0, int(mb * (1 << 20)))
        counts[mb] = (s.collectives, len(buckets))
    out["counts"] = counts
    for zero1 in (False, True):
        st = make_train_step(cfg, TrainConfig(**{**kw, "zero1": zero1}), mesh)
        p, o = params0, init_adam(params0)
        if zero1:
            try:
                st(p, o, tb)
            except ValueError as e:
                out["zero1_whole_state"] = str(e)
            o = zero1_init(o, mesh)
        for _ in range(2):
            loss, p, o = st(p, o, tb)
        out[f"zero1={zero1}"] = {
            "loss": float(loss), "params": _np_tree(p),
            "m": _np_tree(o.m), "v": _np_tree(o.v),
            "collectives": st.collectives}
    out["coords"] = mesh.get_coordinate()
    return out


def pod_train_cases(rank, np_params, batch, flats, sparse_flats):
    """(2, 1) ("pod", "data"): compressed_all_reduce_group on given
    buckets (and on buckets with all-zero chunks), the compress_grads
    psum step (two steps, residuals threaded), the uncompressed psum
    step's synced gradient norm, and sync="rdma" with n_peers from the
    mesh (an ICITransport engine)."""
    _one_thread()
    from repro_torch.core.streaming.compress import (
        compressed_all_reduce_group, init_error_state)
    from repro_torch.launch.mesh import axis_group
    from repro_torch.train import init_adam, make_bucketed_train_step
    cfg, params0 = _tiny(np_params)
    mesh = make_mesh((2, 1), ("pod", "data"))
    tb = _torch_batch(batch)
    out = {}
    pod = mesh.get_local_rank("pod")
    est, res = compressed_all_reduce_group(
        torch.from_numpy(flats[pod][0]), torch.from_numpy(flats[pod][1]),
        axis_group(mesh, ("pod",)), chunk=256)
    out["group_est"], out["group_res"] = est.numpy(), res.numpy()
    est, res = compressed_all_reduce_group(
        torch.from_numpy(sparse_flats[pod][0]),
        torch.from_numpy(sparse_flats[pod][1]),
        axis_group(mesh, ("pod",)), chunk=256)
    out["sparse_est"], out["sparse_res"] = est.numpy(), res.numpy()
    kw = dict(learning_rate=3e-3, warmup_steps=1, total_steps=20,
              remat=False, zero1=False, sequence_parallel=False,
              grad_bucket_mb=0.125)
    step = make_bucketed_train_step(
        cfg, TrainConfig(compress_grads=True, **kw), mesh)
    step.keep_grads = True
    params, opt = params0, init_adam(params0)
    residuals = init_error_state(params0)
    hist = []
    for _ in range(2):
        loss, params, opt, residuals = step(params, opt, tb, residuals)
        hist.append({"loss": float(loss), "params": _np_tree(params),
                     "residuals": _np_tree(residuals),
                     "grads": _np_tree(step.last_grads),
                     "collectives": step.collectives})
    out["compressed"] = hist
    pstep = make_bucketed_train_step(cfg, TrainConfig(**kw), mesh)
    pstep(params0, init_adam(params0), tb, None)
    out["psum_grad_norm"] = float(pstep.grad_norm)
    rstep = make_bucketed_train_step(
        cfg, TrainConfig(**{**kw, "grad_bucket_mb": 0.0625}), mesh,
        sync="rdma")
    loss, p1, _, _ = rstep(params0, init_adam(params0), tb, None)
    eng = rstep.collective(0).engine
    out["rdma"] = {"loss": float(loss), "params": _np_tree(p1),
                   "type": type(eng.transport).__name__,
                   "n_peers": eng.n_peers}
    return out


def pipeline_case(rank, ws, bs, xs):
    """4 stages over 8 microbatches: y = tanh(x @ w + b) per stage."""
    _one_thread()
    from repro_torch.train.pipeline_parallel import pipeline_forward
    mesh = make_mesh((dist.get_world_size(),), ("stage",))
    run = pipeline_forward(lambda p, x: torch.tanh(x @ p["w"] + p["b"]),
                           mesh, "stage", n_microbatches=xs.shape[0])
    got = run({"w": torch.from_numpy(ws), "b": torch.from_numpy(bs)},
              torch.from_numpy(xs))
    return {"got": got.numpy(), "sends": run.sends}


def fail_case(rank):
    """Rank 1 raises while rank 0 waits in a collective."""
    if rank == 1:
        raise RuntimeError("rank 1 fails on purpose")
    dist.barrier()
    return "unreachable"


def hang_case(rank):
    """Rank 1 never joins rank 0's collective (until the timeout)."""
    if rank == 0:
        dist.barrier()
    else:
        import time
        time.sleep(600)
    return "unreachable"


def cuda_two_rank_case(rank, device=None):
    """Two ranks sharing one card (``device=None``): the twin's pool
    against LocalTransport's on the card, and the group form of the
    compressed all-reduce against the leading-dim form, with K1 and K2
    launched."""
    _one_thread()
    from repro_torch.core.streaming.compress import (
        compressed_all_reduce, compressed_all_reduce_group)
    from repro_torch.kernels.quantize_stream import (dequantize_stream,
                                                     quantize_stream)
    eng = RDMAEngine(n_peers=2, pool_size=4096, device=device)
    dev = eng.pool.device
    rng = np.random.default_rng(3)
    init = rng.standard_normal((2, 4096)).astype(np.float32)
    init[:, :64] = -0.0
    loc = TT.LocalTransport(torch.from_numpy(init.copy()).to(dev))
    eng.load_pool(init)
    for _ in range(6):
        plan = random_plan(rng, 2, 4096, int(rng.integers(1, 40)))
        plan.append(("xfer", 0, 1, 0, 100, 64))
        eng.transport.execute_batch(plan)
        loc.execute_batch(plan)
    flats = [torch.from_numpy(rng.standard_normal(5000).astype(np.float32))
             for _ in range(2)]
    res = [torch.from_numpy((rng.standard_normal(5000) * 1e-2).astype(
        np.float32)) for _ in range(2)]
    k1, k2 = quantize_stream.launches, dequantize_stream.launches
    est, new_res = compressed_all_reduce_group(
        flats[rank].to(dev), res[rank].to(dev), dist.group.WORLD)
    launched = (quantize_stream.launches - k1,
                dequantize_stream.launches - k2)
    lead, lead_res = compressed_all_reduce(torch.stack(flats).to(dev),
                                           torch.stack(res).to(dev))
    return {"type": type(eng.transport).__name__, "device": str(dev),
            "pool": eng.transport.gather_pool(),
            "local_pool": loc.pool.cpu().numpy(),
            "est": est.cpu().numpy(), "lead": lead[rank].cpu().numpy(),
            "res": new_res.cpu().numpy(),
            "lead_res": lead_res[rank].cpu().numpy(), "launched": launched}

"""The port's gradient collectives (``repro_torch.train.collectives``) and
its engine-synced train step against the JAX package, on the CPU.

Every case of ``tests/test_collectives.py`` runs here on the port, and
the same shards also run through the JAX package's ``RDMACollective``:
results must be byte-equal (integer-valued f32 payloads sum exactly in
any order) and the ``stats["collectives"]`` ledgers equal. The
``sync="rdma"`` step is held against the JAX package's: loss within
1e-5 relative, parameters within 1e-5 after the step (as in
``tests/test_torch_train.py``), ledgers equal; and its synced mean
gradients against the plain step's within 1e-6 of the global gradient
norm (the two sum the batch in another order).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.train as JTR
from repro.configs.base import TrainConfig as JTrainConfig
from repro.configs.registry import get_config as jax_config
from repro.core.rdma.cost_model import jain_fairness_index
from repro.core.rdma.engine import RDMAEngine as JEngine
from repro.core.rdma.reliability import FaultInjector as JFaultInjector
from repro.models import init_params as j_init_params
from repro.train.collectives import RDMACollective as JCollective
from repro_torch._tree import tree_leaves
from repro_torch.configs.base import TrainConfig
from repro_torch.configs.registry import get_config
from repro_torch.core.rdma.engine import RDMAEngine
from repro_torch.core.rdma.reliability import FaultInjector
from repro_torch.core.rdma.verbs import Opcode, WQE
from repro_torch.models import params_from_jax
from repro_torch.train import init_adam, make_train_step
from repro_torch.train.collectives import (CollectiveError, RDMACollective,
                                           ideal_wire_words)
from repro_torch.train.optimizer import global_norm
from repro_torch.train.train_step import (_bucketize,
                                          make_bucketed_train_step)


def _engine(n: int, pool: int = 1 << 14, **kw) -> RDMAEngine:
    return RDMAEngine(n_peers=max(n, 2), pool_size=pool, device="cpu", **kw)


def _jengine(n: int, pool: int = 1 << 14, **kw) -> JEngine:
    return JEngine(n_peers=max(n, 2), pool_size=pool, **kw)


def _psum_oracle(shards) -> np.ndarray:
    stacked = jnp.stack([jnp.asarray(s, jnp.float32) for s in shards])
    return np.asarray(jax.vmap(lambda x: jax.lax.psum(x, "p"),
                               axis_name="p")(stacked))


def _int_shards(rng, n: int, words: int):
    return [rng.integers(-8, 9, words).astype(np.float32)
            for _ in range(n)]


def _same(got, want):
    """Port results (tensors) byte-equal to the JAX package's (arrays)."""
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert isinstance(g, torch.Tensor) and g.dtype == torch.float32
        assert g.numpy().tobytes() == np.asarray(w).tobytes()


@pytest.mark.parametrize("n", [2, 3, 4, 5, 8])
@pytest.mark.parametrize("algorithm", ["ring", "rd"])
def test_allreduce_parity(n, algorithm):
    rng = np.random.default_rng(n)
    words = 100
    shards = _int_shards(rng, n, words)
    coll = RDMACollective(_engine(n), n, algorithm=algorithm)
    jcoll = JCollective(_jengine(n), n, algorithm=algorithm)
    got, jgot = coll.all_reduce(shards), jcoll.all_reduce(shards)
    want = _psum_oracle(shards)
    for p in range(n):
        assert np.array_equal(got[p][:words].numpy(), want[p])
    _same(got, jgot)
    assert coll.stats == jcoll.stats
    assert coll.stats["wire_words"] == ideal_wire_words(algorithm, n, words)


def test_allreduce_parity_dtype_mix():
    rng = np.random.default_rng(0)
    n = 4
    leaves = {"w": (torch.float32, 96), "h": (torch.bfloat16, 64),
              "r": (torch.int8, 32)}
    per_peer = [torch.cat([torch.from_numpy(rng.integers(-4, 5, size))
                           .to(dt).to(torch.float32)
                           for dt, size in leaves.values()])
                for _ in range(n)]
    as_np = [t.numpy() for t in per_peer]
    coll = RDMACollective(_engine(n), n)
    jcoll = JCollective(_jengine(n), n)
    got, jgot = coll.all_reduce(per_peer), jcoll.all_reduce(as_np)
    want = _psum_oracle(as_np)
    for p in range(n):
        assert np.array_equal(got[p][:per_peer[0].numel()].numpy(), want[p])
    _same(got, jgot)
    assert coll.stats == jcoll.stats


def test_reduce_scatter_all_gather_pair():
    rng = np.random.default_rng(1)
    n, words = 4, 128
    shards = _int_shards(rng, n, words)
    want = _psum_oracle(shards)
    coll = RDMACollective(_engine(n), n)
    jcoll = JCollective(_jengine(n), n)
    chunks, jchunks = coll.reduce_scatter(shards), jcoll.reduce_scatter(
        shards)
    cw = words // n
    for p in range(n):
        own = (p + 1) % n
        assert np.array_equal(chunks[p].numpy(),
                              want[p][own * cw:(own + 1) * cw])
    _same(chunks, jchunks)
    full, jfull = coll.all_gather(chunks), jcoll.all_gather(jchunks)
    for p in range(n):
        assert np.array_equal(full[p].numpy(), want[p])
    _same(full, jfull)
    assert coll.stats == jcoll.stats


def test_zero_warm_compiles_across_steps():
    rng = np.random.default_rng(2)
    n = 4
    eng = _engine(n)
    coll = RDMACollective(eng, n)
    coll.all_reduce(_int_shards(rng, n, 256))
    c0 = eng.stats["transport"]["compiles"]
    q0 = eng.stats["transport"]["qdma_compiles"]
    for _ in range(3):
        coll.all_reduce(_int_shards(rng, n, 256))
    assert eng.stats["transport"]["compiles"] == c0
    assert eng.stats["transport"]["qdma_compiles"] == q0


def test_retransmit_under_seeded_drop_parity():
    """10% seeded drop: retransmits through the same shape buckets —
    byte parity with the JAX package's run of the same fault tape, the
    same retransmit count, zero new compiles."""
    rng = np.random.default_rng(3)
    n = 3
    eng, jeng = _engine(n), _jengine(n)
    eng.install_fault_injector(FaultInjector(7, drop=0.10))
    jeng.install_fault_injector(JFaultInjector(7, drop=0.10))
    coll, jcoll = RDMACollective(eng, n), JCollective(jeng, n)
    shards = _int_shards(rng, n, 96)
    got = coll.all_reduce(shards)
    _same(got, jcoll.all_reduce(shards))
    c0 = eng.stats["transport"]["compiles"]
    q0 = eng.stats["transport"]["qdma_compiles"]
    shards2 = _int_shards(rng, n, 96)
    got2 = coll.all_reduce(shards2)
    _same(got2, jcoll.all_reduce(shards2))
    want2 = _psum_oracle(shards2)
    for p in range(n):
        assert np.array_equal(got2[p][:96].numpy(), want2[p])
    rel = eng.stats.get("reliability", {})
    assert rel.get("retransmits", 0) > 0, "drop profile never fired"
    assert rel["retransmits"] == jeng.stats["reliability"]["retransmits"]
    assert eng.stats["transport"]["compiles"] == c0
    assert eng.stats["transport"]["qdma_compiles"] == q0
    assert coll.stats == jcoll.stats


def test_overlapped_flushes_with_multiple_buckets():
    rng = np.random.default_rng(4)
    n = 2
    coll = RDMACollective(_engine(n, pool=1 << 15), n, pipeline_depth=2)
    jcoll = JCollective(_jengine(n, pool=1 << 15), n, pipeline_depth=2)
    buckets = [_int_shards(rng, n, 256) for _ in range(4)]
    got = coll.all_reduce_buckets(buckets)
    jgot = jcoll.all_reduce_buckets(buckets)
    for b in range(4):
        want = _psum_oracle(buckets[b])
        for p in range(n):
            assert np.array_equal(got[b][p][:256].numpy(), want[p])
        _same(got[b], jgot[b])
    assert coll.stats["overlapped_flushes"] > 0
    assert coll.stats["flushes"] >= coll.stats["overlapped_flushes"]
    assert coll.stats == jcoll.stats


def test_device_tensor_shards_stay_tensors():
    """Tensor shards (a train step's gradients) load without a host
    round trip, odd sizes padded on their device; results equal the
    numpy path's."""
    rng = np.random.default_rng(8)
    n = 3
    shards = _int_shards(rng, n, 101)
    a = RDMACollective(_engine(n), n).all_reduce(shards)
    b = RDMACollective(_engine(n), n).all_reduce(
        [torch.from_numpy(s) for s in shards])
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def test_drr_serving_fairness_while_training_streams():
    def serve_and_reduce(eng, coll_cls):
        hi = eng.pool_size - 512
        eng.register_mr(0, hi, 256)
        src = eng.register_mr(1, hi, 256)
        qa = eng.create_qp(0, 1, weight=2)
        qb = eng.create_qp(0, 1, weight=2)
        for i in range(24):
            for qp in (qa, qb):
                eng.post_send(qp, WQE(Opcode.READ, qp.qp_num,
                                      wr_id=9000 + i, local_addr=hi,
                                      remote_addr=src.base, length=4,
                                      rkey=src.rkey))
                eng.ring_sq_doorbell(qp, defer=True)
        rng = np.random.default_rng(5)
        coll = coll_cls(eng, 2, weight=2, pipeline_depth=2)
        buckets = [_int_shards(rng, 2, 256) for _ in range(3)]
        got = coll.all_reduce_buckets(buckets)
        for b in range(3):
            assert np.array_equal(np.asarray(got[b][0])[:256],
                                  _psum_oracle(buckets[b])[0])
        return [eng.stats["qp_service"].get(q.qp_num, 0)
                for q in (qa, qb)], coll.stats

    served, led = serve_and_reduce(
        _engine(2, pool=1 << 14, scheduler="drr", flush_budget=6),
        RDMACollective)
    jserved, jled = serve_and_reduce(
        _jengine(2, pool=1 << 14, scheduler="drr", flush_budget=6),
        JCollective)
    assert served[0] > 0, "serving tenants never interleaved"
    assert jain_fairness_index(served) == 1.0, served
    assert served == jserved and led == jled


def test_collective_error_surfaces_statuses():
    rng = np.random.default_rng(6)
    eng = _engine(2)
    inj = eng.install_fault_injector(FaultInjector(0))
    coll = RDMACollective(eng, 2, max_flushes=8)
    inj.stall_peer(1)
    with pytest.raises(CollectiveError) as err:
        coll.all_reduce(_int_shards(rng, 2, 64))
    jeng = _jengine(2)
    jeng.install_fault_injector(JFaultInjector(0)).stall_peer(1)
    with pytest.raises(Exception) as jerr:
        JCollective(jeng, 2, max_flushes=8).all_reduce(
            _int_shards(rng, 2, 64))
    assert str(err.value) == str(jerr.value)
    assert sorted(s.value for s in err.value.statuses.values()) == sorted(
        s.value for s in jerr.value.statuses.values())


def test_reserved_slots_fit_buckets_that_grow():
    """The rdma step's pool holds ``pipeline_depth`` slots of the
    largest bucket; first-fit slots for buckets that grow along the plan
    overflow it in both packages (the reference's fault), and slots
    reserved at the largest size fit every bucket."""
    n, depth, largest = 2, 2, 3840
    pool = 1 << (2 * largest * depth + 1024 - 1).bit_length()
    rng = np.random.default_rng(10)
    buckets = [_int_shards(rng, n, w) for w in (1000, 1000, 2000, 2000,
                                                largest, largest)]
    for coll in (JCollective(_jengine(n, pool), n, pipeline_depth=depth),
                 RDMACollective(_engine(n, pool), n, pipeline_depth=depth)):
        with pytest.raises(MemoryError, match="arena exhausted"):
            coll.all_reduce_buckets(buckets)
    coll = RDMACollective(_engine(n, pool), n, pipeline_depth=depth)
    coll.reserve(largest)
    got = coll.all_reduce_buckets(buckets)
    for b, shards in enumerate(buckets):
        assert np.array_equal(got[b][0].numpy(), _psum_oracle(shards)[0])
    assert len(coll._slots) == depth


def test_bucketize_bills_dtype_itemsize():
    grads = {"a": torch.zeros(100, dtype=torch.float32),
             "b": torch.zeros(100, dtype=torch.bfloat16),
             "c": torch.zeros(100, dtype=torch.int8)}
    leaves, buckets = _bucketize(grads, 512)
    assert [l.dtype for l in leaves] == [torch.float32, torch.bfloat16,
                                         torch.int8]
    assert sum(b.bytes for b in buckets) == 700
    assert len(buckets) == 2, [b.bytes for b in buckets]


def test_rdma_step_refuses_compression_and_a_missing_peer_count():
    tc = get_config("tiny")
    with pytest.raises(ValueError, match="compress_grads"):
        make_bucketed_train_step(tc, TrainConfig(compress_grads=True), None,
                                 sync="rdma", n_peers=2)
    with pytest.raises(ValueError, match="n_peers"):
        make_bucketed_train_step(tc, TrainConfig(), None, sync="rdma")


def test_rdma_train_step_end_to_end():
    """sync='rdma' on tiny against the JAX package's rdma step (loss,
    parameters, ledger) and against the port's plain step (gradients);
    two steps: loss falls, zero warm compiles, overlapped flushes."""
    jc, tc = jax_config("tiny"), get_config("tiny")
    cfg = dict(remat=False, zero1=False, sequence_parallel=False,
               grad_bucket_mb=0.0625)
    jp = j_init_params(jc, jax.random.PRNGKey(0))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    step = make_bucketed_train_step(tc, TrainConfig(**cfg), None,
                                    sync="rdma", n_peers=2)
    jstep = JTR.make_bucketed_train_step(jc, JTrainConfig(**cfg), None,
                                         sync="rdma", n_peers=2)
    tok = np.random.default_rng(9).integers(0, tc.vocab_size, (4, 33))
    b = {"tokens": tok[:, :-1].astype(np.int32),
         "labels": tok[:, 1:].astype(np.int32)}
    tb = {k: torch.from_numpy(v) for k, v in b.items()}
    step.keep_grads = True
    loss1, p1, o1, _ = step(tp, init_adam(tp), tb, None)
    jloss1, jp1, _, _ = jstep(jp, JTR.init_adam(jp),
                              {k: jnp.asarray(v) for k, v in b.items()},
                              None)
    assert abs(float(loss1) - float(jloss1)) <= 1e-5 * float(jloss1)
    for g, w in zip(tree_leaves(p1), jax.tree.leaves(jp1)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=1e-5)
    eng = step.collective(0).engine
    jeng = jstep.collective(0).engine
    assert eng.stats["collectives"] == jeng.stats["collectives"]
    assert eng.pool_size == jeng.pool_size

    plain = make_train_step(tc, TrainConfig(**cfg))
    plain.keep_grads = True
    plain(tp, init_adam(tp), tb)
    norm = float(global_norm(plain.last_grads))
    diff = max(float((a - b).abs().max()) for a, b in zip(
        tree_leaves(step.last_grads), tree_leaves(plain.last_grads)))
    assert diff <= 1e-6 * norm, (diff, norm)

    c0 = eng.stats["transport"]["compiles"]
    q0 = eng.stats["transport"]["qdma_compiles"]
    loss2, _, _, _ = step(p1, o1, tb, None)
    assert np.isfinite(float(loss1))
    assert float(loss2) < float(loss1), (float(loss1), float(loss2))
    assert eng.stats["transport"]["compiles"] == c0
    assert eng.stats["transport"]["qdma_compiles"] == q0
    assert eng.stats["collectives"]["overlapped_flushes"] > 0
    assert eng.stats["collectives"]["wire_bytes"] > 0

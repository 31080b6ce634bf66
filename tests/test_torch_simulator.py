"""The port's cost model and paper-§V simulator against the JAX package's.

The simulator is plain Python float arithmetic on both sides, ported
expression for expression, so every output is held with ``==`` (bit
equality), never a tolerance: every public ``simulate_*`` function,
``sweep``, ``doorbell_flush_time`` and ``simulate_host_access`` over a
grid of payloads, batches, QP locations and shapes; ``run_testcase`` over
every ``tests/testcases/*.json`` (each must pass, and return the
reference's dict); the property tests of ``tests/test_simulator.py``.

``predict_from_stats`` is fed the ``engine.stats`` of the port's and the
JAX package's engines after the same traffic (datapath, streaming and
dispatch, KV serving, collectives, reliability, an autotune sweep): the
two stats surfaces must be equal, and the port's prediction must be the
reference's under the reference's executor constants
(``repro.core.rdma.cost_model.XLA_COST``, injected as ``executor=``).
"""
import dataclasses
import glob
import itertools
import os

import numpy as np
import pytest
from hypothesis import given, settings, strategies as st

import repro.core.rdma.cost_model as JCM
import repro.core.rdma.simulator as JS
import repro.train.collectives as JCOL
import repro_torch.core.rdma.cost_model as TCM
import repro_torch.core.rdma.simulator as TS
import repro_torch.train.collectives as TCOL
from _torch_sides import JAX, TORCH, assert_same, snapshot

TESTCASE_DIR = os.path.join(os.path.dirname(__file__), "testcases")
CASES = sorted(glob.glob(os.path.join(TESTCASE_DIR, "*.json")))
XLA = JCM.XLA_COST

PAYLOADS = (1, 64, 100, 2048, 4096, 16384, 32768, 65536, 1 << 20)


# ---------------------------------------------------------------------------
# cost model
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["PAPER_HW", "LC_OFFLOAD", "STREAMING_RX"])
def test_profiles_equal_the_reference(name):
    got, want = getattr(TCM, name), getattr(JCM, name)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


def test_paper_hw_derived_values_bit_equal():
    assert TCM.PAPER_HW.pcie_rate == JCM.PAPER_HW.pcie_rate
    for n in (0, 1, 63, 64, 65, 1000, 2047, 2048, 2049, 1 << 16, 1 << 26):
        assert (TCM.PAPER_HW.host_access_latency(n)
                == JCM.PAPER_HW.host_access_latency(n))


def test_executor_profile_has_the_reference_fields_and_no_tpu():
    """``ExecutorCost`` carries ``XLACost``'s three fields (so either can
    be injected); no TPU profile is ported."""
    assert ({f.name for f in dataclasses.fields(TCM.ExecutorCost)}
            == {f.name for f in dataclasses.fields(JCM.XLACost)})
    assert not hasattr(TCM, "TPU_V5E") and not hasattr(TCM, "TpuV5e")
    assert not hasattr(TCM, "XLA_COST")
    assert isinstance(TCM.EXECUTOR_COST, TCM.ExecutorCost)
    assert all(v >= 0.0 for v in dataclasses.astuple(TCM.EXECUTOR_COST))


@pytest.mark.parametrize("shares", [[], [0, 0], [3], [1, 1, 1], [6, 2, 2, 2],
                                    [0.5, 0.25, 7.0], [1e-9, 1e9]])
def test_jain_fairness_index_bit_equal(shares):
    assert (TCM.jain_fairness_index(shares)
            == JCM.jain_fairness_index(shares))


def test_collective_byte_helpers_bit_equal():
    for nbytes, n in itertools.product((1, 4096, 1 << 30), (1, 2, 3, 8)):
        assert (TCM.ring_all_reduce_bytes(nbytes, n)
                == JCM.ring_all_reduce_bytes(nbytes, n))
        assert TCM.all_gather_bytes(nbytes, n) == JCM.all_gather_bytes(
            nbytes, n)


# ---------------------------------------------------------------------------
# simulator: bit-equal over grids
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("op", ["read", "write"])
@pytest.mark.parametrize("qp_location", ["host_mem", "dev_mem"])
@pytest.mark.parametrize("batch", [0, 1, 2, 50, 200])
def test_simulate_rdma_bit_equal(op, qp_location, batch):
    for payload in PAYLOADS:
        got = TS.simulate_rdma(op, payload, batch, qp_location)
        want = JS.simulate_rdma(op, payload, batch, qp_location)
        assert dataclasses.astuple(got) == dataclasses.astuple(want)
        assert got.as_row() == want.as_row()


def test_simulate_rdma_bad_op_raises_on_both():
    for mod in (TS, JS):
        with pytest.raises(ValueError):
            mod.simulate_rdma("send", 64, 1)


@pytest.mark.parametrize("op,batch,qp_location", [
    ("read", 1, "host_mem"), ("read", 50, "host_mem"),
    ("write", 50, "dev_mem"), ("write", 7, "host_mem")])
def test_sweep_bit_equal(op, batch, qp_location):
    got = TS.sweep(op, list(PAYLOADS), batch, qp_location)
    want = JS.sweep(op, list(PAYLOADS), batch, qp_location)
    assert [dataclasses.astuple(r) for r in got] == [
        dataclasses.astuple(r) for r in want]


@pytest.mark.parametrize("qp_location", ["host_mem", "dev_mem"])
def test_doorbell_flush_time_bit_equal(qp_location):
    for served, payload in itertools.product((0, 1, 2, 16, 50, 1000),
                                             PAYLOADS):
        assert (TS.doorbell_flush_time(served, payload, qp_location)
                == JS.doorbell_flush_time(served, payload, qp_location))


@pytest.mark.parametrize("depths,scheduler,weights,budget,promote", [
    ([64, 8, 8, 8], "rr", None, 16, None),
    ([64, 8, 8, 8], "fifo", None, 16, None),
    ([64, 8, 8, 8], "fifo", None, 16, 2),
    ([60, 12], "drr", [5, 1], 3, None),
    ([60, 12], "rr", [5, 1], 3, None),
    ([48, 16, 16, 16], "drr", [3, 1, 1, 1], 12, None),
    ([5, 0, 9], "rr", [1, 2, 3], 4, None),
    ([0, 0], "rr", None, 16, None),
])
def test_simulate_fair_schedule_bit_equal(depths, scheduler, weights,
                                          budget, promote):
    for payload, qp_location in itertools.product(
            (256, 4096), ("host_mem", "dev_mem")):
        kw = dict(scheduler=scheduler, weights=weights, budget=budget,
                  payload=payload, qp_location=qp_location,
                  promote_after=promote)
        assert (TS.simulate_fair_schedule(depths, **kw)
                == JS.simulate_fair_schedule(depths, **kw))


@pytest.mark.parametrize("m,k,n,elem_bytes,qp_location", [
    (512, 16, 512, 4, "dev_mem"), (2048, 2048, 2048, 4, "dev_mem"),
    (1, 1, 1, 2, "host_mem"), (300, 77, 5, 2, "host_mem")])
def test_simulate_lc_offload_bit_equal(m, k, n, elem_bytes, qp_location):
    assert (TS.simulate_lc_offload(m, k, n, elem_bytes, qp_location)
            == JS.simulate_lc_offload(m, k, n, elem_bytes, qp_location))


@pytest.mark.parametrize("n_pkts,burst", [(1, 1), (1024, 32), (1000, 48),
                                          (16384, 64)])
@pytest.mark.parametrize("pipeline_depth", [1, 2, 4])
def test_simulate_streaming_rx_bit_equal(n_pkts, burst, pipeline_depth):
    for qp_location in ("dev_mem", "host_mem"):
        assert (TS.simulate_streaming_rx(n_pkts, burst, pipeline_depth,
                                         qp_location)
                == JS.simulate_streaming_rx(n_pkts, burst, pipeline_depth,
                                            qp_location))


@pytest.mark.parametrize("n_pkts,shares,burst", [
    (1024, (0.5, 0.5), 32), (16384, (0.5, 0.3, 0.2), 32),
    (100, (1.0,), 8), (37, (0.999, 0.001), 4), (10, (1, 1, 1, 1, 1, 1), 3)])
@pytest.mark.parametrize("pipeline_depth", [1, 4])
def test_simulate_dispatch_bit_equal(n_pkts, shares, burst, pipeline_depth):
    assert (TS.simulate_dispatch(n_pkts, shares, burst, pipeline_depth)
            == JS.simulate_dispatch(n_pkts, shares, burst, pipeline_depth))


@pytest.mark.parametrize("n_pkts,rows,burst", [
    (4096, (64, 65, 2), 32), (100, (16, 16), 8), (33, (8, 4, 2, 1), 16),
    (1, (64, 65, 2), 32)])
@pytest.mark.parametrize("pipeline_depth", [1, 4])
def test_simulate_chain_bit_equal(n_pkts, rows, burst, pipeline_depth):
    for qp_location in ("dev_mem", "host_mem"):
        assert (TS.simulate_chain(n_pkts, rows, burst, pipeline_depth,
                                  qp_location)
                == JS.simulate_chain(n_pkts, rows, burst, pipeline_depth,
                                     qp_location))


@pytest.mark.parametrize("algorithm", ["ring", "rd"])
@pytest.mark.parametrize("n_peers", [1, 2, 3, 4, 5, 8])
def test_simulate_collective_bit_equal(algorithm, n_peers):
    for payload, n_buckets, depth in itertools.product(
            (4096, 1 << 20, 3 * (1 << 20) + 7), (1, 3, 8), (1, 2, 4)):
        assert (TS.simulate_collective(payload, n_peers, algorithm,
                                       n_buckets, depth)
                == JS.simulate_collective(payload, n_peers, algorithm,
                                          n_buckets, depth))


def test_simulate_collective_unknown_algorithm_raises_on_both():
    for mod in (TS, JS):
        with pytest.raises(ValueError):
            mod.simulate_collective(4096, 4, algorithm="tree")


def test_simulate_dma_and_host_access_bit_equal():
    for n in PAYLOADS + (0, 1 << 26, 1 << 30):
        for direction in ("read", "write"):
            assert (TS.simulate_dma(n, direction)
                    == JS.simulate_dma(n, direction))
        assert TS.simulate_host_access(n) == JS.simulate_host_access(n)


# ---------------------------------------------------------------------------
# JSON testcases (paper §V framework)
# ---------------------------------------------------------------------------

def test_every_testcase_is_covered():
    assert len(CASES) >= 8


@pytest.mark.parametrize("path", CASES, ids=os.path.basename)
def test_run_testcase_passes_and_equals_reference(path):
    got = TS.run_testcase(path)
    assert got["pass"], f"{path}: {got['checks']}"
    assert got == JS.run_testcase(path)


def test_run_testcase_unknown_golden_key_and_op():
    tc = {"op": "fair_schedule", "qp_depths": [4, 4],
          "golden": {"throughput_gbps": 1.0, "rtol": 0.1}}
    got = TS.run_testcase(tc)
    assert got == JS.run_testcase(tc)
    assert not got["pass"]
    assert got["checks"] == [("throughput_gbps", 1.0, None, False)]
    for mod in (TS, JS):
        with pytest.raises(ValueError):
            mod.run_testcase({"op": "teleport"})


# ---------------------------------------------------------------------------
# the reference's property tests, on the port
# ---------------------------------------------------------------------------

class TestSimulatorProperties:
    @settings(max_examples=40, deadline=None)
    @given(payload=st.integers(64, 1 << 20), batch=st.integers(1, 200))
    def test_throughput_below_line_rate(self, payload, batch):
        r = TS.simulate_rdma("read", payload, batch)
        assert r.throughput_bps <= TCM.PAPER_HW.line_rate * 8 + 1e-9

    @settings(max_examples=40, deadline=None)
    @given(payload=st.integers(64, 1 << 18))
    def test_batching_never_hurts(self, payload):
        single = TS.simulate_rdma("read", payload, 1)
        batch = TS.simulate_rdma("read", payload, 50)
        assert batch.throughput_bps >= single.throughput_bps

    @settings(max_examples=20, deadline=None)
    @given(payload=st.integers(64, 1 << 16), batch=st.integers(1, 100))
    def test_dev_mem_qp_no_slower(self, payload, batch):
        host = TS.simulate_rdma("read", payload, batch, "host_mem")
        dev = TS.simulate_rdma("read", payload, batch, "dev_mem")
        assert dev.total_time <= host.total_time + 1e-12


# ---------------------------------------------------------------------------
# predict_from_stats on both engines' stats under the same traffic
# ---------------------------------------------------------------------------

POOL = 1 << 14
DATA_PEER, LC_PEER = 1, 0
COLL = {"jax": JCOL.RDMACollective, "torch": TCOL.RDMACollective}


def _reads(s, eng, qp, mr, lengths, seed=0):
    rng = np.random.default_rng(seed)
    for i, ln in enumerate(lengths):
        eng.post_send(qp, s.rdma.WQE(
            s.rdma.Opcode.READ, qp.qp_num, wr_id=i,
            local_addr=int(rng.integers(0, POOL // 4 - ln)),
            remote_addr=int(rng.integers(0, POOL // 4 - ln)),
            length=int(ln), rkey=mr.rkey))


def _datapath(s):
    """Fig 6 on a small matmul, a parser message and host READs on two
    contending QPs (one weighted), staged through ``write_buffer``."""
    eng = s.RDMAEngine(n_peers=2, pool_size=POOL)
    blk = s.lk.LookasideBlock(eng, peer=LC_PEER, scratch_base=POOL // 2)
    s.K.register_default_kernels(blk)
    mr = eng.register_mr(DATA_PEER, 0, POOL // 2)
    rng = np.random.default_rng(1)
    m, k, n = 8, 16, 8
    eng.write_buffer(DATA_PEER, 0, rng.integers(-3, 4, m * k).astype(
        np.float32))
    eng.write_buffer(DATA_PEER, m * k, rng.integers(-3, 4, k * n).astype(
        np.float32))
    assert blk.dispatch(s.lk.ControlMsg(
        s.K.MM_WORKLOAD, (DATA_PEER, mr.rkey, 0, m * k, 2 * m * k + k * n,
                          m, k, n), tag=1)) is None
    assert blk.poll(s.K.MM_WORKLOAD).ok
    qa, qb = eng.create_qp(LC_PEER, DATA_PEER), eng.create_qp(
        LC_PEER, DATA_PEER, weight=3)
    _reads(s, eng, qa, mr, [7, 20, 33, 64], seed=2)
    _reads(s, eng, qb, mr, [16] * 9, seed=3)
    eng.ring_sq_doorbell(qa, defer=True)
    eng.ring_sq_doorbell(qb, defer=True)
    while eng._armed:
        eng.flush_doorbells()
    return eng


def _streaming(s):
    """Mixed-class headers through the router into a ring, drained by
    the match→action dispatcher."""
    depth, ctrl, bulk = 16, 9000, 9100
    eng = s.RDMAEngine(n_peers=2, pool_size=POOL)
    blk = s.lk.LookasideBlock(eng, peer=LC_PEER, scratch_base=POOL // 2,
                              scratch_size=POOL // 4, pipeline_depth=4,
                              eager_writeback=False)
    s.K.register_default_kernels(blk)
    ring = s.S.RXRing(eng, peer=LC_PEER, base=POOL - depth * 64,
                      depth=depth, policy="drop")
    meta_mr = eng.register_mr(DATA_PEER, 0, depth * 4)
    quant_mr = eng.register_mr(DATA_PEER, 2048, depth * s.K.QUANT_ROW)
    table = (s.S.MatchTable(default=s.S.Drop())
             .add(s.S.Forward(), priority=10, is_rdma=1)
             .add(s.S.Handler(s.K.STREAM_PARSER_WORKLOAD), udp_dport=ctrl)
             .add(s.S.Handler(s.K.STREAM_QUANT_WORKLOAD), udp_dport=bulk))
    disp = s.S.StreamDispatcher(blk, ring, table, burst=4)
    disp.register_handler(s.K.STREAM_PARSER_WORKLOAD, DATA_PEER,
                          meta_mr.rkey, 0)
    disp.register_handler(s.K.STREAM_QUANT_WORKLOAD, DATA_PEER,
                          quant_mr.rkey, 2048)
    router = s.TrafficRouter(rx_ring=ring, table=disp.table)
    rng = np.random.default_rng(5)
    hdrs = []
    for i in range(30):
        if i % 3 == 0:
            hdrs.append(s.S.make_roce_header(4, i))
        else:
            h = s.S.make_roce_header(i % 18, i, is_rdma=False,
                                     dport=ctrl if i % 3 == 1 else bulk)
            h[50:] = rng.integers(0, 256, 14).astype(np.uint8)
            hdrs.append(h)
    router.ingest_packets(np.stack(hdrs))
    disp.service()
    return eng


def _kv_serving(s):
    eng = s.RDMAEngine(n_peers=2, pool_size=POOL)
    pool = s.kv.PagedKVPool(eng, 0, page_elems=64, max_pages=6)
    rng = np.random.default_rng(0)
    for seq in (0, 1):
        for row in rng.standard_normal((3, 64)).astype(np.float32):
            pool.write_page(pool.append_page(seq), row)
    client = s.kv.RemoteKVClient(eng, 1, pool)
    gold = client.register_tenant("gold", weight=2)
    best = client.register_tenant("best")
    client.complete(client.fetch_sequence(gold, 0))
    client.complete(client.fetch_sequence(best, 1))
    return eng


def _collectives(s):
    eng = s.RDMAEngine(n_peers=4, pool_size=POOL)
    rng = np.random.default_rng(4)
    shards = [rng.integers(-8, 9, 100).astype(np.float32) for _ in range(4)]
    coll = COLL[s.name](eng, 4, algorithm="ring")
    coll.all_reduce(shards)
    coll.all_reduce([x * 2 for x in shards])
    return eng


def _reliability(s):
    eng = s.RDMAEngine(n_peers=3, pool_size=POOL)
    eng.install_fault_injector(s.rdma.FaultInjector(7, drop=0.10))
    rng = np.random.default_rng(3)
    shards = [rng.integers(-8, 9, 96).astype(np.float32) for _ in range(3)]
    COLL[s.name](eng, 3).all_reduce(shards)
    mr = eng.register_mr(DATA_PEER, 0, POOL // 4)
    qp = eng.create_qp(LC_PEER, DATA_PEER)
    _reads(s, eng, qp, mr, [12] * 20, seed=8)
    eng.ring_sq_doorbell(qp)
    return eng


def _autotune(s):
    eng = s.RDMAEngine(n_peers=2, pool_size=1 << 12)
    mr = eng.register_mr(1, 0, 1024)
    qp = eng.create_qp(0, 1)
    _reads(s, eng, qp, mr, [7, 20, 33])
    eng.ring_sq_doorbell(qp)
    grid = s.rdma.TuningGrid(ring_burst=(16, 32), pipeline_depth=(1, 2),
                             flush_budget=(None, 8), qp_window=(None,))
    s.rdma.AutoTuner(eng, grid=grid, seed=3, passes=1, rows=16).sweep()
    return eng


def _stats(eng):
    """The engine's stats as host values; an autotune surface without
    its wall-clocks (informational, never scored)."""
    stats = snapshot(eng)["stats"]
    for row in (stats.get("autotune") or {}).get("surface", ()):
        row.pop("wall_s")
    return stats


@pytest.mark.parametrize("traffic", [_datapath, _streaming, _kv_serving,
                                     _collectives, _reliability, _autotune],
                         ids=lambda f: f.__name__.strip("_"))
def test_predict_from_stats_equals_reference_on_same_traffic(traffic):
    jeng, teng = traffic(JAX), traffic(TORCH)
    jstats, tstats = _stats(jeng), _stats(teng)
    assert_same(tstats, jstats)
    for payload, op, loc in ((16384, "read", "host_mem"),
                             (256, "write", "dev_mem"),
                             (4096, "write", "host_mem")):
        want = JS.predict_from_stats(jeng.stats, payload, op, loc, xla=XLA)
        assert want["wqes_per_doorbell"] > 0
        assert TS.predict_from_stats(teng.stats, payload, op, loc,
                                     executor=XLA) == want
        # the very same dict through both functions
        assert TS.predict_from_stats(jeng.stats, payload, op, loc,
                                     executor=XLA) == want
        for stats in (teng.stats, teng.stats["transport"]):
            assert (TS.predict_from_stats(stats, payload, op, loc,
                                          executor=XLA)
                    == JS.predict_from_stats(stats, payload, op, loc,
                                             xla=XLA))


def test_predict_from_stats_defaults_to_the_port_profile():
    """Without ``executor=`` the port prices with its own H100 profile;
    the paper-hardware terms do not depend on the profile."""
    stats = {"dispatches": 5, "transport": {
        "wqes": 250, "compiles": 1, "qdma_writes": 3, "qdma_compiles": 1}}
    out = TS.predict_from_stats(stats, 16384, op="read")
    x = TCM.EXECUTOR_COST
    assert out["executor_predicted_s"] == (1 * x.compile_s
                                           + 5 * x.dispatch_s
                                           + 1 * x.compile_s
                                           + 3 * x.staging_dispatch_s)
    ref = JS.predict_from_stats(stats, 16384, op="read")
    assert out["hw_predicted_s"] == ref["hw_predicted_s"]
    assert out["wqes_per_doorbell"] == ref["wqes_per_doorbell"] == 50.0

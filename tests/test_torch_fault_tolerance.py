"""The port's fault-tolerance runtime (``repro_torch.runtime.
fault_tolerance``) against the JAX package's, on the CPU: the cases of
``tests/test_system.py`` (failure loop, stragglers, elastic re-mesh) and
the heartbeat bridge cases of ``tests/test_reliability.py``, run on the
port and, where the reference's answer is data, compared with it
exactly (same dead hosts, plans, events and QP states)."""
import pytest

import repro.runtime.fault_tolerance as JFT
import repro_torch.runtime.fault_tolerance as TFT
from repro_torch.core.rdma.engine import RDMAEngine
from repro_torch.core.rdma.reliability import FaultInjector
from repro_torch.core.rdma.verbs import CQEStatus, Opcode, QPState, WQE
from repro_torch.runtime.fault_tolerance import (ElasticController,
                                                 EngineHeartbeatBridge,
                                                 HeartbeatMonitor, MeshPlan,
                                                 detect_stragglers,
                                                 plan_elastic_mesh)


def _write(qp, wr_id, rkey, length=8):
    return WQE(Opcode.WRITE, qp.qp_num, wr_id=wr_id, local_addr=0,
               remote_addr=0, length=length, rkey=rkey)


def _failure_loop(ft):
    t = [0.0]
    mon = ft.HeartbeatMonitor(16, timeout=10, clock=lambda: t[0])
    ctl = ft.ElasticController(mon, model_parallel=4, devices_per_host=4)
    for h in range(16):
        mon.beat(h)
    first = ctl.step(0)
    t[0] = 30.0
    for h in range(12):        # hosts 12..15 die
        mon.beat(h)
    plan = ctl.step(1, {h: 1.0 for h in range(12)})
    return first, plan, ctl.events, mon.alive_hosts()


def test_fault_tolerance_full_loop_matches_reference():
    first, plan, events, alive = _failure_loop(TFT)
    assert first is None and plan is not None
    assert plan.shape[-1] == 4                       # TP preserved
    assert plan.n_devices <= 12 * 4 and plan.n_devices % 4 == 0
    jfirst, jplan, jevents, jalive = _failure_loop(JFT)
    assert (plan.shape, plan.axes, plan.n_devices, plan.global_batch_scale
            ) == (jplan.shape, jplan.axes, jplan.n_devices,
                  jplan.global_batch_scale)
    assert events == jevents and alive == jalive


def test_straggler_detection():
    times = {0: 1.0, 1: 1.1, 2: 0.9, 3: 5.0, 4: 1.0}
    assert detect_stragglers(times) == [3] == JFT.detect_stragglers(times)
    assert detect_stragglers({0: 1.0}) == []
    assert detect_stragglers(times, threshold=6.0) == []


def test_straggler_is_excluded_at_the_next_step():
    mon = HeartbeatMonitor(4, timeout=1e9)
    ctl = ElasticController(mon, model_parallel=1, devices_per_host=1)
    plan = ctl.step(3, {0: 1.0, 1: 1.0, 2: 9.0, 3: 1.0})
    assert isinstance(plan, MeshPlan) and plan.n_devices == 2
    assert mon.alive_hosts() == [0, 1, 3]
    assert ctl.events[0] == {"step": 3, "straggler": 2}


@pytest.mark.parametrize("alive,tp,pods", [(300, 16, 1), (64, 4, 2),
                                           (17, 1, 4), (8, 8, 1)])
def test_elastic_mesh_math_matches_reference(alive, tp, pods):
    got = plan_elastic_mesh(alive, tp, prefer_pods=pods)
    want = JFT.plan_elastic_mesh(alive, tp, prefer_pods=pods)
    assert (got.shape, got.axes, got.n_devices, got.dropped_hosts,
            got.global_batch_scale) == (want.shape, want.axes,
                                        want.n_devices, want.dropped_hosts,
                                        want.global_batch_scale)
    assert plan_elastic_mesh(300, 16).shape == (16, 16)
    with pytest.raises(RuntimeError):
        plan_elastic_mesh(8, model_parallel=16)


class TestHeartbeatBridge:
    def test_cqe_traffic_beats_and_silence_fails_peer(self):
        clock = [0.0]
        eng = RDMAEngine(n_peers=3, pool_size=4096, device="cpu")
        mon = HeartbeatMonitor(3, timeout=5.0, clock=lambda: clock[0])
        bridge = EngineHeartbeatBridge(eng, mon)
        qp1, qp2 = eng.create_qp(0, 1), eng.create_qp(0, 2)
        mr1, mr2 = eng.register_mr(1, 0, 64), eng.register_mr(2, 0, 64)
        for qp, mr in ((qp1, mr1), (qp2, mr2)):
            eng.post_send(qp, _write(qp, 1, mr.rkey))
            eng.ring_sq_doorbell(qp)
        clock[0] = 4.0                    # peer 1 stays chatty...
        eng.post_send(qp1, _write(qp1, 2, mr1.rkey))
        eng.ring_sq_doorbell(qp1)
        clock[0] = 7.0                    # ...peer 2 goes silent
        dead = bridge.check()
        assert [p for p, _ in dead] == [2]
        assert dead[0][1] == [qp2] and bridge.failed == {2: [qp2]}
        assert qp2.state is QPState.ERROR and qp1.state is QPState.RTS
        assert bridge.check() == []       # dead only reported once

    def test_failed_peer_qps_drain_outstanding_wqes(self):
        clock = [0.0]
        eng = RDMAEngine(n_peers=2, pool_size=4096, device="cpu")
        inj = eng.install_fault_injector(FaultInjector(0))
        mon = HeartbeatMonitor(2, timeout=5.0, clock=lambda: clock[0])
        bridge = EngineHeartbeatBridge(eng, mon)
        qp = eng.create_qp(0, 1)
        mr = eng.register_mr(1, 0, 64)
        inj.stall_peer(1)
        eng.post_send(qp, _write(qp, 1, mr.rkey))
        eng.ring_sq_doorbell(qp, defer=True)
        eng.flush_doorbells()             # parked for replay, no CQE yet
        clock[0] = 7.0
        mon.beat(0)                       # local control plane keepalive
        (peer, qps), = bridge.check()
        assert peer == 1 and qps == [qp]
        eng.flush_doorbells()             # drain leg completes the WQE
        assert [c.status for c in eng.poll_cq(qp)] == \
               [CQEStatus.WR_FLUSH_ERROR]

    def test_error_cqes_do_not_refresh_the_remote_peer(self):
        """A CQE with an error status proves the local peer alive, not
        the remote one."""
        clock = [0.0]
        eng = RDMAEngine(n_peers=2, pool_size=4096, device="cpu")
        mon = HeartbeatMonitor(2, timeout=5.0, clock=lambda: clock[0])
        EngineHeartbeatBridge(eng, mon)
        qp = eng.create_qp(0, 1)
        clock[0] = 4.0
        eng.post_send(qp, _write(qp, 1, rkey=0xDEAD))   # bad rkey
        eng.ring_sq_doorbell(qp)
        (cqe,) = eng.poll_cq(qp)
        assert cqe.status is not CQEStatus.SUCCESS
        assert mon.hosts[0].last_heartbeat == 4.0
        assert mon.hosts[1].last_heartbeat == 0.0

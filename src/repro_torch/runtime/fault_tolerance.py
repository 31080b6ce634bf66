"""Fault-tolerance runtime: heartbeats, straggler detection, elastic
re-meshing.

The port's own copy of ``repro/runtime/fault_tolerance.py`` (plain
Python); ``EngineHeartbeatBridge`` listens on the port's ``RDMAEngine``
(its ``cqe_observers`` and ``fail_peer``).

At 1000+-node scale the control plane must (a) notice dead/slow hosts,
(b) rebuild a working mesh from the survivors, (c) restart from the last
checkpoint with data skip-ahead. The runtime restarts jobs rather
than hot-swapping devices, so this module implements the *controller
logic* (deterministic, fully unit-testable) plus the re-mesh math; the
launcher wires it to checkpoint + pipeline.

Straggler policy mirrors the paper's batching insight: a straggling
host's slow doorbell (dispatch) inflates every collective, so detection
is on step-time outliers and mitigation is exclusion at the next re-mesh
(checkpoint -> shrink -> resume), the standard elastic recipe.
"""
from __future__ import annotations

import math
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple


@dataclass
class HostState:
    host_id: int
    last_heartbeat: float
    step_times: List[float] = field(default_factory=list)
    alive: bool = True


class HeartbeatMonitor:
    """Tracks liveness; a host missing ``timeout`` seconds is dead."""

    def __init__(self, n_hosts: int, timeout: float = 60.0,
                 clock: Callable[[], float] = time.monotonic):
        self.timeout = timeout
        self.clock = clock
        now = clock()
        self.hosts = {i: HostState(i, now) for i in range(n_hosts)}

    def beat(self, host_id: int, step_time: Optional[float] = None) -> None:
        h = self.hosts[host_id]
        h.last_heartbeat = self.clock()
        if step_time is not None:
            h.step_times.append(step_time)
            del h.step_times[:-50]

    def check(self) -> List[int]:
        """Returns newly-dead host ids."""
        now = self.clock()
        dead = []
        for h in self.hosts.values():
            if h.alive and now - h.last_heartbeat > self.timeout:
                h.alive = False
                dead.append(h.host_id)
        return dead

    def alive_hosts(self) -> List[int]:
        return [h.host_id for h in self.hosts.values() if h.alive]


class EngineHeartbeatBridge:
    """Wires a ``HeartbeatMonitor`` to an ``RDMAEngine``'s completion
    stream: every successful CQE on a QP is proof-of-life for that QP's
    remote peer (RoCE traffic doubles as the heartbeat, the way a NIC's
    keepalive rides the data path), and a peer the monitor declares dead
    is failed at the engine — its QPs transition to ERROR and drain with
    WR_FLUSH_ERROR via the reliability layer's state machine, instead of
    their WQEs retrying into a void forever.

    ``monitor`` host ids are engine peer indices here. Call ``check()``
    wherever the control plane ticks (per flush loop, per training
    step): it returns the ``(peer, [qps-failed])`` list of newly-dead
    peers after notifying the engine.
    """

    def __init__(self, engine, monitor: HeartbeatMonitor):
        self.engine = engine
        self.monitor = monitor
        self.failed: Dict[int, list] = {}    # peer -> QPs moved to ERROR
        engine.cqe_observers.append(self._on_cqe)

    def _on_cqe(self, qp, cqe) -> None:
        # any CQE proves the LOCAL peer alive (the engine is running),
        # but only a SUCCESS completion proves the REMOTE peer processed
        # traffic — error/flush CQEs are engine-local and must not
        # refresh the far side's liveness
        if qp.local_peer in self.monitor.hosts:
            self.monitor.beat(qp.local_peer)
        if cqe.status.value == "success" and (
                qp.remote_peer in self.monitor.hosts):
            self.monitor.beat(qp.remote_peer)

    def check(self) -> List[Tuple[int, list]]:
        """Tick the monitor; fail newly-dead peers at the engine."""
        out = []
        for peer in self.monitor.check():
            qps = self.engine.fail_peer(peer)
            self.failed[peer] = qps
            out.append((peer, qps))
        return out


def detect_stragglers(step_times: Dict[int, float],
                      threshold: float = 2.0) -> List[int]:
    """Hosts whose step time exceeds threshold x median."""
    if len(step_times) < 3:
        return []
    times = sorted(step_times.values())
    median = times[len(times) // 2]
    if median <= 0:
        return []
    return [h for h, t in step_times.items() if t > threshold * median]


# ---------------------------------------------------------------------------
# Elastic re-meshing
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class MeshPlan:
    shape: tuple
    axes: tuple
    n_devices: int
    dropped_hosts: tuple
    global_batch_scale: float    # keep per-device batch constant


def largest_pow2_leq(n: int) -> int:
    return 1 << (n.bit_length() - 1) if n > 0 else 0


def plan_elastic_mesh(alive_devices: int, model_parallel: int,
                      prefer_pods: int = 1) -> MeshPlan:
    """Rebuild (pod, data, model) from the surviving device count.

    'model' (TP) degree is preserved (weights shard that way); the DP
    extent shrinks to the largest power-of-two of surviving hosts —
    keeping collectives power-of-two aligned, the standard elastic move.
    """
    if alive_devices < model_parallel:
        raise RuntimeError(
            f"cannot keep TP={model_parallel} with {alive_devices} devices")
    dp_total = largest_pow2_leq(alive_devices // model_parallel)
    pods = min(prefer_pods, dp_total)
    data = dp_total // pods
    if pods > 1:
        shape, axes = (pods, data, model_parallel), ("pod", "data", "model")
    else:
        shape, axes = (data, model_parallel), ("data", "model")
    used = pods * data * model_parallel
    return MeshPlan(shape, axes, used, (),
                    global_batch_scale=dp_total)


class ElasticController:
    """Drives the failure -> checkpoint -> re-mesh -> resume loop."""

    def __init__(self, monitor: HeartbeatMonitor, model_parallel: int,
                 devices_per_host: int = 4):
        self.monitor = monitor
        self.model_parallel = model_parallel
        self.devices_per_host = devices_per_host
        self.events: List[dict] = []

    def step(self, step_idx: int,
             step_times: Optional[Dict[int, float]] = None
             ) -> Optional[MeshPlan]:
        """Call once per training step. Returns a MeshPlan when a restart
        is required, else None."""
        dead = self.monitor.check()
        stragglers = (detect_stragglers(step_times)
                      if step_times else [])
        for h in stragglers:
            # a straggler is excluded like a failure (after confirmation)
            self.events.append({"step": step_idx, "straggler": h})
        if not dead and not stragglers:
            return None
        for h in stragglers:
            self.monitor.hosts[h].alive = False
        alive = self.monitor.alive_hosts()
        plan = plan_elastic_mesh(
            len(alive) * self.devices_per_host, self.model_parallel)
        self.events.append({"step": step_idx, "dead": dead,
                            "stragglers": stragglers,
                            "new_mesh": plan.shape})
        return plan

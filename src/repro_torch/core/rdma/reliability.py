"""Lossy-fabric reliability layer (RoCEv2 RC semantics, paper §III-A/§IV-B).

RecoNIC's RDMA offload engine is a *reliable connected* transport: every
request carries a packet sequence number (PSN), the responder ACKs
in-order arrivals and NAKs gaps, and the requester's retransmission
state machine replays from the lost PSN (go-back-N) until a bounded
retry budget is exhausted — at which point the QP transitions to ERROR
and every outstanding WQE surfaces a terminal error CQE instead of
hanging the host. This module is that state machine for the emulated
engine, mapped onto the paper's blocks as follows:

  PSN sequencing      — each WQE admitted for transport gets the owning
                        QP's next send PSN (the paper's reliability
                        tracking inside the RDMA engine, Fig 2). The
                        responder side is modeled by an expected-PSN
                        cursor per QP: only the in-order head may land
                        (out-of-order arrivals are go-back-N discards),
                        so per-QP execution and CQE order always equal
                        posting order, faults or not.
  ACK / NAK ledger    — a delivered head advances the cursor (ACK); a
                        corrupted packet is an ICRC-style discard + NAK
                        (replay next flush); a silent drop is noticed by
                        the requester's retransmission timer (``
                        timeout_flushes`` engine flushes). Both land in
                        ``engine.stats["reliability"]`` (acks, naks,
                        timeouts, retransmits).
  go-back-N replay    — un-ACKed WQEs re-enter ``doorbell.schedule_plan``
                        as that QP's window on a later flush: replayed
                        traffic flows through the SAME pow2 descriptor-
                        table shape buckets (the same bucket keys as
                        first-time traffic) and is charged to the
                        owning QP's DRR deficit, so a retransmit storm
                        cannot starve innocent tenants.
  RNR backoff         — SEND into an empty RQ is an RNR NAK: the WQE is
                        replayed after an exponentially growing number
                        of flushes (the RNR timer field), ledgered in
                        ``backoff_us``; ``rnr_retry`` exhaustion is
                        terminal.
  QP state machine    — RTS → ERROR (retry/RNR exhaustion, dead peer) →
                        drain (every queued WQE completes with
                        WR_FLUSH_ERROR) → ``engine.recover_qp`` back to
                        RTS with a fresh PSN epoch.
  fault injection     — ``FaultInjector`` sits at the transport boundary
                        (installed on ``transport.fault_injector``): a
                        seeded RNG decides per WQE *transmission* whether
                        the wire delivers, drops, duplicates, delays, or
                        corrupts it, and can stall a peer outright (every
                        packet to/from it is lost until ``unstall``).
                        Duplicates are discarded by the responder's PSN
                        ledger (never re-executed — a stale replay must
                        not clobber newer bytes); delays deliver late,
                        reordering traffic *across* QPs while PSN order
                        holds within each QP.

Invariant the conformance suite pins: under any seeded fault profile
that eventually delivers (≤ 20 % loss), final buffer pools are
byte-identical to the fault-free run and per-QP CQE order equals
posting order; retry exhaustion never raises — it completes.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.rdma.verbs import CQE, CQEStatus, QPState, QueuePair, WQE

#: verdicts a FaultInjector returns for one WQE transmission
DELIVER = "deliver"
DROP = "drop"
DUPLICATE = "duplicate"
DELAY = "delay"
CORRUPT = "corrupt"


@dataclass(frozen=True)
class FaultProfile:
    """Per-transmission fault rates (independent draws, summed < 1)."""
    drop: float = 0.0        # silent loss: requester timer notices
    duplicate: float = 0.0   # wire duplicate: responder PSN ledger drops
    delay: float = 0.0       # late delivery: reorders across QPs
    corrupt: float = 0.0     # ICRC fail at responder: immediate NAK

    def __post_init__(self):
        total = self.drop + self.duplicate + self.delay + self.corrupt
        if not 0.0 <= total <= 1.0:
            raise ValueError(f"fault rates must sum into [0, 1]: {total}")


class FaultInjector:
    """Deterministic, seeded fault source at the transport boundary.

    One RNG draw per WQE transmission attempt, in flush order — the same
    workload + seed always faults the same transmissions. ``only_qps``
    scopes the profile to a victim set (innocent QPs see a perfect
    wire); ``stall_peer`` makes a peer unreachable outright.
    """

    def __init__(self, seed: int, profile: Optional[FaultProfile] = None,
                 only_qps: Optional[Sequence[int]] = None, **rates):
        if profile is not None and rates:
            raise ValueError("pass profile= or rates, not both")
        self.profile = profile if profile is not None else FaultProfile(
            **rates)
        self.seed = seed
        self.rng = np.random.default_rng(seed)
        self.only_qps = set(only_qps) if only_qps is not None else None
        self.stalled: set = set()
        self.stats = {v: 0 for v in
                      (DELIVER, DROP, DUPLICATE, DELAY, CORRUPT)}
        self.stats["stalled_drops"] = 0

    def stall_peer(self, peer: int) -> None:
        """Make a peer unreachable (both directions) until unstalled."""
        self.stalled.add(peer)

    def unstall_peer(self, peer: int) -> None:
        self.stalled.discard(peer)

    def verdict(self, qp: QueuePair) -> str:
        """Fate of one transmission on ``qp``'s connection. Stalled peers
        lose every packet *without* consuming an RNG draw, so recovery
        traffic replays the same fault tape as an undisturbed run."""
        if qp.local_peer in self.stalled or qp.remote_peer in self.stalled:
            self.stats["stalled_drops"] += 1
            return DROP
        if self.only_qps is not None and qp.qp_num not in self.only_qps:
            return DELIVER
        p = self.profile
        u = float(self.rng.random())
        for rate, kind in ((p.drop, DROP), (p.duplicate, DUPLICATE),
                           (p.delay, DELAY), (p.corrupt, CORRUPT)):
            if u < rate:
                self.stats[kind] += 1
                return kind
            u -= rate
        self.stats[DELIVER] += 1
        return DELIVER


@dataclass(frozen=True)
class ReliabilityConfig:
    """Retransmission-policy knobs (RoCEv2 QP attribute analogues)."""
    retry_cnt: int = 7          # transport retries before terminal error
    rnr_retry: int = 7          # RNR replays before terminal error
    timeout_flushes: int = 1    # retransmission timer, in engine flushes
    delay_flushes: int = 1      # late-delivery latency of a DELAY fault
    rnr_base_flushes: int = 1   # first RNR backoff; doubles per NAK
    rnr_max_flushes: int = 64   # backoff ceiling (RoCE RNR timer cap)
    rnr_timer_us: float = 64.0  # modeled µs per base backoff unit


class _TxRecord:
    """One un-ACKed WQE: its PSN, transmission count, and replay timer."""
    __slots__ = ("wqe", "psn", "attempt", "rnr_attempts", "due_in",
                 "reason")

    def __init__(self, wqe: WQE, psn: int):
        self.wqe = wqe
        self.psn = psn
        self.attempt = 0        # transmissions so far
        self.rnr_attempts = 0
        self.due_in = 0         # flushes until the head may replay
        self.reason = None      # why it waits: timeout | nak | rnr | delay


class _QPRel:
    """Per-QP requester state: PSN counters + the un-ACKed window."""
    __slots__ = ("next_psn", "expected_psn", "queue")

    def __init__(self):
        self.next_psn = 0       # next send PSN to assign
        self.expected_psn = 0   # responder's expected PSN (in-order head)
        self.queue: List[_TxRecord] = []   # un-delivered, PSN order


def new_reliability_stats() -> dict:
    """The ``engine.stats["reliability"]`` ledger (all monotonic except
    the ``retx_pressure`` gauge)."""
    return {"psn_assigned": 0, "acks": 0, "naks": 0, "rnr_naks": 0,
            "timeouts": 0, "retransmits": 0, "dropped": 0, "corrupt": 0,
            "delayed": 0, "dup_delivered": 0, "dup_suppressed": 0,
            "backoff_us": 0.0, "qp_errors": 0, "flushed_wqes": 0,
            "recovered": 0, "shed": 0, "retx_pressure": 0}


class ReliabilityLayer:
    """Engine-side reliability: threads PSN tracking, the ACK/NAK ledger
    and go-back-N replay through ``flush_doorbells``.

    The engine consults it in four places: ``begin_flush`` (tick replay
    timers, drain ERROR QPs), ``window`` (what to offer the scheduler:
    the due un-ACKed window, else fresh SQ WQEs), ``process`` (one
    scheduled transmission: fault verdict → execute / queue replay),
    and the armed-list refresh (QPs with un-ACKed WQEs stay armed).
    While a QP has an un-ACKed window, fresh WQEs are withheld (the
    requester's send window closes) — replays therefore always run in
    PSN order and CQE order can never invert.
    """

    def __init__(self, engine, config: Optional[ReliabilityConfig] = None):
        self.engine = engine
        self.cfg = config or ReliabilityConfig()
        self._qps: Dict[int, _QPRel] = {}
        self.stats = engine.stats.setdefault(
            "reliability", new_reliability_stats())

    # ------------------------------------------------------------- queries
    def _rel(self, qp_num: int) -> _QPRel:
        rel = self._qps.get(qp_num)
        if rel is None:
            rel = self._qps[qp_num] = _QPRel()
        return rel

    def pending(self, qp_num: int) -> int:
        """Un-ACKed WQEs held for replay on one QP."""
        rel = self._qps.get(qp_num)
        return len(rel.queue) if rel is not None else 0

    def outstanding(self) -> int:
        """Un-ACKed WQEs across every QP — the retransmit-pressure gauge
        the dispatch plane's load shedder reads."""
        return sum(len(r.queue) for r in self._qps.values())

    # ------------------------------------------------------------ lifecycle
    def begin_flush(self) -> None:
        """Advance replay timers one flush and drain ERROR-state QPs."""
        for qp_num, rel in self._qps.items():
            if rel.queue:
                head = rel.queue[0]
                if head.due_in > 0:
                    head.due_in -= 1
                    if head.due_in == 0 and head.reason == "timeout":
                        self.stats["timeouts"] += 1
        self.drain_error_qps()
        self.stats["retx_pressure"] = self.outstanding()

    def drain_error_qps(self) -> None:
        """Complete every queued WQE of ERROR-state QPs with
        WR_FLUSH_ERROR (the drain leg of the state machine) — CQEs, not
        exceptions, whatever was outstanding."""
        eng = self.engine
        for qp in eng.qps.values():
            if qp.state is not QPState.ERROR:
                continue
            rel = self._qps.get(qp.qp_num)
            if rel is not None and rel.queue:
                for rec in rel.queue:
                    self._flush_cqe(qp, rec.wqe)
                rel.queue.clear()
            if qp.sq:
                n = len(qp.sq)
                for wqe in list(qp.sq):
                    self._flush_cqe(qp, wqe)
                qp.retire(n)
                qp.sq_pidx = qp.sq_doorbell = qp.sq_cidx
                qp.arm_times.clear()

    def _flush_cqe(self, qp: QueuePair, wqe: WQE) -> None:
        self.stats["flushed_wqes"] += 1
        self.engine._complete(qp, CQE(
            wr_id=wqe.wr_id, qp_num=qp.qp_num, opcode=wqe.opcode,
            status=CQEStatus.WR_FLUSH_ERROR, byte_len=0, imm=wqe.imm))

    def window(self, qp: QueuePair, budget: Optional[int]
               ) -> Tuple[list, int]:
        """What this QP offers the scheduler this flush: the due un-ACKed
        window (go-back-N replays the whole window from the lost PSN), or
        fresh SQ WQEs when nothing is outstanding. Returns
        ``(entries, n_replay)``."""
        if qp.state is not QPState.RTS:
            return [], 0
        rel = self._qps.get(qp.qp_num)
        if rel is not None and rel.queue:
            if rel.queue[0].due_in > 0:
                return [], 0             # head's replay timer still arming
            return list(rel.queue), len(rel.queue)
        return qp.pending(budget), 0

    def backlog(self, qp: QueuePair) -> int:
        """True pending depth for the DRR scheduler: replays count like
        any backlogged WQE (they are charged to this QP's deficit)."""
        n = self.pending(qp.qp_num)
        return n if n else qp.pending_count

    # ------------------------------------------------------------ transmit
    def process(self, qp: QueuePair, entry, plan: List[tuple],
                completions: List[tuple]) -> None:
        """One scheduled transmission: assign a PSN to fresh WQEs, draw
        the fault verdict, and either execute (plan entries + released
        CQE) or park the record for replay."""
        if qp.state is not QPState.RTS:
            return                       # errored mid-flush; already drained
        rel = self._rel(qp.qp_num)
        if isinstance(entry, _TxRecord):
            rec = entry
            if rec not in rel.queue:     # completed earlier this flush
                return
        else:
            rec = _TxRecord(entry, rel.next_psn)
            rel.next_psn += 1
            rel.queue.append(rec)
            self.stats["psn_assigned"] += 1
        if rec is not rel.queue[0]:
            # behind the un-ACKed head: a go-back-N responder discards
            # out-of-order PSNs, so only the head may land this flush
            # (the head's own failure re-parks the whole window).
            if rel.queue[0].due_in > 0:
                return
        self._transmit(qp, rel, rec, plan, completions)

    def _transmit(self, qp: QueuePair, rel: _QPRel, rec: _TxRecord,
                  plan: List[tuple], completions: List[tuple]) -> None:
        cfg = self.cfg
        if rec is not rel.queue[0] or rec.due_in > 0:
            return
        if rec.attempt > 0 and rec.reason != "rnr":
            if rec.attempt > cfg.retry_cnt:      # retry budget exhausted
                return self._enter_error(
                    qp, rel, rec, CQEStatus.RETRY_EXC_ERROR, completions)
            self.stats["retransmits"] += 1
        rec.attempt += 1
        inj = self.engine.transport.fault_injector
        if rec.reason == "delay":
            verdict = DELIVER            # the late packet finally arrives
        else:
            verdict = inj.verdict(qp) if inj is not None else DELIVER
        rec.reason = None
        if verdict == DROP:
            self.stats["dropped"] += 1
            rec.due_in, rec.reason = cfg.timeout_flushes, "timeout"
            return
        if verdict == CORRUPT:
            self.stats["corrupt"] += 1
            self.stats["naks"] += 1      # ICRC fail → NAK, replay fast
            rec.due_in, rec.reason = 1, "nak"
            return
        if verdict == DELAY:
            self.stats["delayed"] += 1
            rec.due_in, rec.reason = cfg.delay_flushes, "delay"
            rec.attempt -= 1             # in flight, not retransmitted
            return
        # DELIVER / DUPLICATE: the packet reaches the responder in order.
        # Re-validate at every arrival — an MR invalidated while the WQE
        # waited (queued or between replays) must error, never execute
        # against the stale region.
        status, entries, remote_cqe = self.engine._execute_wqe(qp, rec.wqe)
        if status is CQEStatus.RNR:
            self.stats["rnr_naks"] += 1
            rec.rnr_attempts += 1
            if rec.rnr_attempts > cfg.rnr_retry:
                return self._enter_error(
                    qp, rel, rec, CQEStatus.RNR_RETRY_EXC_ERROR,
                    completions)
            back = min(cfg.rnr_base_flushes << (rec.rnr_attempts - 1),
                       cfg.rnr_max_flushes)
            self.stats["backoff_us"] += (
                cfg.rnr_timer_us * back / cfg.rnr_base_flushes)
            rec.due_in, rec.reason = back, "rnr"
            return
        if verdict == DUPLICATE:
            # the wire copy arrives too: responder's PSN ledger discards
            # it (a stale replay must never clobber newer bytes)
            self.stats["dup_delivered"] += 1
            self.stats["dup_suppressed"] += 1
        plan.extend(entries)
        rel.queue.pop(0)                 # ACK: the in-order head landed
        rel.expected_psn = rec.psn + 1
        self.stats["acks"] += 1
        completions.append((qp, CQE(
            wr_id=rec.wqe.wr_id, qp_num=qp.qp_num, opcode=rec.wqe.opcode,
            status=status or CQEStatus.SUCCESS,
            byte_len=rec.wqe.length if status is None else 0,
            imm=rec.wqe.imm), remote_cqe))

    def _enter_error(self, qp: QueuePair, rel: _QPRel, rec: _TxRecord,
                     status: CQEStatus, completions: List[tuple]) -> None:
        """Retry exhaustion: terminal error CQE for the culprit, QP to
        ERROR, and the rest of the window drains with WR_FLUSH_ERROR."""
        qp.state = QPState.ERROR
        self.stats["qp_errors"] += 1
        # complete immediately (not via end-of-flush ``completions``) so
        # the culprit's terminal CQE precedes the WR_FLUSH_ERROR drain —
        # CQ order must match the state machine's story
        self.engine._complete(qp, CQE(
            wr_id=rec.wqe.wr_id, qp_num=qp.qp_num, opcode=rec.wqe.opcode,
            status=status, byte_len=0, imm=rec.wqe.imm))
        rel.queue.remove(rec)
        # remaining window + SQ drain on the spot: completions surface
        # from the very flush that exhausted the retries
        self.drain_error_qps()

    # ------------------------------------------------------------ recovery
    def recover(self, qp: QueuePair) -> None:
        """ERROR → drain → RTS with a fresh PSN epoch (the modify_qp
        RESET/INIT/RTR/RTS ladder collapsed into one deterministic
        step)."""
        self.drain_error_qps()
        self._qps[qp.qp_num] = _QPRel()
        qp.state = QPState.RTS
        self.stats["recovered"] += 1


class LoadShedder:
    """Graceful degradation off retransmit pressure (cf. ORCA): when the
    engine's un-ACKed replay window exceeds ``threshold`` WQEs, ingress
    packets matched by SHED-marked ``MatchTable`` rows are dropped at the
    MAC instead of admitted — ledgered in
    ``engine.stats["reliability"]["shed"]`` — so a retransmit storm
    sheds best-effort streaming load rather than wedging the ring."""

    def __init__(self, engine, threshold: int = 4):
        self.engine = engine
        self.threshold = max(1, int(threshold))

    @property
    def pressure(self) -> int:
        relia = getattr(self.engine, "_reliability", None)
        return relia.outstanding() if relia is not None else 0

    def should_shed(self) -> bool:
        return self.pressure >= self.threshold

    def record_shed(self, n: int = 1) -> None:
        stats = self.engine.stats.setdefault(
            "reliability", new_reliability_stats())
        stats["shed"] += n

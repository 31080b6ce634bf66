"""RDMAEngine — the shared offload engine (paper §III-A), software-defined.

Faithfully reproduces the control flow of the paper's workflow (Fig 6):

  1. host registers memory regions (MR, rkey) and creates QPs
  2. host (or a compute block — the engine is SHARED, the paper's key
     flexibility point) posts WQEs to an SQ
  3. host rings the SQ doorbell — either per-WQE ("single-request") or once
     per batch ("batch-requests", the paper's §VI-C optimization)
  4. the engine validates rkeys/bounds, executes the covered WQEs as ONE
     descriptor table on the transport, and pushes CQEs
  5. host polls the CQ (or registers an "interrupt" callback)

The engine is SHARED between host and compute blocks (LookasideBlock
kernels ride their own ``lc=True`` QPs through the very same path), so
concurrent QPs contend for it: doorbells may be rung with ``defer=True``
and a single ``flush_doorbells`` then *interleaves* the armed SQ windows
(``scheduler="rr"`` weighted round-robin, ``"drr"`` deficit round-robin
with quantum carry-over, ``"fifo"`` the old whole-window drain order —
optionally bounded by ``promote_after`` age promotion) under an optional
per-flush WQE budget — one deep send queue cannot monopolize the engine
(cf. ORCA/BALBOA fairness).

QPs/buffers carry a ``host_mem`` / ``dev_mem`` placement tag mirroring
``-l host_mem|dev_mem``; host_mem regions live in host RAM (numpy) and are
staged over the PCIe path, dev_mem regions live in the device pool (a
tensor in GPU memory unless the engine was built with ``device="cpu"``).
"""
from __future__ import annotations

import itertools
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.rdma.autotune import TransportTuning
from repro_torch.core.rdma.doorbell import coalesce_plan, schedule_plan
from repro_torch.core.rdma.reliability import (FaultInjector,
                                               ReliabilityConfig,
                                               ReliabilityLayer)
from repro_torch.core.rdma.transport import make_transport
from repro_torch.core.rdma.verbs import (
    CQE, CQEStatus, MemoryRegion, Opcode, ONE_SIDED, Placement, QPState,
    QueuePair, RKEY_BASE, TWO_SIDED, WQE, next_qp_num,
)


class RDMAEngine:
    """One engine instance manages the peers' buffer pool + QPs/MRs.

    ``device=None`` puts the pool on the GPU and raises where there is
    none; pass ``device="cpu"`` for the host path. With ``mesh`` (a 1-D
    peer ``DeviceMesh``), or inside a process group of exactly
    ``n_peers`` ranks, the pool is one row per rank on an
    ``ICITransport`` and every rank drives the engine alike (SPMD)."""

    def __init__(self, n_peers: int = 2, pool_size: int = 1 << 16,
                 dtype=np.float32, device=None, mesh=None,
                 coalesce: bool = True,
                 scheduler: str = "rr", flush_budget: Optional[int] = None,
                 promote_after: Optional[int] = None,
                 qp_window: Optional[int] = None,
                 tuning: Optional[TransportTuning] = None):
        self.n_peers = n_peers
        self.pool_size = pool_size
        self.coalesce = coalesce
        # One knob surface (autotune.TransportTuning): explicit kwargs
        # win over a passed tuning; both fall back to the historical
        # hand-picked defaults. ``self.flush_budget``/``self.qp_window``
        # stay plain mutable attributes (benches/demos poke them live);
        # ``apply_tuning`` re-seeds them from a (tuned) config.
        if tuning is None:
            tuning = TransportTuning(flush_budget=flush_budget,
                                     qp_window=qp_window)
        self.tuning = tuning
        if flush_budget is None:
            flush_budget = tuning.flush_budget
        if qp_window is None:
            qp_window = tuning.qp_window
        # ``qp_window`` caps WQEs any ONE QP contributes to a single
        # flush (None = no cap): a deep SQ can fill an entire
        # ``flush_budget`` in fifo mode, or dominate a drain-mode flush;
        # the window bounds its share without throttling the total.
        self.qp_window = qp_window
        # Multi-QP doorbell scheduling: when several SQ windows are armed
        # for one flush, "rr" interleaves their WQEs round-robin (weighted
        # by QueuePair.weight) so one deep SQ cannot starve the others;
        # "drr" is deficit round-robin with quantum carry-over (service a
        # budget truncates is repaid in later flushes, so long-run shares
        # match weights exactly); "fifo" is the plain drain order (whole
        # windows, arrival order), optionally bounded by age promotion
        # (``promote_after`` flushes of zero service force one quantum).
        # ``flush_budget`` bounds WQEs executed per flush (None = drain);
        # leftovers stay armed for the next flush.
        self.scheduler = scheduler
        self.flush_budget = flush_budget
        self.promote_after = promote_after
        # cross-flush scheduler memory (drr deficits/rotor, fifo ages)
        self._sched_state: Dict = {}
        self.transport = make_transport(n_peers, pool_size, dtype, device,
                                        mesh)
        self.mesh = self.transport.mesh
        # Per-engine rkey allocation: every engine hands out the same
        # deterministic sequence from RKEY_BASE regardless of what other
        # engines (or earlier tests) registered — rkeys are meaningful
        # only within the engine that minted them.
        self._rkey_counter = itertools.count(RKEY_BASE)
        self.mrs: Dict[int, MemoryRegion] = {}
        self.qps: Dict[int, QueuePair] = {}
        self._armed: List[QueuePair] = []   # doorbell arrival order
        # (local_peer, remote_peer) -> QPs, insertion-ordered: O(1)
        # responder lookup instead of a linear scan over all QPs.
        self._conn_index: Dict[Tuple[int, int], List[QueuePair]] = {}
        # host-RAM regions for Placement.HOST_MEM (the paper's host_mem QPs)
        self.host_mem: Dict[int, np.ndarray] = {
            p: np.zeros(pool_size, dtype) for p in range(n_peers)}
        self.interrupt_handlers: Dict[int, Callable[[CQE], None]] = {}
        # engine-wide CQE observers (fire after the per-QP interrupt
        # handler): the heartbeat bridge listens here for peer liveness
        self.cqe_observers: List[Callable[[QueuePair, CQE], None]] = []
        # Reliability layer (PSN tracking / go-back-N / QP state machine)
        # — OFF by default: the perfect-wire fast path is byte- and
        # stat-identical to the seed engine. Enabled explicitly or
        # automatically when a FaultInjector is installed on the
        # transport. While enabled, SEND-with-empty-RQ becomes an RNR
        # NAK with exponential backoff (instead of an immediate RNR
        # CQE), and retry exhaustion drives QPs to ERROR.
        self._reliability: Optional[ReliabilityLayer] = None
        # "transport" aliases the live transport.stats dict (cache
        # hits/misses, compiles, coalesced WQEs, qdma_* staging counters)
        # — one stats surface. "qp_service" accumulates executed WQEs per
        # qp_num (the fairness ledger the cost model reads); "lc_service"
        # is the subset on Lookaside-Compute-owned QPs (host-vs-compute
        # contention on the shared engine); "qp_bytes" ledgers completed
        # payload bytes per QP; "qp_latency_us" histograms doorbell-to-
        # execution latency per QP in pow2-µs buckets.
        # "lc_pipeline" is the Lookaside multi-invocation pipeline's
        # head/tail credit ledger (admitted vs finalized invocations,
        # credit waits, flushes that overlapped a fetch with an earlier
        # write-back) — engine-wide: every LookasideBlock on this engine
        # accumulates into the same dict (like qp_service).
        # "dispatch" is the match→action plane's per-class ledger
        # (streaming.dispatch.StreamDispatcher): dispatch_rounds /
        # dispatch_mixed_rounds plus per-handler pkts/bursts/wqes.
        # "kv_serve" is the disaggregated-KV serving ledger
        # (serve.kv_cache): fetches/pages completed vs failed, QP
        # recoveries, migration pages moved vs rolled back.
        self.stats = {"doorbells": 0, "wqes": 0, "cqes": 0, "errors": 0,
                      "coalesced_wqes": 0, "flushes": 0,
                      "qp_service": {}, "lc_service": {}, "lc_wqes": 0,
                      "qp_bytes": {}, "qp_latency_us": {},
                      "lc_pipeline": {}, "dispatch": {}, "kv_serve": {},
                      "collectives": {}, "autotune": {},
                      "transport": self.transport.stats}

    # ------------------------------------------------------------ tuning
    def apply_tuning(self, tuning: TransportTuning) -> None:
        """Install a (hand-picked or swept) ``TransportTuning`` as the
        live configuration: ``flush_budget``/``qp_window`` take effect at
        the next flush; ``ring_burst``/``pipeline_depth``/``rx_depth``
        seed every LookasideBlock / StreamDispatcher / RXRing built from
        ``engine.tuning`` afterwards (already-built blocks keep the
        config they were constructed with, like real re-synthesized
        compute blocks)."""
        self.tuning = tuning
        self.flush_budget = tuning.flush_budget
        self.qp_window = tuning.qp_window

    def _window_limit(self) -> Optional[int]:
        """Per-QP snapshot cap for one flush: the tighter of the total
        flush budget (no QP can execute more than that anyway) and the
        per-QP window."""
        if self.flush_budget is None:
            return self.qp_window
        if self.qp_window is None:
            return self.flush_budget
        return min(self.flush_budget, self.qp_window)

    # ------------------------------------------------------------------ MRs
    def register_mr(self, peer: int, base: int, length: int,
                    placement: Placement = Placement.DEV_MEM) -> MemoryRegion:
        assert 0 <= base and base + length <= self.pool_size, "MR out of pool"
        mr = MemoryRegion(next(self._rkey_counter), peer, base, length,
                          placement)
        self.mrs[mr.rkey] = mr
        return mr

    def invalidate_mr(self, rkey: int) -> None:
        mr = self.mrs.get(rkey)
        if mr is not None:
            self.mrs[rkey] = MemoryRegion(
                mr.rkey, mr.peer, mr.base, mr.length, mr.placement,
                valid=False)

    # ------------------------------------------------------------------ QPs
    def create_qp(self, local_peer: int, remote_peer: int,
                  placement: Placement = Placement.DEV_MEM,
                  weight: int = 1, lc: bool = False) -> QueuePair:
        """``weight`` is the fair-scheduler quantum: WQEs offered to this
        QP per round-robin round when concurrent SQ windows share a flush.
        ``lc=True`` tags the QP as Lookaside-Compute-owned: its service is
        additionally ledgered in ``stats["lc_service"]``."""
        qp = QueuePair(next_qp_num(), local_peer, remote_peer, placement,
                       weight=weight, lc=lc)
        self.qps[qp.qp_num] = qp
        self._conn_index.setdefault((local_peer, remote_peer), []).append(qp)
        return qp

    # ---------------------------------------------------------------- verbs
    def post_send(self, qp: QueuePair, wqe: WQE) -> None:
        qp.post_send(wqe)

    def post_recv(self, qp: QueuePair, wqe: WQE) -> None:
        qp.post_recv(wqe)

    def ring_sq_doorbell(self, qp: QueuePair, pidx: Optional[int] = None,
                         defer: bool = False) -> None:
        """Ring the SQ producer-index doorbell. ``pidx`` defaults to all
        posted WQEs (batch-requests). Ringing after every single post is
        the paper's single-request mode.

        ``defer=True`` arms the QP without executing — concurrent QPs
        ring deferred, then one ``flush_doorbells`` interleaves all armed
        windows into a single scheduled transport batch. A non-deferred
        ring flushes immediately (serving any other armed QPs too — the
        engine is shared, exactly the paper's contention point)."""
        prev = max(qp.sq_doorbell, qp.sq_cidx)
        qp.sq_doorbell = qp.sq_pidx if pidx is None else pidx
        newly = max(0, qp.sq_doorbell - prev)
        if newly:                       # stamp for the latency histogram
            now = time.perf_counter()
            qp.arm_times.extend([now] * newly)
        if qp not in self._armed:
            self._armed.append(qp)
        self.stats["doorbells"] += 1
        if not defer:
            self.flush_doorbells()

    def poll_cq(self, qp: QueuePair, max_entries: int = 64) -> List[CQE]:
        out: List[CQE] = []
        cq = qp.cq
        while cq and len(out) < max_entries:   # O(polled), not O(len(cq))
            out.append(cq.popleft())
        return out

    def register_interrupt(self, qp: QueuePair,
                           handler: Callable[[CQE], None]) -> None:
        """'Interrupt mode' of the status FIFO: invoke handler on CQE."""
        self.interrupt_handlers[qp.qp_num] = handler

    # ------------------------------------------------------- reliability
    def enable_reliability(self, config: Optional[ReliabilityConfig] = None
                           ) -> ReliabilityLayer:
        """Turn on the RC reliability layer (PSN sequencing, ACK/NAK
        ledger, go-back-N replay, QP error states). Idempotent unless a
        new ``config`` is passed. Installing a FaultInjector on the
        transport enables it automatically at the next flush."""
        if self._reliability is None or config is not None:
            self._reliability = ReliabilityLayer(self, config)
        return self._reliability

    def install_fault_injector(
            self, injector,
            config: Optional[ReliabilityConfig] = None) -> FaultInjector:
        """Convenience: put a seeded FaultInjector at the transport
        boundary AND enable the reliability layer that survives it
        (with ``config``'s retry policy, when given). Returns the
        injector for stall/unstall steering."""
        self.transport.install_fault_injector(injector)
        self.enable_reliability(config)
        return injector

    def recover_qp(self, qp: QueuePair) -> None:
        """ERROR → drain → RTS with a fresh PSN epoch. No-op on a
        healthy QP."""
        if qp.state is QPState.RTS:
            return
        self.enable_reliability().recover(qp)

    def fail_peer(self, peer: int) -> List[QueuePair]:
        """Transition every QP whose connection touches ``peer`` into
        ERROR and drain it (terminal WR_FLUSH_ERROR CQEs) — the
        heartbeat bridge's missed-beat action. Returns the failed QPs."""
        relia = self.enable_reliability()
        failed = []
        for qp in self.qps.values():
            if qp.state is QPState.RTS and peer in (qp.local_peer,
                                                    qp.remote_peer):
                qp.state = QPState.ERROR
                relia.stats["qp_errors"] += 1
                failed.append(qp)
        relia.drain_error_qps()
        return failed

    # ------------------------------------------------------------- engine
    def _check_mr(self, rkey: int, peer: int, addr: int,
                  length: int) -> Optional[CQEStatus]:
        mr = self.mrs.get(rkey)
        if mr is None or not mr.valid or mr.peer != peer:
            return CQEStatus.REMOTE_ACCESS_ERROR
        if not mr.contains(addr, length):
            return CQEStatus.REMOTE_ACCESS_ERROR
        return None

    def _complete(self, qp: QueuePair, cqe: CQE) -> None:
        qp.cq.append(cqe)
        self.stats["cqes"] += 1
        if cqe.status != CQEStatus.SUCCESS:
            self.stats["errors"] += 1
        h = self.interrupt_handlers.get(qp.qp_num)
        if h is not None:
            h(cqe)
        for obs in self.cqe_observers:
            obs(qp, cqe)

    def flush_doorbells(self) -> Dict[int, int]:
        """Execute armed SQ windows as ONE scheduled transport batch.

        ``schedule_plan`` interleaves the armed windows (``self.scheduler``
        policy, per-QP ``weight`` quanta, at most ``flush_budget`` WQEs);
        the merged order is validated WQE-by-WQE, coalesced, and executed
        as a single descriptor-table dispatch. Each QP's picks are a
        prefix of its window, so intra-QP execution and CQE order follow
        posting order regardless of interleaving. QPs with leftover
        (over-budget) WQEs stay armed. Returns {qp_num: WQEs executed}."""
        # A budgeted flush serves at most flush_budget WQEs from any QP,
        # so the snapshot never copies a deep window's tail (keeps each
        # flush O(budget * n_qps), not O(window depth)).
        relia = self._reliability
        if relia is None and self.transport.fault_injector is not None:
            relia = self.enable_reliability()
        if relia is not None:
            # tick replay timers + drain ERROR QPs; QPs replaying an
            # un-ACKed window offer it INSTEAD of fresh WQEs (the send
            # window is closed until the head is ACKed), charged to the
            # same qp_num so DRR bills retransmits to their owner
            relia.begin_flush()
            retx_len: Dict[int, int] = {}
            windows = []
            for qp in self._armed:
                entries, n_retx = relia.window(qp, self._window_limit())
                if entries:
                    windows.append((qp, entries))
                    retx_len[qp.qp_num] = n_retx
            backlog = {qp.qp_num: relia.backlog(qp) for qp, _ in windows}
        else:
            retx_len = {}
            windows = [(qp, qp.pending(self._window_limit()))
                       for qp in self._armed]
            windows = [(qp, w) for qp, w in windows if w]
            backlog = {qp.qp_num: qp.pending_count for qp, _ in windows}
        if not windows:
            self._armed = [qp for qp in self._armed
                           if relia is not None
                           and (qp.pending_count
                                or relia.pending(qp.qp_num))]
            return {}
        order, counts = schedule_plan(
            [(qp.qp_num, wqes) for qp, wqes in windows],
            scheduler=self.scheduler,
            weights={qp.qp_num: qp.weight for qp, _ in windows},
            budget=self.flush_budget,
            qp_window=self.qp_window,
            state=self._sched_state,
            promote_after=self.promote_after,
            # snapshots are budget-truncated; drr needs the true depth to
            # tell "window drained" from "snapshot exhausted"
            backlog=backlog)
        by_num = {qp.qp_num: qp for qp, _ in windows}
        plan: List[tuple] = []
        completions: List[tuple] = []   # (qp, CQE, remote) after transport
        if relia is not None:
            for qp_num, entry in order:
                relia.process(by_num[qp_num], entry, plan, completions)
        else:
            for qp_num, wqe in order:
                self._admit(by_num[qp_num], wqe, plan, completions)

        # Coalesce adjacent contiguous transfers (the descriptor-level
        # doorbell batching), then ONE descriptor-table dispatch.
        if self.coalesce:
            merged = coalesce_plan(plan)
            saved = len(plan) - len(merged)
            self.stats["coalesced_wqes"] += saved
            self.transport.stats["coalesced_wqes"] += saved
            plan = merged
        self.transport.execute_batch(plan)

        served = [n for n in counts.values() if n]
        if len(served) > 1:
            self.transport.stats["interleaved_batches"] += 1
        now = time.perf_counter()
        for qp_num, n in counts.items():
            if n:
                qp = by_num[qp_num]
                # replayed picks never touch the SQ (the reliability
                # layer owns them); only freshly scheduled WQEs retire
                # and stamp the doorbell-latency histogram. Service is
                # charged in FULL — retransmits bill their owner.
                n_new = n - min(n, retx_len.get(qp_num, 0))
                hist = self.stats["qp_latency_us"].setdefault(qp_num, {})
                for _ in range(n_new):
                    t0 = qp.arm_times.popleft() if qp.arm_times else now
                    us = (now - t0) * 1e6
                    bucket = 1           # pow2-µs ceiling bucket
                    while bucket < us:
                        bucket <<= 1
                    hist[bucket] = hist.get(bucket, 0) + 1
                qp.retire(n_new)
                self.stats["qp_service"][qp_num] = (
                    self.stats["qp_service"].get(qp_num, 0) + n)
                if qp.lc:
                    self.stats["lc_wqes"] += n
                    self.stats["lc_service"][qp_num] = (
                        self.stats["lc_service"].get(qp_num, 0) + n)
        self.stats["wqes"] += len(order)
        self.stats["flushes"] += 1

        for q, cqe, remote in completions:
            self.stats["qp_bytes"][q.qp_num] = (
                self.stats["qp_bytes"].get(q.qp_num, 0) + cqe.byte_len)
            self._complete(q, cqe)
            if remote is not None:
                self._complete(*remote)
        self._armed = [qp for qp in self._armed
                       if qp.pending_count
                       or (relia is not None and relia.pending(qp.qp_num))]
        if relia is not None:
            # refresh the pressure gauge post-delivery: the shedder and
            # benches read end-of-flush pressure, not start-of-flush
            relia.stats["retx_pressure"] = relia.outstanding()
        return counts

    def _admit(self, qp: QueuePair, wqe: WQE, plan: List[tuple],
               completions: List[tuple]) -> None:
        """Validate one scheduled WQE: append its transfer(s) to ``plan``
        and its completion(s) to ``completions`` (the perfect-wire path;
        the reliability layer calls ``_execute_wqe`` directly so it can
        withhold CQEs and replay)."""
        status, entries, remote_cqe = self._execute_wqe(qp, wqe)
        plan.extend(entries)
        completions.append((qp, CQE(
            wr_id=wqe.wr_id, qp_num=qp.qp_num, opcode=wqe.opcode,
            status=status or CQEStatus.SUCCESS,
            byte_len=wqe.length if status is None else 0,
            imm=wqe.imm), remote_cqe))

    def _execute_wqe(self, qp: QueuePair, wqe: WQE
                     ) -> Tuple[Optional[CQEStatus], List[tuple],
                                Optional[tuple]]:
        """Validate + lower one WQE arrival at the responder: returns
        ``(status, plan_entries, remote_cqe)``. Validation runs at every
        (re)delivery — an MR invalidated while the WQE sat queued or
        awaited retransmission errors here instead of executing against
        the stale region. An RNR return has NO side effects (the RQ is
        untouched), so the reliability layer can back off and replay."""
        status = None
        remote_cqe = None
        entries: List[tuple] = []
        if wqe.opcode in ONE_SIDED:
            status = self._check_mr(wqe.rkey, qp.remote_peer,
                                    wqe.remote_addr, wqe.length)
            if status is None:
                if wqe.opcode is Opcode.READ:
                    entries.append(("xfer", qp.remote_peer, qp.local_peer,
                                    wqe.remote_addr, wqe.local_addr,
                                    wqe.length))
                else:  # WRITE / WRITE_IMM
                    entries.append(("xfer", qp.local_peer, qp.remote_peer,
                                    wqe.local_addr, wqe.remote_addr,
                                    wqe.length))
                    if wqe.opcode is Opcode.WRITE_IMM:
                        rqp = self._responder_qp(qp)
                        if rqp is not None:
                            remote_cqe = (rqp, CQE(
                                wr_id=wqe.wr_id, qp_num=rqp.qp_num,
                                opcode=wqe.opcode, byte_len=wqe.length,
                                imm=wqe.imm))
        elif wqe.opcode in TWO_SIDED:
            rqp = self._responder_qp(qp)
            if rqp is None or not rqp.rq:
                status = CQEStatus.RNR
            else:
                recv = rqp.rq.popleft()
                n = min(wqe.length, recv.length)
                entries.append(("xfer", qp.local_peer, qp.remote_peer,
                                wqe.local_addr, recv.local_addr, n))
                if wqe.opcode is Opcode.SEND_INV and wqe.inv_rkey is not None:
                    self.invalidate_mr(wqe.inv_rkey)
                remote_cqe = (rqp, CQE(
                    wr_id=recv.wr_id, qp_num=rqp.qp_num,
                    opcode=Opcode.RECV, byte_len=n,
                    imm=wqe.imm if wqe.opcode is Opcode.SEND_IMM else None))
        else:
            status = CQEStatus.INVALID_OPCODE
        return status, entries, remote_cqe

    def _responder_qp(self, qp: QueuePair) -> Optional[QueuePair]:
        """The paired QP on the remote peer (same connection) — indexed
        lookup on (remote, local), not a scan over every QP."""
        for other in self._conn_index.get(
                (qp.remote_peer, qp.local_peer), ()):
            if other.qp_num != qp.qp_num:
                return other
        return None

    # ----------------------------------------------------- host data access
    def write_buffer(self, peer: int, addr: int, data,
                     placement: Placement = Placement.DEV_MEM) -> None:
        if placement is Placement.HOST_MEM:
            self.host_mem[peer][addr:addr + len(data)] = data
        else:
            self.transport.host_write(peer, addr, data)

    def read_buffer(self, peer: int, addr: int, length: int,
                    placement: Placement = Placement.DEV_MEM) -> np.ndarray:
        if placement is Placement.HOST_MEM:
            return self.host_mem[peer][addr:addr + length].copy()
        return self.transport.host_read(peer, addr, length)

    def read_device(self, peer: int, addr: int, length: int):
        """``length`` words of a peer's dev_mem as a tensor on the pool's
        device (a copy: later writes to the pool do not show through)."""
        return self.transport.device_read(peer, addr, length)

    def sync_host_to_dev(self, peer: int, addr: int, length: int) -> None:
        """Stage a host_mem region into dev_mem (the QDMA H2C path)."""
        self.transport.host_write(
            peer, addr, self.host_mem[peer][addr:addr + length])

    def load_pool(self, np_pool) -> None:
        """Copy a ``(n_peers, pool_size)`` array into the pool on its
        device (e.g. ``np.asarray`` of another engine's pool)."""
        self.transport.load_pool(np_pool)

    @property
    def pool(self):
        return self.transport.pool

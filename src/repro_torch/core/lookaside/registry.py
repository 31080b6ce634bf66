"""Lookaside Compute block: kernel registry + execution loop (paper Fig 3).

The block "has the capacity to accommodate multiple kernels"; each kernel
is a Python callable with a control FIFO and a status FIFO. The host enqueues
``ControlMsg``s (compute control API); when the control FIFO is not empty
the kernel retrieves a message, accesses memory through the RDMA engine,
executes, and pushes a StatusMsg.

Kernels are FIRST-CLASS CLIENTS of the shared offload engine (the paper's
key flexibility point, §I/§III-B): each ``LCKernel`` owns its own QP(s)
(tagged ``lc=True``), its remote memory accesses are lowered to READ/WRITE
WQEs that land in the SAME descriptor tables as concurrent host verbs
traffic (ring deferred, flush shared — visible in the engine's
``interleaved_batches`` / ``qp_service`` / ``lc_service`` stats), and its
``StatusMsg`` completion is driven off the write-back CQEs:

  * poll mode       — ``block.poll(workload_id)`` drains the status FIFO,
  * interrupt mode  — a handler registered per kernel fires on completion,
  * and the StatusMsg itself is only pushed once every WQE of the
    invocation has completed (``LCContext.commit(wait=False)`` leaves the
    write-back armed: the status then appears when a later — possibly
    host-driven — ``flush_doorbells`` executes it, exactly the shared-
    engine contention the conformance suite pins).

Kernel functions take an ``LCContext`` (not the raw engine): ``ctx`` is
the kernel's AXI view of the world — verbs on its own QPs for remote
memory, ``load``/``store`` for local dev_mem scratch.

Control-FIFO overflow is *backpressure*, not a crash: ``dispatch``
returns a retryable ``StatusMsg(ok=False)`` instead of raising through
the engine loop.

Multi-invocation pipelining (the §IV-D follow-up): a kernel fn may be a
GENERATOR — everything up to its first ``yield`` is the operand-fetch
phase (post READ WQEs, ``commit(wait=False)``), everything after it the
compute/write-back phase. On a block built with ``pipeline_depth > 1``
the service loop admits up to ``pipeline_depth`` invocations at once,
each into its own scratch *partition*: invocation *i+1*'s fetch WQEs are
armed (deferred) while invocation *i* computes, so one shared flush
executes *i*'s write-back alongside *i+1*'s fetch — one descriptor table
where the serial path needed two. Head/tail credit accounting lands in
``engine.stats["lc_pipeline"]``.

Data stays on the device: ``LCContext.load`` returns a tensor on the
pool's device and ``LCContext.store`` writes a device tensor into the
pool in place, so an offloaded kernel receives GPU tensors and launches
its CUDA kernel — the operands never cross PCIe. ``store`` keeps the
QDMA ledger (``stats["transport"]["qdma_*"]``) of the reference.

On an ``ICITransport`` engine (one process per peer, SPMD) every rank
runs every block: ``load`` is a broadcast from the block peer's rank, so
each rank holds the same operands and runs the kernel on them
redundantly (each rank launches it), and only the owner's ``store``
lands in the pool; the results leave the block only through the
transport (its write-back WRITEs broadcast from the owner). A rank that
skipped the kernel would need the result's shape and the kernel's
branches anyway; running it keeps every rank on the same path.

Streaming compute (§IV-D): ring consumption lives in the dispatch plane
(``streaming.dispatch.StreamDispatcher``) — ``attach_ring`` binds a
kernel to an ``RXRing`` by building a ONE-ENTRY dispatcher (a MatchTable
whose default action is that kernel), and ``LCKernel.stream()`` drains
through it: up to ``ring_burst`` pending packets are claimed per
invocation and gathered into kernel scratch by ONE descriptor-table
execution per flush (loopback READ WQEs on the kernel's own ``lc=True``
QP), with no ControlMsg round-trip per packet. A multi-entry table
routes the same ring's slots to DIFFERENT handler kernels by parsed
class; ``service_group`` then admits one invocation per handler before
each shared flush. Service CHAINS generalize this to inter-kernel
dataflow (``service_group(..., keep_idle=True)``): stage *i*'s
write-back region is stage *i+1*'s operand-fetch source, the downstream
ControlMsg enqueued by the upstream finalize hook mid-pass.
"""
from __future__ import annotations

import inspect
import itertools
from collections import deque
from typing import Callable, Dict, List, Optional, Sequence, Set

from repro_torch.core.lookaside.control import ControlMsg, FIFO, StatusMsg
from repro_torch.core.rdma.autotune import TransportTuning
from repro_torch.core.rdma.verbs import CQE, CQEStatus, Opcode, WQE


class LCKernel:
    """One registered lookaside kernel.

    ``fn(ctx, *args) -> Optional[int]`` accesses memory through an
    ``LCContext`` and returns an optional result address. ``weight`` is
    the fair-scheduler quantum of the kernel's QPs (how hard this kernel
    may lean on the shared engine per service round). ``ring_burst`` is
    the streaming claim size (packets per invocation when an RX ring is
    attached), threaded from the block's ``TransportTuning`` by
    ``LookasideBlock.register``.
    """

    def __init__(self, workload_id: int, fn: Callable, name: str = "",
                 weight: int = 1, ring_burst: int = 32):
        self.workload_id = workload_id
        self.fn = fn
        self.name = name or getattr(fn, "__name__", "kernel")
        self.weight = weight
        self.qps: Dict[int, object] = {}     # remote_peer -> QueuePair
        self.control_fifo = FIFO()
        self.status_fifo = FIFO()
        self.interrupt_handler: Optional[Callable[[StatusMsg], None]] = None
        self.block = None                    # set by LookasideBlock.register
        self.ring = None                     # set by attach_ring
        self.ring_burst = max(1, int(ring_burst))
        self.stream_out = None               # (out_peer, out_rkey, out_base)
        self.dispatcher = None               # one-entry plane (attach_ring)
        # chain-capable kernels declare their row geometry here (a
        # ``ChainStageSpec``); ``StreamDispatcher.register_chain``
        # validates stage composition against it
        self.stage_spec = None

    def stream(self, max_bursts: Optional[int] = None) -> int:
        """Drain this kernel's attached RX ring (see
        ``LookasideBlock.stream``). Returns packets consumed."""
        return self.block.stream(self.workload_id, max_bursts=max_bursts)


class _Invocation:
    """In-flight state of one ControlMsg: outstanding WQEs + outcome."""

    __slots__ = ("kernel", "msg", "outstanding", "failures", "fn_done",
                 "error", "result_addr", "finalized", "partition",
                 "cursor", "on_fetched", "on_finalized")

    def __init__(self, kernel: LCKernel, msg: ControlMsg):
        self.kernel = kernel
        self.msg = msg
        self.outstanding: Set[int] = set()   # wr_ids awaiting CQEs
        self.failures: List[CQE] = []
        self.fn_done = False
        self.error: Optional[str] = None
        self.result_addr: Optional[int] = None
        self.finalized = False
        self.partition: Optional[int] = None     # scratch partition index
        self.cursor: Optional[int] = None        # partition bump cursor
        self.on_fetched: Optional[Callable] = None    # first yield landed
        self.on_finalized: Optional[Callable] = None  # StatusMsg pushed


class LCContext:
    """What an offloaded kernel sees while servicing one ControlMsg.

    Remote memory is reached ONLY through verbs on the kernel's own QPs
    (``read_remote`` / ``write_remote`` post WQEs; ``commit`` rings the
    doorbells deferred and — with ``wait=True`` — drives shared engine
    flushes until this invocation's CQEs land). Local dev_mem scratch is
    the LC block's AXI4 data interface (``load`` / ``store`` / ``alloc``).
    """

    def __init__(self, block: "LookasideBlock", inv: _Invocation):
        self._block = block
        self._inv = inv
        self.engine = block.engine
        self.peer = block.peer
        self._dirty: List[object] = []       # QPs with unrung WQEs

    # -- remote memory: lowered to WQEs on the kernel's QPs ---------------
    def qp(self, remote_peer: int):
        return self._block._qp(self._inv.kernel, remote_peer)

    def read_remote(self, remote_peer: int, rkey: int, remote_addr: int,
                    local_addr: int, length: int) -> int:
        """RDMA-READ ``length`` words of the remote peer's memory into
        local scratch. Returns the wr_id."""
        return self._post(Opcode.READ, remote_peer, rkey,
                          local_addr, remote_addr, length)

    def write_remote(self, remote_peer: int, rkey: int, local_addr: int,
                     remote_addr: int, length: int) -> int:
        """RDMA-WRITE local scratch back to the remote peer."""
        return self._post(Opcode.WRITE, remote_peer, rkey,
                          local_addr, remote_addr, length)

    def _post(self, opcode: Opcode, remote_peer: int, rkey: int,
              local_addr: int, remote_addr: int, length: int) -> int:
        qp = self.qp(remote_peer)
        wr_id = next(self._block._wr_ids)
        self._inv.outstanding.add(wr_id)
        self._block._wr[wr_id] = self._inv
        self.engine.post_send(qp, WQE(
            opcode, qp.qp_num, wr_id, local_addr=local_addr,
            remote_addr=remote_addr, length=length, rkey=rkey))
        if qp not in self._dirty:
            self._dirty.append(qp)
        return wr_id

    def commit(self, wait: bool = True) -> None:
        """Ring the doorbells of every QP with posted WQEs — DEFERRED, so
        the next flush schedules them alongside any armed host windows
        (one shared descriptor table). ``wait=True`` then flushes until
        this invocation's outstanding CQEs have all landed; ``wait=False``
        leaves them armed for whoever flushes next (CQE-driven async
        completion)."""
        for qp in self._dirty:
            self.engine.ring_sq_doorbell(qp, defer=True)
        self._dirty.clear()
        if wait:
            self._block._drain(self._inv)

    @property
    def failed(self) -> List[CQE]:
        """CQEs of this invocation that completed with an error status."""
        return list(self._inv.failures)

    @property
    def eager_writeback(self) -> bool:
        """Block-level policy: should kernels wait on their write-back
        commit (sync StatusMsg) or leave it armed (CQE-driven async)?"""
        return self._block.eager_writeback

    # -- local scratch: the AXI4 data interface ---------------------------
    def alloc(self, length: int) -> int:
        return self._block._alloc(length, self._inv)

    def load(self, addr: int, length: int):
        """``length`` words of this peer's dev_mem, as a tensor on the
        pool's device."""
        return self.engine.read_device(self.peer, addr, length)

    def store(self, addr: int, data) -> None:
        """Write ``data`` (a tensor on the pool's device, or host data)
        into this peer's dev_mem at ``addr``."""
        self.engine.write_buffer(self.peer, addr, data)


class LookasideBlock:
    """The LC block on one peer's NIC: kernels sharing the offload engine.

    ``peer`` is the mesh position the block (and its dev_mem scratch)
    lives on; ``scratch_base``/``scratch_size`` bound the pool region the
    per-invocation bump allocator hands out (recycled whenever no
    invocation is in flight). ``eager_writeback`` is the default commit
    mode kernels use for their result write-back.

    ``pipeline_depth > 1`` enables multi-invocation pipelining: the
    scratch region splits into ``pipeline_depth`` equal partitions, each
    held by one in-flight invocation from admission to finalize — so
    invocation *i+1* may arm its operand fetch while *i*'s write-back is
    still in flight without the bump allocator aliasing their scratch.
    Credits = free partitions; ``engine.stats["lc_pipeline"]`` ledgers
    head (finalized), tail (admitted), credit waits, and how many flushes
    actually overlapped a fetch with an earlier invocation's write-back.
    """

    def __init__(self, engine, peer: int = 0,
                 scratch_base: Optional[int] = None,
                 scratch_size: Optional[int] = None,
                 eager_writeback: bool = True,
                 pipeline_depth: Optional[int] = None,
                 tuning: Optional[TransportTuning] = None):
        self.engine = engine                 # shared RDMA engine (paper §I)
        self.peer = peer
        self.scratch_base = (engine.pool_size // 2 if scratch_base is None
                             else scratch_base)
        self.scratch_size = (engine.pool_size - self.scratch_base
                             if scratch_size is None else scratch_size)
        self.eager_writeback = eager_writeback
        # Knob resolution: explicit kwarg > block tuning > engine tuning
        # > historical defaults. The resolved TransportTuning also seeds
        # ring_burst for every kernel registered on this block.
        self.tuning = (tuning if tuning is not None
                       else getattr(engine, "tuning", None)
                       or TransportTuning())
        if pipeline_depth is None:
            pipeline_depth = self.tuning.pipeline_depth
        self.pipeline_depth = max(1, int(pipeline_depth))
        self._part_size = self.scratch_size // self.pipeline_depth
        self._free_parts = list(range(self.pipeline_depth))
        # Double-buffer split: at most half the partitions fetch while
        # the other half's write-backs drain — both sides of ONE shared
        # flush. A full-depth fetch window would alternate fetch-only
        # and write-back-only flushes instead of overlapping them.
        self._stage_window = max(1, self.pipeline_depth // 2)
        self.kernels: Dict[int, LCKernel] = {}
        self._cursor = self.scratch_base
        self._inflight = 0
        self._wr: Dict[int, _Invocation] = {}     # wr_id -> invocation
        self._wr_ids = itertools.count(0x40000)
        # stream() attaches per-ControlMsg lifecycle hooks (ring-slot
        # release on fetch, latency stamp on status) keyed by message
        # identity; _admit_invocation pops them onto the invocation.
        self._hooks: Dict[int, Dict] = {}
        self.stats = {"dispatched": 0, "completed": 0, "errors": 0,
                      "backpressure": 0, "status_drops": 0}
        # head/tail credit ledger of the invocation pipeline, surfaced on
        # the engine's one stats surface (tail - head = in flight).
        # Blocks SHARE the engine-wide ledger (like qp_service): a second
        # block accumulates into it instead of discarding the first
        # block's history; "depth" reports the deepest pipeline attached.
        lp = engine.stats.setdefault("lc_pipeline", {})
        for key in ("head", "tail", "in_flight_peak", "credit_waits",
                    "overlapped_flushes", "fetch_wqes_overlapped"):
            lp.setdefault(key, 0)
        lp["depth"] = max(lp.get("depth", 0), self.pipeline_depth)
        self._lp = lp

    def register(self, workload_id: int, fn: Callable, name: str = "",
                 weight: int = 1,
                 ring_burst: Optional[int] = None) -> LCKernel:
        if workload_id in self.kernels:
            raise KeyError(f"workload_id {workload_id} already registered")
        k = LCKernel(workload_id, fn, name, weight,
                     ring_burst=(self.tuning.ring_burst
                                 if ring_burst is None else ring_burst))
        k.block = self
        self.kernels[workload_id] = k
        return k

    def attach_ring(self, workload_id: int, ring, out_peer: int,
                    out_rkey: int, out_base: int,
                    burst: Optional[int] = None) -> LCKernel:
        """Bind an ``RXRing`` to a streaming kernel: ``stream()`` drains
        the ring in bursts of up to ``burst`` packets (``None`` keeps the
        kernel's tuned ``ring_burst``), and the kernel writes each
        packet's status/metadata row to ``out_base + slot_index * row``
        on ``out_peer`` (rkey-checked) — the meta ring mirrors the packet
        ring slot-for-slot.

        Internally this is the one-entry degenerate case of the dispatch
        plane: a ``StreamDispatcher`` over a ``MatchTable`` whose default
        action is this kernel, so the whole ring belongs to it."""
        from repro_torch.core.streaming.dispatch import (Handler,
                                                         MatchTable,
                                                         StreamDispatcher)
        k = self.kernels[workload_id]
        k.ring = ring
        if burst is not None:
            k.ring_burst = max(1, int(burst))
        k.stream_out = (out_peer, out_rkey, out_base)
        k.dispatcher = StreamDispatcher(
            self, ring, MatchTable(default=Handler(workload_id)),
            burst=k.ring_burst)
        k.dispatcher.register_handler(workload_id, out_peer, out_rkey,
                                      out_base)
        return k

    def register_interrupt(self, workload_id: int,
                           handler: Callable[[StatusMsg], None]) -> None:
        self.kernels[workload_id].interrupt_handler = handler

    # -- host-side compute-control API (libreconic Control API) -----------
    def dispatch(self, msg: ControlMsg,
                 service: bool = True) -> Optional[StatusMsg]:
        """Push a control message. Returns ``None`` when accepted, or a
        *retryable* ``StatusMsg(ok=False)`` when the control FIFO asserts
        backpressure (the host drains completions and re-dispatches —
        nothing raises through the engine loop). ``service=False`` only
        enqueues (the fabric is busy); call ``service()`` to run."""
        k = self.kernels[msg.workload_id]
        if not k.control_fifo.try_push(msg):
            self.stats["backpressure"] += 1
            return StatusMsg(k.workload_id, msg.tag, False,
                             detail="EAGAIN: control FIFO full "
                                    "(backpressure) — drain completions "
                                    "and re-dispatch",
                             retryable=True)
        self.stats["dispatched"] += 1
        if service:
            self._service(k)
        return None

    def service(self, workload_id: int) -> None:
        """Drain the control FIFO of one kernel (explicit fabric step for
        messages enqueued with ``dispatch(..., service=False)``)."""
        self._service(self.kernels[workload_id])

    def stream(self, workload_id: int,
               max_bursts: Optional[int] = None) -> int:
        """Streaming-compute drain (§IV-D): consume the kernel's RX ring
        without a per-packet host round trip.

        Delegates to the kernel's one-entry ``StreamDispatcher`` (built
        by ``attach_ring``): pending slots are claimed in bursts of up to
        ``ring_burst``; each burst becomes ONE kernel invocation whose
        operand fetch is the loopback gather of the burst's (≤ 2, wrap)
        contiguous slot spans — one descriptor-table execution per
        flush. Slots are freed the moment the gather lands
        (``on_fetched``), so the producer can refill while the kernel
        still computes; ring-to-status latency is stamped when the
        burst's StatusMsg fires. All claimed bursts are enqueued BEFORE
        one service pass, so a ``pipeline_depth > 1`` block overlaps
        burst *i*'s compute with burst *i+1*'s gather. Returns the
        number of packets consumed."""
        k = self.kernels[workload_id]
        # re-bind from the kernel attrs every call: tests/operators
        # retarget k.ring / k.stream_out / k.ring_burst between drains
        out_peer, out_rkey, out_base = k.stream_out
        k.dispatcher.register_handler(workload_id, out_peer, out_rkey,
                                      out_base)
        k.dispatcher.ring = k.ring
        k.dispatcher.burst = k.ring_burst
        return k.dispatcher.service(max_bursts=max_bursts)

    def service_group(self, workload_ids: Sequence[int],
                      keep_idle: bool = False) -> None:
        """Service several kernels' control FIFOs as ONE dispatch round
        stream: with more than one backlogged kernel, admissions
        round-robin across them so every kernel's operand-fetch WQEs are
        armed before the shared flush — the match→action plane's
        one-descriptor-table-per-service-round contract. A single
        backlogged kernel takes the plain ``_service`` path (serial or
        pipelined by ``pipeline_depth``), byte- and flush-identical to
        the pre-dispatch behavior.

        ``keep_idle=True`` is the multi-kernel DATAFLOW admission mode
        (service chains): listed kernels whose control FIFO is currently
        empty stay in the grouped pass anyway, because a downstream
        stage's ControlMsg is enqueued mid-pass by its upstream stage's
        finalize hook — the grouped loop re-checks every listed FIFO per
        round, so the late message is admitted into a later round of the
        SAME pass and its fetch rides a later shared flush."""
        kernels = [self.kernels[w] for w in workload_ids]
        if not keep_idle:
            kernels = [k for k in kernels if k.control_fifo.not_empty]
            if len(kernels) == 1:
                self._service(kernels[0])
            elif kernels:
                self._service_grouped(kernels)
            return
        if any(k.control_fifo.not_empty for k in kernels):
            self._service_grouped(kernels)

    def _service(self, k: LCKernel) -> None:
        if self.pipeline_depth > 1:
            self._service_grouped([k])
            return
        while k.control_fifo.not_empty:
            msg = k.control_fifo.pop()
            inv = self._admit_invocation(k, msg)
            ctx = LCContext(self, inv)
            try:
                res = k.fn(ctx, *msg.args)
                if inspect.isgenerator(res):
                    res = self._drive(inv, res)
                inv.result_addr = res
            except Exception as e:       # kernel fault -> error status
                inv.error = str(e)
                # ring + drain whatever the kernel posted before faulting
                # so no WQE dangles half-armed in the SQ
                ctx.commit(wait=True)
            inv.fn_done = True
            if not inv.outstanding:
                self._finalize(inv)
            # else: CQE-driven — _on_cqe finalizes when the last
            # write-back lands (possibly in a later host-driven flush)

    def _admit_invocation(self, k: LCKernel, msg: ControlMsg,
                          partition: Optional[int] = None) -> _Invocation:
        inv = _Invocation(k, msg)
        hooks = self._hooks.pop(id(msg), None)
        if hooks:
            inv.on_fetched = hooks.get("on_fetched")
            inv.on_finalized = hooks.get("on_finalized")
        if partition is not None:
            inv.partition = partition
            inv.cursor = self.scratch_base + partition * self._part_size
        self._inflight += 1
        self._lp["tail"] += 1
        in_flight = self._lp["tail"] - self._lp["head"]
        if in_flight > self._lp["in_flight_peak"]:
            self._lp["in_flight_peak"] = in_flight
        return inv

    def _drive(self, inv: _Invocation, gen) -> Optional[int]:
        """Serial generator driver: each ``yield`` means "my armed WQEs
        must land before I continue" — flush the shared engine until this
        invocation's CQEs arrive, then resume the kernel."""
        try:
            while True:
                next(gen)
                self._drain(inv)
                self._fetched(inv)
        except StopIteration as e:
            return e.value

    def _fetched(self, inv: _Invocation) -> None:
        """First-phase (operand fetch) CQEs landed: release claimed
        resources (e.g. RX-ring slots) exactly once."""
        if inv.on_fetched is not None:
            inv.on_fetched()
            inv.on_fetched = None

    def _service_grouped(self, kernels: Sequence[LCKernel]) -> None:
        """Pipelined service loop — one kernel (the classic
        ``pipeline_depth > 1`` path) or a dispatch group of several, up
        to the admission window of invocations in flight at once.

        Round structure — (1) ADMIT invocations while partition credits
        last (round-robin across the group's kernels, so every handler
        of a mixed-class dispatch round is represented), running each to
        its first ``yield`` so its operand-fetch WQEs are armed
        *deferred*; (2) one shared FLUSH executes every armed fetch
        together with earlier invocations' armed write-backs (one
        descriptor table where the serial path needed two — and, for a
        group, one table for ALL handlers' gathers); (3) RESUME each
        fetched invocation — compute + arm write-back. The write-back
        then rides the NEXT round's flush, overlapped with the next
        admissions' fetches.

        Scratch isolation: with ``pipeline_depth > 1`` each admission
        holds a partition credit exactly as before. A depth-1 group
        (several handlers on an unpartitioned block) admits one
        invocation per kernel per round on the shared bump allocator —
        safe because the cursor only advances until the group drains."""
        # a lone kernel keeps the historical window (half the partitions
        # fetch while half drain); a group widens it so every handler
        # can arm its fetch before the shared flush
        use_parts = self.pipeline_depth > 1
        window = (self._stage_window if len(kernels) == 1
                  else max(len(kernels), self._stage_window))
        stages: deque = deque()          # fetch armed, awaiting CQEs
        wb: List[_Invocation] = []       # fn done, write-back in flight
        while any(k.control_fifo.not_empty for k in kernels) or stages \
                or wb:
            wb = [i for i in wb if not i.finalized]
            ready: deque = deque(k for k in kernels
                                 if k.control_fifo.not_empty)
            while ready and len(stages) < window:
                if use_parts and not self._free_parts:
                    self._lp["credit_waits"] += 1
                    break
                k = ready.popleft()
                msg = k.control_fifo.pop()
                part = self._free_parts.pop(0) if use_parts else None
                inv = self._admit_invocation(k, msg, part)
                if k.control_fifo.not_empty:
                    ready.append(k)      # round-robin across the group
                ctx = LCContext(self, inv)
                try:
                    res = k.fn(ctx, *msg.args)
                    if inspect.isgenerator(res):
                        next(res)        # arm fetch (deferred, NO flush)
                        stages.append((inv, ctx, res))
                        continue
                    inv.result_addr = res
                except StopIteration as e:   # generator with no yield
                    inv.result_addr = e.value
                except Exception as e:
                    inv.error = str(e)
                    ctx.commit(wait=True)
                inv.fn_done = True
                if not inv.outstanding:
                    self._finalize(inv)
                else:
                    wb.append(inv)
            if stages:
                fetch_armed = sum(len(i.outstanding)
                                  for i, _, _ in stages)
                if any(i.outstanding for i in wb):
                    self._lp["overlapped_flushes"] += 1
                    self._lp["fetch_wqes_overlapped"] += fetch_armed
                self._drain(stages[0][0])    # shared flush: fetch + wb
                still: deque = deque()
                for inv, ctx, gen in stages:
                    if inv.outstanding:      # budgeted flush cut it short
                        still.append((inv, ctx, gen))
                        continue
                    self._fetched(inv)
                    try:
                        next(gen)            # compute + arm write-back
                        still.append((inv, ctx, gen))   # multi-phase
                        continue
                    except StopIteration as e:
                        inv.result_addr = e.value
                    except Exception as e:
                        inv.error = str(e)
                        ctx.commit(wait=True)
                    inv.fn_done = True
                    if not inv.outstanding:
                        self._finalize(inv)
                    else:
                        wb.append(inv)       # rides the next round's flush
                stages = still
            elif wb:
                self._drain(wb[0])           # land trailing write-backs

    # -- CQE-driven completion --------------------------------------------
    def _qp(self, kernel: LCKernel, remote_peer: int):
        qp = kernel.qps.get(remote_peer)
        if qp is None:
            qp = self.engine.create_qp(self.peer, remote_peer,
                                       weight=kernel.weight, lc=True)
            self.engine.register_interrupt(qp, self._on_cqe)
            kernel.qps[remote_peer] = qp
        return qp

    def _on_cqe(self, cqe: CQE) -> None:
        """Engine interrupt on LC QPs: retire the WQE from its invocation;
        the last one (with the kernel function done) pushes the
        StatusMsg. Must not flush (runs inside flush_doorbells)."""
        inv = self._wr.pop(cqe.wr_id, None)
        if inv is None:
            return
        inv.outstanding.discard(cqe.wr_id)
        if cqe.status is not CQEStatus.SUCCESS:
            inv.failures.append(cqe)
        if inv.fn_done and not inv.outstanding and not inv.finalized:
            self._finalize(inv)

    def _finalize(self, inv: _Invocation) -> None:
        inv.finalized = True
        # a kernel that faulted BEFORE its first yield never reached the
        # fetch-landed hook: release the claimed resources (ring slots)
        # here or the ring wedges with _head stuck behind _pend
        self._fetched(inv)
        self._inflight -= 1
        self._lp["head"] += 1
        if inv.partition is not None:    # credit the partition back
            self._free_parts.append(inv.partition)
        if self._inflight == 0:          # recycle the bump allocator
            self._cursor = self.scratch_base
        k = inv.kernel
        ok = inv.error is None and not inv.failures
        detail = inv.error or ""
        if inv.failures and not detail:
            detail = (f"{len(inv.failures)} WQE(s) failed: "
                      f"{inv.failures[0].status.value}")
        status = StatusMsg(k.workload_id, inv.msg.tag, ok,
                           inv.result_addr if ok else None, detail=detail)
        if inv.on_finalized is not None:     # e.g. ring-to-status stamp
            inv.on_finalized()
            inv.on_finalized = None
        if not k.status_fifo.try_push(status):
            k.status_fifo.pop()          # bounded RTL FIFO: drop oldest
            self.stats["status_drops"] += 1
            k.status_fifo.try_push(status)
        self.stats["completed"] += 1
        if not ok:
            self.stats["errors"] += 1
        if k.interrupt_handler is not None:      # interrupt mode
            while k.status_fifo.not_empty:
                k.interrupt_handler(k.status_fifo.pop())

    def _drain(self, inv: _Invocation) -> None:
        """Flush the shared engine until this invocation's CQEs land.
        Budgeted flushes may take several rounds; armed host windows get
        served along the way (the engine is shared). With the reliability
        layer on, a lossy wire parks WQEs for replay (timeout / RNR
        backoff can sit out many flushes) — un-ACKed windows count as
        progress, and the retry budget guarantees termination: every
        parked WQE either delivers or surfaces a terminal error CQE,
        which retires it from ``inv.outstanding`` like any other."""
        stalls = 0
        while inv.outstanding:
            counts = self.engine.flush_doorbells()
            relia = getattr(self.engine, "_reliability", None)
            if any(counts.values()) or (
                    relia is not None and relia.outstanding() > 0):
                stalls = 0
            else:
                stalls += 1
                if stalls > 8:
                    raise RuntimeError(
                        "LC drain stalled: outstanding WQEs were never "
                        "scheduled (doorbell not armed?)")

    # -- scratch allocator -------------------------------------------------
    def _alloc(self, length: int,
               inv: Optional[_Invocation] = None) -> int:
        if inv is not None and inv.partition is not None:
            # per-invocation partition: concurrent pipelined invocations
            # can never alias each other's scratch
            end = (self.scratch_base
                   + (inv.partition + 1) * self._part_size)
            if inv.cursor + length > end:
                raise MemoryError(
                    f"LC scratch partition {inv.partition} exhausted: "
                    f"need {length}, [{inv.cursor}, {end}) left")
            addr = inv.cursor
            inv.cursor += length
            return addr
        if self._cursor + length > self.scratch_base + self.scratch_size:
            raise MemoryError(
                f"LC scratch exhausted: need {length}, "
                f"[{self._cursor}, {self.scratch_base + self.scratch_size})"
                " left")
        addr = self._cursor
        self._cursor += length
        return addr

    def poll(self, workload_id: int) -> Optional[StatusMsg]:
        """Polling mode: host checks the status FIFO."""
        return self.kernels[workload_id].status_fifo.pop()

"""RDMA verb/queue data structures (RecoNIC / RoCEv2 semantics).

These mirror the paper's §III-A / §IV-B terminology: work queue elements
(WQE), send queues (SQ), receive queues (RQ), completion queues (CQ) and
queue pairs (QP = SQ + RQ + CQ). The transport is a per-peer pool
in GPU memory instead of 100GbE, but the verb semantics are kept:

  READ / WRITE          one-sided, responder CPU not involved
  SEND / RECV           two-sided, RECV must be pre-posted on responder RQ
  WRITE_IMM / SEND_IMM  carry 32-bit immediate delivered in responder CQE
  SEND_INV              invalidates a remote rkey on completion

Memory regions (MR) carry rkeys and a placement tag (``host_mem`` /
``dev_mem``) exactly like the paper's ``-l host_mem|dev_mem`` option.
"""
from __future__ import annotations

import enum
import itertools
from collections import deque
from dataclasses import dataclass, field
from itertools import islice
from typing import Deque, Optional


class Opcode(enum.Enum):
    READ = "read"
    WRITE = "write"
    SEND = "send"
    RECV = "recv"
    WRITE_IMM = "write_imm"
    SEND_IMM = "send_imm"
    SEND_INV = "send_inv"


ONE_SIDED = {Opcode.READ, Opcode.WRITE, Opcode.WRITE_IMM}
TWO_SIDED = {Opcode.SEND, Opcode.SEND_IMM, Opcode.SEND_INV}


class Placement(enum.Enum):
    HOST_MEM = "host_mem"
    DEV_MEM = "dev_mem"


class CQEStatus(enum.Enum):
    SUCCESS = "success"
    REMOTE_ACCESS_ERROR = "remote_access_error"   # bad rkey / bounds
    INVALID_OPCODE = "invalid_opcode"
    RNR = "receiver_not_ready"                    # SEND with empty RQ
    # terminal statuses of the reliability layer's QP state machine:
    # retry budgets exhausted on the wire / RNR path, and the flush
    # status every remaining WQE drains with once a QP is in ERROR
    RETRY_EXC_ERROR = "retry_exceeded"
    RNR_RETRY_EXC_ERROR = "rnr_retry_exceeded"
    WR_FLUSH_ERROR = "wr_flush_err"


class QPState(enum.Enum):
    """QP state machine (the RoCEv2 modify_qp ladder, collapsed):
    ``RTS`` serves traffic; ``SQD`` drains the send queue without
    admitting new WQEs; ``ERROR`` (entered on retry/RNR exhaustion or a
    dead peer) completes every queued WQE with ``WR_FLUSH_ERROR`` until
    ``engine.recover_qp`` transitions back to RTS with a fresh PSN
    epoch."""
    RTS = "rts"
    SQD = "sqd"
    ERROR = "error"


@dataclass(frozen=True)
class MemoryRegion:
    """A registered buffer region. ``rkey`` gates remote access — the
    address-MSB routing of the paper becomes an explicit region handle."""
    rkey: int
    peer: int                 # owning peer (mesh position on the peer axis)
    base: int                 # offset into the peer's buffer pool
    length: int
    placement: Placement = Placement.DEV_MEM
    valid: bool = True

    def contains(self, addr: int, length: int) -> bool:
        return self.base <= addr and addr + length <= self.base + self.length


@dataclass(frozen=True)
class WQE:
    """Work queue element — the paper's 'argument list' for one transfer."""
    opcode: Opcode
    qp_num: int
    wr_id: int
    local_addr: int = 0
    remote_addr: int = 0
    length: int = 0
    rkey: int = -1            # remote MR key (one-sided ops)
    imm: Optional[int] = None
    inv_rkey: Optional[int] = None


@dataclass(frozen=True)
class CQE:
    """Completion queue entry."""
    wr_id: int
    qp_num: int
    opcode: Opcode
    status: CQEStatus = CQEStatus.SUCCESS
    byte_len: int = 0
    imm: Optional[int] = None


@dataclass
class QueuePair:
    """QP: SQ/RQ descriptor rings + a CQ. ``sq_pidx``/``sq_doorbell`` mimic
    the producer-index doorbell of the paper — WQEs posted beyond the last
    rung doorbell are not visible to the engine until ``ring_sq_doorbell``.

    The rings are ``deque``s (hardware rings are circular buffers): the SQ
    holds only the not-yet-retired window ``[sq_cidx, sq_pidx)``, the RQ
    pops RECVs from the head in O(1), and the CQ drains from the head in
    O(polled) — no O(n) ``pop(0)``/slice anywhere on a completion path.

    Ordering guarantee: WQEs of one QP execute (and complete — CQEs land
    on the CQ) strictly in posting order, whatever the engine's multi-QP
    scheduler interleaves *between* QPs. ``weight`` is the fair-scheduler
    quantum: a weight-k QP is offered k WQEs per round-robin round when
    several SQ windows contend for one flush. ``lc`` tags QPs owned by a
    Lookaside Compute kernel — the engine accounts their service
    separately (``stats["lc_service"]``) so host-vs-compute contention on
    the shared engine is observable. ``arm_times`` stamps each
    doorbell-covered WQE so the engine can histogram service latency.
    """
    qp_num: int
    local_peer: int
    remote_peer: int
    placement: Placement = Placement.DEV_MEM
    weight: int = 1
    lc: bool = False
    state: QPState = QPState.RTS
    arm_times: Deque[float] = field(default_factory=deque)
    sq: Deque[WQE] = field(default_factory=deque)
    rq: Deque[WQE] = field(default_factory=deque)   # pre-posted RECVs
    cq: Deque[CQE] = field(default_factory=deque)
    sq_pidx: int = 0          # producer index (posted)
    sq_doorbell: int = 0      # last doorbell value (visible to engine)
    sq_cidx: int = 0          # consumer index (executed/retired)

    def post_send(self, wqe: WQE) -> None:
        self.sq.append(wqe)
        self.sq_pidx += 1

    def post_recv(self, wqe: WQE) -> None:
        self.rq.append(wqe)

    def pending(self, limit: Optional[int] = None) -> list:
        """WQEs covered by the doorbell but not yet executed (the head of
        the SQ window; retired entries have already been popped).
        ``limit`` caps the snapshot — a budgeted flush can serve at most
        that many, so it need not copy a deep window's tail."""
        n = max(0, self.sq_doorbell - self.sq_cidx)
        if limit is not None:
            n = min(n, limit)
        return list(islice(self.sq, n))

    @property
    def pending_count(self) -> int:
        """Doorbell-covered, not-yet-executed WQEs — O(1)."""
        return max(0, self.sq_doorbell - self.sq_cidx)

    def retire(self, n: int) -> None:
        """Consume ``n`` executed WQEs from the SQ head."""
        for _ in range(n):
            self.sq.popleft()
        self.sq_cidx += n


_qp_counter = itertools.count(1)

#: The first rkey an engine-local allocator hands out (RDMAEngine owns a
#: per-engine ``itertools.count(RKEY_BASE)`` so rkeys are deterministic
#: per engine and never leak across engines or test execution order).
#: Rkeys come only from ``RDMAEngine.register_mr``.
RKEY_BASE = 0x1000


def next_qp_num() -> int:
    return next(_qp_counter)

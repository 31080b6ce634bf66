"""Doorbell coalescing — the paper's §VI-C insight as a reusable policy.

The paper shows that ringing one doorbell for a batch of n=50 WQEs (and
polling the CQ once) takes RDMA reads from ~18 Gb/s to ~89 Gb/s at 16 KB:
fixed per-dispatch costs (MMIO doorbell, first WQE fetch ≈ 680 ns, CQ poll)
amortize over the batch while the engine pipelines subsequent WQE fetches
(≈ 40 ns each).

In a distributed training system the same economics govern collective dispatch:
each all-reduce carries a fixed launch + latency cost (α) plus a byte cost
(β·bytes). ``BucketPlanner`` coalesces per-tensor gradients into fixed-size
buckets — n small all-reduces become ceil(n/bucket) large ones. This module
provides:

  * ``DoorbellCoalescer`` — queues WQEs, flushes on threshold: the verb-level
    batching used by the engine and examples.
  * ``BucketPlanner``    — greedy size-based bucketing of a gradient pytree,
    with the α–β model predicting the win (used by bench_grad_buckets and
    the training step).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from repro_torch.core.rdma.verbs import WQE


# ---------------------------------------------------------------------------
# Transport-plan coalescing (wire-level doorbell batching)
# ---------------------------------------------------------------------------

def coalesce_plan(plan: Sequence[tuple]) -> List[tuple]:
    """Merge adjacent same-direction, address-contiguous transfers.

    ``plan`` entries are ``(kind, src, dst, src_addr, dst_addr, length)``.
    Two consecutive entries merge when they share ``(src, dst)`` and both
    address ranges extend contiguously — n tiny WQEs produced by a strided
    producer collapse into one descriptor, the engine analogue of the
    paper's batched WQE fetch streaming at the steady-state interval.

    Semantics guard: a merged transfer reads its whole source range before
    writing (memcpy semantics), while the unmerged pair executes
    sequentially — if entry B's source overlaps entry A's destination the
    two disagree. That can only happen on a loopback row (``src == dst``),
    so a merge there additionally requires the combined source and
    destination ranges to be disjoint.
    """
    out: List[tuple] = []
    for entry in plan:
        kind, src, dst, src_addr, dst_addr, length = entry
        if out:
            k0, s0, d0, sa0, da0, ln0 = out[-1]
            contiguous = ((s0, d0) == (src, dst)
                          and src_addr == sa0 + ln0
                          and dst_addr == da0 + ln0)
            total = ln0 + length
            safe = (src != dst
                    or sa0 + total <= da0 or da0 + total <= sa0)
            if contiguous and safe and k0 == kind:
                out[-1] = (k0, s0, d0, sa0, da0, total)
                continue
        out.append(entry)
    return out


# ---------------------------------------------------------------------------
# Multi-QP doorbell scheduling (fair interleave of concurrent SQ windows)
# ---------------------------------------------------------------------------

def schedule_plan(windows: Sequence[Tuple[int, Sequence]],
                  scheduler: str = "rr",
                  weights: Optional[Dict[int, int]] = None,
                  budget: Optional[int] = None,
                  qp_window: Optional[int] = None,
                  state: Optional[Dict] = None,
                  promote_after: Optional[int] = None,
                  backlog: Optional[Dict[int, int]] = None
                  ) -> Tuple[List[tuple], Dict[int, int]]:
    """Interleave per-QP doorbell windows into one execution order.

    ``windows`` is the doorbell-arrival-ordered list of ``(qp_id,
    entries)`` pairs, one per armed QP (qp_ids must be unique); ``entries``
    is that QP's in-order pending window (entries are opaque — the engine
    passes WQEs, the conformance tests raw plan tuples). Returns
    ``(merged, counts)``: ``merged`` is the execution order as ``(qp_id,
    entry)`` picks, ``counts`` maps each qp_id to how many of its entries
    were taken.

    Guarantees (the transport conformance contract):

    * per-QP order — each QP's picks are a *prefix* of its window, in
      posting order (RDMA's intra-QP ordering rule; CQEs follow suit),
    * budget — at most ``budget`` total entries are taken (``None`` =
      drain everything), so one flush models a bounded engine service
      round,
    * ``qp_window`` — at most ``qp_window`` entries are taken from any
      ONE QP (``None`` = no cap): the per-QP share bound the autotuner
      sweeps, orthogonal to the total budget — a deep SQ in fifo mode
      (or a drain-mode flush) cannot fill the whole descriptor table.
      Leftovers stay in the QP's window for the next flush,
    * ``scheduler="rr"`` — stateless weighted round-robin over backlogged
      QPs, ``weights`` (default 1) entries per QP per round: no deep SQ
      can starve the others; with equal weights every backlogged QP's
      share of a flush is within one quantum of even,
    * ``scheduler="drr"`` — deficit round-robin with quantum carry-over:
      each *visit* credits the QP its quantum into a deficit counter that
      persists in ``state`` across flushes, so service truncated by the
      budget is repaid later and long-run shares of continuously
      backlogged QPs match ``weights`` exactly (ragged windows included).
      A persistent rotor resumes the round where the budget cut it.
      Deficits are carried, never minted: ``state`` tracks ``credited``
      (quanta granted) and ``destroyed`` (credit dropped when a window
      drains — an idle QP banks nothing), and the invariant
      ``credited == served + deficits + destroyed`` holds per QP,
    * ``scheduler="fifo"`` — the plain drain order: windows execute
      end-to-end in arrival order (the parity baseline; under a budget a
      deep first window starves the rest). With ``promote_after=T`` and a
      persistent ``state``, age-based promotion bounds the starvation: a
      backlogged QP that got zero service for T consecutive flushes is
      served one quantum ahead of the drain (oldest first), so no QP
      waits more than T flushes between services.

    ``state`` is the cross-flush scheduler memory (deficits, rotor, ages,
    conservation ledgers) owned by the caller — the engine threads its
    own dict through every flush; ``None`` keeps the call stateless.

    ``backlog`` gives each QP's TRUE pending depth when ``windows`` are
    budget-truncated snapshots (the engine copies at most ``flush_budget``
    WQEs per QP): drr must not mistake an exhausted snapshot for a
    drained window, or it would destroy carried deficit / re-credit a
    cut quantum and break the exact-share guarantee for weights
    comparable to the budget. Defaults to the window lengths.
    """
    if scheduler not in ("rr", "fifo", "drr"):
        raise ValueError(f"scheduler must be rr|fifo|drr, got {scheduler!r}")
    ids = [qid for qid, _ in windows]
    if len(set(ids)) != len(ids):
        raise ValueError("duplicate qp_id in windows")
    weights = weights or {}
    if qp_window is not None:
        # per-QP cap: truncate each window to its share bound. The
        # engine's snapshot is usually pre-capped (``_window_limit``);
        # capping here keeps schedule_plan independently correct for
        # direct callers (conformance tests, the fairness simulator).
        w_cap = max(1, int(qp_window))
        windows = [(qid, w[:w_cap] if len(w) > w_cap else w)
                   for qid, w in windows]
    total = sum(len(w) for _, w in windows)
    remaining = total if budget is None else min(budget, total)
    merged: List[tuple] = []
    counts: Dict[int, int] = {qid: 0 for qid in ids}
    lens = {qid: len(w) for qid, w in windows}
    entries_by_id = dict(windows)
    cursors = {qid: 0 for qid in ids}

    def _quantum(qid):
        return max(1, int(weights.get(qid, 1)))

    def _take(qid, n):
        nonlocal remaining
        ents = entries_by_id[qid]
        merged.extend((qid, ents[cursors[qid] + j]) for j in range(n))
        cursors[qid] += n
        counts[qid] += n
        remaining -= n

    if scheduler == "fifo":
        st = state if state is not None else {}
        ages = st.setdefault("ages", {})
        if promote_after is not None and remaining > 0:
            starving = sorted(
                (qid for qid in ids
                 if lens[qid] and ages.get(qid, 0) >= promote_after),
                key=lambda q: -ages.get(q, 0))          # oldest first
            for qid in starving:
                n = min(_quantum(qid), lens[qid], remaining)
                if n:
                    _take(qid, n)
                if remaining <= 0:
                    break
        for qid, _ in windows:
            n = min(lens[qid] - cursors[qid], remaining)
            if n:
                _take(qid, n)
            if remaining <= 0:
                break
        for qid in ids:                 # age only backlogged, unserved QPs
            ages[qid] = 0 if counts[qid] or not lens[qid] \
                else ages.get(qid, 0) + 1
        return merged, counts

    if scheduler == "drr":
        st = state if state is not None else {}
        deficits = st.setdefault("deficits", {})
        credited = st.setdefault("credited", {})
        destroyed = st.setdefault("destroyed", {})
        backlog = backlog or {}

        def _left(qid):
            """Truly-backlogged entries beyond the served cursor (the
            snapshot may be shorter than the QP's real window)."""
            return max(lens[qid], backlog.get(qid, 0)) - cursors[qid]

        start = ids.index(st["rotor"]) if st.get("rotor") in ids else 0
        rotation = ids[start:] + ids[:start]
        # A budget cut mid-quantum pauses the round DURING this QP's
        # service: the next flush resumes at it, spending the banked
        # deficit WITHOUT a fresh credit (otherwise every flush would
        # credit a full round while serving only part of one, minting
        # unbounded deficit for whoever sits at the cut).
        skip_credit = st.pop("no_credit", None)
        progressed = True
        while remaining > 0 and progressed:
            progressed = False
            for pos, qid in enumerate(rotation):
                avail = lens[qid] - cursors[qid]
                if avail <= 0:
                    continue
                if qid == skip_credit:
                    skip_credit = None          # resume: no double credit
                else:
                    q = _quantum(qid)
                    deficits[qid] = deficits.get(qid, 0) + q
                    credited[qid] = credited.get(qid, 0) + q
                n = min(deficits[qid], avail, remaining)
                _take(qid, n)
                deficits[qid] -= n
                progressed = True
                if _left(qid) == 0 and deficits[qid]:
                    # window drained: idle QPs bank no credit (classic DRR)
                    destroyed[qid] = destroyed.get(qid, 0) + deficits[qid]
                    deficits[qid] = 0
                if remaining <= 0:
                    if deficits[qid] > 0 and _left(qid) > 0:
                        st["rotor"] = qid       # cut mid-quantum: resume
                        st["no_credit"] = qid
                    else:
                        st["rotor"] = rotation[(pos + 1) % len(rotation)]
                    break
        return merged, counts

    # stateless weighted round-robin (the default)
    progressed = True
    while remaining > 0 and progressed:
        progressed = False
        for qid, _ in windows:
            n = min(_quantum(qid), lens[qid] - cursors[qid], remaining)
            if n <= 0:
                continue
            _take(qid, n)
            progressed = True
            if remaining <= 0:
                break
    return merged, counts


class DoorbellCoalescer:
    """Accumulate posted WQEs; ring one doorbell when the batch is full.

    ``flush_threshold`` = n in the paper's batch-requests (they use n=50).

    Context-manager contract: a CLEAN exit rings the doorbell for any
    partial tail batch; exiting via an exception ABORTS it instead — the
    not-yet-doorbelled WQEs are rescinded from the SQ so no later
    doorbell (here or anywhere else: ``ring_sq_doorbell`` defaults to
    covering every posted WQE) can execute a half-built batch. A KV
    migration whose destination allocation raises ``MemoryError``
    mid-loop must not ring for the pages it did manage to post. WQEs
    already flushed by an earlier threshold crossing are beyond recall;
    ``abort`` only rescinds the unrung tail.
    """

    def __init__(self, engine, qp, flush_threshold: int = 50):
        self.engine = engine
        self.qp = qp
        self.flush_threshold = max(1, flush_threshold)
        self._pending = 0

    def post(self, wqe: WQE) -> None:
        self.engine.post_send(self.qp, wqe)
        self._pending += 1
        if self._pending >= self.flush_threshold:
            self.flush()

    def flush(self) -> None:
        if self._pending:
            self.engine.ring_sq_doorbell(self.qp)
            self._pending = 0

    def abort(self) -> int:
        """Rescind the unrung tail: pop the batched-but-unrung WQEs off
        the SQ and rewind the producer index, so they are invisible to
        every future doorbell. Returns how many were rescinded."""
        n = self._pending
        for _ in range(n):
            self.qp.sq.pop()
        self.qp.sq_pidx -= n
        self._pending = 0
        return n

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        if exc_type is None:
            self.flush()
        else:
            self.abort()
        return False


# ---------------------------------------------------------------------------
# Gradient bucketing (training-side doorbell batching)
# ---------------------------------------------------------------------------

@dataclass
class Bucket:
    """One coalesced collective: a set of leaves flushed together."""
    leaf_ids: List[int] = field(default_factory=list)
    bytes: int = 0


def plan_buckets(leaf_sizes_bytes: Sequence[int],
                 bucket_bytes: int) -> List[Bucket]:
    """Greedy fill in reverse-autodiff order (gradients become available
    from the last layer backwards, so buckets fill in that order and can
    overlap with remaining backward compute)."""
    buckets: List[Bucket] = [Bucket()]
    for i in reversed(range(len(leaf_sizes_bytes))):
        b = buckets[-1]
        if b.bytes and b.bytes + leaf_sizes_bytes[i] > bucket_bytes:
            buckets.append(Bucket())
            b = buckets[-1]
        b.leaf_ids.append(i)
        b.bytes += leaf_sizes_bytes[i]
    return buckets


# ---------------------------------------------------------------------------
# Collective round schedules (multi-peer, multi-round transfer plans)
# ---------------------------------------------------------------------------
#
# Point-to-point workloads have one initiator, one responder, and
# independent rounds. A collective is the first schedule-LEVEL
# dependency the engine sees — round k's READ operands are round k-1's
# write-backs — so the plan is expressed as an ordered list of ROUNDS,
# each round a list of (phase, peer, src_peer, chunk) transfer entries
# that are mutually independent and may share one descriptor-table flush.
# ``chunk`` indexes a 1/n slice of the padded vector; ``chunk == -1``
# means the full vector (recursive doubling moves whole vectors).
# Phases: "rs" (reduce-scatter: READ then host-reduce), "ag" (all-gather:
# READ into place), "fold"/"xor" (recursive doubling reduce READs),
# "bcast" (non-pow2 extras READ the final vector).

def plan_ring_reduce_scatter(n_peers: int) -> List[List[tuple]]:
    """Ring reduce-scatter rounds: in round r, peer p READs chunk
    ``(p - r - 1) mod n`` from its left neighbor ``(p - 1) mod n`` and
    host-reduces it into its own copy. After n-1 rounds peer p owns the
    fully reduced chunk ``(p + 1) mod n``. Each peer moves (n-1)/n of
    the vector — the bandwidth-optimal half of the ring α–β model."""
    return [[("rs", p, (p - 1) % n_peers, (p - r - 1) % n_peers)
             for p in range(n_peers)]
            for r in range(n_peers - 1)]


def plan_ring_all_gather(n_peers: int) -> List[List[tuple]]:
    """Ring all-gather rounds: in round r, peer p READs chunk
    ``(p - r) mod n`` from its left neighbor directly into place (no
    reduce — the neighbor already holds it final). Round 0 copies the
    neighbor's OWNED chunk, later rounds relay what arrived earlier."""
    return [[("ag", p, (p - 1) % n_peers, (p - r) % n_peers)
             for p in range(n_peers)]
            for r in range(n_peers - 1)]


def plan_ring_allreduce(n_peers: int) -> List[List[tuple]]:
    """Full ring all-reduce: reduce-scatter then all-gather — 2(n-1)
    rounds, 2(n-1)/n of the vector on the wire per peer (exactly the
    ``predicted_sync_time`` wire term)."""
    return plan_ring_reduce_scatter(n_peers) + plan_ring_all_gather(n_peers)


def plan_rd_allreduce(n_peers: int) -> List[List[tuple]]:
    """Recursive-doubling all-reduce: latency-optimal (log2 rounds) at
    full-vector bandwidth per round. Non-pow2 peer counts fold the
    ``extras`` (peers m..n-1, m the largest pow2 <= n) into the core
    first and broadcast the result back out last."""
    m = 1
    while m * 2 <= n_peers:
        m *= 2
    extras = n_peers - m
    rounds: List[List[tuple]] = []
    if extras:
        rounds.append([("fold", i, m + i, -1) for i in range(extras)])
    k = 1
    while k < m:
        rounds.append([("xor", p, p ^ k, -1) for p in range(m)])
        k *= 2
    if extras:
        rounds.append([("bcast", m + i, i, -1) for i in range(extras)])
    return rounds


def collective_wire_words(algorithm: str, n_peers: int,
                          padded_words: int) -> int:
    """Exact pool words a schedule moves over the wire (all peers
    summed) — the denominator of the bench's wire-ratio gate. Ring:
    2(n-1) rounds x n peers x a 1/n chunk. Recursive doubling:
    log2(m) rounds x m peers x the full vector, plus one fold and one
    broadcast of the full vector per extra peer."""
    if n_peers <= 1:
        return 0
    if algorithm == "ring":
        return 2 * (n_peers - 1) * padded_words
    if algorithm == "rd":
        m = 1
        while m * 2 <= n_peers:
            m *= 2
        log2m = m.bit_length() - 1
        return (log2m * m + 2 * (n_peers - m)) * padded_words
    raise ValueError(f"algorithm must be ring|rd, got {algorithm!r}")


def predicted_sync_time(n_dispatches: int, total_bytes: int,
                        n_devices: int, alpha_s: float,
                        link_bw: float) -> float:
    """α–β ring-all-reduce time: each dispatch pays α; wire bytes for a
    ring all-reduce are 2·(n-1)/n · bytes at link_bw per device."""
    wire = 2.0 * (n_devices - 1) / n_devices * total_bytes / link_bw
    return n_dispatches * alpha_s + wire


def choose_bucket_bytes(leaf_sizes_bytes: Sequence[int], n_devices: int,
                        alpha_s: float, link_bw: float,
                        candidates: Optional[Sequence[int]] = None
                        ) -> Tuple[int, float]:
    """Pick the bucket size minimizing predicted sync time."""
    if candidates is None:
        candidates = [1 << 20, 4 << 20, 16 << 20, 64 << 20, 256 << 20]
    total = sum(leaf_sizes_bytes)
    best = (0, predicted_sync_time(len(leaf_sizes_bytes), total,
                                   n_devices, alpha_s, link_bw))
    for cand in candidates:
        n = len(plan_buckets(leaf_sizes_bytes, cand))
        t = predicted_sync_time(n, total, n_devices, alpha_s, link_bw)
        if t < best[1]:
            best = (cand, t)
    return best

"""Streaming-compute RX descriptor ring (paper §IV-D).

The paper's streaming mode processes packets straight off the MAC: packet
buffers land in a device-resident ring and user logic fires per arrival —
no per-invocation host round trip (cf. FPsPIN's handler-per-arrival
rings). Here the ring is a region of the engine's device pool:

  * producer — the MAC/ingress path (``TrafficRouter.ingest_packets``)
    pushes raw headers into ring slots over the QDMA staging path (one
    pow2 chunk bucket per slot size),
  * consumer — ``LCKernel.stream()`` drains up to ``ring_burst`` pending
    slots per invocation, gathering them into kernel scratch with
    loopback READ WQEs executed as ONE descriptor table per flush (the
    shape-bucketed descriptor tables — steady-state streaming sees no
    new bucket after warm-up).

In the port the ring's slots are words of the engine's pool tensor, so on
a GPU engine a push is one host-to-device copy of the slot (the QDMA
staging write of the reference, one per packet) and the gather never
leaves the card.

Cursors are monotonic sequence numbers (the hardware head/tail pointers);
``seq % depth`` is the slot index:

    head  — slots freed back to the producer (their gather landed)
    pend  — slots claimed by an in-flight consumer burst
    tail  — slots produced

A full ring either DROPS the packet (``policy="drop"`` — the MAC cannot
stall) or asserts BACKPRESSURE (``policy="backpressure"`` — flow control:
the producer retries after a drain); both are counted here AND mirrored
into ``transport.stats`` (the ``rx_ring_*`` keys) so the engine's one
stats surface shows ring health. Ring-to-status latency is histogrammed
per packet in pow2-µs ceiling buckets when the streaming kernel's
StatusMsg lands (cf. ORCA's µs-scale accounting).

Dispatch-plane extension (FPsPIN-style match→handler routing): slots are
CLASS-TAGGED — the ingress table stamps each packet with its handler id
at push time — and claims grew a per-class form: ``claim(n, match=...)``
picks the oldest ``n`` pending slots the predicate accepts, so a
``StreamDispatcher`` can carve one mixed-class ring into per-handler
sub-bursts that each stay FIFO in arrival order even when interleaved
with other classes or split by the wrap boundary. Claimed slots complete
out of order (``complete_seqs``) — the head cursor only advances over
the finished prefix, so an unfinished older claim still guards its slots
from the producer.
"""
from __future__ import annotations

import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.kernels.packet_parser import HDR_BYTES


def record_latency_us(hist: dict, seconds: float) -> None:
    """Bucket one latency sample into a pow2-µs ceiling histogram (the
    same bucketing as ``engine.stats["qp_latency_us"]``)."""
    us = seconds * 1e6
    bucket = 1
    while bucket < us:
        bucket <<= 1
    hist[bucket] = hist.get(bucket, 0) + 1


def percentile_us(hist: dict, q: float = 0.99) -> float:
    """Upper-edge percentile of a pow2-µs bucket histogram."""
    total = sum(hist.values())
    if not total:
        return 0.0
    rank = q * total
    seen = 0
    for bucket in sorted(hist):
        seen += hist[bucket]
        if seen >= rank:
            return float(bucket)
    return float(max(hist))


class RXRing:
    """Device-resident RX descriptor ring on one peer's pool.

    ``base`` defaults to sitting just BELOW ``pool_size // 2`` so it
    cannot alias a default-placed ``LookasideBlock`` scratch region
    (which starts at ``pool_size // 2``); pass explicit regions when the
    layout is custom. The ring registers its own MR so the streaming
    kernel's loopback gather READs are rkey-checked like any other verbs
    traffic.
    """

    def __init__(self, engine, peer: int = 0, base: int = None,
                 depth: Optional[int] = None, slot_bytes: int = HDR_BYTES,
                 policy: str = "drop"):
        if policy not in ("drop", "backpressure"):
            raise ValueError(
                f"policy must be drop|backpressure, got {policy!r}")
        self.engine = engine
        self.peer = peer
        # depth defaults from the engine's TransportTuning (rx_depth — a
        # layout knob the tuner records but does not sweep: resizing a
        # live ring would drop in-flight slots)
        if depth is None:
            tuning = getattr(engine, "tuning", None)
            depth = tuning.rx_depth if tuning is not None else 64
        self.depth = int(depth)
        self.slot_bytes = int(slot_bytes)
        self.base = (engine.pool_size // 2 - self.depth * self.slot_bytes
                     if base is None else base)
        assert self.base >= 0 and (self.base + self.depth * self.slot_bytes
                                   <= engine.pool_size), "ring out of pool"
        self.policy = policy
        self.mr = engine.register_mr(peer, self.base,
                                     self.depth * self.slot_bytes)
        self._head = 0            # freed for the producer
        self._tail = 0            # produced
        # seq -> (cls, push stamp): produced, not yet claimed. Plain dict
        # (insertion-ordered) — per-class claims remove from the middle.
        self._pending: Dict[int, Tuple[Optional[int], float]] = {}
        # seq -> done flag: claimed, not yet freed past the head cursor
        self._claimed: Dict[int, bool] = {}
        self.stats = {"pushed": 0, "dropped": 0, "backpressure": 0,
                      "consumed": 0, "swept": 0, "wrap_bursts": 0,
                      "peak_occupancy": 0, "latency_us": {}}

    # ------------------------------------------------------------ cursors
    @property
    def occupancy(self) -> int:
        """Slots not yet freed back to the producer."""
        return self._tail - self._head

    @property
    def available(self) -> int:
        """Slots a consumer burst can still claim."""
        return len(self._pending)

    def available_for(self, match: Optional[Callable[[Optional[int]], bool]]
                      ) -> int:
        """Pending slots whose class tag the predicate accepts
        (``None`` = all)."""
        if match is None:
            return len(self._pending)
        return sum(1 for cls, _ in self._pending.values() if match(cls))

    @property
    def space(self) -> int:
        return self.depth - self.occupancy

    def slot_addr(self, seq: int) -> int:
        return self.base + (seq % self.depth) * self.slot_bytes

    # ----------------------------------------------------------- producer
    def push(self, header, cls: Optional[int] = None) -> bool:
        """Land one packet in the next slot (the MAC arrival), tagged
        with its dispatch class (the handler id the ingress match table
        resolved; ``None`` = unclassified). Returns False when the ring
        is full: the packet is dropped (``policy="drop"``) or refused
        for retry (``"backpressure"``)."""
        t = self.engine.transport.stats
        if self.occupancy >= self.depth:
            key = "dropped" if self.policy == "drop" else "backpressure"
            self.stats[key] += 1
            t["rx_ring_" + key] += 1
            return False
        header = np.asarray(header, np.float32).ravel()
        assert header.shape[0] == self.slot_bytes, header.shape
        self.engine.write_buffer(self.peer, self.slot_addr(self._tail),
                                 header)
        self._pending[self._tail] = (cls, time.perf_counter())
        self._tail += 1
        self.stats["pushed"] += 1
        t["rx_ring_pushed"] += 1
        occ = self.occupancy
        if occ > self.stats["peak_occupancy"]:
            self.stats["peak_occupancy"] = occ
            # engine-wide high-water mark: max across rings, not the
            # latest ring's personal peak
            t["rx_ring_peak_occupancy"] = max(
                t["rx_ring_peak_occupancy"], occ)
        return True

    # ----------------------------------------------------------- consumer
    def claim(self, n: int,
              match: Optional[Callable[[Optional[int]], bool]] = None
              ) -> Tuple[List[int], List[Tuple[int, int]], List[float]]:
        """Claim the oldest ``n`` pending slots whose class tag ``match``
        accepts (``None`` = any class — the whole-ring burst). Returns
        the claimed seqs, their contiguous ``(addr, count)`` spans in
        arrival order (a run splits at the wrap boundary and at gaps
        left by other classes' slots), and the claimed packets' push
        stamps. Claimed slots stay allocated until ``complete_seqs`` /
        ``complete_consume`` (the gather must land before the producer
        may overwrite them)."""
        seqs: List[int] = []
        for seq, (cls, _) in self._pending.items():
            if match is None or match(cls):
                seqs.append(seq)
                if len(seqs) == n:
                    break
        assert 0 < n == len(seqs), (n, len(seqs))
        stamps = [self._pending[s][1] for s in seqs]
        for s in seqs:
            del self._pending[s]
            self._claimed[s] = False
        return seqs, self._spans(seqs), stamps

    def begin_consume(self, n: int) -> Tuple[List[Tuple[int, int]],
                                             List[float]]:
        """Class-blind burst claim (the single-parser path): oldest ``n``
        available slots, ``(spans, stamps)``."""
        _, spans, stamps = self.claim(n)
        return spans, stamps

    def _spans(self, seqs: List[int]) -> List[Tuple[int, int]]:
        """Contiguous (addr, count) spans of a claimed seq list: runs of
        consecutive seqs, split where the ring wraps (a wrap split is
        counted in ``wrap_bursts``; class gaps are not)."""
        spans: List[Tuple[int, int]] = []
        wrapped = False
        start = prev = seqs[0]
        for s in seqs[1:]:
            if s == prev + 1 and s % self.depth != 0:
                prev = s
                continue
            wrapped |= (s == prev + 1)       # consecutive, but wrapped
            spans.append((self.slot_addr(start), prev - start + 1))
            start = prev = s
        spans.append((self.slot_addr(start), prev - start + 1))
        if wrapped:
            self.stats["wrap_bursts"] += 1
        return spans

    def _free_seqs(self, seqs: List[int]) -> None:
        """Release claimed slots back toward the producer. The head
        cursor advances over the finished prefix only — an unfinished
        older claim keeps the producer out of its slots."""
        for s in seqs:
            assert self._claimed.get(s) is False, (s, self._claimed.get(s))
            self._claimed[s] = True
        while self._claimed.get(self._head):
            del self._claimed[self._head]
            self._head += 1

    def complete_seqs(self, seqs: List[int]) -> None:
        """Free specific claimed slots whose gather landed (the packets
        were PROCESSED — they count as consumed)."""
        self._free_seqs(seqs)
        self.stats["consumed"] += len(seqs)
        self.engine.transport.stats["rx_ring_consumed"] += len(seqs)

    def drop_seqs(self, seqs: List[int]) -> None:
        """Free specific claimed slots WITHOUT processing them (the
        dispatch plane's orphan sweep): counted as ``swept`` — never as
        consumed — and mirrored to ``rx_ring_swept``, so processed vs
        discarded packets stay distinguishable in every ledger."""
        self._free_seqs(seqs)
        self.stats["swept"] += len(seqs)
        self.engine.transport.stats["rx_ring_swept"] += len(seqs)

    def complete_consume(self, n: int) -> None:
        """Free the ``n`` oldest claimed slots back to the producer —
        called once their gather READ CQEs have landed."""
        todo = sorted(s for s, done in self._claimed.items()
                      if not done)[:n]
        assert len(todo) == n, (n, len(todo))
        self.complete_seqs(todo)

    def record_status(self, stamps: List[float]) -> None:
        """Histogram ring-to-status latency for one finalized burst."""
        now = time.perf_counter()
        for t0 in stamps:
            record_latency_us(self.stats["latency_us"], now - t0)

"""Gradient-bucket collectives as scheduled RDMA verbs on the shared engine.

The port of ``repro/train/collectives.py``: the same round plans
(``core.rdma.doorbell``), ``wr_id`` tokens, DRR tenancy, retransmits and
``stats["collectives"]`` ledger. The partial reduce between rounds is a
device add: both operands are read with ``engine.read_device`` and the
sum goes back through ``engine.write_buffer`` (the QDMA staging path,
ledgered as in the reference), so gradient words stay in the pool's
memory (HBM on the GPU). Shards may be numpy arrays or tensors; results
are tensors on the pool's device.

The paper's central claim is that compute blocks and the host *share
one RDMA offload engine* (§III-A); a data-parallel all-reduce is a
multi-peer, multi-round pattern of the same one-sided verbs serving
traffic already uses.

Mapping (ring rounds -> one-sided verbs -> descriptor buckets):

  ring round      -> one deferred doorbell flush: every peer posts ONE
                     one-sided READ of a 1/n chunk from its left
                     neighbor's bucket region (reduce-scatter half), or
                     of an already-final chunk directly into place
                     (all-gather half). All n READs of a round coalesce
                     into a single shape-bucketed descriptor table — the
                     §VI-C batch-requests doorbell applied to a
                     collective (n peers x 1 chunk ≙ the paper's n=50
                     WQE batch).
  chunk transfer  -> pow2 shape buckets in the transport: a training
                     run's bucket sizes repeat every step, so after the
                     first step every READ and every QDMA write-back
                     rides a cached descriptor program — ZERO
                     steady-state compiles in the transport's ledger.
  partial reduce  -> the accumulate between rounds (the Streaming
                     Compute block's training role), on the pool's
                     device; its write-back is the QDMA staging path,
                     also pow2 chunk-bucketed.
  bucket overlap  -> ``defer=True`` doorbells: bucket i's wire phase and
                     bucket i+1's round arm into the SAME flush
                     (``pipeline_depth`` in-flight buckets), so gradient
                     communication overlaps remaining backward compute
                     exactly as the reverse-autodiff bucket order
                     intends. ``stats["collectives"]`` ledgers the
                     overlapped flushes.
  fairness        -> collective QPs are ordinary tenants: they carry a
                     DRR ``weight`` and contend under the engine
                     scheduler, so a 100M-param gradient stream cannot
                     starve serving traffic (serving-tenant Jain stays
                     1.0).
  lossy fabric    -> chunk READs are PSN-tracked like any WQE: a dropped
                     gradient chunk is retransmitted go-back-N through
                     the same shape buckets, byte-identically and with
                     zero new compiles.

Algorithms: ``ring`` (bandwidth-optimal: 2(n-1)/n of the vector per
peer), ``rd`` recursive doubling (latency-optimal: log2 rounds of full
vectors, non-pow2 peer counts via fold/broadcast), plus the explicit
``reduce_scatter``/``all_gather`` pair (the ZeRO-1 boundary: reduce-
scatter before the sharded optimizer update, all-gather after).

All reductions run in f32 pool words and compute the SUM — callers
divide for a mean. With integer-valued payloads the result is exact
regardless of reduction order, which is what the conformance suite's
byte-parity oracle pins.
"""
from __future__ import annotations

import itertools
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.core.rdma.doorbell import (collective_wire_words,
                                      plan_rd_allreduce,
                                      plan_ring_all_gather,
                                      plan_ring_allreduce,
                                      plan_ring_reduce_scatter)
from repro_torch.core.rdma.verbs import CQEStatus, Opcode, WQE

#: wr_id tokens for collective traffic: engine-wide unique so a round
#: never mistakes a stale CQE (earlier round, same QP) for its own
_wr_tokens = itertools.count(0x434F4C00)


class CollectiveError(RuntimeError):
    """A chunk transfer that completed with a terminal error CQE;
    ``statuses`` maps the failed wr_id tokens to their statuses."""

    def __init__(self, msg: str, statuses: Optional[dict] = None):
        super().__init__(msg)
        self.statuses = statuses or {}


def _ledger(engine) -> dict:
    """The engine's ``stats["collectives"]`` ledger, default-initialized."""
    led = engine.stats.setdefault("collectives", {})
    for key in ("all_reduces", "reduce_scatters", "all_gathers", "buckets",
                "rounds", "chunk_reads", "wire_words", "wire_bytes",
                "reduce_words", "flushes", "overlapped_flushes"):
        led.setdefault(key, 0)
    return led


@dataclass
class _Slot:
    """One in-flight bucket's engine memory: per-peer data + scratch
    regions (scratch receives a round's incoming words so the reduce
    reads both operands after the flush — a READ can't accumulate)."""
    capacity: int                       # pool words per region
    data: Dict[int, object] = field(default_factory=dict)    # peer -> MR
    scratch: Dict[int, object] = field(default_factory=dict)
    qps: Dict[tuple, object] = field(default_factory=dict)   # (l, r) -> QP
    busy: bool = False


@dataclass
class _BucketState:
    """Progress of one bucket through its round schedule."""
    slot: _Slot
    rounds: List[List[tuple]]
    r: int                              # next round index
    words: int                          # unpadded words
    padded: int
    cw: int                             # chunk words (padded / n)
    pending: Dict[int, List[int]] = field(default_factory=dict)  # qp->toks
    reduces: List[tuple] = field(default_factory=list)  # (peer, addr, words)


class RDMACollective:
    """Bucketed all-reduce / reduce-scatter / all-gather over per-peer
    QPs of a shared :class:`~repro_torch.core.rdma.engine.RDMAEngine`.

    ``weight`` is the DRR quantum of every collective QP — the training
    stream's SLO tier when it contends with serving tenants.
    ``pipeline_depth`` bounds in-flight buckets; with depth >= 2,
    consecutive buckets' rounds share flushes (the comm/compute overlap
    the reverse-autodiff bucket order buys). ``pool_base`` offsets the
    per-peer region arena so the collective can cohabit a pool with
    other allocators (e.g. a serving ``PagedKVPool``).
    """

    def __init__(self, engine, n_peers: Optional[int] = None,
                 algorithm: str = "ring", weight: int = 1,
                 pipeline_depth: int = 2, pool_base: int = 0,
                 max_flushes: int = 256):
        if algorithm not in ("ring", "rd"):
            raise ValueError(f"algorithm must be ring|rd, got {algorithm!r}")
        self.engine = engine
        self.n = n_peers if n_peers is not None else engine.n_peers
        if not 1 <= self.n <= engine.n_peers:
            raise ValueError(
                f"n_peers={self.n} outside engine mesh ({engine.n_peers})")
        self.algorithm = algorithm
        self.weight = weight
        self.pipeline_depth = max(1, pipeline_depth)
        self.pool_base = pool_base
        self.max_flushes = max_flushes
        self._word_bytes = np.dtype(
            engine.host_mem[0].dtype).itemsize if engine.host_mem else 4
        self._bump = {p: pool_base for p in range(self.n)}
        self._slots: List[_Slot] = []
        self.stats = _ledger(engine)

    # ------------------------------------------------------------ plumbing
    def _qp(self, slot: _Slot, local: int, remote: int):
        """The slot's QP for one ring/XOR direction. QPs are per SLOT so
        concurrently in-flight buckets never share a CQ — one bucket's
        completion poll must not consume another's CQEs."""
        qp = slot.qps.get((local, remote))
        if qp is None:
            qp = self.engine.create_qp(local, remote, weight=self.weight)
            slot.qps[(local, remote)] = qp
        return qp

    def _alloc(self, peer: int, words: int):
        base = self._bump[peer]
        if base + words > self.engine.pool_size:
            raise MemoryError(
                f"collective arena exhausted on peer {peer}: "
                f"{base}+{words} > {self.engine.pool_size}")
        self._bump[peer] = base + words
        return self.engine.register_mr(peer, base, words)

    def _slot(self, capacity: int) -> _Slot:
        """A free slot with >= ``capacity`` words per region (regions are
        registered once and reused every step — repeated bucket shapes
        are what keep the descriptor and QDMA caches warm)."""
        for s in self._slots:
            if not s.busy and s.capacity >= capacity:
                s.busy = True
                return s
        slot = _Slot(capacity)
        for p in range(self.n):
            slot.data[p] = self._alloc(p, capacity)
            slot.scratch[p] = self._alloc(p, capacity)
        slot.busy = True
        self._slots.append(slot)
        return slot

    def reserve(self, capacity: int) -> None:
        """Register ``pipeline_depth`` free slots of ``capacity`` words
        up front. Slots are taken first-fit and a bucket that finds none
        large enough registers a new one, so buckets that grow along the
        plan leave smaller slots behind: tinyllama-1.1b's 11 buckets at
        16 MiB (65.5M, 90K, 11.5M, 92.3M, 92.3M, 11.5M, 3 x 253.8M, 2K,
        65.5M words) take 1330.8M words per peer that way, over the 2^30
        of two slots of the largest. Reserved slots fit every bucket up
        to ``capacity``, so the arena stays at that."""
        slots = [self._slot(capacity) for _ in range(self.pipeline_depth)]
        for slot in slots:
            slot.busy = False

    def _plan(self, algorithm: str) -> List[List[tuple]]:
        if algorithm == "ring":
            return plan_ring_allreduce(self.n)
        return plan_rd_allreduce(self.n)

    # -------------------------------------------------------- round loop
    def _load(self, slot: _Slot, shards: Sequence, padded: int) -> None:
        for p in range(self.n):
            vec = _f32_flat(shards[p])
            pad = padded - _size(vec)
            if pad and isinstance(vec, torch.Tensor):
                vec = torch.cat([vec, vec.new_zeros(pad)])
            elif pad:
                vec = np.concatenate([vec, np.zeros(pad, np.float32)])
            self.engine.write_buffer(p, slot.data[p].base, vec)

    def _arm_round(self, st: _BucketState) -> None:
        """Post this round's READs on their QPs and ring ``defer=True``
        doorbells — the round executes at the NEXT shared flush, so
        several buckets' (and any serving tenant's) rounds ride one
        descriptor table."""
        slot, cw = st.slot, st.cw
        st.pending = {}
        st.reduces = []
        for phase, p, src, chunk in st.rounds[st.r]:
            qp = self._qp(slot, p, src)
            length = cw if chunk >= 0 else st.padded
            src_off = chunk * cw if chunk >= 0 else 0
            if phase in ("rs", "fold", "xor"):
                local = slot.scratch[p].base
                st.reduces.append((p, slot.data[p].base + src_off, length))
            else:                       # ag / bcast: copy into place
                local = slot.data[p].base + src_off
            tok = next(_wr_tokens)
            self.engine.post_send(qp, WQE(
                Opcode.READ, qp.qp_num, wr_id=tok, local_addr=local,
                remote_addr=slot.data[src].base + src_off, length=length,
                rkey=slot.data[src].rkey))
            self.engine.ring_sq_doorbell(qp, defer=True)
            st.pending.setdefault(qp.qp_num, []).append(tok)
            self.stats["chunk_reads"] += 1
            self.stats["wire_words"] += length
            self.stats["wire_bytes"] += length * self._word_bytes
        st.r += 1
        self.stats["rounds"] += 1

    def _complete_round(self, st: _BucketState) -> None:
        """Collect this round's CQEs (driving ``flush_doorbells`` between
        polls so retransmission timers advance on a lossy fabric), then
        add the landed scratch words into the data regions."""
        wanted = {tok for toks in st.pending.values() for tok in toks}
        qps = [self.engine.qps[qn] for qn in st.pending]
        got: Dict[int, object] = {}
        for _ in range(self.max_flushes):
            for qp in qps:
                for cqe in self.engine.poll_cq(
                        qp, max_entries=4 * len(wanted) + 16):
                    if cqe.wr_id in wanted:
                        got[cqe.wr_id] = cqe.status
            if len(got) == len(wanted):
                break
            self.engine.flush_doorbells()
        bad = {tok: s for tok, s in got.items()
               if s is not CQEStatus.SUCCESS}
        if bad or len(got) != len(wanted):
            raise CollectiveError(
                f"round {st.r - 1}: {len(bad)} failed / "
                f"{len(wanted) - len(got)} missing chunk READs", bad)
        for p, addr, words in st.reduces:
            cur = self.engine.read_device(p, addr, words)
            inc = self.engine.read_device(
                p, st.slot.scratch[p].base, words)
            self.engine.write_buffer(p, addr, cur.add_(inc))
            self.stats["reduce_words"] += words

    def _read_out(self, st: _BucketState) -> List[torch.Tensor]:
        return [self.engine.read_device(p, st.slot.data[p].base, st.words)
                for p in range(self.n)]

    # ------------------------------------------------------------- public
    def all_reduce_buckets(self, bucket_shards: Sequence[Sequence],
                           algorithm: Optional[str] = None
                           ) -> List[List[torch.Tensor]]:
        """Pipelined all-reduce over a list of buckets.

        ``bucket_shards[b][p]`` is peer p's flat shard of bucket b (f32
        words on the wire); returns the SUMMED vectors in the same
        layout, as f32 tensors on the pool's device. Up to
        ``pipeline_depth`` buckets are in flight: each tick arms every
        in-flight bucket's next round deferred and ONE
        ``flush_doorbells`` executes them all — a flush serving more
        than one bucket is ledgered as overlapped (bucket i's wire phase
        riding with bucket i+1's, the comm/compute overlap metric).
        """
        algorithm = algorithm or self.algorithm
        plan = self._plan(algorithm)
        results: List[Optional[List[torch.Tensor]]] = [None] * len(
            bucket_shards)
        inflight: List[tuple] = []      # (bucket_idx, _BucketState)
        pending = list(enumerate(bucket_shards))
        self.stats["all_reduces"] += len(bucket_shards)
        self.stats["buckets"] += len(bucket_shards)
        while pending or inflight:
            while pending and len(inflight) < self.pipeline_depth:
                idx, shards = pending.pop(0)
                st = self._new_state(shards, plan)
                if not st.rounds:       # n == 1: nothing on the wire
                    results[idx] = self._read_out(st)
                    st.slot.busy = False
                    continue
                inflight.append((idx, st))
            if not inflight:
                continue
            for _, st in inflight:
                self._arm_round(st)
            self.stats["flushes"] += 1
            if len(inflight) > 1:
                self.stats["overlapped_flushes"] += 1
            self.engine.flush_doorbells()
            still = []
            for idx, st in inflight:
                self._complete_round(st)
                if st.r == len(st.rounds):
                    results[idx] = self._read_out(st)
                    st.slot.busy = False
                else:
                    still.append((idx, st))
            inflight = still
        return results              # type: ignore[return-value]

    def all_reduce(self, shards: Sequence,
                   algorithm: Optional[str] = None) -> List[torch.Tensor]:
        """Sum one vector across peers: ``shards[p]`` -> summed copies."""
        return self.all_reduce_buckets([shards], algorithm)[0]

    def reduce_scatter(self, shards: Sequence) -> List[torch.Tensor]:
        """Ring reduce-scatter (the ZeRO-1 gradient boundary): returns
        peer p's OWNED fully-reduced chunk — chunk ``(p+1) mod n`` of
        the padded sum, ``padded/n`` words."""
        st = self._new_state(shards, plan_ring_reduce_scatter(self.n))
        self._run_serial(st)
        self.stats["reduce_scatters"] += 1
        out = [self.engine.read_device(
            p, st.slot.data[p].base + ((p + 1) % self.n) * st.cw, st.cw)
            for p in range(self.n)]
        st.slot.busy = False
        return out

    def all_gather(self, chunks: Sequence) -> List[torch.Tensor]:
        """Ring all-gather (the ZeRO-1 parameter boundary): inverse of
        :meth:`reduce_scatter` — ``chunks[p]`` is the chunk peer p owns
        (logical index ``(p+1) mod n``); returns the full concatenated
        vector on every peer."""
        cw = _size(chunks[0])
        padded = cw * self.n
        st = _BucketState(self._slot(padded),
                          plan_ring_all_gather(self.n), 0,
                          padded, padded, cw)
        for p in range(self.n):
            self.engine.write_buffer(
                p, st.slot.data[p].base + ((p + 1) % self.n) * cw,
                _f32_flat(chunks[p]))
        self._run_serial(st)
        self.stats["all_gathers"] += 1
        out = self._read_out(st)
        st.slot.busy = False
        return out

    # ------------------------------------------------------------ helpers
    def _new_state(self, shards: Sequence,
                   rounds: List[List[tuple]]) -> _BucketState:
        words = _size(shards[0])
        cw = -(-words // self.n)
        padded = cw * self.n
        st = _BucketState(self._slot(padded), rounds, 0, words, padded, cw)
        self._load(st.slot, shards, padded)
        return st

    def _run_serial(self, st: _BucketState) -> None:
        while st.r < len(st.rounds):
            self._arm_round(st)
            self.stats["flushes"] += 1
            self.engine.flush_doorbells()
            self._complete_round(st)


def _size(x) -> int:
    return x.numel() if isinstance(x, torch.Tensor) else int(
        np.asarray(x).size)


def _f32_flat(x):
    if isinstance(x, torch.Tensor):
        return x.reshape(-1).to(torch.float32)
    return np.asarray(x, np.float32).reshape(-1)


def ideal_wire_words(algorithm: str, n_peers: int, words: int) -> int:
    """α–β-model wire words for one all-reduce of ``words`` (padded to a
    multiple of n): the bench's wire-ratio denominator."""
    cw = -(-words // n_peers)
    return collective_wire_words(algorithm, n_peers, cw * n_peers)

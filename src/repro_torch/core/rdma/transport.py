"""Local transport: executes RDMA descriptor tables over a pool tensor.

The "wire" of the RDMA engine. Registered buffers live in one tensor of
shape ``(n_peers, pool_size)`` on the engine's device: row *i* is peer
*i*'s device memory (the paper's dev_mem). On an H100 the whole pool sits
in HBM, so a transfer between two peers is a device-to-device copy that
never crosses PCIe.

Descriptor-driven execution (the paper's §VI-C engine): each doorbell
batch is packed into a descriptor table of ``(src, dst, src_addr,
dst_addr, length)`` rows and executed in table order. The executor keeps
the sequential meaning of the reference's ``fori_loop``: a later
descriptor sees the writes of earlier ones, and each descriptor gathers
its whole source range before it scatters (a same-row transfer whose
ranges overlap copies through a temporary). Source lanes are clipped to
``[0, pool_size - 1]``; destination lanes past the row end are dropped,
and negative ones wrap once, exactly as the reference's masked
gather/scatter does.

The (slots, chunk) shape buckets of the reference stay as host
bookkeeping — ``shape_buckets``, ``pack_descriptors``' bucket key,
``stats['bucket_hist']``, the cache hit/miss ledger and the online
``BucketLearner`` — so the ``stats`` surface and its counts equal the
reference's under the same traffic. PyTorch runs eagerly and keeps no
compile cache, so here a "miss" only marks a bucket as first seen, and
``prewarm`` only marks buckets as seen.

The QDMA staging path (``host_write`` / ``sync_host_to_dev``, the
paper's host<->dev_mem H2C DMA) keeps the reference's bounds check and
its ``qdma_*`` chunk-bucket ledger. A device tensor written through it
(the Lookaside block's ``store``) is copied in place on the device.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch._device import numpy_dtype, resolve_device, torch_dtype
from repro_torch.core.rdma.autotune import BucketLearner

# Bucketing policy: WQE slots and the per-WQE chunk length round up to
# powers of two (the reference's compiled-shape key, kept as the traffic
# profile's key).
MIN_SLOT_BUCKET = 8
MIN_CHUNK_BUCKET = 16


# ---------------------------------------------------------------------------
# Descriptor packing (host side)
# ---------------------------------------------------------------------------

def _next_pow2(n: int) -> int:
    return 1 << max(0, (int(n) - 1).bit_length())


def shape_buckets(n_wqes: int, max_len: int, pool_size: int
                  ) -> Tuple[int, int]:
    """(slots, chunk) bucket key for a doorbell batch."""
    slots = max(MIN_SLOT_BUCKET, _next_pow2(max(1, n_wqes)))
    chunk = max(MIN_CHUNK_BUCKET, _next_pow2(max(1, max_len)))
    return slots, min(chunk, _next_pow2(pool_size))


def pack_descriptors(plan: Sequence[tuple], pool_size: int
                     ) -> Tuple[np.ndarray, int]:
    """Pack ``(kind, src, dst, src_addr, dst_addr, length)`` WQEs into a
    padded ``(slots, 5)`` int64 descriptor table + its chunk bucket.
    Padded rows carry ``length = 0`` and are no-ops."""
    slots, chunk = shape_buckets(
        len(plan), max((e[5] for e in plan), default=0), pool_size)
    desc = np.zeros((slots, 5), np.int64)
    for i, (_, src, dst, src_addr, dst_addr, length) in enumerate(plan):
        desc[i] = (src, dst, src_addr, dst_addr, length)
    return desc, chunk


def _new_stats() -> dict:
    return {"dispatches": 0, "wqes": 0, "coalesced_wqes": 0,
            "cache_hits": 0, "cache_misses": 0, "compiles": 0,
            # (slots, chunk) shape-bucket histogram of executed batches,
            # keyed "SLOTSxCHUNK" (JSON-friendly)
            "bucket_hist": {}, "prewarmed_buckets": 0,
            # online bucket learner (autotune.BucketLearner): spans
            # evicted by weight decay, pow2-adjacent spans merged, and the
            # current number of learned (slots, chunk) buckets.
            "bucket_decay_events": 0, "bucket_merges": 0,
            "learned_buckets": 0,
            # multi-QP scheduler: flushes whose descriptor table mixed
            # WQEs from more than one QP (set by the engine).
            "interleaved_batches": 0,
            # QDMA staging path (host_write / sync_host_to_dev): chunk
            # buckets first seen vs reused, plus total staged writes.
            "qdma_writes": 0, "qdma_cache_hits": 0,
            "qdma_cache_misses": 0, "qdma_compiles": 0,
            # Streaming-compute RX ring counters (set by the RX ring of
            # the dispatch plane; kept so the surface matches).
            "rx_ring_pushed": 0, "rx_ring_consumed": 0,
            "rx_ring_dropped": 0, "rx_ring_backpressure": 0,
            "rx_ring_swept": 0, "rx_ring_peak_occupancy": 0}


def pack_staging(length: int, addr: int, pool_size: int) -> int:
    """Bounds-check one host->device staging write of ``length`` words at
    ``addr`` and return its pow2 chunk bucket (the ``qdma_*`` ledger key).

    Overrunning writes raise: clamping the start address would shift the
    write and dropping lanes would truncate it — both silently corrupt,
    so the staging layer rejects them outright."""
    if addr < 0 or addr + length > pool_size:
        raise ValueError(
            f"host_write out of bounds: [{addr}, {addr + length}) "
            f"vs pool of {pool_size}")
    chunk = max(MIN_CHUNK_BUCKET, _next_pow2(max(1, length)))
    return min(chunk, _next_pow2(pool_size))


# ---------------------------------------------------------------------------
# Descriptor executor
# ---------------------------------------------------------------------------

def _exec_descriptor(pool: torch.Tensor, src: int, dst: int, src_addr: int,
                     dst_addr: int, length: int, chunk: int) -> None:
    """Execute one descriptor in place, as the reference's masked
    gather/scatter does: lanes ``[0, min(length, chunk))`` gather row
    ``src`` from ``src_addr`` (indices clipped into the row) and scatter
    to row ``dst`` at ``dst_addr + lane``. A negative destination index
    wraps once (``idx + pool_size``, the reference scatter's index
    normalisation); one still outside the row is dropped. All lanes are
    gathered before any is written."""
    pool_size = pool.shape[1]
    n = min(length, chunk)
    pieces = []                             # (first lane, end lane, wrap)
    for lo, hi, wrap in ((max(0, -dst_addr - pool_size),
                          min(n, -dst_addr), pool_size),
                         (max(0, -dst_addr), min(n, pool_size - dst_addr),
                          0)):
        if lo < hi:
            pieces.append((lo, hi, wrap))
    if not pieces:
        return
    lo = min(p[0] for p in pieces)
    hi = max(p[1] for p in pieces)
    s0, s1 = src_addr + lo, src_addr + hi
    if 0 <= s0 and s1 <= pool_size:
        vals = pool[src, s0:s1]
        if src == dst and any(s0 < dst_addr + w + b and dst_addr + w + a < s1
                              for a, b, w in pieces):
            vals = vals.clone()             # gather before scatter
    else:                                   # clipped source lanes
        idx = torch.arange(s0, s1, device=pool.device).clamp_(
            0, pool_size - 1)
        vals = pool[src].index_select(0, idx)
    for a, b, wrap in pieces:
        d0 = dst_addr + wrap + a
        pool[dst, d0:d0 + (b - a)].copy_(vals[a - lo:b - lo])


def _exec_descriptors_local(pool: torch.Tensor, desc: np.ndarray,
                            chunk: int) -> None:
    """Run a descriptor table in order (one descriptor sees the writes of
    the ones before it, like the reference's ``fori_loop``)."""
    for src, dst, src_addr, dst_addr, length in desc.tolist():
        if length > 0:
            _exec_descriptor(pool, src, dst, src_addr, dst_addr, length,
                             chunk)


# ---------------------------------------------------------------------------
# Transport
# ---------------------------------------------------------------------------

class LocalTransport:
    """The peer fabric on one device: row i of the pool is peer i's memory.

    ``stats`` carries dispatches, wqes, shape-bucket hits and misses,
    coalesced WQEs, interleaved multi-QP batches and the ``qdma_*``
    staging counters, under the reference's key names.
    """

    def __init__(self, pool: torch.Tensor):
        self.pool = pool
        self.stats = _new_stats()
        self._seen_buckets = set()
        self._seen_qdma_buckets = set()
        # Online (slots, chunk) histogram: every dispatch observes its
        # shape bucket; ``prewarm()`` with no arguments reads it.
        self.bucket_learner = BucketLearner(stats=self.stats)
        # Reliability harness hook: a seeded reliability.FaultInjector
        # installed here decides, per WQE transmission, whether the wire
        # delivers/drops/duplicates/delays/corrupts it.
        self.fault_injector = None

    def install_fault_injector(self, injector):
        """Attach a ``reliability.FaultInjector`` at the transport
        boundary (``None`` restores the perfect wire). The engine
        auto-enables its reliability layer on the next flush."""
        self.fault_injector = injector
        return injector

    @property
    def dispatch_count(self) -> int:
        return self.stats["dispatches"]

    @property
    def wqe_count(self) -> int:
        return self.stats["wqes"]

    def _account(self, key: Tuple[int, int], n_wqes: int,
                 max_len: Optional[int] = None) -> None:
        if key in self._seen_buckets:
            self.stats["cache_hits"] += 1
        else:
            self._seen_buckets.add(key)
            self.stats["cache_misses"] += 1
            self.stats["compiles"] += 1
        hist = self.stats["bucket_hist"]
        hkey = f"{key[0]}x{key[1]}"
        hist[hkey] = hist.get(hkey, 0) + 1
        self.bucket_learner.observe(key[0], key[1], n_wqes=n_wqes,
                                    max_len=max_len)
        self.stats["dispatches"] += 1
        self.stats["wqes"] += n_wqes

    def prewarm(self, buckets=None) -> int:
        """Mark (slots, chunk) buckets as seen, so later batches in them
        count as hits. ``None`` reads this transport's own
        ``bucket_learner``; another learner, a ``stats['bucket_hist']``
        (keys like ``"8x16"``) or explicit pairs are accepted too.
        Oversized chunk keys clamp as ``shape_buckets`` clamps real
        batches. Returns how many buckets were newly marked."""
        if buckets is None:
            buckets = self.bucket_learner
        new = 0
        pool_cap = _next_pow2(self.pool.shape[1])
        for b in buckets:
            slots, chunk = (b.split("x") if isinstance(b, str) else b)
            key = (int(slots), min(int(chunk), pool_cap))
            if key in self._seen_buckets:
                continue
            self._seen_buckets.add(key)
            self.stats["prewarmed_buckets"] += 1
            new += 1
        return new

    def _account_qdma(self, chunk: int) -> None:
        if chunk in self._seen_qdma_buckets:
            self.stats["qdma_cache_hits"] += 1
        else:
            self._seen_qdma_buckets.add(chunk)
            self.stats["qdma_cache_misses"] += 1
            self.stats["qdma_compiles"] += 1
        self.stats["qdma_writes"] += 1

    def execute_batch(self, plan: Sequence[tuple]) -> None:
        """plan: iterable of (kind, src, dst, src_addr, dst_addr, length).
        One dispatch per doorbell batch, executed in plan order."""
        if not plan:
            return
        desc, chunk = pack_descriptors(plan, self.pool.shape[1])
        _exec_descriptors_local(self.pool, desc, chunk)
        self._account((desc.shape[0], chunk), len(plan),
                      max_len=max((e[5] for e in plan), default=0))

    def host_read(self, peer: int, addr: int, length: int) -> np.ndarray:
        """D2H copy of ``length`` words of a peer's row (the host's view)."""
        return self.pool[peer, addr:addr + length].cpu().numpy()

    def device_read(self, peer: int, addr: int, length: int
                    ) -> torch.Tensor:
        """A copy of ``length`` words of a peer's row that stays on the
        pool's device (the Lookaside block's AXI4 read)."""
        return self.pool[peer, addr:addr + length].clone()

    def host_write(self, peer: int, addr: int, data) -> None:
        """QDMA H2C write of ``data`` at ``addr`` of row ``peer``. A numpy
        array (or sequence) is cast to the pool dtype as numpy casts and
        copied to the device; a tensor already on the device is copied
        in place there. Both count one ``qdma_writes`` in the chunk
        bucket of its length."""
        if isinstance(data, torch.Tensor):
            flat = data.reshape(-1)
        else:
            flat = torch.from_numpy(np.ascontiguousarray(
                np.asarray(data).reshape(-1).astype(
                    numpy_dtype(self.pool.dtype))))
        length = int(flat.shape[0])
        chunk = pack_staging(length, addr, self.pool.shape[1])
        self.pool[peer, addr:addr + length].copy_(flat)
        self._account_qdma(chunk)

    def load_pool(self, np_pool) -> None:
        """Copy a ``(n_peers, pool_size)`` array (``np.asarray`` of another
        engine's pool) into this pool on its device."""
        arr = np.asarray(np_pool)
        if tuple(arr.shape) != tuple(self.pool.shape):
            raise ValueError(f"pool shape {arr.shape} != "
                             f"{tuple(self.pool.shape)}")
        self.pool.copy_(torch.from_numpy(np.ascontiguousarray(
            arr.astype(numpy_dtype(self.pool.dtype)))))


def make_transport(n_peers: int, pool_size: int, dtype=np.float32,
                   device=None) -> LocalTransport:
    """Allocate the zeroed ``(n_peers, pool_size)`` pool on ``device``
    (``None`` -> the GPU) and wrap it in a ``LocalTransport``."""
    pool = torch.zeros((n_peers, pool_size), dtype=torch_dtype(dtype),
                       device=resolve_device(device))
    return LocalTransport(pool)

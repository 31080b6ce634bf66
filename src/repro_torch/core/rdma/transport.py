"""Transports: execute RDMA descriptor tables over the peers' pool.

The "wire" of the RDMA engine. Registered buffers are a pool of shape
``(n_peers, pool_size)``: row *i* is peer *i*'s device memory (the
paper's dev_mem). Two transports hold it:

* ``LocalTransport`` — the whole pool in one tensor on one device. On an
  H100 it sits in HBM, so a transfer between two peers is a
  device-to-device copy that never crosses PCIe.
* ``ICITransport`` — one process per peer over a ``torch.distributed``
  group (the reference's one pool row per device inside ``shard_map``):
  each rank holds only its own row, as a ``(1, pool_size)`` tensor on its
  device, and every rank runs the same program on the same tables
  (SPMD). ``make_transport`` picks it when given a mesh, or when the
  process group holds exactly ``n_peers`` ranks.

Descriptor-driven execution (the paper's §VI-C engine): each doorbell
batch is packed into a descriptor table of ``(src, dst, src_addr,
dst_addr, length)`` rows and executed in table order. The executor keeps
the sequential meaning of the reference's ``fori_loop``: a later
descriptor sees the writes of earlier ones, and each descriptor gathers
its whole source range before it scatters (a same-row transfer whose
ranges overlap copies through a temporary). Source lanes are clipped to
``[0, pool_size - 1]``; destination lanes past the row end are dropped,
and negative ones wrap once, exactly as the reference's masked
gather/scatter does. On ``ICITransport`` a descriptor between two rows
is a ``broadcast`` of the gathered lanes from the source rank, scattered
by the destination rank: a byte copy. (The reference broadcasts with a
masked ``psum``, which turns a ``-0.0`` into ``+0.0``; the port does
not.) Anything a rank reads from a row it does not own — ``host_read``,
``device_read``, ``gather_pool`` — is a ``broadcast`` from the owner, so
every rank sees the same bytes and takes the same branches.

The seed executors (``execute_batch_static``, ``host_write_static``)
keep the reference's ``dynamic_slice`` / ``dynamic_update_slice``
meaning, the parity oracle of the descriptor path: a negative start
index wraps once, then it is clamped so that the whole length fits,
shifting the copy; nothing is clipped per lane or dropped.

The (slots, chunk) shape buckets of the reference stay as host
bookkeeping — ``shape_buckets``, ``pack_descriptors``' bucket key,
``stats['bucket_hist']``, the cache hit/miss ledger and the online
``BucketLearner`` — so the ``stats`` surface and its counts equal the
reference's under the same traffic. PyTorch runs eagerly and keeps no
compile cache, so here a "miss" only marks a bucket as first seen, and
``prewarm`` only marks buckets as seen. ``descriptor_cache_size``,
``staging_cache_size`` and ``host_write_cache_size`` count the distinct
keys each executor has seen in the process, where the reference counts
its jit caches' programs: steady-state traffic adds none.

The QDMA staging path (``host_write`` / ``sync_host_to_dev``, the
paper's host<->dev_mem H2C DMA) keeps the reference's bounds check and
its ``qdma_*`` chunk-bucket ledger. A device tensor written through it
(the Lookaside block's ``store``) is copied in place on the device.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch._device import (numpy_dtype, rank_device, resolve_device,
                                 torch_dtype)
from repro_torch.core.rdma.autotune import BucketLearner

PEER_AXIS = "peers"

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
# Descriptor executor: one descriptor's gather half and scatter half
# ---------------------------------------------------------------------------

def _lane_span(dst_addr: int, length: int, chunk: int, pool_size: int):
    """The lanes a descriptor moves: ``(lo, hi, pieces)``, lanes ``[lo,
    hi)`` gathered and each ``(a, b, wrap)`` piece of them scattered to
    ``dst_addr + wrap + lane``; ``None`` when every lane drops. Lanes
    ``[0, min(length, chunk))`` take part; a negative destination index
    wraps once (``idx + pool_size``, the reference scatter's index
    normalisation) and one still outside the row is dropped."""
    n = min(length, chunk)
    pieces = [(lo, hi, wrap) for lo, hi, wrap in (
        (max(0, -dst_addr - pool_size), min(n, -dst_addr), pool_size),
        (max(0, -dst_addr), min(n, pool_size - dst_addr), 0)) if lo < hi]
    if not pieces:
        return None
    return (min(p[0] for p in pieces), max(p[1] for p in pieces), pieces)


def _gather(row: torch.Tensor, src_addr: int, lo: int, hi: int
            ) -> torch.Tensor:
    """Lanes ``[lo, hi)`` of ``row`` from ``src_addr``, indices clipped
    into the row (a view where none needs clipping)."""
    s0, s1 = src_addr + lo, src_addr + hi
    if 0 <= s0 and s1 <= row.shape[0]:
        return row[s0:s1]
    idx = torch.arange(s0, s1, device=row.device).clamp_(0, row.shape[0] - 1)
    return row.index_select(0, idx)


def _scatter(row: torch.Tensor, dst_addr: int, pieces, vals: torch.Tensor,
             lo: int) -> None:
    for a, b, wrap in pieces:
        d0 = dst_addr + wrap + a
        row[d0:d0 + (b - a)].copy_(vals[a - lo:b - lo])


def _exec_descriptor(pool: torch.Tensor, src: int, dst: int, src_addr: int,
                     dst_addr: int, length: int, chunk: int) -> None:
    """Execute one descriptor in place, as the reference's masked
    gather/scatter does; all lanes are gathered before any is written."""
    span = _lane_span(dst_addr, length, chunk, pool.shape[1])
    if span is None:
        return
    lo, hi, pieces = span
    vals = _gather(pool[src], src_addr, lo, hi)
    s0, s1 = src_addr + lo, src_addr + hi
    if src == dst and any(s0 < dst_addr + w + b and dst_addr + w + a < s1
                          for a, b, w in pieces):
        vals = vals.clone()                 # gather before scatter
    _scatter(pool[dst], dst_addr, pieces, vals, lo)


def _exec_descriptors_local(pool: torch.Tensor, desc: np.ndarray,
                            chunk: int) -> None:
    """Run a descriptor table in order (one descriptor sees the writes of
    the ones before it, like the reference's ``fori_loop``)."""
    for src, dst, src_addr, dst_addr, length in desc.tolist():
        if length > 0:
            _exec_descriptor(pool, src, dst, src_addr, dst_addr, length,
                             chunk)


# ---------------------------------------------------------------------------
# Seed (static-plan) executors — ``dynamic_slice`` semantics
# ---------------------------------------------------------------------------

def _clamp(start: int, length: int, size: int) -> int:
    """``dynamic_slice``'s start index: a negative one wraps once (``+
    size``), then it is clamped so that ``length`` fits."""
    if length > size:
        raise ValueError(f"a slice of {length} does not fit in {size}")
    start = int(start)
    if start < 0:
        start += size
    return min(max(start, 0), size - length)


def _run_plan_local_static(pool: torch.Tensor, plan: Sequence[tuple]
                           ) -> None:
    """The reference's seed executor on one pool: each transfer copies a
    ``dynamic_slice`` of row ``src`` into row ``dst`` by
    ``dynamic_update_slice`` (peer and address clamped, the copy shifted,
    nothing dropped), in plan order."""
    n_peers, pool_size = pool.shape
    for (_, src, dst, src_addr, dst_addr, length) in plan:
        s = _clamp(src_addr, length, pool_size)
        d = _clamp(dst_addr, length, pool_size)
        chunk = pool[_clamp(src, 1, n_peers), s:s + length].clone()
        pool[_clamp(dst, 1, n_peers), d:d + length].copy_(chunk)


def _flat_host(data, dtype: torch.dtype) -> torch.Tensor:
    """``data`` flattened: a tensor as it is, anything else cast to
    ``dtype`` as numpy casts."""
    if isinstance(data, torch.Tensor):
        return data.reshape(-1)
    return torch.from_numpy(np.ascontiguousarray(
        np.asarray(data).reshape(-1).astype(numpy_dtype(dtype))))


# Process-wide keys each executor has seen (the reference counts its jit
# caches' programs): (slots, chunk) of the local descriptor executor, the
# chunk of the staging path, (length, dtype) of the seed host write.
_DESCRIPTOR_KEYS = set()
_STAGING_KEYS = set()
_HOST_WRITE_KEYS = set()


def descriptor_cache_size() -> int:
    """Distinct (slots, chunk) buckets the local descriptor executor has
    run or prewarmed in this process (benchmarks diff this across a
    workload)."""
    return len(_DESCRIPTOR_KEYS)


def staging_cache_size() -> int:
    """Distinct chunk buckets the QDMA staging path has run in this
    process (shared by both transports)."""
    return len(_STAGING_KEYS)


def host_write_cache_size() -> int:
    """Distinct (length, dtype) keys of the seed (per-length) host write
    in this process."""
    return len(_HOST_WRITE_KEYS)


# ---------------------------------------------------------------------------
# Transports
# ---------------------------------------------------------------------------

class _TransportBase:
    """Shared bookkeeping: the ``stats`` surface (dispatches, wqes,
    shape-bucket hits and misses, coalesced WQEs, interleaved multi-QP
    batches and the ``qdma_*`` staging counters, under the reference's
    key names), the bucket learner, ``prewarm`` and the fault-injector
    hook."""

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

    def _warm(self, key: Tuple[int, int]) -> None:
        """A bucket's executor is ready (the reference compiles here)."""

    def _account(self, key: Tuple[int, int], n_wqes: int,
                 max_len: Optional[int] = None) -> None:
        self._warm(key)
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
            self._warm(key)
            self._seen_buckets.add(key)
            self.stats["prewarmed_buckets"] += 1
            new += 1
        return new

    def _account_qdma(self, chunk: int) -> None:
        _STAGING_KEYS.add(chunk)
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
        self._run_descriptors(desc, chunk)
        self._account((desc.shape[0], chunk), len(plan),
                      max_len=max((e[5] for e in plan), default=0))

    def execute_batch_static(self, plan: Sequence[tuple]) -> None:
        """Seed executor (``dynamic_slice`` semantics): the parity
        reference of ``execute_batch`` and the benches' baseline."""
        if not plan:
            return
        self._run_static(plan)
        self.stats["dispatches"] += 1
        self.stats["wqes"] += len(plan)


class LocalTransport(_TransportBase):
    """The peer fabric on one device: row i of the pool is peer i's
    memory."""

    mesh = None

    def _warm(self, key: Tuple[int, int]) -> None:
        _DESCRIPTOR_KEYS.add(key)

    def _run_descriptors(self, desc: np.ndarray, chunk: int) -> None:
        _exec_descriptors_local(self.pool, desc, chunk)

    def _run_static(self, plan: Sequence[tuple]) -> None:
        _run_plan_local_static(self.pool, plan)

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
        flat = _flat_host(data, self.pool.dtype)
        length = int(flat.shape[0])
        chunk = pack_staging(length, addr, self.pool.shape[1])
        self.pool[peer, addr:addr + length].copy_(flat)
        self._account_qdma(chunk)

    def host_write_static(self, peer: int, addr: int, data) -> None:
        """Seed QDMA path: ``dynamic_update_slice`` of ``data`` at (peer,
        addr), both clamped so that it fits — the write shifts, it never
        raises for a start out of range."""
        flat = _flat_host(data, self.pool.dtype)
        n_peers, pool_size = self.pool.shape
        length = int(flat.shape[0])
        a = _clamp(addr, length, pool_size)
        self.pool[_clamp(peer, 1, n_peers), a:a + length].copy_(flat)
        _HOST_WRITE_KEYS.add((length, str(self.pool.dtype)))

    def load_pool(self, np_pool) -> None:
        """Copy a ``(n_peers, pool_size)`` array (``np.asarray`` of another
        engine's pool) into this pool on its device."""
        arr = np.asarray(np_pool)
        if tuple(arr.shape) != tuple(self.pool.shape):
            raise ValueError(f"pool shape {arr.shape} != "
                             f"{tuple(self.pool.shape)}")
        self.pool.copy_(torch.from_numpy(np.ascontiguousarray(
            arr.astype(numpy_dtype(self.pool.dtype)))))

    def gather_pool(self) -> np.ndarray:
        """The whole ``(n_peers, pool_size)`` pool on the host."""
        return self.pool.cpu().numpy()


class ICITransport(_TransportBase):
    """The peer fabric over a process group: this rank is peer
    ``mesh.get_local_rank(axis)`` and ``pool`` its ``(1, pool_size)``
    row. Every rank executes the same tables (SPMD); a descriptor between
    two rows is a ``broadcast`` of the gathered lanes from the source
    peer's rank, scattered by the destination peer's rank (a byte copy,
    where the reference's masked ``psum`` flattens ``-0.0``). A
    descriptor within one row runs on its owner alone. Bounds checks run
    on every rank, so every rank raises alike."""

    def __init__(self, mesh, pool: torch.Tensor, axis: str = PEER_AXIS):
        if pool.ndim != 2 or pool.shape[0] != 1:
            raise ValueError(f"an ICITransport holds its own (1, pool_size) "
                             f"row, got {tuple(pool.shape)}")
        super().__init__(pool)
        self.mesh = mesh
        self.axis = axis
        self.group = mesh.get_group(axis)
        self.peer = mesh.get_local_rank(axis)
        self.n_peers = mesh.size(mesh.mesh_dim_names.index(axis))
        self._ranks = [dist.get_global_rank(self.group, p)
                       for p in range(self.n_peers)]

    def _bcast(self, t: torch.Tensor, peer: int) -> torch.Tensor:
        dist.broadcast(t, src=self._ranks[peer], group=self.group)
        return t

    def _owned_or_empty(self, peer: int, row_slice: slice, n: int
                        ) -> torch.Tensor:
        if peer == self.peer:
            return self.pool[0, row_slice].clone()
        return torch.empty(n, dtype=self.pool.dtype, device=self.pool.device)

    def _check_peer(self, peer: int) -> None:
        if not 0 <= peer < self.n_peers:
            raise IndexError(f"peer {peer} outside the {self.n_peers}-peer "
                             f"mesh")

    def _run_descriptors(self, desc: np.ndarray, chunk: int) -> None:
        row, me, pool_size = self.pool[0], self.peer, self.pool.shape[1]
        for src, dst, src_addr, dst_addr, length in desc.tolist():
            if length <= 0:
                continue
            self._check_peer(src)
            self._check_peer(dst)
            if src == dst:
                if me == src:
                    _exec_descriptor(self.pool, 0, 0, src_addr, dst_addr,
                                     length, chunk)
                continue
            span = _lane_span(dst_addr, length, chunk, pool_size)
            if span is None:
                continue
            lo, hi, pieces = span
            vals = (_gather(row, src_addr, lo, hi).contiguous() if me == src
                    else torch.empty(hi - lo, dtype=row.dtype,
                                     device=row.device))
            self._bcast(vals, src)
            if me == dst:
                _scatter(row, dst_addr, pieces, vals, lo)

    def _run_static(self, plan: Sequence[tuple]) -> None:
        """The reference's ``_run_plan_static``: per transfer, ``src``'s
        clamped ``dynamic_slice`` reaches ``dst`` (a broadcast where the
        reference ``ppermute``s), which writes it clamped."""
        row, me, pool_size = self.pool[0], self.peer, self.pool.shape[1]
        for (_, src, dst, src_addr, dst_addr, length) in plan:
            self._check_peer(src)
            self._check_peer(dst)
            s = _clamp(src_addr, length, pool_size)
            d = _clamp(dst_addr, length, pool_size)
            if src == dst:
                if me == src:
                    row[d:d + length].copy_(row[s:s + length].clone())
                continue
            vals = self._bcast(self._owned_or_empty(
                src, slice(s, s + length), length), src)
            if me == dst:
                row[d:d + length].copy_(vals)

    def device_read(self, peer: int, addr: int, length: int
                    ) -> torch.Tensor:
        """``length`` words of a peer's row on this rank's device, sent by
        the owner's rank to every rank (the same bytes everywhere)."""
        self._check_peer(peer)
        sl = slice(addr, addr + length)
        n = len(range(self.pool.shape[1])[sl])
        return self._bcast(self._owned_or_empty(peer, sl, n), peer)

    def host_read(self, peer: int, addr: int, length: int) -> np.ndarray:
        """``device_read`` copied to this rank's host."""
        return self.device_read(peer, addr, length).cpu().numpy()

    def host_write(self, peer: int, addr: int, data) -> None:
        """QDMA H2C write, landed by the owner's rank alone; checked and
        ledgered on every rank (see ``LocalTransport.host_write``)."""
        self._check_peer(peer)
        flat = _flat_host(data, self.pool.dtype)
        length = int(flat.shape[0])
        chunk = pack_staging(length, addr, self.pool.shape[1])
        if peer == self.peer:
            self.pool[0, addr:addr + length].copy_(flat)
        self._account_qdma(chunk)

    def host_write_static(self, peer: int, addr: int, data) -> None:
        """Seed QDMA path (peer and address clamped, never raises for a
        start out of range), landed by the owner's rank."""
        flat = _flat_host(data, self.pool.dtype)
        length = int(flat.shape[0])
        a = _clamp(addr, length, self.pool.shape[1])
        if _clamp(peer, 1, self.n_peers) == self.peer:
            self.pool[0, a:a + length].copy_(flat)
        _HOST_WRITE_KEYS.add((length, str(self.pool.dtype)))

    def load_pool(self, np_pool) -> None:
        """Keep this rank's row of a ``(n_peers, pool_size)`` array."""
        arr = np.asarray(np_pool)
        want = (self.n_peers, self.pool.shape[1])
        if tuple(arr.shape) != want:
            raise ValueError(f"pool shape {arr.shape} != {want}")
        self.pool[0].copy_(torch.from_numpy(np.ascontiguousarray(
            arr[self.peer].astype(numpy_dtype(self.pool.dtype)))))

    def gather_pool(self) -> np.ndarray:
        """The whole ``(n_peers, pool_size)`` pool on every rank's host,
        each row broadcast by its owner (``np.asarray`` of the
        reference's sharded pool)."""
        return np.stack([self.host_read(p, 0, self.pool.shape[1])
                         for p in range(self.n_peers)])


def make_peer_mesh(n_peers: int):
    """A 1-D ``("peers",)`` mesh over an initialized process group of
    ``n_peers`` ranks."""
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh("cpu", (n_peers,), mesh_dim_names=(PEER_AXIS,))


def alloc_pool(mesh, n_peers: int, pool_size: int, dtype=np.float32,
               device=None) -> torch.Tensor:
    """This rank's zeroed ``(1, pool_size)`` pool row on its device
    (``_device.rank_device``; ``None`` -> its GPU)."""
    axis = mesh.mesh_dim_names[0]
    if mesh.size(0) != n_peers:
        raise ValueError(f"a {n_peers}-peer pool on a mesh of "
                         f"{mesh.size(0)} peers")
    return torch.zeros((1, pool_size), dtype=torch_dtype(dtype),
                       device=rank_device(mesh.get_local_rank(axis),
                                          device))


def make_transport(n_peers: int, pool_size: int, dtype=np.float32,
                   device=None, mesh=None):
    """``ICITransport`` over ``mesh``, or over a fresh peer mesh when a
    process group of exactly ``n_peers`` ranks is initialized; otherwise
    a ``LocalTransport`` whose zeroed ``(n_peers, pool_size)`` pool lies
    on ``device`` (``None`` -> the GPU)."""
    if mesh is None and dist.is_available() and dist.is_initialized() \
            and dist.get_world_size() == n_peers:
        mesh = make_peer_mesh(n_peers)
    if mesh is not None:
        return ICITransport(mesh, alloc_pool(mesh, n_peers, pool_size,
                                             dtype, device),
                            mesh.mesh_dim_names[0])
    pool = torch.zeros((n_peers, pool_size), dtype=torch_dtype(dtype),
                       device=resolve_device(device))
    return LocalTransport(pool)

"""Disaggregated paged KV-cache serving over one-sided RDMA READs.

The port of ``repro/serve/kv_cache.py``: RecoNIC's memory model applied
to serving, block by block —

  KV page      -> a registered ``MemoryRegion`` in a peer's dev_mem pool
                  (the engine's pool tensor, in HBM on the H100). The
                  page table is host-side metadata.
  page fetch   -> a one-sided READ WQE posted on the fetching tenant's
                  own QP, scheduled into the same descriptor tables as
                  all other engine traffic.
  migration    -> ONE doorbell batch of READs, completion-tracked per
                  page: a source page is evicted only after its READ
                  completed with SUCCESS; failed destination pages roll
                  back.
  SLO tiers    -> per-tenant QPs whose scheduler ``weight`` is the tier.
  compression  -> ``compressed=True`` pools store pages quantize-packed:
                  per 64-lane chunk, int8 values (K1) + one fp32 scale,
                  int8 pairs packed two per pool word; a fetch unpacks
                  and dequantizes (K2) after the READs land.

Everything on the data side stays on the pool's device: caches flatten
with ``torch.cat`` there, pages are written as device tensors, fetched
pages come back through ``engine.read_device``, and the int8 pairs are
packed and unpacked with torch integer math, so a 200 MB handoff never
crosses PCIe and K1/K2 get device tensors. (The reference moves all of
it through host numpy.) Pages are byte-identical to the reference's.

Byte accounting derives from the pool's element dtype (``itemsize``),
and a compressed page bills its packed payload (int8 values + fp32
scales). Reliability: every completion loop drives
``engine.flush_doorbells`` so retransmission timers advance; retry
exhaustion surfaces terminal CQEs, after which the caller recovers the
QP (``RemoteKVClient.complete(recover=True)``) or gets the error
(``KVFetchError`` / migration rollback).
"""
from __future__ import annotations

import itertools
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import torch

from repro_torch._device import torch_dtype
from repro_torch.core.memory import BufferPool
from repro_torch.core.rdma.doorbell import DoorbellCoalescer
from repro_torch.core.rdma.verbs import CQEStatus, Opcode, WQE
from repro_torch.core.streaming.classifier import (TrafficClass,
                                                   TransferDesc)
from repro_torch.kernels.lc_offload import (_dequant_bucketed,
                                            _quant_bucketed)

#: quantization chunk of a compressed page (= the bulk-class stream
#: handler's slot width)
PAGE_CHUNK = 64

#: wr_id tokens for KV traffic: engine-wide unique so a client never
#: mistakes a stale CQE (earlier fetch on the same QP) for its own
_wr_tokens = itertools.count(0x4B560000)


def _ledger(engine) -> dict:
    """The engine's ``stats["kv_serve"]`` ledger, default-initialized."""
    led = engine.stats.setdefault("kv_serve", {})
    for key in ("fetches", "completed", "failed", "pages_posted",
                "pages_fetched", "pages_failed", "posted_words",
                "recoveries", "migrations", "pages_migrated",
                "pages_rolled_back"):
        led.setdefault(key, 0)
    return led


def packed_page_words(page_elems: int) -> int:
    """Pool words of one quantize-packed page: one fp32 scale per
    64-elem chunk + the int8 values packed two per word — 33/64 of the
    uncompressed footprint."""
    assert page_elems % PAGE_CHUNK == 0, page_elems
    return page_elems // PAGE_CHUNK + page_elems // 2


def _pack_rows(x: torch.Tensor) -> torch.Tensor:
    """(n, page_elems) f32 logical pages -> (n, packed_page_words) pool
    words ``[scales | int8 pairs]``, one K1 launch for all rows (each
    64-lane chunk quantizes on its own)."""
    n, pe = x.shape
    q, s = _quant_bucketed(x.reshape(-1, PAGE_CHUNK))
    pairs = (q.to(torch.int32) + 128).reshape(n, pe // 2, 2)
    packed = (pairs[..., 0] * 256 + pairs[..., 1]).to(torch.float32)
    return torch.cat([s.reshape(n, pe // PAGE_CHUNK), packed], dim=1)


def _unpack_rows(words: torch.Tensor, page_elems: int) -> torch.Tensor:
    """Inverse of ``_pack_rows``: (n, packed_page_words) pool words ->
    (n, page_elems) dequantized f32, one K2 launch for all rows."""
    n = words.shape[0]
    n_chunks = page_elems // PAGE_CHUNK
    s = words[:, :n_chunks].to(torch.float32).reshape(-1, 1)
    pw = torch.round(words[:, n_chunks:].to(torch.float32)).to(torch.int32)
    q = torch.stack([pw // 256 - 128, pw % 256 - 128], dim=-1)
    q = q.reshape(-1, PAGE_CHUNK).to(torch.int8)
    return _dequant_bucketed(q, s).reshape(n, page_elems)


def quant_pack_page(x) -> torch.Tensor:
    """Quantize-pack one logical page into its wire format.

    ``x`` (page_elems,) f32 -> (packed_page_words,) f32 pool words:
    ``[scales (n_chunks) | int8 pairs (page_elems/2)]`` where a pair
    word is ``(q0+128)*256 + (q1+128)`` — an exact small integer in
    fp32 (< 2^16), so the float pool carries it bit-faithfully. Runs
    where ``x`` lies (K1 on the GPU)."""
    x = torch.as_tensor(x).to(torch.float32).reshape(1, -1)
    return _pack_rows(x)[0]


def quant_unpack_page(words, page_elems: int) -> torch.Tensor:
    """Inverse of ``quant_pack_page``: (packed_page_words,) pool words
    -> (page_elems,) dequantized f32 (K2 on the GPU)."""
    words = torch.as_tensor(words).reshape(1, -1)
    return _unpack_rows(words, page_elems)[0]


@dataclass
class Page:
    """One KV page: its MR in the owning peer's pool, plus the billable
    payload bytes (dtype-derived — what a real NIC would serialize)."""
    mr: object                  # MemoryRegion holding the page payload
    seq_id: int
    page_idx: int
    nbytes: int = 0


class PagedKVPool:
    """Fixed-size page allocator over a peer's BufferPool.

    ``dtype`` (numpy or torch) is the logical element type of a page
    (one element per pool word) and drives billing: a page's ``nbytes``
    is ``page_elems * itemsize``. ``compressed=True`` stores pages
    quantize-packed instead: the MR shrinks to ``packed_page_words`` and
    bills the packed payload (int8 values + fp32 scales).
    """

    def __init__(self, engine, peer: int, page_elems: int,
                 max_pages: int, dtype=torch.float32,
                 compressed: bool = False):
        self.engine = engine
        self.peer = peer
        self.page_elems = page_elems
        self.dtype = torch_dtype(dtype)
        self.compressed = compressed
        if compressed:
            self.page_words = packed_page_words(page_elems)
            self.page_nbytes = (page_elems
                                + 4 * (page_elems // PAGE_CHUNK))
        else:
            self.page_words = page_elems
            self.page_nbytes = page_elems * self.dtype.itemsize
        self.pool = BufferPool(engine, peer)
        self.pages: Dict[int, List[Page]] = {}      # seq_id -> pages
        self.max_pages = max_pages
        self.allocated = 0

    def append_page(self, seq_id: int,
                    page_idx: Optional[int] = None) -> Page:
        """Allocate the next page of ``seq_id``. ``page_idx`` pins the
        logical index (migration mirrors the source page's index so a
        retried partial migration never collides)."""
        if self.allocated >= self.max_pages:
            raise MemoryError("KV pool exhausted (eviction required)")
        mr = self.pool.alloc(self.page_words)
        if page_idx is None:
            page_idx = len(self.pages.get(seq_id, []))
        page = Page(mr, seq_id, page_idx, self.page_nbytes)
        self.pages.setdefault(seq_id, []).append(page)
        self.allocated += 1
        return page

    def write_page(self, page: Page, data) -> None:
        """Stage logical page data (``page_elems`` elements, numpy or a
        tensor) into the page's MR on the pool's device — compressed pools
        quantize-pack on the way in."""
        data = torch.as_tensor(data).to(self.engine.pool.device,
                                        torch.float32).reshape(-1)
        if self.compressed:
            data = quant_pack_page(data)
        self.pool.write(page.mr, data)

    def read_page(self, page: Page) -> torch.Tensor:
        """Logical page contents on the pool's device (dequantized for
        compressed pools)."""
        raw = self.read_page_raw(page)
        if self.compressed:
            return quant_unpack_page(raw, self.page_elems)
        return raw

    def read_page_raw(self, page: Page) -> torch.Tensor:
        """The page's pool words exactly as the wire moves them."""
        return self.engine.read_device(self.peer, page.mr.base,
                                       page.mr.length)

    def evict(self, seq_id: int) -> int:
        pages = self.pages.pop(seq_id, [])
        for p in pages:
            self.pool.free(p.mr)
        self.allocated -= len(pages)
        return len(pages)

    def evict_pages(self, seq_id: int, pages: List[Page]) -> int:
        """Partial eviction: free exactly ``pages`` of ``seq_id`` (the
        rollback path of a failed migration/fetch). Pages not present
        are ignored. Returns how many were freed."""
        live = self.pages.get(seq_id, [])
        doomed = {id(p) for p in pages}
        keep, freed = [], 0
        for p in live:
            if id(p) in doomed:
                self.pool.free(p.mr)
                freed += 1
            else:
                keep.append(p)
        if keep:
            self.pages[seq_id] = keep
        else:
            self.pages.pop(seq_id, None)
        self.allocated -= freed
        return freed

    def seq_len_pages(self, seq_id: int) -> int:
        return len(self.pages.get(seq_id, []))


def _drive_completions(engine, qp, wanted, max_flushes: int = 64) -> dict:
    """Collect one CQE per wr_id in ``wanted`` from ``qp``'s CQ,
    driving ``engine.flush_doorbells`` between polls so the reliability
    layer's retransmission timers advance (a silently dropped READ is
    only replayed ``timeout_flushes`` flushes later). Stale CQEs (other
    wr_ids) are skipped. Terminates without the full set only at
    ``max_flushes`` — unreached in practice, because retry exhaustion
    surfaces terminal CQEs (RETRY_EXC / WR_FLUSH drain) for every
    outstanding WQE instead of hanging."""
    wanted = set(wanted)
    got: dict = {}
    batch = 4 * len(wanted) + 16
    for _ in range(max_flushes):
        for cqe in engine.poll_cq(qp, max_entries=batch):
            if cqe.wr_id in wanted and cqe.wr_id not in got:
                got[cqe.wr_id] = cqe.status
        if len(got) == len(wanted):
            return got
        engine.flush_doorbells()
    for cqe in engine.poll_cq(qp, max_entries=batch):
        if cqe.wr_id in wanted and cqe.wr_id not in got:
            got[cqe.wr_id] = cqe.status
    return got


def migrate_sequence(engine, router, src_pool: PagedKVPool,
                     dst_pool: PagedKVPool, seq_id: int, qp,
                     max_flushes: int = 64) -> int:
    """Move all pages of ``seq_id`` src->dst as ONE doorbell batch of
    RDMA READs (the paper's batch-requests applied to KV migration),
    reliability-aware:

      * each page's READ is tracked to its own CQE; a source page is
        evicted ONLY on SUCCESS — error CQEs (RETRY_EXC_ERROR after the
        PR-6 retry budget, WR_FLUSH_ERROR drains, REMOTE_ACCESS_ERROR)
        leave it in place and roll the matching destination page back;
      * destination exhaustion mid-batch (``MemoryError``) aborts the
        unrung doorbell (no half-built batch executes), rolls back the
        pages already allocated, and re-raises — the source is intact;
      * a QP driven to ERROR is surfaced, not hidden: the failed pages
        stay at the source and the caller decides (``engine.recover_qp``
        + retry, or reroute).

    Partial success leaves the sequence split across the pools; the
    destination mirrors each source page's ``page_idx``, so a retry of
    the remainder slots in cleanly. Returns pages actually migrated.
    """
    src_pages = src_pool.pages.get(seq_id, [])
    if not src_pages:
        return 0
    assert src_pool.page_words == dst_pool.page_words, \
        "src/dst pools disagree on the page wire format"
    router.route([TransferDesc(TrafficClass.KV_PAGE, p.nbytes,
                               src=src_pool.peer, dst=dst_pool.peer)
                  for p in src_pages])

    dst_pages: List[Page] = []
    tokens: Dict[int, int] = {}          # wr_id token -> batch index
    try:
        with DoorbellCoalescer(engine, qp,
                               flush_threshold=len(src_pages)) as db:
            for i, p in enumerate(src_pages):
                dp = dst_pool.append_page(seq_id, page_idx=p.page_idx)
                dst_pages.append(dp)
                tok = next(_wr_tokens)
                tokens[tok] = i
                db.post(WQE(Opcode.READ, qp.qp_num, wr_id=tok,
                            local_addr=dp.mr.base, remote_addr=p.mr.base,
                            length=p.mr.length, rkey=p.mr.rkey))
    except MemoryError:
        # The coalescer aborted the unrung tail on our way out, so none
        # of the posted READs can ever execute: roll back the partially
        # allocated destination and leave the source untouched.
        dst_pool.evict_pages(seq_id, dst_pages)
        raise

    statuses = _drive_completions(engine, qp, tokens, max_flushes)
    moved, failed_dst = [], []
    for tok, i in tokens.items():
        if statuses.get(tok) is CQEStatus.SUCCESS:
            moved.append(src_pages[i])
        else:
            failed_dst.append(dst_pages[i])
    dst_pool.evict_pages(seq_id, failed_dst)
    src_pool.evict_pages(seq_id, moved)
    led = _ledger(engine)
    led["migrations"] += 1
    led["pages_migrated"] += len(moved)
    led["pages_rolled_back"] += len(failed_dst)
    return len(moved)


class KVFetchError(RuntimeError):
    """A sequence fetch that could not be completed; ``statuses`` maps
    the failed wr_id tokens to their terminal CQE statuses."""

    def __init__(self, msg: str, statuses: Optional[dict] = None):
        super().__init__(msg)
        self.statuses = dict(statuses or {})


@dataclass
class KVTenant:
    """One serving tenant: its own QP whose scheduler ``weight`` is the
    SLO tier (a weight-w tenant is offered w WQEs per DRR round when
    fetches from several tenants share a flush)."""
    name: str
    qp: object
    weight: int


@dataclass
class FetchTicket:
    """One in-flight sequence fetch: n one-sided READs on the tenant's
    QP, one wr_id token per page. ``issued_flush``/``done_flush`` stamp
    the engine flush counter — the open-loop bench's deterministic
    "clock" for tail latency."""
    tenant: KVTenant
    seq_id: int
    pages: List[Page]
    stage: object                       # local staging MR
    tokens: Dict[int, tuple]            # token -> (page i, offset, words)
    statuses: Dict[int, CQEStatus] = field(default_factory=dict)
    data: Optional[torch.Tensor] = None  # (n_pages, page_elems) on success
    issued_flush: int = 0
    done_flush: int = 0

    @property
    def outstanding(self) -> int:
        return len(self.tokens) - len(self.statuses)

    @property
    def failed(self) -> List[int]:
        return [tok for tok, st in self.statuses.items()
                if st is not CQEStatus.SUCCESS]


class RemoteKVClient:
    """A decode worker's transport-client view of a remote PagedKVPool.

    Fetches ride one-sided READ WQEs on per-tenant QPs into a local
    staging BufferPool and come back as a tensor on the pool's device.
    ``advance`` is the non-blocking completion pump for open-loop serving
    loops; ``complete`` is the closed-loop wrapper that also recovers
    errored QPs on request. Everything is ledgered in
    ``engine.stats["kv_serve"]``.
    """

    def __init__(self, engine, local_peer: int, pool: PagedKVPool,
                 router=None, staging_size: Optional[int] = None):
        self.engine = engine
        self.local_peer = local_peer
        self.pool = pool                     # the REMOTE pool
        self.router = router
        self.staging = BufferPool(engine, local_peer, size=staging_size)
        self.tenants: Dict[str, KVTenant] = {}
        self._outstanding: Dict[str, List[FetchTicket]] = {}

    # --------------------------------------------------------- tenants
    def register_tenant(self, name: str, weight: int = 1) -> KVTenant:
        qp = self.engine.create_qp(self.local_peer, self.pool.peer,
                                   weight=weight)
        tenant = KVTenant(name, qp, weight)
        self.tenants[name] = tenant
        return tenant

    def _tenant(self, tenant) -> KVTenant:
        return (self.tenants[tenant] if isinstance(tenant, str)
                else tenant)

    # --------------------------------------------------------- fetches
    def fetch_sequence(self, tenant, seq_id: int,
                       defer: bool = False) -> FetchTicket:
        """Post one READ per page of ``seq_id`` on the tenant's QP and
        ring ONE doorbell (``defer=True`` arms it for the next shared
        flush — the open-loop mode). Staging exhaustion raises
        ``MemoryError`` — the caller's admission-control point."""
        t = self._tenant(tenant)
        pages = self.pool.pages.get(seq_id)
        if not pages:
            raise KeyError(f"seq {seq_id} has no pages in the remote "
                           f"pool on peer {self.pool.peer}")
        total = sum(p.mr.length for p in pages)
        stage = self.staging.alloc(total)
        tokens: Dict[int, tuple] = {}
        off = 0
        for i, p in enumerate(pages):
            tok = next(_wr_tokens)
            tokens[tok] = (i, off, p.mr.length)
            self.engine.post_send(t.qp, WQE(
                Opcode.READ, t.qp.qp_num, wr_id=tok,
                local_addr=stage.base + off, remote_addr=p.mr.base,
                length=p.mr.length, rkey=p.mr.rkey))
            off += p.mr.length
        self.engine.ring_sq_doorbell(t.qp, defer=defer)
        if self.router is not None:
            self.router.route([TransferDesc(
                TrafficClass.KV_PAGE, p.nbytes,
                src=self.pool.peer, dst=self.local_peer)
                for p in pages])
        led = _ledger(self.engine)
        led["fetches"] += 1
        led["pages_posted"] += len(pages)
        led["posted_words"] += total
        ticket = FetchTicket(t, seq_id, list(pages), stage, tokens,
                             issued_flush=self.engine.stats["flushes"])
        self._outstanding.setdefault(t.name, []).append(ticket)
        return ticket

    def advance(self, tenant) -> List[FetchTicket]:
        """Non-blocking completion pump (the open-loop serving loop's
        per-tick call): drain the tenant's CQ, credit statuses to its
        in-flight tickets, finalize the fully-resolved ones. A ticket
        whose READs all landed SUCCESS carries its (dequantized)
        payload in ``.data``; one with failures carries ``data=None``.
        Staging is freed either way. Returns the finalized tickets."""
        t = self._tenant(tenant)
        live = self._outstanding.get(t.name, [])
        if not live:
            return []
        by_tok = {tok: tk for tk in live for tok in tk.tokens
                  if tok not in tk.statuses}
        for cqe in self.engine.poll_cq(t.qp,
                                       max_entries=len(by_tok) + 64):
            tk = by_tok.get(cqe.wr_id)
            if tk is not None and cqe.wr_id not in tk.statuses:
                tk.statuses[cqe.wr_id] = cqe.status
        finished = [tk for tk in live if tk.outstanding == 0]
        if finished:
            self._outstanding[t.name] = [tk for tk in live
                                         if tk.outstanding]
            for tk in finished:
                self._finalize(tk)
        return finished

    def _finalize(self, tk: FetchTicket) -> None:
        led = _ledger(self.engine)
        tk.done_flush = self.engine.stats["flushes"]
        if not tk.failed:
            raw = self.engine.read_device(self.local_peer, tk.stage.base,
                                          tk.stage.length)
            rows = raw.reshape(len(tk.pages), self.pool.page_words)
            if self.pool.compressed:
                rows = _unpack_rows(rows, self.pool.page_elems)
            tk.data = rows
            led["pages_fetched"] += len(tk.pages)
            led["completed"] += 1
        else:
            led["pages_failed"] += len(tk.failed)
            led["failed"] += 1
        self.staging.free(tk.stage)

    def _wait(self, ticket: FetchTicket, max_flushes: int) -> bool:
        for _ in range(max_flushes):
            self.advance(ticket.tenant)
            if ticket.outstanding == 0:
                return True
            self.engine.flush_doorbells()
        self.advance(ticket.tenant)
        return ticket.outstanding == 0

    def complete(self, ticket: FetchTicket, max_flushes: int = 64,
                 recover: bool = False) -> torch.Tensor:
        """Drive engine flushes until ``ticket`` resolves; return its
        (n_pages, page_elems) payload on the pool's device. On failed
        READs: with ``recover=True`` the errored QP is re-armed
        (``recover_qp``, fresh PSN epoch) and the sequence fetched once
        more — the transient-fault path; otherwise (or when the retry
        fails too) the error surfaces as ``KVFetchError``. Source pages
        are never touched by a fetch, so no data is ever lost here."""
        if not self._wait(ticket, max_flushes):
            raise KVFetchError(
                f"fetch of seq {ticket.seq_id} unresolved after "
                f"{max_flushes} flushes", ticket.statuses)
        if ticket.data is not None:
            return ticket.data
        failed = {tok: ticket.statuses[tok] for tok in ticket.failed}
        if not recover:
            raise KVFetchError(
                f"fetch of seq {ticket.seq_id}: {len(failed)}/"
                f"{len(ticket.tokens)} pages failed "
                f"({sorted(st.value for st in failed.values())})", failed)
        self.engine.recover_qp(ticket.tenant.qp)
        _ledger(self.engine)["recoveries"] += 1
        retry = self.fetch_sequence(ticket.tenant, ticket.seq_id)
        if not self._wait(retry, max_flushes) or retry.data is None:
            raise KVFetchError(
                f"fetch of seq {ticket.seq_id} failed again after QP "
                "recovery", retry.statuses)
        ticket.data = retry.data
        return retry.data

    # ------------------------------------------- cache pytree plumbing
    def publish_caches(self, seq_id: int, caches) -> int:
        """Prefill-node role: flatten a KV-cache pytree into pages of
        the remote pool (zero-padded to the page boundary), written as
        device tensors. Returns pages written."""
        flat = flatten_cache_leaves(caches, self.engine.pool.device)
        pe = self.pool.page_elems
        n_pages = max(1, -(-int(flat.numel()) // pe))
        padded = flat.new_zeros(n_pages * pe)
        padded[:flat.numel()] = flat
        for i in range(n_pages):
            page = self.pool.append_page(seq_id)
            self.pool.write_page(page, padded[i * pe:(i + 1) * pe])
        return n_pages

    def fetch_caches(self, seq_id: int, like, tenant, **kw):
        """Decode-node role: fetch ``seq_id``'s pages over one-sided
        READs and rebuild a cache pytree shaped ``like`` (bit-exact for
        uncompressed f32 pools; int8-quantized for compressed ones)."""
        ticket = self.fetch_sequence(tenant, seq_id)
        data = self.complete(ticket, **kw)
        return unflatten_cache_leaves(data.reshape(-1), like)

    def roundtrip_caches(self, seq_id: int, caches, tenant,
                         evict: bool = True, **kw):
        """publish -> fetch: the prefill-node -> decode-node handoff of
        one sequence's caches through the remote pool."""
        self.publish_caches(seq_id, caches)
        out = self.fetch_caches(seq_id, caches, tenant, **kw)
        if evict:
            self.pool.evict(seq_id)
        return out


def _tree_leaves(tree) -> list:
    """Leaves in JAX's tree order: dict keys sorted, sequences in order,
    ``None`` skipped."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _tree_leaves(v)]
    return [tree]


def flatten_cache_leaves(caches, device=None) -> torch.Tensor:
    """Flatten a cache pytree to one f32 vector on ``device`` (default:
    the leaves' own), leaf order = JAX tree order (``k``, ``pos``, ``v``
    for an attention cache), so pages match the reference's bytes.
    Integer leaves (positions) are small enough to be exact in f32."""
    leaves = [torch.as_tensor(x) for x in _tree_leaves(caches)]
    if not leaves:
        return torch.zeros(0, dtype=torch.float32, device=device)
    device = leaves[0].device if device is None else device
    return torch.cat([x.to(device, torch.float32).reshape(-1)
                      for x in leaves])


def unflatten_cache_leaves(flat: torch.Tensor, like):
    """Rebuild a pytree shaped/dtyped ``like`` from the flat f32 vector
    (inverse of ``flatten_cache_leaves``; trailing page padding is
    ignored). The leaves lie on ``flat``'s device; f32 leaves are views
    of ``flat``."""
    flat = torch.as_tensor(flat)
    off = 0

    def build(tree):
        nonlocal off
        if tree is None:
            return None
        if isinstance(tree, dict):
            out = {k: None for k in tree}       # keep the key order
            for k in sorted(tree):
                out[k] = build(tree[k])
            return out
        if isinstance(tree, (list, tuple)):
            return type(tree)(build(v) for v in tree)
        leaf = torch.as_tensor(tree)
        n = leaf.numel()
        vals = flat[off:off + n].reshape(leaf.shape).to(leaf.dtype)
        off += n
        return vals

    return build(like)

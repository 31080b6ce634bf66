"""Offloaded Lookaside kernels (paper §IV-C/§IV-D, run as engine clients).

Each kernel here follows the paper's offload contract end to end:
RDMA-read its operands from a *remote* peer over the shared engine (WQEs
on the kernel's own QP, scheduled into the same descriptor tables as host
verbs traffic), compute on the NIC — here the hand-written CUDA kernels
on the pool's GPU — and RDMA-write the result back. The host only
exchanges ``ControlMsg``/``StatusMsg``; ``ctx.load`` hands the kernel a
tensor on the pool's device and ``ctx.store`` writes one back in place,
so the data never crosses PCIe.

ControlMsg argument conventions (all ints unless noted):

  ``systolic_mm``   : (remote_peer, rkey, a_addr, b_addr, out_addr, m, k, n)
  ``packet_parser`` : (remote_peer, rkey, pkts_addr, n_pkts, out_addr)
  stream handlers   : (ring_peer, ring_rkey, ring_base, out_peer, out_rkey,
  out_base, spans) — ``spans`` is a tuple of contiguous ``(addr, count)``
  slot spans of a ring (or any pool region of 64-word slots), in order.
  The streaming dispatch plane builds these; a host can dispatch them
  directly too.
  chain stages (the dispatcher's ``Chain`` pipelines): the stream-handler
  args plus a trailing ``in_row`` — the INPUT row width in pool words —
  because a chain stage's source region is either the RX ring (stage 0)
  or the upstream stage's slot-mirrored output ring. Slot index recovery
  is ``(addr - in_base) // in_row`` at any stage position. Each
  chain-stage kernel publishes a ``ChainStageSpec`` that
  ``register_chain`` composes and validates.

Stream handlers registered here:

  ``packet_parser_stream`` — parse each slot's RoCEv2-style header into a
  4-word meta row (one row per slot in the slot-mirrored meta region).
  ``quantize_stream``      — int8-quantize each slot's 64-lane payload,
  writing a 65-word row per slot (64 int8 values as f32 + the fp32
  scale).

Chain stages registered here (``register_chain_kernels``), each a
generator with the same fetch → ``yield`` → compute/write-back shape:

  ``chain_parse``    — framed slots (64 header bytes + a 65-word quant
  payload, ``FRAME_ROW`` = 129 words) → [meta(4) ‖ payload(65)] rows
  (``PARSED_ROW`` = 69): the header words are cast to uint8 on the
  device and parsed by K3.
  ``chain_dequant``  — the TRAILING ``QUANT_ROW`` words of each input row
  cast to int8 on the device and dequantized by K2 into a 64-lane f32
  row.
  ``chain_compress`` — 64-lane f32 rows → 65-word [q ‖ scale] rows by K1
  (byte parity with ``ops.compress(x, chunk=64)``).
  ``chain_checksum`` — a 2-word [checksum, width] row per input row of
  any width: the position-weighted sum of the words' raw bit patterns
  mod 2^24, in torch integer math on the device (the JAX package has no
  kernel for it either).

Every stage's rows stay on the pool's device between the gather and the
write-back.

Correctness contract: the parser, quantizer and chain-stage rows are
byte-identical to the JAX package's on the same operand bytes; the
matmul is within the f32 tolerance ``1e-5 * k / 128`` (the sums run in
another order).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

from repro_torch.kernels.packet_parser import HDR_BYTES, parse_packets
from repro_torch.kernels.quantize_stream import (dequantize_stream,
                                                 quantize_stream)
from repro_torch.kernels.systolic_mm import systolic_mm

MM_WORKLOAD = 0x10
PARSER_WORKLOAD = 0x11
STREAM_PARSER_WORKLOAD = 0x12
STREAM_QUANT_WORKLOAD = 0x13

#: chain-stage workload ids (0x20+ keeps them disjoint from handlers)
CHAIN_PARSE_WORKLOAD = 0x20
CHAIN_DEQUANT_WORKLOAD = 0x21
CHAIN_COMPRESS_WORKLOAD = 0x22
CHAIN_CHECKSUM_WORKLOAD = 0x23

#: one quantize_stream output row: 64 int8 lanes (as f32) + 1 fp32 scale
QUANT_ROW = HDR_BYTES + 1
#: one framed ingress-chain slot: RoCE header bytes + quant payload
FRAME_ROW = HDR_BYTES + QUANT_ROW
#: one parsed frame row: 4 meta words + the untouched quant payload
PARSED_ROW = 4 + QUANT_ROW
#: one checksum row: [checksum mod 2^24, input row width]
CSUM_ROW = 2


def _parse_bucketed(pkts) -> torch.Tensor:
    """Parse (n, 64) header bytes (any numeric dtype holding 0..255, e.g.
    the f32 pool's words) -> (n, 4) int32 meta rows. The cast to uint8
    happens where the tensor lies, on the device for pool data."""
    return parse_packets(torch.as_tensor(pkts).to(torch.uint8).contiguous())


def _quant_bucketed(x):
    """Quantize (n, 64) payload rows -> (int8 (n, 64), f32 scales (n, 1))."""
    return quantize_stream(torch.as_tensor(x).to(torch.float32).contiguous(),
                           chunk=HDR_BYTES)


def _dequant_bucketed(q, s) -> torch.Tensor:
    """Inverse of ``_quant_bucketed``: (n, 64) int8 + (n, 1) scales ->
    (n, 64) f32."""
    return dequantize_stream(torch.as_tensor(q).to(torch.int8).contiguous(),
                             torch.as_tensor(s).to(torch.float32).contiguous())


def lc_systolic_mm(ctx, remote_peer, rkey, a_addr, b_addr, out_addr,
                   m, k, n):
    """Offloaded (M,K)x(K,N) matmul: read A,B -> systolic MM -> write C."""
    a_loc, b_loc = ctx.alloc(m * k), ctx.alloc(k * n)
    c_loc = ctx.alloc(m * n)
    ctx.read_remote(remote_peer, rkey, a_addr, a_loc, m * k)
    ctx.read_remote(remote_peer, rkey, b_addr, b_loc, k * n)
    ctx.commit(wait=True)
    if ctx.failed:
        raise RuntimeError(
            f"operand fetch failed: {ctx.failed[0].status.value}")
    x = ctx.load(a_loc, m * k).reshape(m, k)
    y = ctx.load(b_loc, k * n).reshape(k, n)
    z = systolic_mm(x, y)
    ctx.store(c_loc, z.to(torch.float32).reshape(-1))
    ctx.write_remote(remote_peer, rkey, c_loc, out_addr, m * n)
    ctx.commit(wait=ctx.eager_writeback)
    return out_addr


def lc_packet_parser(ctx, remote_peer, rkey, pkts_addr, n_pkts, out_addr):
    """Offloaded RoCEv2 classifier: read headers -> parse -> write meta.

    Packets ride the float32 pool as byte values 0..255 (exact in fp32);
    the (n_pkts, 4) int32 metadata rows write back the same way (every
    field < 2^24, exact in fp32)."""
    nbytes = n_pkts * HDR_BYTES
    in_loc, out_loc = ctx.alloc(nbytes), ctx.alloc(n_pkts * 4)
    ctx.read_remote(remote_peer, rkey, pkts_addr, in_loc, nbytes)
    ctx.commit(wait=True)
    if ctx.failed:
        raise RuntimeError(
            f"packet fetch failed: {ctx.failed[0].status.value}")
    pkts = ctx.load(in_loc, nbytes).reshape(n_pkts, HDR_BYTES)
    meta = _parse_bucketed(pkts)
    ctx.store(out_loc, meta.to(torch.float32).reshape(-1))
    ctx.write_remote(remote_peer, rkey, out_loc, out_addr, n_pkts * 4)
    ctx.commit(wait=ctx.eager_writeback)
    return out_addr


def _gather_spans(ctx, ring_peer, ring_rkey, in_loc, spans,
                  unit: int) -> int:
    """Post the loopback READ gather of a sub-burst's spans into
    contiguous scratch (``unit`` pool words per slot). Returns total
    words gathered. The WQEs are POSTED only — the caller arms them
    deferred so the whole service round shares one descriptor table."""
    off = 0
    for addr, cnt in spans:
        if cnt:
            ctx.read_remote(ring_peer, ring_rkey, addr, in_loc + off,
                            cnt * unit)
            off += cnt * unit
    return off


def _scatter_rows(ctx, ring_base, out_peer, out_rkey, out_base, out_loc,
                  spans, row: int, unit: int = HDR_BYTES) -> None:
    """RDMA-WRITE each span's result rows to the output region at the
    matching slot indices (``row`` words per output slot; ``unit`` is
    the INPUT region's row width)."""
    off = 0
    for addr, cnt in spans:
        if cnt:
            slot0 = (addr - ring_base) // unit
            ctx.write_remote(out_peer, out_rkey, out_loc + off,
                             out_base + slot0 * row, cnt * row)
            off += cnt * row


def lc_packet_parser_stream(ctx, ring_peer, ring_rkey, ring_base,
                            out_peer, out_rkey, out_base, spans):
    """Streaming ``packet_parser`` handler (§IV-D): parse one sub-burst.

    A GENERATOR kernel — the two phases around the ``yield`` are what the
    pipelined service loop overlaps across invocations:

      fetch    — gather the sub-burst's spans into contiguous scratch with
                 loopback READ WQEs on the kernel's own QP, armed
                 deferred;
      compute  — parse the headers on the device and RDMA-WRITE each
                 span's metadata rows to ``out_peer`` at the matching
                 slot indices.

    Byte-contract: identical rows to ``lc_packet_parser`` for the same
    header bytes.
    """
    n_pkts = sum(cnt for _, cnt in spans)
    nbytes = n_pkts * HDR_BYTES
    in_loc = ctx.alloc(nbytes)
    meta_loc = ctx.alloc(n_pkts * 4)
    _gather_spans(ctx, ring_peer, ring_rkey, in_loc, spans, HDR_BYTES)
    ctx.commit(wait=False)       # armed: the service loop flushes
    yield                        # ...and resumes once the gather lands
    if ctx.failed:
        raise RuntimeError(
            f"ring gather failed: {ctx.failed[0].status.value}")
    pkts = ctx.load(in_loc, nbytes).reshape(n_pkts, HDR_BYTES)
    meta = _parse_bucketed(pkts)
    ctx.store(meta_loc, meta.to(torch.float32).reshape(-1))
    _scatter_rows(ctx, ring_base, out_peer, out_rkey, out_base, meta_loc,
                  spans, 4)
    ctx.commit(wait=ctx.eager_writeback)
    return out_base


def lc_quantize_stream(ctx, ring_peer, ring_rkey, ring_base,
                       out_peer, out_rkey, out_base, spans):
    """Streaming bulk-class handler: int8-quantize one sub-burst's
    payload slots in flight (``quantize_stream`` per 64-lane slot).

    Same generator shape as the parser handler (fetch → ``yield`` →
    compute/write-back); each slot's output row is its 64 int8 values
    (as f32 — exact) followed by its fp32 max-abs scale, written to the
    slot-mirrored output region at the matching slot index.
    """
    n_slots = sum(cnt for _, cnt in spans)
    nwords = n_slots * HDR_BYTES
    in_loc = ctx.alloc(nwords)
    out_loc = ctx.alloc(n_slots * QUANT_ROW)
    _gather_spans(ctx, ring_peer, ring_rkey, in_loc, spans, HDR_BYTES)
    ctx.commit(wait=False)       # armed: the service loop flushes
    yield                        # ...and resumes once the gather lands
    if ctx.failed:
        raise RuntimeError(
            f"ring gather failed: {ctx.failed[0].status.value}")
    x = ctx.load(in_loc, nwords).reshape(n_slots, HDR_BYTES)
    q, s = _quant_bucketed(x)
    rows = torch.cat([q.to(torch.float32), s], dim=1)
    ctx.store(out_loc, rows.reshape(-1))
    _scatter_rows(ctx, ring_base, out_peer, out_rkey, out_base, out_loc,
                  spans, QUANT_ROW)
    ctx.commit(wait=ctx.eager_writeback)
    return out_base


# --------------------------------------------------------------- chains
@dataclass(frozen=True)
class ChainStageSpec:
    """Row geometry one chain-stage kernel publishes so
    ``StreamDispatcher.register_chain`` can compose and validate a
    pipeline: the stage's fixed output row width, plus what it demands
    of its input rows (``fixed_in_row`` pins the width exactly,
    ``min_in_row`` lower-bounds it — e.g. the dequantize stage consumes
    the trailing ``QUANT_ROW`` words of however wide a row the upstream
    emits)."""
    out_row: int
    fixed_in_row: Optional[int] = None
    min_in_row: int = 1


def _checksum_rows(rows) -> torch.Tensor:
    """(n, w) f32 rows → (n, 2) f32 [checksum, w] integrity rows, where
    the rows lie.

    The checksum is the position-weighted sum of each word's raw 32-bit
    pattern, ``sum((i+1) * bits_i) mod 2^24`` in int64 (at most
    ``w * (w+1) / 2 * 2^32``, far below 2^63) — mod 2^24 keeps the value
    exactly representable in the f32 pool. Hashing the bit patterns (not
    the float values) makes the stamp see NaN payloads, but the modulus
    keeps only each word's low 24 bits: the sign bit and the top seven
    exponent bits (a signed zero's sign among them) do not change it.
    The JAX package computes the same value."""
    rows = torch.as_tensor(rows).to(torch.float32).contiguous()
    bits = rows.view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    w = torch.arange(1, rows.shape[1] + 1, dtype=torch.int64,
                     device=rows.device)
    csum = (bits * w).sum(dim=1) % (1 << 24)
    out = torch.stack([csum, torch.full_like(csum, rows.shape[1])], dim=1)
    return out.to(torch.float32)


def _chain_stage_kernel(compute, out_row: int):
    """Build one chain-stage generator kernel from a row-batch compute
    fn. The generator shape matches the stream handlers — gather the
    input spans (``in_row`` words per slot) with loopback READs armed
    deferred, ``yield`` for the shared flush, then compute and
    RDMA-WRITE slot-mirrored ``out_row``-word rows — so a stage pipelines
    through ``_service_grouped`` exactly like any handler, and its
    write-back region is the next stage's fetch source."""
    def stage(ctx, in_peer, in_rkey, in_base, out_peer, out_rkey,
              out_base, spans, in_row):
        n = sum(cnt for _, cnt in spans)
        nwords = n * in_row
        in_loc = ctx.alloc(nwords)
        out_loc = ctx.alloc(n * out_row)
        _gather_spans(ctx, in_peer, in_rkey, in_loc, spans, in_row)
        ctx.commit(wait=False)   # armed: the service loop flushes
        yield                    # ...and resumes once the gather lands
        if ctx.failed:
            raise RuntimeError(
                f"chain stage gather failed: {ctx.failed[0].status.value}")
        rows = ctx.load(in_loc, nwords).reshape(n, in_row)
        out = compute(rows)
        ctx.store(out_loc, out.to(torch.float32).reshape(-1))
        _scatter_rows(ctx, in_base, out_peer, out_rkey, out_base,
                      out_loc, spans, out_row, unit=in_row)
        ctx.commit(wait=ctx.eager_writeback)
        return out_base
    return stage


def _parse_frame_rows(rows) -> torch.Tensor:
    """(n, FRAME_ROW) framed slots → (n, PARSED_ROW) [meta ‖ payload]:
    the header words (f32 holding 0..255) become uint8 where the rows
    lie and run through K3 like the stream handler's; the quant payload
    passes through untouched for the next stage."""
    rows = torch.as_tensor(rows).to(torch.float32)
    meta = _parse_bucketed(rows[:, :HDR_BYTES])
    return torch.cat([meta.to(torch.float32), rows[:, HDR_BYTES:]], dim=1)


def _dequant_trailing_rows(rows) -> torch.Tensor:
    """(n, ≥QUANT_ROW) rows → (n, 64) f32: dequantize the TRAILING
    ``QUANT_ROW`` words (64 int8 lanes as f32 + the fp32 scale) with K2;
    leading words (e.g. the parse stage's meta) are pass-by metadata this
    stage ignores."""
    rows = torch.as_tensor(rows).to(torch.float32)
    return _dequant_bucketed(rows[:, -QUANT_ROW:-1], rows[:, -1:])


def _compress_rows(rows) -> torch.Tensor:
    """(n, 64) f32 rows → (n, QUANT_ROW) [q ‖ scale] rows by K1 — byte
    parity with ``ops.compress(x, chunk=64)`` row-wise."""
    q, s = _quant_bucketed(rows)
    return torch.cat([q.to(torch.float32), s], dim=1)


#: workload id → (name, stage compute fn, spec) of every chain-capable
#: kernel ``register_chain_kernels`` installs.
CHAIN_STAGES = {
    CHAIN_PARSE_WORKLOAD: (
        "chain_parse", _parse_frame_rows,
        ChainStageSpec(out_row=PARSED_ROW, fixed_in_row=FRAME_ROW)),
    CHAIN_DEQUANT_WORKLOAD: (
        "chain_dequant", _dequant_trailing_rows,
        ChainStageSpec(out_row=HDR_BYTES, min_in_row=QUANT_ROW)),
    CHAIN_COMPRESS_WORKLOAD: (
        "chain_compress", _compress_rows,
        ChainStageSpec(out_row=QUANT_ROW, fixed_in_row=HDR_BYTES)),
    CHAIN_CHECKSUM_WORKLOAD: (
        "chain_checksum", _checksum_rows,
        ChainStageSpec(out_row=CSUM_ROW)),
}


def register_chain_kernels(block, weight: int = 1):
    """Register the chain-capable stage kernels on a block, attaching
    each one's ``ChainStageSpec`` so ``register_chain`` can validate
    pipeline composition. Registering an id twice raises (the contract
    of ``register``)."""
    for wid, (name, compute, spec) in CHAIN_STAGES.items():
        k = block.register(wid, _chain_stage_kernel(compute, spec.out_row),
                           name, weight=weight)
        k.stage_spec = spec
    return block


def register_default_kernels(block, weight: int = 1):
    """Register the paper's example offload kernels on a block (the two
    ControlMsg kernels plus the stream handler mix)."""
    block.register(MM_WORKLOAD, lc_systolic_mm, "systolic_mm",
                   weight=weight)
    block.register(PARSER_WORKLOAD, lc_packet_parser, "packet_parser",
                   weight=weight)
    block.register(STREAM_PARSER_WORKLOAD, lc_packet_parser_stream,
                   "packet_parser_stream", weight=weight)
    block.register(STREAM_QUANT_WORKLOAD, lc_quantize_stream,
                   "quantize_stream", weight=weight)
    return block

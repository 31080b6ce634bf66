"""In-flight gradient compression with error feedback (Streaming Compute).

The SC block's training-system role: compress gradient buckets to int8 as
they stream into the cross-pod all-reduce, keeping a local fp32 residual
(error feedback) so compression noise does not bias convergence.

The pure functions take and return tensors where they lie (K1 and K2 on
the GPU, their plain versions on the CPU), state threaded explicitly.
``compressed_all_reduce`` takes the peers as an explicit leading
dimension and sums over it on one device; ``compressed_all_reduce_group``
is the reference's axis form, each rank of a ``torch.distributed`` group
one peer, where the JAX package's ``psum`` reduces over a named mesh
axis. ``GradEgressChain`` is the same compression expressed
as the dispatch plane's first PRODUCTION service chain: gradient rows
stream through a compress→checksum ``Chain`` on the datapath — the
compress stage int8-quantizes each 64-lane row (byte parity with
``ops.compress(x, chunk=64)``), its RDMA write-back region feeds the
checksum stage's fetch, and the error-feedback residual is computed from
the ACTUAL wire bytes read back from the chain's output rings, so what
the residual corrects is exactly what the fabric carried.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch._device import resolve_device
from repro_torch.core.lookaside.registry import LookasideBlock
from repro_torch.core.streaming.dispatch import (Chain, MatchTable,
                                                 StreamDispatcher)
from repro_torch.core.streaming.rx_ring import RXRing
from repro_torch.kernels import ops as kops
from repro_torch.kernels.lc_offload import (CHAIN_CHECKSUM_WORKLOAD,
                                            CHAIN_COMPRESS_WORKLOAD, CSUM_ROW,
                                            HDR_BYTES, QUANT_ROW,
                                            _checksum_rows,
                                            register_chain_kernels)


def init_error_state(grads, device=None):
    """Residual tree, same structure/shape as grads (nested dicts, lists
    and tuples), fp32 zeros. A tensor leaf's residual lies on its device;
    any other leaf's on ``device`` (``None`` = the GPU)."""
    if isinstance(grads, dict):
        return {k: init_error_state(v, device) for k, v in grads.items()}
    if isinstance(grads, (list, tuple)):
        return type(grads)(init_error_state(v, device) for v in grads)
    if isinstance(grads, torch.Tensor):
        return torch.zeros(grads.shape, dtype=torch.float32,
                           device=grads.device)
    return torch.zeros(np.shape(grads), dtype=torch.float32,
                       device=resolve_device(device))


def compress_bucket(flat: torch.Tensor, residual: torch.Tensor, *,
                    chunk: int = 1024
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Quantize (flat + residual) to int8 chunks; new residual = error.

    Returns (q_int8 (n,chunk), scales (n,1), new_residual).
    """
    target = flat.to(torch.float32) + residual
    q, s, _ = kops.compress(target, chunk=chunk)
    back = kops.decompress(q, s, target.shape, dtype=torch.float32)
    return q, s, target - back


def decompress_bucket(q: torch.Tensor, scales: torch.Tensor, shape,
                      dtype=torch.float32) -> torch.Tensor:
    return kops.decompress(q, scales, shape, dtype=dtype)


def _mean_scale(s_sum: torch.Tensor, live: torch.Tensor) -> torch.Tensor:
    """Each chunk's mean scale over the peers whose chunk is not all zero
    (``s_sum`` their scales' sum, ``live`` their count; a chunk zero
    everywhere gets 0). K1 gives an all-zero chunk the scale 1.0, and the
    reference averages that in: where a chunk is zero on one of two peers
    (an embedding row its tokens miss) the other peer's codes, up to 127,
    dequantize at a scale near 0.5 instead of their own. With every chunk
    live this is the reference's mean, bit for bit."""
    return s_sum / live.clamp_min(1).to(s_sum.dtype)


def compressed_all_reduce(flat: torch.Tensor, residual: torch.Tensor, *,
                          chunk: int = 1024
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Compress -> sum(int8 as int32) over peers -> dequant mean.

    ``flat`` and ``residual`` are ``(n_peers, n)``: row *p* is peer *p*'s
    bucket. Each peer's bucket quantizes on its own chunk grid (zero
    padded to a chunk multiple, as ``compress_bucket`` pads it), all
    peers in one K1 and one K2 launch. int8 payloads sum as int32 (no
    overflow below ~2^23 peers); scales are summed too so the dequant
    uses the mean scale — a standard 1-bit/8-bit SGD style estimator with
    error feedback carrying the bias. The mean is over the peers whose
    chunk is not all zero (``_mean_scale``). Returns ``(out (n_peers,
    n), new residual (n_peers, n))``: every peer's copy of the mean estimate
    (equal rows) and each peer's local compression error.
    """
    n_peers, n = flat.shape
    target = flat.to(torch.float32) + residual
    pad = (-n) % chunk
    if pad:
        target_p = torch.cat([target, target.new_zeros(n_peers, pad)], 1)
    else:
        target_p = target
    rows = target_p.shape[1] // chunk
    q, s, _ = kops.compress(target_p, chunk=chunk)
    back = kops.decompress(q, s, (n_peers, rows * chunk))[:, :n]
    new_residual = target - back
    q3 = q.reshape(n_peers, rows, chunk)
    q_sum = q3.to(torch.int32).sum(dim=0)
    live = q3.ne(0).any(dim=2, keepdim=True)
    s_mean = _mean_scale(torch.where(live, s.reshape(n_peers, rows, 1),
                                     0.0).sum(dim=0), live.sum(dim=0))
    # mean over peers: (sum_i q_i * s_i) ~= s_mean * sum_i q_i  / n
    est = q_sum.to(torch.float32) * s_mean / n_peers
    out = est.reshape(-1)[:n].to(flat.dtype)
    return out.unsqueeze(0).repeat(n_peers, 1), new_residual


def compressed_all_reduce_group(flat: torch.Tensor, residual: torch.Tensor,
                                group, *, chunk: int = 1024
                                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Compress -> all_reduce(int8 as int32) -> dequant mean, over the
    ranks of ``group`` (the reference's ``compressed_all_reduce(flat,
    residual, axis)`` inside ``shard_map``): this rank's ``flat`` bucket
    and residual in, the group's mean estimate (equal on every rank) and
    this rank's new residual out. K1 quantizes and K2 dequantizes on the
    rank's device; the codes and the scales (with each chunk's count of
    ranks where it is not all zero, ``_mean_scale``) are two
    ``all_reduce``s."""
    n = dist.get_world_size(group)
    q, s, new_residual = compress_bucket(flat, residual, chunk=chunk)
    live = q.ne(0).any(dim=1, keepdim=True)
    scales = torch.cat([torch.where(live, s, 0.0), live.to(s.dtype)], 1)
    q_sum = q.to(torch.int32)
    del q
    dist.all_reduce(q_sum, group=group)
    dist.all_reduce(scales, group=group)
    s_mean = _mean_scale(scales[:, :1], scales[:, 1:])
    # mean over peers: (sum_i q_i * s_i) ~= s_mean * sum_i q_i  / n, in
    # place (a bucket may be a whole stacked weight)
    est = q_sum.to(torch.float32)
    del q_sum
    est.mul_(s_mean).div_(n)
    out = est.reshape(-1)[: flat.shape[0]].to(flat.dtype)
    return out, new_residual


def compression_ratio(nbytes_fp32: int, chunk: int = 1024) -> float:
    """Wire-bytes ratio: int8 payload + fp32 scale per chunk vs fp32."""
    n_chunks = -(-nbytes_fp32 // 4 // chunk)
    compressed = nbytes_fp32 // 4 + n_chunks * 4
    return compressed / nbytes_fp32


class GradEgressChain:
    """compress→checksum gradient egress as a datapath service chain.

    Wiring: a 64-word-slot ``RXRing`` on the LC peer receives gradient
    rows; a two-stage ``Chain`` (``chain_compress`` → ``chain_checksum``)
    is the ring's DEFAULT owner, so every pushed row belongs to it. One
    ``dispatcher.service()`` pass per window drives both stages — the
    compress stage's [q ‖ scale] write-back rows land slot-mirrored at
    ``out_base`` on ``data_peer`` and are the checksum stage's fetch
    source; its [checksum, width] rows land after them. Every stage
    gather/write-back shares the engine's descriptor tables with
    whatever host verbs traffic is armed (``stats["dispatch"]["chains"]``
    ledgers the pipeline). Both stages run on the engine's device (K1 and
    the torch checksum).

    ``compress()`` then reads the wire bytes BACK from the chain's
    output rings to form the error-feedback residual — the estimator
    corrects exactly what the fabric carried, checksum-stamped.
    """

    def __init__(self, engine, *, data_peer: int, ring_base: int,
                 out_base: int, lc_peer: int = 0, depth: int = 32,
                 burst: int = 8, block: "LookasideBlock" = None,
                 scratch_base: int = None, scratch_size: int = None,
                 pipeline_depth: int = 4, name: str = "grad_egress"):
        self.engine = engine
        self.data_peer = data_peer
        if block is None:
            block = LookasideBlock(engine, peer=lc_peer,
                                   scratch_base=scratch_base,
                                   scratch_size=scratch_size,
                                   eager_writeback=False,
                                   pipeline_depth=pipeline_depth)
            register_chain_kernels(block)
        self.block = block
        self.ring = RXRing(engine, peer=block.peer, base=ring_base,
                           depth=depth, slot_bytes=HDR_BYTES)
        self.q_base = out_base
        self.csum_base = out_base + depth * QUANT_ROW
        self.out_mr = engine.register_mr(
            data_peer, out_base, depth * (QUANT_ROW + CSUM_ROW))
        self.chain = Chain((CHAIN_COMPRESS_WORKLOAD,
                            CHAIN_CHECKSUM_WORKLOAD), name=name)
        self.dispatcher = StreamDispatcher(
            block, self.ring, MatchTable(default=self.chain), burst=burst)
        self.dispatcher.register_chain(self.chain, data_peer,
                                       self.out_mr.rkey,
                                       [self.q_base, self.csum_base])
        self._seq = 0                    # rows pushed since construction

    def compress(self, flat, residual
                 ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
        """Stream one bucket through the chain in ring-sized windows.

        Returns ``(q int8 (rows, 64), scales (rows, 1), checksums
        (rows,), new_residual (n,))`` as host arrays — byte-compatible
        with ``compress_bucket(flat, residual, chunk=64)``'s (q, s) plus
        the wire-integrity stamps, the residual formed from the read-back
        wire bytes (dequantized by K2 on the engine's device)."""
        target = (np.asarray(flat, np.float32).reshape(-1)
                  + np.asarray(residual, np.float32).reshape(-1))
        n = target.shape[0]
        rows = -(-n // HDR_BYTES)
        padded = np.zeros(rows * HDR_BYTES, np.float32)
        padded[:n] = target
        batch = padded.reshape(rows, HDR_BYTES)
        depth = self.ring.depth
        q_rows = np.empty((rows, QUANT_ROW), np.float32)
        c_rows = np.empty((rows, CSUM_ROW), np.float32)
        done = 0
        while done < rows:
            take = min(depth, rows - done)
            for r in range(done, done + take):
                if not self.ring.push(batch[r]):
                    raise RuntimeError("egress ring refused a row "
                                       "(window exceeds ring depth?)")
            self.dispatcher.service()
            for r in range(done, done + take):
                slot = (self._seq + r) % depth
                q_rows[r] = self.engine.read_buffer(
                    self.data_peer, self.q_base + slot * QUANT_ROW,
                    QUANT_ROW)
                c_rows[r] = self.engine.read_buffer(
                    self.data_peer, self.csum_base + slot * CSUM_ROW,
                    CSUM_ROW)
            done += take
        self._seq += rows
        q = q_rows[:, :HDR_BYTES].astype(np.int8)
        s = q_rows[:, HDR_BYTES:].astype(np.float32)
        dev = self.engine.pool.device
        back = kops.decompress(torch.from_numpy(q).to(dev),
                               torch.from_numpy(s).to(dev),
                               (rows * HDR_BYTES,)).cpu().numpy()
        new_residual = target - back[:n]
        return q, s, c_rows[:, 0].copy(), new_residual

    @staticmethod
    def verify_checksums(q, s, checksums) -> bool:
        """Recompute the integrity stamps from (q, s) wire rows and
        compare — what a receiver does before trusting a compressed
        bucket. Host arrays or tensors; the stamps are recomputed where
        ``q`` lies."""
        q, s = torch.as_tensor(q), torch.as_tensor(s)
        rows = torch.cat([q.to(torch.float32),
                          s.to(torch.float32).to(q.device)], dim=1)
        want = torch.as_tensor(checksums, dtype=torch.float32)
        return bool(torch.equal(_checksum_rows(rows)[:, 0].cpu(),
                                want.cpu()))

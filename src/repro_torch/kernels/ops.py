"""Public wrappers around the port's kernels.

Shapes need no padding to block multiples: the CUDA kernels mask ragged
edges themselves. Where a tensor lies decides the path — plain PyTorch on
the CPU, the hand-written kernel on the GPU.
"""
from __future__ import annotations

import math
from typing import Callable, Optional, Tuple

import torch

from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import packet_parser as _pp
from repro_torch.kernels import quantize_stream as _qs
from repro_torch.kernels import systolic_mm as _mm


def matmul(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """General (M,K)x(K,N) matmul via the systolic kernel."""
    return _mm.systolic_mm(x, y)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True, window: int = 0, q_offset: int = 0,
              backward: Optional[Callable] = None) -> torch.Tensor:
    """q: (B, Sq, Hq, d), k: (B, Skv, Hkv, d), v: (B, Skv, Hkv, dv) ->
    (B, Sq, Hq, dv).

    GQA: q heads grouped onto kv heads (Hq % Hkv == 0). The kernel maps
    q head h to kv head h // group itself, so K and V are never repeated
    or transposed, and no length is padded. ``q_offset``: the position of
    q's first row among the keys. ``backward``: what the autograd
    backward recomputes and differentiates (``flash_attention``'s
    argument; the plain version when None)."""
    return _fa.flash_attention(q, k, v, causal=causal, window=window,
                               q_offset=q_offset, backward=backward)


def compress(x: torch.Tensor, *, chunk: int = 1024
             ) -> Tuple[torch.Tensor, torch.Tensor, int]:
    """Flatten + zero-pad to a chunk multiple + chunked int8 quantize.
    Returns (q, scales, n)."""
    flat = x.reshape(-1)
    n = flat.shape[0]
    pad = (-n) % chunk
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    q, s = _qs.quantize_stream(flat.reshape(-1, chunk), chunk=chunk)
    return q, s, n


def decompress(q: torch.Tensor, scales: torch.Tensor, shape,
               dtype=torch.float32) -> torch.Tensor:
    x = _qs.dequantize_stream(q, scales, out_dtype=dtype)
    size = math.prod(shape)
    return x.reshape(-1)[:size].reshape(shape)


def classify_packets(pkts: torch.Tensor) -> torch.Tensor:
    """(n, 64) uint8 headers -> (n, 4) [is_rdma, opcode, dest_qp, class]."""
    return _pp.parse_packets(pkts)


def classify_packet_fields(pkts: torch.Tensor) -> torch.Tensor:
    """(n, 64) uint8 headers -> (n, N_FIELDS) raw parsed field vectors
    (``packet_parser.FIELD_NAMES`` order) — what the match→action
    dispatch plane matches its table entries against."""
    return _pp.parse_packet_fields(pkts)

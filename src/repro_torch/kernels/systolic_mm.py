"""Systolic-array matrix multiply — the paper's Lookaside Compute example
(§IV-C), K5 ``systolic_mm``.

The paper's HLS systolic array accumulates partial products across the K
dimension for each output tile. On the H100 the CUDA kernel
(``csrc/systolic_mm.cu``) gives each 256-thread block one 128x128 output
tile (64x64 where that leaves SMs idle) and walks K inside the block in
double-buffered 8-deep slices, with 8x8 f32 accumulators per thread on
the CUDA cores (full f32, no TF32); it masks ragged edges itself, so any
(M, K) x (K, N) runs without padding, misaligned operands included.

``systolic_mm`` runs the plain PyTorch version for tensors on the CPU
and launches the CUDA kernel for tensors on the GPU;
``systolic_mm.launches`` counts the launches.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.roofline.count import charge

_DTYPES = (torch.float32, torch.bfloat16)


def systolic_mm_plain(x: torch.Tensor, y: torch.Tensor,
                      out_dtype: Optional[torch.dtype] = None
                      ) -> torch.Tensor:
    """(M, K) x (K, N) in f32 arithmetic, cast to ``out_dtype``."""
    out_dtype = out_dtype or x.dtype
    return torch.matmul(x.to(torch.float32), y.to(torch.float32)
                        ).to(out_dtype)


def systolic_mm_cost(x: torch.Tensor, y: torch.Tensor,
                     out_dtype: Optional[torch.dtype] = None):
    """(flops, bytes) of (M, K) x (K, N): 2 M K N flops, x and y read and
    the (M, N) output written once."""
    (m, k), n = x.shape, y.shape[1]
    out_size = (out_dtype or x.dtype).itemsize
    return (2 * m * k * n,
            x.element_size() * m * k + y.element_size() * k * n
            + out_size * m * n)


def systolic_mm(x: torch.Tensor, y: torch.Tensor, *,
                out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """x: (M, K), y: (K, N), both f32 or both bf16 -> (M, N) ``out_dtype``
    (default: x's dtype), accumulated in f32."""
    if x.ndim != 2 or y.ndim != 2 or x.shape[1] != y.shape[0]:
        raise ValueError(f"bad matmul shapes {tuple(x.shape)} x "
                         f"{tuple(y.shape)}")
    out_dtype = out_dtype or x.dtype
    if x.dtype not in _DTYPES or y.dtype != x.dtype or \
            out_dtype not in _DTYPES:
        raise TypeError(f"systolic_mm: unsupported dtypes {x.dtype} x "
                        f"{y.dtype} -> {out_dtype}")
    with charge("systolic_mm", systolic_mm_cost, x, y, out_dtype):
        if x.device.type == "cpu" and y.device.type == "cpu":
            return systolic_mm_plain(x, y, out_dtype)
        _build.check_cuda("systolic_mm", x, y)
        m, k = x.shape
        n = y.shape[1]
        out = torch.empty((m, n), dtype=out_dtype, device=x.device)
        if m and n:
            _build.launch("reconic_systolic_mm", x.data_ptr(), y.data_ptr(),
                          out.data_ptr(), m, n, k,
                          int(x.dtype == torch.bfloat16),
                          int(out_dtype == torch.bfloat16),
                          _build.stream_ptr(x.device))
            systolic_mm.launches += 1
        return out


systolic_mm.launches = 0

"""Streaming int8 quantization — the Streaming Compute block's in-flight
compression kernel (K1 ``quantize_stream``, K2 ``dequantize_stream``).

Data is processed in packet-sized chunks: each ``(chunk,)`` row is
quantized independently with its own fp32 scale (max-abs / 127), so a
buffer can be compressed as it streams without a global reduction.

Each wrapper runs the plain PyTorch version for a tensor on the CPU and
launches its CUDA kernel (``csrc/quantize_stream.cu``) for a tensor on
the GPU; it never falls back from one to the other. ``.launches`` on each
wrapper counts its kernel launches.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch.kernels import _build
from repro_torch.roofline.count import charge

#: scale = amax * (1/127) as an EXPLICIT fp32 multiply by the fp32
#: reciprocal — the reference's constant, passed to the CUDA kernel too,
#: so every version computes the same scale bit for bit.
INV_QMAX = float(np.float32(1.0) / np.float32(127.0))

_IN_DTYPES = (torch.float32, torch.bfloat16)


def quantize_stream_plain(x: torch.Tensor):
    """(n, chunk) f32/bf16 -> (int8 (n, chunk), f32 scales (n, 1))."""
    xf = x.to(torch.float32)
    amax = xf.abs().amax(dim=-1, keepdim=True)
    # a Python float multiplies an f32 tensor in f32 (INV_QMAX is exact)
    scale = torch.where(amax == 0.0, torch.ones_like(amax), amax * INV_QMAX)
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_stream_plain(q: torch.Tensor, scales: torch.Tensor,
                            out_dtype=torch.float32) -> torch.Tensor:
    return (q.to(torch.float32) * scales).to(out_dtype)


def quantize_stream_cost(x: torch.Tensor):
    """(flops, bytes) of quantizing ``x`` (n, chunk): 4 flops a value
    (abs, max, divide, round), x read, the int8 codes and f32 scales
    written once."""
    n, chunk = x.shape
    return 4 * n * chunk, n * chunk * (x.element_size() + 1) + 4 * n


def dequantize_stream_cost(q: torch.Tensor, scales: torch.Tensor,
                           out_dtype=torch.float32):
    """(flops, bytes) of dequantizing int8 ``q`` (n, chunk): one multiply
    a value, codes and scales read, the output written once."""
    n, chunk = q.shape
    return n * chunk, n * chunk * (1 + out_dtype.itemsize) + 4 * n


def quantize_stream(x: torch.Tensor, *, chunk: int = 1024):
    """x: (n, chunk) f32 or bf16 -> (int8 values (n, chunk), f32 scales
    (n, 1)). ``ops.compress`` handles padding/reshape of any tensor."""
    if x.ndim != 2 or x.shape[1] != chunk:
        raise ValueError(f"expected (n, {chunk}), got {tuple(x.shape)}")
    if x.dtype not in _IN_DTYPES:
        raise TypeError(f"quantize_stream: unsupported dtype {x.dtype}")
    with charge("quantize_stream", quantize_stream_cost, x):
        if x.device.type == "cpu":
            return quantize_stream_plain(x)
        _build.check_cuda("quantize_stream", x)
        n = x.shape[0]
        q = torch.empty((n, chunk), dtype=torch.int8, device=x.device)
        s = torch.empty((n, 1), dtype=torch.float32, device=x.device)
        if n:
            _build.launch("reconic_quantize", x.data_ptr(),
                          int(x.dtype == torch.bfloat16), q.data_ptr(),
                          s.data_ptr(), n, chunk, ctypes.c_float(INV_QMAX),
                          _build.stream_ptr(x.device))
            quantize_stream.launches += 1
        return q, s


quantize_stream.launches = 0


def dequantize_stream(q: torch.Tensor, scales: torch.Tensor, *,
                      out_dtype=torch.float32) -> torch.Tensor:
    """int8 (n, chunk) + f32 scales (n, 1) -> (n, chunk) ``out_dtype``
    (f32 or bf16)."""
    if q.ndim != 2 or q.dtype != torch.int8:
        raise ValueError(f"expected int8 (n, chunk), got {q.dtype} "
                         f"{tuple(q.shape)}")
    if tuple(scales.shape) != (q.shape[0], 1) or \
            scales.dtype != torch.float32:
        raise ValueError(f"expected f32 scales ({q.shape[0]}, 1), got "
                         f"{scales.dtype} {tuple(scales.shape)}")
    if out_dtype not in _IN_DTYPES:
        raise TypeError(f"dequantize_stream: unsupported {out_dtype}")
    with charge("dequantize_stream", dequantize_stream_cost, q, scales,
                out_dtype):
        if q.device.type == "cpu":
            return dequantize_stream_plain(q, scales, out_dtype)
        _build.check_cuda("dequantize_stream", q, scales)
        n, chunk = q.shape
        out = torch.empty((n, chunk), dtype=out_dtype, device=q.device)
        if q.numel():
            _build.launch("reconic_dequantize", q.data_ptr(),
                          scales.data_ptr(), out.data_ptr(),
                          int(out_dtype == torch.bfloat16), n, chunk,
                          _build.stream_ptr(q.device))
            dequantize_stream.launches += 1
        return out


dequantize_stream.launches = 0

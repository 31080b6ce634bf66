"""Blockwise (flash) attention — the serving path's prefill kernel (K6
``flash_attention``).

Online-softmax attention with causal and sliding-window masks, GQA (q
head ``h`` reads kv head ``h // group``) and a zero output for a row that
sees no key. On the H100 the CUDA kernel (``csrc/flash_attention.cu``)
gives each 4-warp thread block one (sequence, q head, 64-row q tile) and
walks the 64-key K/V tiles it can see, double-buffered in shared memory,
with QK^T and PV on the tensor cores (``mma.sync``: bf16 with P split
into two bf16 halves, f32 as 3xTF32, both within the reference's f32
tolerance) and the online softmax in the accumulator registers. It masks
ragged edges itself: any ``Sq``, ``Skv`` runs without padding, and K/V
are never repeated per q head. It takes 16-byte aligned tensors. V and
the output may be narrower than q and k for a listed pair of head dims
(MLA's 192 for q and k, 128 for v).

``flash_attention`` runs the plain PyTorch version for tensors on the
CPU, launches the CUDA kernel for tensors on the GPU and, for tensors on
the ``meta`` device (the dry-run's), returns an output of the kernel's
shape and dtype and launches nothing; ``flash_attention.launches``
counts the launches. On every device the result carries a ``grad_fn``
whose backward recomputes the plain version and differentiates it
(``_FlashAttention``); the forward stays the kernel. An active
``roofline.count.OpCounter`` is charged ``flash_attention_cost`` per
call, whatever the device.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.kernels import _build
from repro_torch.roofline.count import charge

NEG_INF = -1e30

#: (q and k head dim, v and output head dim) pairs the CUDA kernel is
#: instantiated for: the square dims, and MLA's nope + rope / v
HEAD_DIMS = ((16, 16), (32, 32), (64, 64), (128, 128), (192, 128))

_DTYPES = (torch.float32, torch.bfloat16)


def _as_bshd(x: torch.Tensor) -> torch.Tensor:
    """(BH, S, d) -> a (BH, S, 1, d) view; (B, S, H, d) passes through."""
    if x.ndim == 3:
        return x.unsqueeze(2)
    if x.ndim != 4:
        raise ValueError(f"expected (BH, S, d) or (B, S, H, d), got "
                         f"{tuple(x.shape)}")
    return x


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor,
                          v: torch.Tensor, *, causal: bool = True,
                          window: int = 0,
                          scale: Optional[float] = None) -> torch.Tensor:
    """q: (B, Sq, Hq, d), k: (B, Skv, Hkv, d), v: (B, Skv, Hkv, dv) ->
    (B, Sq, Hq, dv), the reference oracle's arithmetic
    (``kernels/ref.py:ref_attention``): f32 scores of ``q * scale``
    against k, ``-1e30`` where masked, softmax, zeros for a row with no
    visible key, cast to q's dtype. GQA groups q heads onto kv heads by
    a reshape, not a repeat."""
    b, sq, hq, d = q.shape
    _, skv, hkv, _ = k.shape
    dv = v.shape[-1]
    group = hq // hkv
    scale = scale if scale is not None else d ** -0.5
    qg = q.reshape(b, sq, hkv, group, d).to(torch.float32) * scale
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg, k.to(torch.float32))
    q_pos = torch.arange(sq, device=q.device)[:, None]
    k_pos = torch.arange(skv, device=q.device)[None, :]
    mask = torch.ones((sq, skv), dtype=torch.bool, device=q.device)
    if causal:
        mask &= q_pos >= k_pos
    if window > 0:
        mask &= (q_pos - k_pos) < window
    s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhgqk,bkhd->bqhgd", p, v.to(torch.float32))
    out = torch.where(mask.any(dim=-1)[None, :, None, None, None], out,
                      torch.zeros_like(out))
    return out.reshape(b, sq, hq, dv).to(q.dtype)


def visible_pairs(sq: int, skv: int, causal: bool, window: int) -> int:
    """(q, k) pairs of one head that the mask lets through: query ``i``
    sees key ``j`` when ``j <= i`` (causal) and ``i - j < window``
    (a window), as ``flash_attention_plain`` masks."""
    i = np.arange(sq, dtype=np.int64)
    hi = np.minimum(i, skv - 1) if causal else np.full(sq, skv - 1)
    lo = np.maximum(i - window + 1, 0) if window > 0 else 0
    return int(np.clip(hi - lo + 1, 0, None).sum())


def flash_attention_cost(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool = True, window: int = 0):
    """(flops, bytes) of one call, the function's own work: 2 (d + dv)
    flops per visible (q, k) pair and q head, and q, k and v read and
    the output written once each. Any of the layouts ``flash_attention``
    takes."""
    q4, k4, v4 = _as_bshd(q), _as_bshd(k), _as_bshd(v)
    b, sq, hq, d = q4.shape
    skv, hkv, dv = k4.shape[1], k4.shape[2], v4.shape[-1]
    flops = 2 * (d + dv) * visible_pairs(sq, skv, causal, window) * b * hq
    nbytes = q.element_size() * b * (d + dv) * (sq * hq + skv * hkv)
    return flops, nbytes


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    scale: Optional[float] = None) -> torch.Tensor:
    """q: (BH, Sq, d), k: (BH, Skv, d), v: (BH, Skv, dv) -> (BH, Sq, dv);
    or, with GQA, q: (B, Sq, Hq, d), k: (B, Skv, Hkv, d), v: (B, Skv,
    Hkv, dv) -> (B, Sq, Hq, dv) with ``Hq % Hkv == 0``. On the GPU ``(d,
    dv)`` is one of ``HEAD_DIMS``. f32 or bf16 inputs of one dtype,
    computed in f32, output in the input dtype. ``window`` 0 means no
    window; ``scale`` defaults to ``d ** -0.5``."""
    squeeze = q.ndim == 3
    q4, k4, v4 = _as_bshd(q), _as_bshd(k), _as_bshd(v)
    b, sq, hq, d = q4.shape
    bk, skv, hkv, dk = k4.shape
    dv = v4.shape[-1]
    if (bk, d) != (b, dk) or tuple(v4.shape[:3]) != tuple(k4.shape[:3]) \
            or hkv == 0 or hq % hkv:
        raise ValueError(f"bad attention shapes q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention: unsupported dtypes {q.dtype}, "
                        f"{k.dtype}, {v.dtype}")
    if window < 0:
        raise ValueError(f"window must be >= 0, got {window}")
    scale = scale if scale is not None else d ** -0.5
    if {t.device.type for t in (q, k, v)} not in ({"cpu"}, {"meta"}):
        if (d, dv) not in HEAD_DIMS:
            raise ValueError(f"flash_attention: head_dim {d} with v "
                             f"head_dim {dv} not in {HEAD_DIMS}")
        if b * hq > 65535:
            raise ValueError(f"flash_attention: B * Hq = {b * hq} > 65535")
        _build.check_cuda("flash_attention", q4, k4, v4)
        for name, t in (("q", q4), ("k", k4), ("v", v4)):
            if t.data_ptr() % 16:
                raise ValueError(f"flash_attention: {name} is not 16-byte "
                                 f"aligned (the kernel loads 16-byte rows)")
    with charge("flash_attention", flash_attention_cost, q4, k4, v4,
                causal=causal, window=window):
        out = _FlashAttention.apply(q4, k4, v4, causal, window, scale)
    return out[:, :, 0] if squeeze else out


class _FlashAttention(torch.autograd.Function):
    """K6 as an autograd op: the forward launches the CUDA kernel (the
    plain version on the CPU, a shape-only output on ``meta``); the
    backward recomputes ``flash_attention_plain`` on the saved inputs and
    returns its gradients (the JAX package trains through plain
    attention too). Under ``no_grad`` it is the bare forward."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, scale):
        b, sq, hq, d = q.shape
        _, skv, hkv, dv = v.shape
        ctx.save_for_backward(q, k, v)
        ctx.opts = (causal, window, scale)
        if q.device.type == "cpu":
            # laid out as the kernel writes it, so that later ops see the
            # same strides on every device
            return flash_attention_plain(q, k, v, causal=causal,
                                         window=window,
                                         scale=scale).contiguous()
        out = q.new_empty((b, sq, hq, dv))
        if out.numel() and q.device.type == "cuda":
            _build.launch("reconic_flash_attention", q.data_ptr(),
                          k.data_ptr(), v.data_ptr(), out.data_ptr(), b, hq,
                          hkv, sq, skv, d, dv, int(causal), int(window),
                          float(np.float32(scale)),
                          int(q.dtype == torch.bfloat16),
                          _build.stream_ptr(q.device))
            flash_attention.launches += 1
        return out

    @staticmethod
    def backward(ctx, grad_out):
        causal, window, scale = ctx.opts
        inputs = [t.detach().requires_grad_() for t in ctx.saved_tensors]
        with torch.enable_grad():
            out = flash_attention_plain(*inputs, causal=causal,
                                        window=window, scale=scale)
            grads = torch.autograd.grad(out, inputs, grad_out)
        return (*grads, None, None, None)


flash_attention.launches = 0

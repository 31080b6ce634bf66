"""Shared model layers, the dense subset (PyTorch, explicit param dicts).

RMSNorm, RoPE, GQA attention with optional qk-norm / QKV bias / sliding
window, and the SwiGLU MLP — what the dense serving path runs. Attention
from an empty cache (prefill at position 0, or a forward without caches)
goes through K6 (``kernels.ops.attention``); decode attends over the
cache with plain masked attention, the reference's own split (its XLA
path there, ``repro/models/layers.py:_attention_naive``). Projections are
``torch.matmul``, as the reference leaves them to XLA. There is one
device, so the reference's sharding annotations have no counterpart.

The KV cache is updated in place (the reference returns a new one): a
tinyllama cache at 8 x 552 tokens is ~200 MB, and copying it per layer
and step would dominate decode.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops

NEG_INF = -1e30


def init_dense(gen: torch.Generator, d_in: int, d_out: int, dtype,
               device, *, layers: Optional[int] = None) -> torch.Tensor:
    """N(0, 1) * sqrt(2 / (d_in + d_out)), the reference's ``init_dense``
    distribution, drawn from ``gen``; with ``layers``, a stacked
    ``(layers, d_in, d_out)`` draw."""
    shape = (d_in, d_out) if layers is None else (layers, d_in, d_out)
    scale = (2.0 / (d_in + d_out)) ** 0.5
    return (torch.randn(shape, generator=gen, dtype=torch.float32,
                        device=device) * scale).to(dtype)


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float
             ) -> torch.Tensor:
    xf = x.to(torch.float32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return ((xf * torch.rsqrt(var + eps)) * scale.to(torch.float32)
            ).to(x.dtype)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float
               ) -> torch.Tensor:
    """x: (B, S, H, d); positions: (B, S) int."""
    d = x.shape[-1]
    freqs = rope_freqs(d, theta, x.device)                  # (d/2,)
    angles = positions[..., None].to(torch.float32) * freqs  # (B, S, d/2)
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Attention
# ---------------------------------------------------------------------------

def init_attention(gen: torch.Generator, cfg: ModelConfig, dtype, device,
                   layers: int) -> dict:
    """Stacked ``(layers, ...)`` attention params of ``cfg``."""
    hd = cfg.resolved_head_dim()
    d, qd, kvd = cfg.d_model, cfg.num_heads * hd, cfg.num_kv_heads * hd

    def dense(a, b):
        return init_dense(gen, a, b, dtype, device, layers=layers)

    p = {"wq": dense(d, qd), "wk": dense(d, kvd), "wv": dense(d, kvd),
         "wo": dense(qd, d)}
    if cfg.qkv_bias:
        for name, n in (("b_q", qd), ("b_k", kvd), ("b_v", kvd)):
            p[name] = torch.zeros((layers, n), dtype=dtype, device=device)
    if cfg.qk_norm:
        for name in ("q_norm_scale", "k_norm_scale"):
            p[name] = torch.ones((layers, hd), dtype=dtype, device=device)
    return p


def _causal_window_mask(sq: int, skv: int, q_offset: int, window: int,
                        causal: bool, device) -> torch.Tensor:
    """(sq, skv) bool mask (window 0 = off)."""
    q_pos = q_offset + torch.arange(sq, device=device)[:, None]
    k_pos = torch.arange(skv, device=device)[None, :]
    mask = torch.ones((sq, skv), dtype=torch.bool, device=device)
    if causal:
        mask &= q_pos >= k_pos
    mask &= (q_pos - k_pos) < (window if window > 0 else 2 ** 30)
    return mask


def attention_core(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                   causal: bool = True, window: int = 0, q_offset: int = 0,
                   kv_len: Optional[torch.Tensor] = None) -> torch.Tensor:
    """q: (B,Sq,Hq,d), k/v: (B,Skv,Hkv,d) -> (B,Sq,Hq,d). ``kv_len``:
    optional (B,) valid length (decode caches).

    Attention from an empty cache (no offset, no ``kv_len``) is K6;
    attention over a cache is plain masked attention."""
    if q_offset == 0 and kv_len is None:
        return ops.attention(q, k, v, causal=causal, window=window)
    return _attention_naive(q, k, v, causal=causal, window=window,
                            q_offset=q_offset, kv_len=kv_len)


def _attention_naive(q, k, v, *, causal, window, q_offset, kv_len):
    """Full-score attention over (B,H,Sq,Skv) f32 scores; GQA by reshape
    to (B, Skv, Hkv, group, d), no repeat of K or V."""
    b, sq, hq, d = q.shape
    _, skv, hkv, _ = k.shape
    dv = v.shape[-1]
    group = hq // hkv
    scale = d ** -0.5
    qg = q.reshape(b, sq, hkv, group, d)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg.to(torch.float32) * scale,
                     k.to(torch.float32))
    mask = _causal_window_mask(sq, skv, q_offset, window, causal, q.device)
    if kv_len is not None:
        mask = mask[None] & (torch.arange(skv, device=q.device)[None, None, :]
                             < kv_len[:, None, None])
        mask = mask[:, None, None]
    else:
        mask = mask[None, None, None]
    s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhgqk,bkhd->bqhgd", p, v.to(torch.float32))
    return out.reshape(b, sq, hq, dv).to(q.dtype)


def attention_block(params: dict, cfg: ModelConfig, x: torch.Tensor,
                    positions: torch.Tensor, *, causal: bool = True,
                    window: int = 0, cache: Optional[dict] = None,
                    pos: int = 0):
    """Full attention sub-block. Returns (out, cache).

    With ``cache`` ({"k", "v", "pos"} views of one layer), the new keys
    and values are written in place at host position ``pos``; ``pos ==
    0`` attends over them alone (K6), a later position over the cache."""
    b, s, _ = x.shape
    hd = cfg.resolved_head_dim()
    q = x @ params["wq"]
    k = x @ params["wk"]
    v = x @ params["wv"]
    if cfg.qkv_bias:
        q = q + params["b_q"]
        k = k + params["b_k"]
        v = v + params["b_v"]
    q = q.reshape(b, s, cfg.num_heads, hd)
    k = k.reshape(b, s, cfg.num_kv_heads, hd)
    v = v.reshape(b, s, cfg.num_kv_heads, hd)
    if cfg.qk_norm:
        q = rms_norm(q, params["q_norm_scale"], cfg.rms_eps)
        k = rms_norm(k, params["k_norm_scale"], cfg.rms_eps)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)

    if cache is not None:
        ck, cv = cache["k"], cache["v"]
        ck[:, pos:pos + s] = k.to(ck.dtype)
        cv[:, pos:pos + s] = v.to(cv.dtype)
        cache["pos"].fill_(pos + s)
    if cache is None or pos == 0:
        if cache is not None:
            # K and V rounded as the cache holds them (a bf16 cache), as
            # the reference attends over its cache; no copy for f32
            k, v = k.to(ck.dtype).to(q.dtype), v.to(cv.dtype).to(q.dtype)
        out = attention_core(q, k.contiguous(), v.contiguous(),
                             causal=causal, window=window)
    else:
        kv_len = torch.full((b,), pos + s, dtype=torch.int32,
                            device=x.device)
        out = attention_core(q, ck.to(q.dtype), cv.to(q.dtype),
                             causal=causal, window=window, q_offset=pos,
                             kv_len=kv_len)
    out = out.reshape(b, s, cfg.num_heads * hd)
    return out @ params["wo"], cache


# ---------------------------------------------------------------------------
# SwiGLU MLP
# ---------------------------------------------------------------------------

def init_mlp(gen: torch.Generator, d_model: int, d_ff: int, dtype, device,
             layers: int) -> dict:
    def dense(a, b):
        return init_dense(gen, a, b, dtype, device, layers=layers)

    return {"w_gate": dense(d_model, d_ff), "w_up": dense(d_model, d_ff),
            "w_down": dense(d_ff, d_model)}


def mlp_block(params: dict, x: torch.Tensor) -> torch.Tensor:
    h = F.silu(x @ params["w_gate"]) * (x @ params["w_up"])
    return h @ params["w_down"]

"""Mamba-2 (SSD — state-space duality) block, chunked parallel form.

The port of ``repro/models/ssm.py``. The three routes of ``ssm_block``
are the reference's: a prefill seeded from the cached state and a
forward without caches run the chunked scan (K7 ``ssd_scan``, which on
the GPU takes the initial state and returns the final one); decode is
the O(1) recurrent step in plain PyTorch, as the reference leaves it to
XLA. Parameters are stacked per layer by ``models.transformer``; here
they are one layer's views.

Caches are updated in place (the reference returns new ones):
``cache["conv"]`` and ``cache["ssm"]`` are views of the stacked cache.
The conv buffer must hold the activations' dtype, as the reference's
returned ``new_conv`` does (``models.transformer.forward`` converts it
once); the state is f32.

Shapes: x (B,S,D); d_inner = expand*D; nh heads of head_dim hd;
B/C projections have n_groups G sharing state dim N (d_state).
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.ssd_scan import ssd_scan
from repro_torch.models.layers import init_dense, rms_norm


def init_ssm(gen: torch.Generator, cfg: ModelConfig, dtype, device,
             layers: int) -> dict:
    """Stacked ``(layers, ...)`` SSM params in the reference's layout and
    distributions: in_proj and out_proj as ``init_dense``, conv_w
    N(0, 1) / sqrt(d_conv), a_log = log(linspace(1, 16, nh)) (f32),
    d_skip 1 and dt_bias 0 (f32), gate norm scale 1."""
    s = cfg.ssm
    d = cfg.d_model
    di = s.d_inner(d)
    nh = s.n_heads(d)
    conv_ch = di + 2 * s.n_groups * s.d_state
    f32 = torch.float32

    def vec(values):
        return values.to(device=device, dtype=f32).expand(layers, nh).clone()

    conv_w = torch.randn((layers, s.d_conv, conv_ch), generator=gen,
                         dtype=f32, device=device)
    return {
        # [z, x, B, C, dt] fused input projection
        "in_proj": init_dense(gen, d, 2 * di + 2 * s.n_groups * s.d_state
                              + nh, dtype, device, layers=layers),
        "conv_w": (conv_w * math.sqrt(1.0 / s.d_conv)).to(dtype),
        "a_log": vec(torch.log(torch.linspace(1.0, 16.0, nh))),
        "d_skip": vec(torch.ones(nh)),
        "dt_bias": vec(torch.zeros(nh)),
        "gate_norm_scale": torch.ones((layers, di), dtype=dtype,
                                      device=device),
        "out_proj": init_dense(gen, di, d, dtype, device, layers=layers),
    }


def _causal_conv(x: torch.Tensor, w: torch.Tensor,
                 state: Optional[torch.Tensor] = None):
    """Depthwise causal conv. x: (B,S,C), w: (K,C). Returns (y, new_state)
    where state carries the last K-1 inputs for decode. The reference's
    per-tap sum, in its order (no cuDNN convolution: that runs in TF32
    by default and sums in another order)."""
    k = w.shape[0]
    s = x.shape[1]
    if state is None:
        pad = x.new_zeros((x.shape[0], k - 1, x.shape[2]))
    else:
        pad = state.to(x.dtype)
    xp = torch.cat([pad, x], dim=1)                  # (B, S+K-1, C)
    y = xp[:, 0:s] * w[0]
    for i in range(1, k):
        y = y + xp[:, i:i + s] * w[i]
    new_state = xp[:, -(k - 1):] if k > 1 else None
    return y, new_state


def ssm_block(params: dict, cfg: ModelConfig, x: torch.Tensor, *,
              cache: Optional[dict] = None):
    """Full mamba-2 block. Returns (out (B,S,D), cache); with ``cache``
    ({"conv", "ssm"} views of one layer) the caches are written in
    place."""
    s_cfg = cfg.ssm
    b, s, _ = x.shape
    di = s_cfg.d_inner(cfg.d_model)
    nh = s_cfg.n_heads(cfg.d_model)
    hd = s_cfg.head_dim
    g, n = s_cfg.n_groups, s_cfg.d_state

    zxbcdt = x @ params["in_proj"]
    z, xs, bm, cm, dt = torch.split(zxbcdt, [di, di, g * n, g * n, nh],
                                    dim=-1)

    conv_in = torch.cat([xs, bm, cm], dim=-1)
    conv_state = cache["conv"] if cache is not None else None
    if conv_state is not None and conv_state.dtype != x.dtype:
        raise ValueError(f"the conv cache holds {conv_state.dtype}, the "
                         f"activations are {x.dtype}: it would round")
    conv_out, new_conv = _causal_conv(conv_in, params["conv_w"], conv_state)
    conv_out = F.silu(conv_out)
    xs, bm, cm = torch.split(conv_out, [di, g * n, g * n], dim=-1)

    dt = F.softplus(dt.to(torch.float32) + params["dt_bias"])
    a = -torch.exp(params["a_log"])                    # (nh,)
    xh = xs.reshape(b, s, nh, hd)
    bm = bm.reshape(b, s, g, n).to(torch.float32).contiguous()
    cm = cm.reshape(b, s, g, n).to(torch.float32).contiguous()

    if cache is not None and s > 1:
        # prefill with state: chunked scan seeded from the cached state
        y, final = ssd_scan(xh.to(torch.float32).contiguous(), dt, a, bm,
                            cm, chunk=min(s_cfg.chunk_size, s),
                            init_state=cache["ssm"], return_final_state=True)
        cache["ssm"].copy_(final)
    elif cache is not None:
        # recurrent decode: S <- exp(dt a) S + dt B x^T ; y = C S + D x
        st = cache["ssm"]                              # (b,nh,hd,n)
        dt1 = dt[:, 0]                                 # (b,nh)
        dec = torch.exp(dt1 * a)                       # (b,nh)
        bh = torch.repeat_interleave(bm[:, 0], nh // g, dim=1)  # (b,nh,n)
        ch = torch.repeat_interleave(cm[:, 0], nh // g, dim=1)
        xt = xh[:, 0].to(torch.float32)                # (b,nh,hd)
        st.copy_(st * dec[:, :, None, None]
                 + torch.einsum("bh,bhn,bhd->bhdn", dt1, bh, xt))
        y = torch.einsum("bhn,bhdn->bhd", ch, st)[:, None]  # (b,1,nh,hd)
    else:
        y = ssd_scan(xh.to(torch.float32).contiguous(), dt, a, bm, cm,
                     chunk=min(s_cfg.chunk_size, s))
    if cache is not None:
        cache["conv"].copy_(new_conv)

    y = y + params["d_skip"][:, None] * xh.to(torch.float32)
    y = y.reshape(b, s, di).to(x.dtype)
    y = rms_norm(y * F.silu(z), params["gate_norm_scale"], cfg.rms_eps)
    return y @ params["out_proj"], cache


def init_ssm_cache(cfg: ModelConfig, layers: int, batch: int, dtype,
                   device) -> dict:
    """Stacked SSM caches: conv (L, B, K-1, C) in ``dtype``, ssm (L, B,
    nh, hd, N) f32 — the reference's keys, shapes and dtypes."""
    s = cfg.ssm
    di = s.d_inner(cfg.d_model)
    nh = s.n_heads(cfg.d_model)
    conv_ch = di + 2 * s.n_groups * s.d_state
    return {
        "conv": torch.zeros((layers, batch, s.d_conv - 1, conv_ch),
                            dtype=dtype, device=device),
        "ssm": torch.zeros((layers, batch, nh, s.head_dim, s.d_state),
                           dtype=torch.float32, device=device),
    }

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

Given a ``sharding.TensorParallel`` (``tp=``) the block is one rank's
share over the ``model`` axis on the reference's cuts: ``in_proj`` and
``conv_w`` column-cut and ``out_proj`` row-cut where their widths divide
the axis, the rest whole; the conv cache cut on its channels and the
state on its head dim (``init_ssm_cache(tp_size=)``).
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.ssd_scan import ssd_scan
from repro_torch.models.layers import (_rows_out, _tp_in, _tp_out,
                                       init_dense, rms_norm)
from repro_torch.models.sharding import active


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


def head_parallel(cfg: ModelConfig, tp: int) -> bool:
    """Whether the scan runs head-parallel over a ``model`` axis of
    ``tp``: its heads, and its B/C groups (or a single group), divide
    the axis. Otherwise every rank scans every head, as the reference's
    activations stay whole where ``shard`` drops an undividable dim."""
    s = cfg.ssm
    g = s.n_groups
    return s.n_heads(cfg.d_model) % tp == 0 and (g == 1 or g % tp == 0)


def ssm_block(params: dict, cfg: ModelConfig, x: torch.Tensor, *,
              cache: Optional[dict] = None, tp=None):
    """Full mamba-2 block. Returns (out (B,S,D), cache); with ``cache``
    ({"conv", "ssm"} views of one layer) the caches are written in
    place.

    With ``tp`` (a ``sharding.TensorParallel``), one rank's share over
    its ``model`` axis: the whole input (``_tp_in``) through the rank's
    columns of ``in_proj``, gathered whole (a whole ``in_proj`` computes
    all of them on every rank); the conv over the rank's channels
    (``conv_w``'s cut, with the conv cache's), gathered whole. Then the
    scan over the rank's heads (``head_parallel``; every head
    otherwise), K7 for a prefill or a forward: a cut state's head dim is
    turned onto the heads before it (an all-to-all; an all-gather when
    every rank scans every head) and back after. Decode updates the
    state where it lies (the recurrence is independent per head-dim row)
    and gathers its rows of y. The gate norm over the whole
    ``d_inner``: head-parallel, the sum of squares of the rank's columns
    is reduced over the group; otherwise every rank norms all of y and
    keeps its columns. The rank's columns through its rows of
    ``out_proj``, reduced into the residual's layout (``_tp_out``); an
    ``out_proj`` whose rows do not divide the axis is whole, and takes
    the rank's share of the rows of y, every column
    (``layers._rows_out``)."""
    s_cfg = cfg.ssm
    di = s_cfg.d_inner(cfg.d_model)
    nh = s_cfg.n_heads(cfg.d_model)
    hd = s_cfg.head_dim
    g, n = s_cfg.n_groups, s_cfg.d_state
    sharded = active(tp)
    if sharded:
        x_in = _tp_in(x, tp)
    else:
        x_in = x
    b, s, _ = x_in.shape

    zxbcdt = x_in @ params["in_proj"]
    if zxbcdt.shape[-1] != 2 * di + 2 * g * n + nh:
        zxbcdt = tp.gather(zxbcdt, 2)
    z, xs, bm, cm, dt = torch.split(zxbcdt, [di, di, g * n, g * n, nh],
                                    dim=-1)

    conv_in = torch.cat([xs, bm, cm], dim=-1)
    cut_conv = params["conv_w"].shape[-1] != conv_in.shape[-1]
    if cut_conv:
        conv_in = tp.cut(conv_in, 2)
    conv_state = cache["conv"] if cache is not None else None
    if conv_state is not None and conv_state.dtype != x.dtype:
        raise ValueError(f"the conv cache holds {conv_state.dtype}, the "
                         f"activations are {x.dtype}: it would round")
    conv_out, new_conv = _causal_conv(conv_in, params["conv_w"], conv_state)
    conv_out = F.silu(conv_out)
    if cut_conv:
        conv_out = tp.gather(conv_out, 2)
    xs, bm, cm = torch.split(conv_out, [di, g * n, g * n], dim=-1)

    dt_all = F.softplus(dt.to(torch.float32) + params["dt_bias"])
    a_all = -torch.exp(params["a_log"])                # (nh,)
    xh_all = xs.reshape(b, s, nh, hd)
    bm = bm.reshape(b, s, g, n).to(torch.float32).contiguous()
    cm = cm.reshape(b, s, g, n).to(torch.float32).contiguous()
    xh, dt, a, d_skip = xh_all, dt_all, a_all, params["d_skip"]
    bm_l, cm_l = bm, cm
    heads = sharded and head_parallel(cfg, tp.size)
    if heads:
        # the rank's heads, and the groups they read (K7 takes contiguous
        # tensors)
        xh, dt = tp.cut(xh, 2), tp.cut(dt, 2).contiguous()
        a, d_skip = tp.cut(a, 0), tp.cut(d_skip, 0)
        if g > 1:
            bm_l = tp.cut(bm, 2).contiguous()
            cm_l = tp.cut(cm, 2).contiguous()
    st = cache["ssm"] if cache is not None else None
    cut_state = st is not None and st.shape[2] != hd

    if st is not None and s > 1:
        # prefill with state: chunked scan seeded from the cached state
        init = st
        if cut_state:
            init = (tp.all_to_all_plain(st.contiguous(), 1, 2) if heads
                    else tp.all_gather(st.contiguous(), 2))
        elif heads:
            init = tp.cut(st, 1).contiguous()
        y, final = ssd_scan(xh.to(torch.float32).contiguous(), dt, a, bm_l,
                            cm_l, chunk=min(s_cfg.chunk_size, s),
                            init_state=init, return_final_state=True)
        if cut_state:
            final = (tp.all_to_all_plain(final.contiguous(), 2, 1) if heads
                     else tp.cut(final, 2))
        elif heads:
            final = tp.all_gather(final.contiguous(), 1)
        st.copy_(final)
    elif st is not None:
        # recurrent decode of every head on the state where it lies (a
        # rank's cut of the head dim, or all of it): S <- exp(dt a) S +
        # dt B x^T ; y = C S + D x, each head-dim row on its own
        dt1 = dt_all[:, 0]                             # (b,nh)
        dec = torch.exp(dt1 * a_all)                   # (b,nh)
        bh = torch.repeat_interleave(bm[:, 0], nh // g, dim=1)  # (b,nh,n)
        ch = torch.repeat_interleave(cm[:, 0], nh // g, dim=1)
        xt = xh_all[:, 0].to(torch.float32)            # (b,nh,hd)
        if cut_state:
            xt = tp.cut(xt, 2)
        st.copy_(st * dec[:, :, None, None]
                 + torch.einsum("bh,bhn,bhd->bhdn", dt1, bh, xt))
        y = torch.einsum("bhn,bhdn->bhd", ch, st)
        if cut_state:
            y = tp.all_gather(y.contiguous(), 2)
        if heads:
            y = tp.cut(y, 1)
        y = y[:, None]                                 # (b,1,nh,hd)
    else:
        y = ssd_scan(xh.to(torch.float32).contiguous(), dt, a, bm_l, cm_l,
                     chunk=min(s_cfg.chunk_size, s))
    if cache is not None:
        cache["conv"].copy_(new_conv)

    y = y + d_skip[:, None] * xh.to(torch.float32)
    y = y.reshape(b, s, -1).to(x.dtype)
    scale = params["gate_norm_scale"]
    if heads:
        gated = (y * F.silu(tp.cut(z, 2))).to(torch.float32)
        # the sum of squares over all of d_inner: reduced forward, and its
        # gradient (each rank's columns use it) summed back
        ss = tp.copy(tp.reduce(torch.sum(gated * gated, dim=-1,
                                         keepdim=True)))
        y = ((gated * torch.rsqrt(ss / di + cfg.rms_eps))
             * tp.cut(scale, 0).to(torch.float32)).to(x.dtype)
    else:
        y = rms_norm(y * F.silu(z), scale, cfg.rms_eps)
        if sharded and params["out_proj"].shape[0] == di:
            # an out_proj whose rows do not divide the axis (never
            # head-parallel): the rank's share of the rows through it
            lo, hi = tp.share(s)
            return _rows_out(y[:, lo:hi] @ params["out_proj"], lo, s,
                             tp), cache
        if sharded:
            y = tp.cut(y, 2)
    out = y @ params["out_proj"]
    return (_tp_out(out, tp) if sharded else out), cache


def init_ssm_cache(cfg: ModelConfig, layers: int, batch: int, dtype,
                   device, tp_size: int = 1) -> dict:
    """Stacked SSM caches: conv (L, B, K-1, C) in ``dtype``, ssm (L, B,
    nh, hd, N) f32 — the reference's keys, shapes and dtypes. With
    ``tp_size`` over 1 a rank's cut, as ``launch.specs.
    cache_partition_specs`` cuts them: C and hd to ``1 / tp_size`` where
    they divide."""
    s = cfg.ssm
    di = s.d_inner(cfg.d_model)
    nh = s.n_heads(cfg.d_model)
    conv_ch = di + 2 * s.n_groups * s.d_state
    lead = () if layers is None else (layers,)

    def cut(dim):
        return dim // tp_size if dim % tp_size == 0 else dim

    return {
        "conv": torch.zeros((*lead, batch, s.d_conv - 1, cut(conv_ch)),
                            dtype=dtype, device=device),
        "ssm": torch.zeros((*lead, batch, nh, cut(s.head_dim), s.d_state),
                           dtype=torch.float32, device=device),
    }

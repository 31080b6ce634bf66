"""Plain reference of the hymba-1.5b share: Hymba's hybrid-head blocks
(arXiv:2411.13676), attention heads and SSM heads on the same input,
each output RMS-normed and the two averaged, as one rank of the
deployment's ``model`` axis runs them, in float32.

The rank holds ``1 / n`` of the columns of ``wq``, ``wk``, ``wv``, the
conv taps, the MLP's gate and up projections, and of the rows of ``wo``,
``out_proj`` and the MLP's down projection, ``in_proj`` whole (its
width does not divide the axis) and ``1 / n`` of the vocabulary. Its
heads do not divide the axis, so a decode step attends with every head:
q, k and v are joined from the rank's columns (``common.tile``: copies
of its part), the cache holds the rank's part of each kv head's dims
and the scores are the rank's part of every head's product, as the
ranks' partial scores would be summed; the conv runs on the rank's
channels, and the state holds the rank's part of each SSM head's dims.
A prefill's attention (its sequence divides the axis) takes the rank's
rows of q, made of the rank's columns (an all-to-all: copies of its
part), against k and v joined from its columns, and hands its rows'
output, the rank's columns of it, back as every block of rows; the scan
runs over every head of the joined conv output from the joined state.

Departures from the published model, as the deployment runs it: the
SSM heads are Mamba-2's (SSD, heads of 64, one B/C group) in place of
Hymba's Mamba heads, there are no meta tokens and no KV sharing across
layers, the global-attention layers are ``as_run``'s
``global_attn_idx``, and the head is untied.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from perfbench.reference.common import (F32, Prec, attend, part, rms_norm,
                                        rope, swiglu, tile)


def _layer(tree, i):
    if isinstance(tree, dict):
        return {k: _layer(v, i) for k, v in tree.items()}
    return tree[i]


def window_of(conf: dict, i: int) -> int:
    glob = conf["as_run"]["global_attn_idx"]
    return 0 if i in glob else conf["sliding_window"]


def attention_decode(p, conf, share, h, cache, pos: int, window: int,
                     prec: Prec):
    """One token's attention (h: (B, D)) over the rank's part of the
    cache (``cache["k"]``, ``cache["v"]``: (B, S, Hkv, hd / n) f32),
    whose slot ``pos`` it writes first."""
    n, r = share["n"], share["rank"]
    b = h.shape[0]
    hd = conf["head_dim"]
    hq, hkv = conf["num_attention_heads"], conf["num_key_value_heads"]
    theta = conf["rope_theta"]
    positions = torch.full((b, 1), pos, device=h.device)
    q = tile(prec.mm(h, p["wq"]), n, 1).reshape(b, 1, hq, hd)
    k = tile(prec.mm(h, p["wk"]), n, 1).reshape(b, 1, hkv, hd)
    v = tile(prec.mm(h, p["wv"]), n, 1).reshape(b, 1, hkv, hd)
    q, k = rope(q, positions, theta), rope(k, positions, theta)
    cache["k"][:, pos] = part(k[:, 0], n, r, 2)
    cache["v"][:, pos] = part(v[:, 0], n, r, 2)
    out = attend(part(q, n, r, 3), cache["k"], cache["v"],
                 q_pos=torch.tensor([pos]), k_len=pos + 1, window=window,
                 scale=hd ** -0.5, prec=prec)             # (b, 1, hq, hd/n)
    out = tile(out, n, 3).reshape(b, hq * hd)
    return prec.mm(part(out, n, r, 1), p["wo"])


def ssm_decode(p, conf, share, h, cache, prec: Prec):
    """One token's Mamba-2 step (h: (B, D)) on the rank's conv channels
    (``cache["conv"]``: (B, K - 1, C / n)) and its part of each head's
    state (``cache["ssm"]``: (B, nh, hd / n, N)), both updated."""
    n, r = share["n"], share["rank"]
    b = h.shape[0]
    di = conf["mamba_expand"] * conf["hidden_size"]
    ns = conf["mamba_d_state"]
    hd = conf["ssm_head_dim"]
    nh = di // hd
    zx = prec.mm(h, p["in_proj"])
    z, xs, bm, cm, dt = zx.split([di, di, ns, ns, nh], dim=-1)
    conv_in = part(torch.cat([xs, bm, cm], dim=-1), n, r, 1)
    xp = torch.cat([cache["conv"], conv_in[:, None]], dim=1)  # (b, K, C/n)
    w = p["conv_w"].to(F32)
    conv = (xp * w[None]).sum(1)
    cache["conv"].copy_(xp[:, 1:])
    xs, bm, cm = tile(F.silu(conv), n, 1).split([di, ns, ns], dim=-1)
    dt = F.softplus(dt + p["dt_bias"].to(F32))              # (b, nh)
    a = -torch.exp(p["a_log"].to(F32))
    xh = xs.reshape(b, nh, hd)
    st = cache["ssm"]
    st.mul_(torch.exp(dt * a)[:, :, None, None]).add_(
        dt[:, :, None, None] * part(xh, n, r, 2)[..., None]
        * bm[:, None, None, :])
    y = tile(torch.einsum("bn,bhdn->bhd", cm, st), n, 2)
    y = (y + p["d_skip"].to(F32)[:, None] * xh).reshape(b, di)
    y = rms_norm(y * F.silu(z), p["gate_norm_scale"], conf["rms_norm_eps"])
    return prec.mm(part(y, n, r, 1), p["out_proj"])


def ssd_scan(x, dt, a, bm, cm, init, chunk: int, prec: Prec,
             group: int = 16):
    """Mamba-2's state-space scan, chunked: x (B, S, H, P), dt (B, S, H)
    (after the softplus), a (H,) negative, bm and cm (B, S, N) (one
    group), init (B, H, P, N). Within a chunk the quadratic form
    ``y_i = sum_{j<=i} exp(A_i - A_j) (C_i . B_j) dt_j x_j`` (A the
    in-chunk sum of dt a), across chunks the state, passed in order.
    Returns (y (B, S, H, P), final state)."""
    b, s, h, p = x.shape
    nc = s // chunk
    xc = x.reshape(b, nc, chunk, h, p)
    dtc = dt.reshape(b, nc, chunk, h)
    bc = bm.reshape(b, nc, chunk, -1)
    cc = cm.reshape(b, nc, chunk, -1)
    cum = torch.cumsum(dtc * a, dim=2)                      # (b, nc, L, h)
    to_end = torch.exp(cum[:, :, -1:] - cum) * dtc
    inc = torch.einsum("bclh,bcln,bclhp->bchpn", to_end, bc, xc)
    state, starts = init, []
    for c in range(nc):
        starts.append(state)
        state = torch.exp(cum[:, c, -1])[:, :, None, None] * state + inc[:, c]
    starts = torch.stack(starts, dim=1)                     # (b, nc, h, p, n)
    y = torch.einsum("bcln,bchpn->bclhp", cc, starts) \
        * torch.exp(cum)[..., None]
    tri = torch.tril(torch.ones(chunk, chunk, dtype=torch.bool,
                                device=x.device))
    for c0 in range(0, nc, group):
        c1 = min(nc, c0 + group)
        cb = prec.mm(cc[:, c0:c1], bc[:, c0:c1].transpose(-1, -2))
        seg = cum[:, c0:c1]                                 # (b, g, L, h)
        dec = torch.exp((seg[:, :, :, None] - seg[:, :, None]).masked_fill(
            ~tri[None, None, :, :, None], float("-inf")))   # (b, g, L, L, h)
        w = cb[..., None] * dec * dtc[:, c0:c1, None]       # (b, g, i, j, h)
        y[:, c0:c1] += torch.einsum("bgijh,bgjhp->bgihp", w, xc[:, c0:c1])
    return y.reshape(b, s, h, p), state


def attention_prefill(p, conf, share, h, window: int, prec: Prec):
    """The rank's share of a prompt's attention (h: (B, S, D) from
    position 0); returns the output in the residual's layout and the
    rank's part of k and v for the cache."""
    n, r = share["n"], share["rank"]
    b, s, _ = h.shape
    hd = conf["head_dim"]
    hq, hkv = conf["num_attention_heads"], conf["num_key_value_heads"]
    theta = conf["rope_theta"]
    rows = s // n
    positions = torch.arange(s, device=h.device).expand(b, s)
    q = tile(part(prec.mm(h, p["wq"]), n, r, 1), n, 2)      # (b, rows, hq hd)
    q = rope(q.reshape(b, rows, hq, hd), positions[:, r * rows:(r + 1) * rows],
             theta)
    k = tile(prec.mm(h, p["wk"]), n, 2).reshape(b, s, hkv, hd)
    v = tile(prec.mm(h, p["wv"]), n, 2).reshape(b, s, hkv, hd)
    k = rope(k, positions, theta)
    out = attend(q, k, v, q_pos=torch.arange(r * rows, (r + 1) * rows),
                 k_len=s, window=window, scale=hd ** -0.5, prec=prec,
                 block=512)
    out = tile(part(out.reshape(b, rows, hq * hd), n, r, 2), n, 1)
    return prec.mm(out, p["wo"]), (part(k, n, r, 3), part(v, n, r, 3))


def ssm_prefill(p, conf, share, h, prec: Prec):
    """The rank's share of a prompt's Mamba-2 mixer (h: (B, S, D)) from
    a fresh state; returns the output and the rank's conv channels' last
    inputs and part of the final state, for the cache."""
    n, r = share["n"], share["rank"]
    b, s, _ = h.shape
    di = conf["mamba_expand"] * conf["hidden_size"]
    ns, k = conf["mamba_d_state"], conf["mamba_d_conv"]
    hd = conf["ssm_head_dim"]
    nh = di // hd
    z, xs, bm, cm, dt = prec.mm(h, p["in_proj"]).split(
        [di, di, ns, ns, nh], dim=-1)
    conv_in = part(torch.cat([xs, bm, cm], dim=-1), n, r, 2)
    xp = F.pad(conv_in, (0, 0, k - 1, 0))
    w = p["conv_w"].to(F32)
    conv = sum(xp[:, i:i + s] * w[i] for i in range(k))
    xs, bm, cm = tile(F.silu(conv), n, 2).split([di, ns, ns], dim=-1)
    dt = F.softplus(dt + p["dt_bias"].to(F32))
    a = -torch.exp(p["a_log"].to(F32))
    xh = xs.reshape(b, s, nh, hd)
    init = torch.zeros((b, nh, hd, ns), dtype=F32, device=h.device)
    y, final = ssd_scan(xh, dt, a, bm, cm, init, conf["ssm_chunk"], prec)
    y = (y + p["d_skip"].to(F32)[:, None] * xh).reshape(b, s, di)
    y = rms_norm(y * F.silu(z), p["gate_norm_scale"], conf["rms_norm_eps"])
    return prec.mm(part(y, n, r, 2), p["out_proj"]), \
        (xp[:, -(k - 1):], part(final, n, r, 2))


@torch.no_grad()
def prefill(params: dict, conf: dict, share: dict, tokens: torch.Tensor,
            prec: Prec = Prec()) -> dict:
    """The share's prefill of ``tokens`` (B, S) from position 0 with
    fresh caches: the last position's logits over the rank's vocabulary
    rows (B, V / n), and each layer's cache entries as the rank holds
    them: ``k``, ``v`` (B, S, Hkv, hd / n), ``conv`` (B, K - 1, C / n)
    and ``ssm`` (B, nh, hd / n, N)."""
    eps = conf["rms_norm_eps"]
    layers = params["layers"]
    x = params["embed"][tokens - share["lo"]].to(F32)
    caches = []
    for i in range(layers["pre_norm_scale"].shape[0]):
        bp = _layer(layers, i)
        mx = bp["mixer"]
        h = rms_norm(x, bp["pre_norm_scale"], eps)
        a_out, (ck, cv) = attention_prefill(mx["attn"], conf, share, h,
                                            window_of(conf, i), prec)
        s_out, (conv, st) = ssm_prefill(mx["ssm"], conf, share, h, prec)
        caches.append({"k": ck, "v": cv, "conv": conv, "ssm": st})
        x = x + 0.5 * (rms_norm(a_out, mx["attn_out_norm_scale"], eps)
                       + rms_norm(s_out, mx["ssm_out_norm_scale"], eps))
        m = bp["ffn"]["mlp"]
        x = x + swiglu(rms_norm(x, bp["post_norm_scale"], eps),
                       m["w_gate"], m["w_up"], m["w_down"], prec)
    last = rms_norm(x[:, -1], params["final_norm_scale"], eps)
    return {"logits": prec.mm(last, params["lm_head"]), "caches": caches}


@torch.no_grad()
def decode(params: dict, conf: dict, share: dict, caches: dict,
           tokens: torch.Tensor, pos0: int, prec: Prec = Prec()) -> dict:
    """The share's decode of ``tokens`` (B, T), token t at position
    ``pos0 + t``, over ``caches`` (f32, updated in place: per layer
    ``k``, ``v``, ``conv``, ``ssm`` as the rank holds them). Returns each
    step's logits over the rank's vocabulary rows (T, B, V / n)."""
    eps = conf["rms_norm_eps"]
    layers = params["layers"]
    nl = layers["pre_norm_scale"].shape[0]
    out = []
    for t in range(tokens.shape[1]):
        x = params["embed"][tokens[:, t] - share["lo"]].to(F32)
        for i in range(nl):
            bp, c = _layer(layers, i), caches[i]
            mx = bp["mixer"]
            h = rms_norm(x, bp["pre_norm_scale"], eps)
            a_out = attention_decode(mx["attn"], conf, share, h, c,
                                     pos0 + t, window_of(conf, i), prec)
            s_out = ssm_decode(mx["ssm"], conf, share, h, c, prec)
            x = x + 0.5 * (rms_norm(a_out, mx["attn_out_norm_scale"], eps)
                           + rms_norm(s_out, mx["ssm_out_norm_scale"], eps))
            m = bp["ffn"]["mlp"]
            x = x + swiglu(rms_norm(x, bp["post_norm_scale"], eps),
                           m["w_gate"], m["w_up"], m["w_down"], prec)
        out.append(prec.mm(rms_norm(x, params["final_norm_scale"], eps),
                           params["lm_head"]))
    return {"logits": torch.stack(out)}

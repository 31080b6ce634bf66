"""Plain reference of the deepseek-v2-lite-16b share: DeepSeek-V2's
multi-head latent attention and its mixture of experts (arXiv:2405.04434),
as one rank of the deployment's ``model`` axis holds them, in float32.

The rank holds ``num_attention_heads`` of the heads (their columns of
``wq``, ``w_uk``, ``w_uv`` and rows of ``wo``), the latent projection
``w_dkv`` whole and ``1 / n`` of the rope key's projection ``w_kr``,
``n_routed_experts`` of the experts, ``1 / n`` of the shared experts'
and the dense layer's hidden columns, and ``1 / n`` of the vocabulary
(``vocab_size`` rows of the embedding, columns of the head). It routes
every token over all ``n_routed_experts * n`` experts and computes its
own experts' part. The rope key is joined from the ranks' parts before
it turns (``common.tile``: copies of this rank's part), and the caches
hold the rank's part of the latent and of the turned rope key.

Departures from the published model, as the deployment runs it: no
YaRN scaling of the rope (theta 10000 over every position), the top-k
gates renormalised to sum to 1, expert capacity
``max(int(k T / E * capacity_factor), k)`` of the call's T tokens with
later assignments dropped (in token order), and a scale of
``(qk_nope_head_dim + qk_rope_head_dim) ** -0.5`` on the scores.
"""
from __future__ import annotations

import torch

from perfbench.reference.common import (F32, Prec, attend, part, rms_norm,
                                        rope, swiglu, tile)


def _layer(tree, i):
    if isinstance(tree, dict):
        return {k: _layer(v, i) for k, v in tree.items()}
    return tree[i]


def blocks(params: dict, conf: dict):
    """The blocks in order: (block params, has experts)."""
    out = [(bp, False) for _, bp in sorted(
        params.get("dense_blocks", {}).items(), key=lambda kv: int(kv[0]))]
    n = params["layers"]["pre_norm_scale"].shape[0]
    out += [(_layer(params["layers"], i), True) for i in range(n)]
    assert len(out) == conf["num_hidden_layers"]
    return out


def mla(p: dict, conf: dict, share: dict, h, positions, prec: Prec):
    """The rank's heads of MLA over its own rows from position 0, and the
    rank's parts of the latent and the turned rope key for the cache."""
    n, r = share["n"], share["rank"]
    b, s, _ = h.shape
    dn, dr, dv = (conf["qk_nope_head_dim"], conf["qk_rope_head_dim"],
                  conf["v_head_dim"])
    heads = conf["num_attention_heads"]
    eps, theta = conf["rms_norm_eps"], conf["rope_theta"]
    q = prec.mm(h, p["wq"]).reshape(b, s, heads, dn + dr)
    q_nope, q_rope = q.split([dn, dr], dim=-1)
    q_rope = rope(q_rope, positions, theta)
    c_kv = rms_norm(prec.mm(h, p["w_dkv"]), p["kv_norm_scale"], eps)
    k_rope = rope(tile(prec.mm(h, p["w_kr"]), n, 2)[:, :, None], positions,
                  theta)                                  # (b, s, 1, dr)
    k_nope = prec.mm(c_kv, p["w_uk"]).reshape(b, s, heads, dn)
    v = prec.mm(c_kv, p["w_uv"]).reshape(b, s, heads, dv)
    k = torch.cat([k_nope, k_rope.expand(b, s, heads, dr)], dim=-1)
    out = attend(torch.cat([q_nope, q_rope], dim=-1), k, v,
                 q_pos=torch.arange(s, device=h.device), k_len=s, window=0,
                 scale=(dn + dr) ** -0.5, prec=prec)
    cache = (part(c_kv, n, r, 2), part(k_rope[:, :, 0], n, r, 2))
    return prec.mm(out.reshape(b, s, heads * dv), p["wo"]), cache


def moe(p: dict, conf: dict, share: dict, h2, prec: Prec):
    """The rank's part of the MoE FFN over the call's T tokens: every
    token routed over all experts (softmax of f32 router logits, top-k,
    the k gates renormalised), the rank's experts applied to the tokens
    they keep within their capacity (in token order), and the rank's
    columns of the shared experts."""
    b, s, d = h2.shape
    t = b * s
    x = h2.reshape(t, d)
    k = conf["num_experts_per_tok"]
    held = conf["n_routed_experts"]
    e_all = held * share["n"]
    cap = max(int(k * t / e_all * conf["capacity_factor"]), k)
    probs = torch.softmax(prec.mm(x, p["router"]), dim=-1)
    gates, idx = torch.topk(probs, k, dim=-1, sorted=True)
    gates = gates / gates.sum(-1, keepdim=True)
    out = torch.zeros((t, d), dtype=F32, device=x.device)
    we = p["experts"]
    for j in range(held):
        e = share["rank"] * held + j
        hit = idx == e                                    # (t, k)
        tok = torch.nonzero(hit.any(-1)).flatten()[:cap]
        if tok.numel() == 0:
            continue
        gate = (gates * hit).sum(-1)[tok]
        y = swiglu(x[tok], we["w_gate"][j], we["w_up"][j], we["w_down"][j],
                   prec)
        out.index_add_(0, tok, y * gate[:, None])
    sh = p["shared"]
    out += swiglu(x, sh["w_gate"], sh["w_up"], sh["w_down"], prec)
    return out.reshape(b, s, d)


@torch.no_grad()
def prefill(params: dict, conf: dict, share: dict, tokens: torch.Tensor,
            prec: Prec = Prec()) -> dict:
    """The share's prefill of ``tokens`` (B, S) from position 0: the last
    position's logits over the rank's vocabulary rows (B, V / n), and
    each layer's cache entries (``caches``), the rank's parts of the
    latent ``c_kv`` (B, S, r / n) and of the turned rope key ``k_rope``
    (B, S, dr / n)."""
    eps = conf["rms_norm_eps"]
    b, s = tokens.shape
    positions = torch.arange(s, device=tokens.device).expand(b, s)
    x = params["embed"][tokens - share["lo"]].to(F32)
    c_kv, k_rope = [], []
    for bp, experts in blocks(params, conf):
        h = rms_norm(x, bp["pre_norm_scale"], eps)
        mix, (cc, cr) = mla(bp["mixer"]["mla"], conf, share, h, positions,
                            prec)
        c_kv.append(cc)
        k_rope.append(cr)
        x = x + mix
        h2 = rms_norm(x, bp["post_norm_scale"], eps)
        if experts:
            x = x + moe(bp["ffn"]["moe"], conf, share, h2, prec)
        else:
            m = bp["ffn"]["mlp"]
            x = x + swiglu(h2, m["w_gate"], m["w_up"], m["w_down"], prec)
    last = rms_norm(x[:, -1], params["final_norm_scale"], eps)
    return {"logits": prec.mm(last, params["lm_head"]),
            "caches": [{"c_kv": c, "k_rope": r} for c, r in zip(c_kv, k_rope)]}

"""Model backbone, the dense subset: embeds -> blocks -> norm -> lm head.

The port of ``repro/models/transformer.py`` for dense GQA decoders
(tinyllama, the qwen dense configs, ``tiny``). Parameters keep the
reference's pytree layout — nested dicts with the layer dimension
stacked first under ``"layers"`` — so ``convert.params_from_jax`` maps a
JAX pytree leaf for leaf. The reference scans the stack with
``lax.scan``; here a Python loop runs the layers on views of the stacked
tensors.

Families and features of later slices (SSM, hybrid, MoE, MLA,
encoder-decoder, M-RoPE) raise ``NotImplementedError``.
"""
from __future__ import annotations

from typing import List

import torch

from repro_torch._device import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import (attention_block, init_attention,
                                       init_dense, init_mlp, mlp_block,
                                       rms_norm)


def check_supported(cfg: ModelConfig) -> None:
    """Raise unless ``cfg`` is a dense GQA decoder (this slice's path)."""
    unsupported = [name for name, on in (
        (f"family {cfg.family!r}", cfg.family != "dense"),
        ("MLA", cfg.mla.enabled), ("MoE", cfg.moe.enabled),
        ("SSM", cfg.ssm.enabled),
        ("hybrid heads", cfg.hybrid_parallel_heads),
        ("encoder-decoder", cfg.enc_dec), ("M-RoPE", cfg.mrope),
        ("frontend stub", cfg.embedding_frontend_stub)) if on]
    if unsupported:
        raise NotImplementedError(
            f"{cfg.name}: {', '.join(unsupported)} not ported yet (the "
            "PyTorch port serves dense GQA decoders)")


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------

def init_params(cfg: ModelConfig, seed: int = 0, dtype=torch.float32,
                device=None) -> dict:
    """Random parameters in the reference's layout and distributions
    (``init_dense``: N(0, 1) * sqrt(2 / (d_in + d_out)); norm scales 1,
    biases 0), drawn from a ``torch.Generator`` seeded with ``seed`` on
    ``device`` (``None`` -> the GPU). The numbers differ from the JAX
    package's for the same seed; ``convert.params_from_jax`` carries a
    JAX pytree over instead."""
    check_supported(cfg)
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    n, d, pv = cfg.num_layers, cfg.d_model, cfg.padded_vocab()

    def ones(*shape):
        return torch.ones(shape, dtype=dtype, device=dev)

    p = {"embed": init_dense(gen, pv, d, dtype, dev),
         "final_norm_scale": ones(d)}
    if not cfg.tie_embeddings:
        p["lm_head"] = init_dense(gen, d, pv, dtype, dev)
    p["layers"] = {
        "pre_norm_scale": ones(n, d),
        "mixer": {"attn": init_attention(gen, cfg, dtype, dev, n)},
        "post_norm_scale": ones(n, d),
        "ffn": {"mlp": init_mlp(gen, d, cfg.d_ff, dtype, dev, n)},
    }
    return p


def layer_windows(cfg: ModelConfig, n: int) -> List[int]:
    """Per-layer attention window (0 = global), as host ints: the window
    selects the kernel's mask."""
    if cfg.attention_kind != "swa":
        return [0] * n
    out = []
    for i in range(n):
        is_global = i in (0, n - 1) or (cfg.global_attn_every > 0 and
                                        i % cfg.global_attn_every == 0)
        out.append(0 if is_global else cfg.sliding_window)
    return out


# ---------------------------------------------------------------------------
# Blocks
# ---------------------------------------------------------------------------

def _layer(tree, i: int):
    """Layer ``i`` of a stacked pytree, as views."""
    if isinstance(tree, dict):
        return {k: _layer(v, i) for k, v in tree.items()}
    return tree[i]


def _block_apply(bp: dict, cfg: ModelConfig, x, positions, window: int,
                 cache, pos: int):
    """One transformer block. Returns (x, cache); the cache is updated in
    place."""
    h = rms_norm(x, bp["pre_norm_scale"], cfg.rms_eps)
    mix, cache = attention_block(bp["mixer"]["attn"], cfg, h, positions,
                                 window=window, cache=cache, pos=pos)
    x = x + mix
    h2 = rms_norm(x, bp["post_norm_scale"], cfg.rms_eps)
    x = x + mlp_block(bp["ffn"]["mlp"], h2)
    return x, cache


def forward(params: dict, cfg: ModelConfig, batch: dict, *, caches=None,
            pos: int = 0):
    """Full forward. batch keys: tokens (B,S)[, positions]. ``pos`` is the
    host position where the tokens enter the caches (0 for prefill).
    Returns (logits (B, S, V_padded), caches, aux); caches are updated in
    place, aux is 0 (no MoE)."""
    check_supported(cfg)
    tokens = batch["tokens"]
    b, s = tokens.shape
    positions = batch.get("positions")
    if positions is None:
        positions = (pos + torch.arange(s, dtype=torch.int32,
                                        device=tokens.device)
                     ).expand(b, s)
    x = params["embed"][tokens]                         # (B, S, D)
    wins = layer_windows(cfg, cfg.num_layers)
    for i in range(cfg.num_layers):
        cache = (None if caches is None
                 else _layer(caches["scan"], i))
        x, _ = _block_apply(_layer(params["layers"], i), cfg, x, positions,
                            wins[i], cache, pos)
    x = rms_norm(x, params["final_norm_scale"], cfg.rms_eps)
    head = (params["embed"].T if cfg.tie_embeddings
            else params["lm_head"])
    logits = x @ head
    return logits, caches, torch.zeros((), dtype=torch.float32,
                                       device=x.device)


# ---------------------------------------------------------------------------
# KV caches (serving)
# ---------------------------------------------------------------------------

def init_caches(cfg: ModelConfig, batch: int, max_seq: int,
                dtype=torch.bfloat16, device=None) -> dict:
    """Stacked cache pytree, the reference's keys and shapes:
    ``{"scan": {"k": (L, B, max_seq, Hkv, hd), "v": ..., "pos": (L,)
    int32}}``."""
    check_supported(cfg)
    dev = resolve_device(device)
    hd, n = cfg.resolved_head_dim(), cfg.num_layers
    shape = (n, batch, max_seq, cfg.num_kv_heads, hd)
    return {"scan": {
        "k": torch.zeros(shape, dtype=dtype, device=dev),
        "v": torch.zeros(shape, dtype=dtype, device=dev),
        "pos": torch.zeros((n,), dtype=torch.int32, device=dev)}}

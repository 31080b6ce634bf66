"""Model backbone: embeds -> blocks -> norm -> lm head.

The port of ``repro/models/transformer.py`` for dense GQA decoders
(tinyllama, the qwen dense configs, ``tiny``), the SSM family
(mamba2-370m, ``tiny-ssm``: a Mamba-2 mixer, ``models/ssm.py``) and
hybrid parallel heads (hymba-1.5b: attention and SSM heads on the same
input, each output RMS-normed, then averaged). Parameters keep the
reference's pytree layout — nested dicts with the layer dimension
stacked first under ``"layers"`` — so ``convert.params_from_jax`` maps a
JAX pytree leaf for leaf. The reference scans the stack with
``lax.scan``; here a Python loop runs the layers on views of the stacked
tensors. Training takes ``loss_fn`` (the reference's cross entropy over
the padded vocab) with ``remat`` checkpointing each block.

Features of later slices (MoE, MLA, encoder-decoder, M-RoPE, the
frontend stub) raise ``NotImplementedError``.
"""
from __future__ import annotations

from typing import List

import torch
import torch.utils.checkpoint

from repro_torch._device import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.layers import (attention_block, init_attention,
                                       init_dense, init_mlp, mlp_block,
                                       rms_norm)


def check_supported(cfg: ModelConfig) -> None:
    """Raise unless ``cfg`` is a dense GQA decoder, an SSM model or a
    hybrid-heads model (the ported paths)."""
    unsupported = [name for name, on in (
        (f"family {cfg.family!r}",
         cfg.family not in ("dense", "ssm", "hybrid")),
        ("MLA", cfg.mla.enabled), ("MoE", cfg.moe.enabled),
        ("encoder-decoder", cfg.enc_dec), ("M-RoPE", cfg.mrope),
        ("frontend stub", cfg.embedding_frontend_stub)) if on]
    if unsupported:
        raise NotImplementedError(
            f"{cfg.name}: {', '.join(unsupported)} not ported yet (the "
            "PyTorch port serves dense GQA decoders, SSM and hybrid-heads "
            "models)")


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
    if cfg.family == "ssm":
        mixer = {"ssm": ssm_mod.init_ssm(gen, cfg, dtype, dev, n)}
    else:
        mixer = {"attn": init_attention(gen, cfg, dtype, dev, n)}
        if cfg.hybrid_parallel_heads:
            mixer["ssm"] = ssm_mod.init_ssm(gen, cfg, dtype, dev, n)
            mixer["attn_out_norm_scale"] = ones(n, d)
            mixer["ssm_out_norm_scale"] = ones(n, d)
    p["layers"] = {
        "pre_norm_scale": ones(n, d),
        "mixer": mixer,
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


def _unstack(tree, n: int) -> List[dict]:
    """The ``n`` layers of a stacked pytree, as views, split once by
    ``unbind``: its backward stacks the layers' gradients in one write,
    where indexing each layer would add a stack-sized zero-padded
    gradient per layer."""
    if isinstance(tree, dict):
        per_key = {k: _unstack(v, n) for k, v in tree.items()}
        return [{k: v[i] for k, v in per_key.items()} for i in range(n)]
    return list(tree.unbind(0))


def _mixer_apply(mp: dict, cfg: ModelConfig, x, positions, window: int,
                 cache, pos: int):
    """Returns (out, cache); the cache is updated in place."""
    if cfg.family == "ssm":
        return ssm_mod.ssm_block(mp["ssm"], cfg, x, cache=cache)
    if cfg.hybrid_parallel_heads:
        a_out, _ = attention_block(
            mp["attn"], cfg, x, positions, window=window,
            cache=cache["attn"] if cache is not None else None, pos=pos)
        s_out, _ = ssm_mod.ssm_block(
            mp["ssm"], cfg, x,
            cache=cache["ssm"] if cache is not None else None)
        out = 0.5 * (rms_norm(a_out, mp["attn_out_norm_scale"], cfg.rms_eps)
                     + rms_norm(s_out, mp["ssm_out_norm_scale"],
                                cfg.rms_eps))
        return out, cache
    return attention_block(mp["attn"], cfg, x, positions, window=window,
                           cache=cache, pos=pos)


def _block_apply(bp: dict, cfg: ModelConfig, x, positions, window: int,
                 cache, pos: int):
    """One transformer block. Returns (x, cache); the cache is updated in
    place. The FFN runs on every family, as in the reference (a reduced
    mamba2 has one); a zero-width FFN (full mamba2, ``d_ff`` 0) adds an
    exact 0 there and is skipped here."""
    h = rms_norm(x, bp["pre_norm_scale"], cfg.rms_eps)
    mix, cache = _mixer_apply(bp["mixer"], cfg, h, positions, window,
                              cache, pos)
    x = x + mix
    if cfg.d_ff:
        h2 = rms_norm(x, bp["post_norm_scale"], cfg.rms_eps)
        x = x + mlp_block(bp["ffn"]["mlp"], h2)
    return x, cache


def _conv_caches_to(tree, dtype) -> None:
    """Give the stacked SSM conv buffers the activations' dtype, in
    place in the cache dict: the reference's ``ssm_block`` returns its
    new conv state in that dtype, whatever the cache was made with, so a
    conv buffer of another dtype updated in place would round where the
    reference does not."""
    for key, val in tree.items():
        if isinstance(val, dict):
            _conv_caches_to(val, dtype)
        elif key == "conv" and val.dtype != dtype:
            tree[key] = val.to(dtype)


def forward(params: dict, cfg: ModelConfig, batch: dict, *, caches=None,
            pos: int = 0, remat: bool = False):
    """Full forward. batch keys: tokens (B,S)[, positions]. ``pos`` is the
    host position where the tokens enter the caches (0 for prefill).
    Returns (logits (B, S, V_padded), caches, aux); caches are updated in
    place, aux is 0 (no MoE). ``remat`` checkpoints each block
    (``torch.utils.checkpoint``, non-reentrant) when gradients are being
    recorded: its activations are recomputed in the backward, as the
    reference's ``jax.checkpoint`` of the scanned block does."""
    check_supported(cfg)
    tokens = batch["tokens"]
    b, s = tokens.shape
    positions = batch.get("positions")
    if positions is None:
        positions = (pos + torch.arange(s, dtype=torch.int32,
                                        device=tokens.device)
                     ).expand(b, s)
    x = params["embed"][tokens]                         # (B, S, D)
    if caches is not None:
        _conv_caches_to(caches["scan"], x.dtype)
    wins = layer_windows(cfg, cfg.num_layers)
    layers = _unstack(params["layers"], cfg.num_layers)
    checkpointed = remat and caches is None and torch.is_grad_enabled()
    for i, bp in enumerate(layers):
        if checkpointed:
            x = torch.utils.checkpoint.checkpoint(
                _remat_block, bp, x, cfg, positions, wins[i],
                use_reentrant=False)
            continue
        cache = (None if caches is None
                 else _layer(caches["scan"], i))
        x, _ = _block_apply(bp, cfg, x, positions, wins[i], cache, pos)
    x = rms_norm(x, params["final_norm_scale"], cfg.rms_eps)
    head = (params["embed"].T if cfg.tie_embeddings
            else params["lm_head"])
    logits = x @ head
    return logits, caches, torch.zeros((), dtype=torch.float32,
                                       device=x.device)


def _remat_block(bp: dict, x, cfg: ModelConfig, positions, window: int):
    """A block without caches, the function each remat checkpoint
    recomputes."""
    return _block_apply(bp, cfg, x, positions, window, None, 0)[0]


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  vocab: int) -> torch.Tensor:
    """Mean token cross entropy over the ``vocab``-wide (padded) logits,
    the reference's stable form: the max is held constant for the
    gradient, and the label's logit is picked from the shifted logits."""
    if logits.shape[-1] != vocab:
        raise ValueError(f"logits are {logits.shape[-1]} wide, the vocab "
                         f"{vocab}")
    logits = logits.to(torch.float32)
    m = torch.amax(logits, dim=-1, keepdim=True).detach()
    shifted = logits - m
    lse = torch.log(torch.sum(torch.exp(shifted), dim=-1)) + m[..., 0]
    picked = torch.gather(shifted, -1,
                          labels.long()[..., None])[..., 0] + m[..., 0]
    return torch.mean(lse - picked)


def loss_fn(params: dict, cfg: ModelConfig, batch: dict, *,
            remat: bool = False) -> torch.Tensor:
    """Cross entropy of the forward's logits against ``batch["labels"]``
    over the padded vocab (MoE's aux term comes with MoE, which
    ``check_supported`` refuses)."""
    logits, _, _ = forward(params, cfg, batch, remat=remat)
    return cross_entropy(logits, batch["labels"], cfg.padded_vocab())


# ---------------------------------------------------------------------------
# KV caches (serving)
# ---------------------------------------------------------------------------

def init_caches(cfg: ModelConfig, batch: int, max_seq: int,
                dtype=torch.bfloat16, device=None) -> dict:
    """Stacked cache pytree, the reference's keys, shapes and dtypes:
    ``{"scan": {"k": (L, B, max_seq, Hkv, hd), "v": ..., "pos": (L,)
    int32}}`` for attention, ``{"scan": {"conv": (L, B, K-1, C), "ssm":
    (L, B, nh, hd, N) f32}}`` for SSM, ``{"scan": {"attn": {...}, "ssm":
    {...}}}`` for hybrid heads. A forward gives the conv buffers the
    activations' dtype on its first step (``_conv_caches_to``)."""
    check_supported(cfg)
    dev = resolve_device(device)
    n = cfg.num_layers
    if cfg.family == "ssm":
        return {"scan": ssm_mod.init_ssm_cache(cfg, n, batch, dtype, dev)}
    shape = (n, batch, max_seq, cfg.num_kv_heads, cfg.resolved_head_dim())
    attn = {"k": torch.zeros(shape, dtype=dtype, device=dev),
            "v": torch.zeros(shape, dtype=dtype, device=dev),
            "pos": torch.zeros((n,), dtype=torch.int32, device=dev)}
    if cfg.hybrid_parallel_heads:
        return {"scan": {"attn": attn, "ssm": ssm_mod.init_ssm_cache(
            cfg, n, batch, dtype, dev)}}
    return {"scan": attn}

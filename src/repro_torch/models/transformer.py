"""Model backbone: embeds -> blocks -> norm -> lm head.

The port of ``repro/models/transformer.py`` for dense GQA decoders
(tinyllama, the qwen dense configs, ``tiny``), the SSM family
(mamba2-370m, ``tiny-ssm``: a Mamba-2 mixer, ``models/ssm.py``), hybrid
parallel heads (hymba-1.5b: attention and SSM heads on the same input,
each output RMS-normed, then averaged) and MoE decoders (phi3.5-moe: GQA
attention with a routed-expert FFN, ``models/moe.py``; deepseek-v2-lite:
MLA attention, shared experts and leading dense blocks). Parameters keep
the reference's pytree layout — nested dicts with the layer dimension
stacked first under ``"layers"``, the leading dense blocks unstacked
under ``"dense_blocks"`` — so ``convert.params_from_jax`` maps a JAX
pytree leaf for leaf. The reference scans the stack with ``lax.scan``;
here a Python loop runs the layers on views of the stacked tensors.
Training takes ``loss_fn`` (the reference's cross entropy over the
padded vocab, plus MoE's weighted aux loss) with ``remat`` checkpointing
each block.

Encoder-decoder stacks, M-RoPE and the frontend stub raise
``NotImplementedError``.
"""
from __future__ import annotations

from typing import List, Optional

import torch
import torch.utils.checkpoint

from repro_torch._device import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.models import moe as moe_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.layers import (attention_block, init_attention,
                                       init_dense, init_mla, init_mlp,
                                       mla_block, mlp_block, rms_norm)


def check_supported(cfg: ModelConfig) -> None:
    """Raise unless ``cfg`` is a dense GQA decoder, an SSM model, a
    hybrid-heads model or an MoE decoder (with GQA or MLA attention):
    the ported paths."""
    unsupported = [name for name, on in (
        (f"family {cfg.family!r}",
         cfg.family not in ("dense", "ssm", "hybrid", "moe")),
        ("encoder-decoder", cfg.enc_dec), ("M-RoPE", cfg.mrope),
        ("frontend stub", cfg.embedding_frontend_stub)) if on]
    if unsupported:
        raise NotImplementedError(
            f"{cfg.name}: {', '.join(unsupported)} not ported yet (the "
            "PyTorch port serves dense GQA decoders, SSM, hybrid-heads "
            "and MoE models)")


def _n_scanned(cfg: ModelConfig) -> int:
    """Layers of the stack: all but MoE's leading dense blocks."""
    return cfg.num_layers - (cfg.moe.first_dense_layers
                             if cfg.moe.enabled else 0)


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
    d, pv = cfg.d_model, cfg.padded_vocab()
    p = {"embed": init_dense(gen, pv, d, dtype, dev),
         "final_norm_scale": torch.ones((d,), dtype=dtype, device=dev)}
    if not cfg.tie_embeddings:
        p["lm_head"] = init_dense(gen, d, pv, dtype, dev)
    if cfg.moe.enabled and cfg.moe.first_dense_layers:
        p["dense_blocks"] = {
            str(i): _init_block(gen, cfg, dtype, dev, None, dense_ffn=True)
            for i in range(cfg.moe.first_dense_layers)}
    p["layers"] = _init_block(gen, cfg, dtype, dev, _n_scanned(cfg))
    return p


def _init_block(gen, cfg: ModelConfig, dtype, dev, n: Optional[int],
                dense_ffn: bool = False) -> dict:
    """One block's params, stacked ``(n, ...)`` (``n`` None: unstacked).
    ``dense_ffn``: an MoE model's leading dense block, a SwiGLU MLP of
    ``dense_d_ff``."""
    d = cfg.d_model
    lead = () if n is None else (n,)

    def ones():
        return torch.ones((*lead, d), dtype=dtype, device=dev)

    if cfg.family == "ssm":
        mixer = {"ssm": ssm_mod.init_ssm(gen, cfg, dtype, dev, n)}
    elif cfg.mla.enabled:
        mixer = {"mla": init_mla(gen, cfg, dtype, dev, n)}
    else:
        mixer = {"attn": init_attention(gen, cfg, dtype, dev, n)}
        if cfg.hybrid_parallel_heads:
            mixer["ssm"] = ssm_mod.init_ssm(gen, cfg, dtype, dev, n)
            mixer["attn_out_norm_scale"] = ones()
            mixer["ssm_out_norm_scale"] = ones()
    if cfg.moe.enabled and not dense_ffn:
        ffn = {"moe": moe_mod.init_moe(gen, cfg, dtype, dev, n)}
    else:
        d_ff = ((cfg.moe.dense_d_ff or cfg.d_ff) if cfg.moe.enabled
                else cfg.d_ff)
        ffn = {"mlp": init_mlp(gen, d, d_ff, dtype, dev, n)}
    return {"pre_norm_scale": ones(), "mixer": mixer,
            "post_norm_scale": ones(), "ffn": ffn}


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
    if cfg.mla.enabled:
        return mla_block(mp["mla"], cfg, x, positions, cache=cache, pos=pos)
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
    """One transformer block. Returns (x, cache, aux): the cache is
    updated in place, aux is the MoE FFN's load-balancing loss (None
    without MoE). The FFN runs on every family, as in the reference (a
    reduced mamba2 has one); a zero-width FFN (full mamba2, ``d_ff`` 0)
    adds an exact 0 there and is skipped here."""
    h = rms_norm(x, bp["pre_norm_scale"], cfg.rms_eps)
    mix, cache = _mixer_apply(bp["mixer"], cfg, h, positions, window,
                              cache, pos)
    x = x + mix
    aux = None
    if "moe" in bp["ffn"]:
        h2 = rms_norm(x, bp["post_norm_scale"], cfg.rms_eps)
        f, aux = moe_mod.moe_ffn(bp["ffn"]["moe"], cfg, h2)
        x = x + f
    elif cfg.d_ff:
        h2 = rms_norm(x, bp["post_norm_scale"], cfg.rms_eps)
        x = x + mlp_block(bp["ffn"]["mlp"], h2)
    return x, cache, aux


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
    place, aux is the MoE layers' summed load-balancing loss (0 without
    MoE). The leading dense blocks of an MoE model run first, then the
    stack. ``remat`` checkpoints each block
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
    checkpointed = remat and caches is None and torch.is_grad_enabled()
    # (block params, its cache, its window): the dense blocks, then the stack
    blocks = [(bp, None if caches is None else caches["dense"][i], 0)
              for i, bp in sorted(params.get("dense_blocks", {}).items(),
                                  key=lambda kv: int(kv[0]))]
    n = _n_scanned(cfg)
    wins = layer_windows(cfg, n)
    blocks += [(bp, None if caches is None else _layer(caches["scan"], i),
                wins[i])
               for i, bp in enumerate(_unstack(params["layers"], n))]
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    for bp, cache, window in blocks:
        if checkpointed:
            x, aux = torch.utils.checkpoint.checkpoint(
                _remat_block, bp, x, cfg, positions, window,
                use_reentrant=False)
        else:
            x, _, aux = _block_apply(bp, cfg, x, positions, window, cache,
                                     pos)
        if aux is not None:
            aux_total = aux_total + aux
    x = rms_norm(x, params["final_norm_scale"], cfg.rms_eps)
    head = (params["embed"].T if cfg.tie_embeddings
            else params["lm_head"])
    logits = x @ head
    return logits, caches, aux_total


def _remat_block(bp: dict, x, cfg: ModelConfig, positions, window: int):
    """A block without caches, the function each remat checkpoint
    recomputes: (x, aux)."""
    x, _, aux = _block_apply(bp, cfg, x, positions, window, None, 0)
    return x, aux


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
            remat: bool = False,
            aux_weight: Optional[float] = None) -> torch.Tensor:
    """Cross entropy of the forward's logits against ``batch["labels"]``
    over the padded vocab; an MoE model adds its aux loss weighted by
    ``aux_weight`` (default ``cfg.moe.aux_loss_weight``)."""
    logits, _, aux = forward(params, cfg, batch, remat=remat)
    loss = cross_entropy(logits, batch["labels"], cfg.padded_vocab())
    if cfg.moe.enabled:
        w = cfg.moe.aux_loss_weight if aux_weight is None else aux_weight
        loss = loss + w * aux
    return loss


# ---------------------------------------------------------------------------
# KV caches (serving)
# ---------------------------------------------------------------------------

def init_caches(cfg: ModelConfig, batch: int, max_seq: int,
                dtype=torch.bfloat16, device=None) -> dict:
    """Stacked cache pytree, the reference's keys, shapes and dtypes:
    ``{"scan": {"k": (L, B, max_seq, Hkv, hd), "v": ..., "pos": (L,)
    int32}}`` for attention, ``{"scan": {"c_kv": (L, B, max_seq,
    kv_lora_rank), "k_rope": (L, B, max_seq, rope_dim), "pos": (L,)}}``
    for MLA, ``{"scan": {"conv": (L, B, K-1, C), "ssm": (L, B, nh, hd, N)
    f32}}`` for SSM, ``{"scan": {"attn": {...}, "ssm": {...}}}`` for
    hybrid heads; an MoE model's leading dense blocks add ``{"dense":
    {"0": <one unstacked layer>, ...}}``. A forward gives the conv
    buffers the activations' dtype on its first step
    (``_conv_caches_to``)."""
    check_supported(cfg)
    dev = resolve_device(device)
    n = _n_scanned(cfg)
    caches = {"scan": _layer_caches(cfg, n, batch, max_seq, dtype, dev)}
    if cfg.moe.enabled and cfg.moe.first_dense_layers:
        caches["dense"] = {
            str(i): _layer_caches(cfg, None, batch, max_seq, dtype, dev)
            for i in range(cfg.moe.first_dense_layers)}
    return caches


def _layer_caches(cfg: ModelConfig, n: Optional[int], batch: int,
                  max_seq: int, dtype, dev) -> dict:
    """The caches of ``n`` stacked layers (``n`` None: one unstacked)."""
    lead = () if n is None else (n,)

    def zeros(*shape, dt=dtype):
        return torch.zeros((*lead, *shape), dtype=dt, device=dev)

    if cfg.family == "ssm":
        return ssm_mod.init_ssm_cache(cfg, n, batch, dtype, dev)
    if cfg.mla.enabled:
        m = cfg.mla
        return {"c_kv": zeros(batch, max_seq, m.kv_lora_rank),
                "k_rope": zeros(batch, max_seq, m.qk_rope_head_dim),
                "pos": zeros(dt=torch.int32)}
    hd = cfg.resolved_head_dim()
    attn = {"k": zeros(batch, max_seq, cfg.num_kv_heads, hd),
            "v": zeros(batch, max_seq, cfg.num_kv_heads, hd),
            "pos": zeros(dt=torch.int32)}
    if cfg.hybrid_parallel_heads:
        return {"attn": attn, "ssm": ssm_mod.init_ssm_cache(
            cfg, n, batch, dtype, dev)}
    return attn

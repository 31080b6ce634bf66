"""Model backbone: embeds -> blocks -> norm -> lm head.

The port of ``repro/models/transformer.py`` for dense GQA decoders
(tinyllama, the qwen dense configs, ``tiny``), the SSM family
(mamba2-370m, ``tiny-ssm``: a Mamba-2 mixer, ``models/ssm.py``), hybrid
parallel heads (hymba-1.5b: attention and SSM heads on the same input,
each output RMS-normed, then averaged) and MoE decoders (phi3.5-moe: GQA
attention with a routed-expert FFN, ``models/moe.py``; deepseek-v2-lite:
MLA attention, shared experts and leading dense blocks), the
encoder-decoder stack (seamless-m4t: a non-causal encoder over the
frontend stub's frame embeddings ``enc_embeds``, a decoder with
cross-attention onto its output) and vision-language decoders
(qwen2-vl: M-RoPE over (t, h, w) ids, ``patch_embeds`` merged over the
first token embeddings). Parameters keep the reference's pytree layout
— nested dicts with the layer dimension stacked first under
``"layers"`` (``"enc_layers"`` and ``"dec_layers"`` for enc-dec), the
leading dense blocks unstacked under ``"dense_blocks"`` — so
``convert.params_from_jax`` maps a JAX pytree leaf for leaf. The
reference scans the stack with ``lax.scan``; here a Python loop runs
the layers on views of the stacked tensors.
Training takes ``loss_fn`` (the reference's cross entropy over the
padded vocab, plus MoE's weighted aux loss) with ``remat`` checkpointing
each block.

As in the reference, the encoder runs on every call, decode steps
included: its output and the cross K/V are not cached.
"""
from __future__ import annotations

from typing import List, Optional

import torch
import torch.utils.checkpoint

from repro_torch._device import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.models import moe as moe_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.layers import (attention_block, attention_core,
                                       init_attention, init_dense, init_mla,
                                       init_mlp, mla_block, mlp_block,
                                       rms_norm)


FAMILIES = ("dense", "ssm", "hybrid", "moe", "vlm", "audio")


def check_supported(cfg: ModelConfig) -> None:
    """Raise unless ``cfg`` is of one of the registry's families
    (``FAMILIES``)."""
    if cfg.family not in FAMILIES:
        raise NotImplementedError(
            f"{cfg.name}: family {cfg.family!r} not ported (the PyTorch "
            f"port runs {', '.join(FAMILIES)})")


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
    ``device`` (``None`` -> the GPU; a CPU generator for ``meta``, which
    has none and draws nothing). The numbers differ from the JAX
    package's for the same seed; ``convert.params_from_jax`` carries a
    JAX pytree over instead."""
    check_supported(cfg)
    dev = resolve_device(device)
    gen = torch.Generator(device="cpu" if dev.type == "meta" else dev)
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
    if cfg.enc_dec:
        p["enc_layers"] = _init_block(gen, cfg, dtype, dev,
                                      cfg.encoder_layers)
        p["dec_layers"] = _init_block(gen, cfg, dtype, dev, cfg.num_layers,
                                      cross_attn=True)
    else:
        p["layers"] = _init_block(gen, cfg, dtype, dev, _n_scanned(cfg))
    return p


def _init_block(gen, cfg: ModelConfig, dtype, dev, n: Optional[int],
                dense_ffn: bool = False, cross_attn: bool = False) -> dict:
    """One block's params, stacked ``(n, ...)`` (``n`` None: unstacked).
    ``dense_ffn``: an MoE model's leading dense block, a SwiGLU MLP of
    ``dense_d_ff``. ``cross_attn``: a decoder block of an enc-dec stack,
    with a cross-attention onto the encoder's output."""
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
    p = {"pre_norm_scale": ones(), "mixer": mixer,
         "post_norm_scale": ones(), "ffn": ffn}
    if cross_attn:
        p["cross_norm_scale"] = ones()
        p["cross"] = init_attention(gen, cfg, dtype, dev, n)
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
                 cache, pos: int, causal: bool = True,
                 mrope_positions=None):
    """Returns (out, cache); the cache is updated in place. ``causal``
    (the encoder's False) and M-RoPE reach the plain attention mixer
    only, as in the reference; an enc-dec decoder block's cache is
    ``{"self": {...}}``."""
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
    if isinstance(cache, dict) and "self" in cache:
        cache = cache["self"]
    return attention_block(mp["attn"], cfg, x, positions, causal=causal,
                           window=window, cache=cache, pos=pos,
                           mrope_positions=mrope_positions)


def _cross_attention(params: dict, cfg: ModelConfig, x, enc_out):
    """Cross-attention: q from the decoder's ``x``, k and v from the
    encoder's output; no rope, no bias, not causal, from no cache (K6
    over the encoder's frames)."""
    b, s, _ = x.shape
    se = enc_out.shape[1]
    hd = cfg.resolved_head_dim()
    q = (x @ params["wq"]).reshape(b, s, cfg.num_heads, hd)
    k = (enc_out @ params["wk"]).reshape(b, se, cfg.num_kv_heads, hd)
    v = (enc_out @ params["wv"]).reshape(b, se, cfg.num_kv_heads, hd)
    out = attention_core(q, k, v, causal=False)
    return out.reshape(b, s, cfg.num_heads * hd) @ params["wo"]


def _block_apply(bp: dict, cfg: ModelConfig, x, positions, window: int,
                 cache, pos: int, mrope_positions=None, enc_out=None,
                 causal: bool = True):
    """One transformer block. Returns (x, cache, aux): the cache is
    updated in place, aux is the MoE FFN's load-balancing loss (None
    without MoE). With ``enc_out`` (an enc-dec decoder block), a
    cross-attention onto it follows the mixer. The FFN runs on every
    family, as in the reference (a reduced mamba2 has one); a zero-width
    FFN (full mamba2, ``d_ff`` 0) adds an exact 0 there and is skipped
    here."""
    h = rms_norm(x, bp["pre_norm_scale"], cfg.rms_eps)
    mix, cache = _mixer_apply(bp["mixer"], cfg, h, positions, window,
                              cache, pos, causal, mrope_positions)
    x = x + mix
    if enc_out is not None:
        hc = rms_norm(x, bp["cross_norm_scale"], cfg.rms_eps)
        x = x + _cross_attention(bp["cross"], cfg, hc, enc_out)
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


def embed_inputs(params: dict, cfg: ModelConfig, batch: dict
                 ) -> torch.Tensor:
    """Token embeddings, with the frontend stub's ``embeds`` passed
    through (no ``enc_embeds`` given) and a VLM's ``patch_embeds`` (B, P,
    D) over the first P positions."""
    if cfg.embedding_frontend_stub and "enc_embeds" not in batch \
            and "embeds" in batch:
        return batch["embeds"]
    x = params["embed"][batch["tokens"]]                # (B, S, D)
    if cfg.mrope and "patch_embeds" in batch:
        pe = batch["patch_embeds"].to(x.dtype)
        x = torch.cat([pe, x[:, pe.shape[1]:]], dim=1)
    return x


def _run_stack(blocks, cfg: ModelConfig, x, positions, checkpointed: bool,
               pos: int = 0, mrope_positions=None, enc_out=None,
               causal: bool = True):
    """``blocks`` ((block params, its cache, its window), ...) in turn.
    Returns (x, the MoE layers' summed aux, 0 without MoE)."""
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    for bp, cache, window in blocks:
        if checkpointed:
            x, aux = torch.utils.checkpoint.checkpoint(
                _remat_block, bp, x, cfg, positions, window,
                mrope_positions, enc_out, causal, use_reentrant=False)
        else:
            x, _, aux = _block_apply(bp, cfg, x, positions, window, cache,
                                     pos, mrope_positions, enc_out, causal)
        if aux is not None:
            aux_total = aux_total + aux
    return x, aux_total


def encode(params: dict, cfg: ModelConfig, enc_embeds: torch.Tensor, *,
           checkpointed: bool = False) -> torch.Tensor:
    """The enc-dec encoder over the frontend stub's frame embeddings (B,
    S_enc, D), in the parameters' dtype: not causal, no cache, RoPE over
    0..S_enc-1, no final norm."""
    b, se = enc_embeds.shape[:2]
    x = enc_embeds.to(params["embed"].dtype)
    positions = torch.arange(se, dtype=torch.int32,
                             device=x.device).expand(b, se)
    n = cfg.encoder_layers
    blocks = zip(_unstack(params["enc_layers"], n), [None] * n,
                 layer_windows(cfg, n))
    x, _ = _run_stack(blocks, cfg, x, positions, checkpointed, causal=False)
    return x


def forward(params: dict, cfg: ModelConfig, batch: dict, *, caches=None,
            pos: int = 0, remat: bool = False):
    """Full forward. batch keys: tokens (B,S)[, positions,
    mrope_positions (3,B,S), patch_embeds (B,P,D), enc_embeds
    (B,S_enc,D), embeds]. ``pos`` is the host position where the tokens
    enter the caches (0 for prefill). Returns (logits (B, S, V_padded),
    caches, aux); caches are updated in place, aux is the MoE layers'
    summed load-balancing loss (0 without MoE). An enc-dec model runs its
    encoder first, on every call; the leading dense blocks of an MoE
    model run before the stack. ``remat`` checkpoints each block
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
    mrope_positions = batch.get("mrope_positions")
    checkpointed = remat and caches is None and torch.is_grad_enabled()
    enc_out = (encode(params, cfg, batch["enc_embeds"],
                      checkpointed=checkpointed) if cfg.enc_dec else None)
    x = embed_inputs(params, cfg, batch)
    if caches is not None:
        _conv_caches_to(caches["scan"], x.dtype)
    # (block params, its cache, its window): the dense blocks, then the stack
    blocks = [(bp, None if caches is None else caches["dense"][i], 0)
              for i, bp in sorted(params.get("dense_blocks", {}).items(),
                                  key=lambda kv: int(kv[0]))]
    n = _n_scanned(cfg)
    wins = layer_windows(cfg, n)
    stack = _unstack(params["dec_layers" if cfg.enc_dec else "layers"], n)
    blocks += [(bp, None if caches is None else _layer(caches["scan"], i),
                wins[i]) for i, bp in enumerate(stack)]
    x, aux_total = _run_stack(blocks, cfg, x, positions, checkpointed, pos,
                              mrope_positions, enc_out)
    x = rms_norm(x, params["final_norm_scale"], cfg.rms_eps)
    head = (params["embed"].T if cfg.tie_embeddings
            else params["lm_head"])
    logits = x @ head
    return logits, caches, aux_total


def _remat_block(bp: dict, x, cfg: ModelConfig, positions, window: int,
                 mrope_positions=None, enc_out=None, causal: bool = True):
    """A block without caches, the function each remat checkpoint
    recomputes: (x, aux)."""
    x, _, aux = _block_apply(bp, cfg, x, positions, window, None, 0,
                             mrope_positions, enc_out, causal)
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
    hybrid heads, ``{"scan": {"self": {"k", "v", "pos"}}}`` for an
    enc-dec decoder (the encoder keeps no cache); an MoE model's leading
    dense blocks add ``{"dense": {"0": <one unstacked layer>, ...}}``. A
    forward gives the conv buffers the activations' dtype on its first
    step (``_conv_caches_to``)."""
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
    if cfg.enc_dec:
        return {"self": attn}
    return attn

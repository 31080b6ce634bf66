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
each block under the reference's policy (``set_remat_policy``: ``full``
recomputes the whole block, ``dots`` keeps the outputs of its matrix
products without batch dims, ``none`` checkpoints nothing).

As in the reference, the encoder runs on every call, decode steps
included: its output and the cross K/V are not cached.

Given a ``sharding.TensorParallel`` (``tp=``), ``forward``, ``loss_fn``
and the serving steps run as one rank of the ``model`` axis on that
rank's cut of the parameters (``init_params(tp_rank=, tp_size=)`` draws
one, ``sharding.shard_tree`` cuts a whole tree) and of the caches
(``init_caches(tp_size=)``): the embedding vocab-parallel, the residual
cut by sequence under sequence parallelism, the logits vocab-parallel
(B, S, V_padded / tp) and ``cross_entropy`` reduced over the group (a
padded vocab the axis does not divide whole on every rank, and every
other leaf that does not divide it too, as ``models/sharding.py`` runs
them); MoE
expert-parallel, MLA head-parallel or by rows, the Mamba-2 mixer on its
column, conv and row cuts (``models/ssm.py``), hybrid heads with both
mixers cut, and the enc-dec encoder over its own residual, its output gathered
whole once for the decoder's cross-attention (``models/sharding.py``).
Every family (``sharding.model_axis_sharded``).
"""
from __future__ import annotations

from typing import List, Optional

import contextlib
import functools

import torch
import torch.utils.checkpoint
from torch.utils.checkpoint import (CheckpointPolicy,
                                    create_selective_checkpoint_contexts)

from repro_torch._device import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.models import moe as moe_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models import sharding
from repro_torch.models.layers import (_attention_hd_cut, _tp_in,
                                       _tp_o_proj, _tp_qkv,
                                       attention_block, attention_core,
                                       init_attention, init_dense, init_mla,
                                       init_mlp, mla_block, mlp_block,
                                       output_unneeded, rms_norm)
from repro_torch.roofline.count import in_hand_kernel


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
                device=None, *, tp_rank: int = 0, tp_size: int = 1) -> dict:
    """Random parameters in the reference's layout and distributions
    (``init_dense``: N(0, 1) * sqrt(2 / (d_in + d_out)); norm scales 1,
    biases 0), drawn from a ``torch.Generator`` seeded with ``seed`` on
    ``device`` (``None`` -> the GPU; a CPU generator for ``meta``, which
    has none and draws nothing). The numbers differ from the JAX
    package's for the same seed; ``convert.params_from_jax`` carries a
    JAX pytree over instead. With ``tp_size`` over 1, rank ``tp_rank``'s
    cut (``sharding.model_specs``) drawn at its own shape, so that no
    whole leaf is ever allocated (``_init_cut``)."""
    check_supported(cfg)
    dev = resolve_device(device)
    if tp_size > 1:
        return _init_cut(cfg, seed, dtype, dev, tp_rank, tp_size)
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


def _init_cut(cfg: ModelConfig, seed: int, dtype, dev, rank: int,
              tp: int) -> dict:
    """Rank ``rank`` of ``tp``'s cut of a model's parameters, each leaf
    drawn at the cut's shape from one generator in leaf order: a matrix
    (an expert stack's ``(layers, E / tp, d_in, d_out)`` too) N(0, 1) *
    sqrt(2 / (d_in + d_out)) of the whole leaf's last two dims, a norm
    scale 1, a bias 0, the router in f32; the SSM's ``conv_w`` N(0, 1) /
    sqrt(d_conv), ``a_log`` log(linspace(1, 16, nh)), ``d_skip`` 1 and
    ``dt_bias`` 0 in f32 (``init_params``' distributions and dtypes; the
    draws are not a cut of the whole draw)."""
    sharding.check_model_axis(cfg, tp)
    whole, specs = sharding.whole_specs(cfg, tp)
    gen = torch.Generator(device="cpu" if dev.type == "meta" else dev)
    gen.manual_seed(seed)

    def draw(path, x, spec):
        shape = sharding.cut_shape(x.shape, spec, tp)
        name = path.split("/")[-1]
        f32 = torch.float32
        if name == "a_log":
            return torch.log(torch.linspace(1.0, 16.0, shape[-1],
                                            dtype=f32, device=dev)
                             ).expand(shape).clone()
        if name in ("d_skip", "dt_bias"):
            return (torch.ones if name == "d_skip" else torch.zeros)(
                shape, dtype=f32, device=dev)
        if name.endswith("scale"):
            return torch.ones(shape, dtype=dtype, device=dev)
        if name.startswith("b_"):
            return torch.zeros(shape, dtype=dtype, device=dev)
        scale = ((1.0 / x.shape[-2]) ** 0.5 if name == "conv_w" else
                 (2.0 / (x.shape[-2] + x.shape[-1])) ** 0.5)
        return torch.randn(shape, generator=gen, dtype=torch.float32,
                           device=dev).mul_(scale).to(
            torch.float32 if name == "router" else dtype)

    out: dict = {}
    for (path, x), (_, spec) in zip(sharding._leaf_paths(whole, ""),
                                    sharding._leaf_paths(specs, "")):
        sharding._set(out, path.split("/"), draw(path, x, spec))
    return out


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
        ffn = {"mlp": init_mlp(gen, d, _mlp_width(cfg), dtype, dev, n)}
    p = {"pre_norm_scale": ones(), "mixer": mixer,
         "post_norm_scale": ones(), "ffn": ffn}
    if cross_attn:
        p["cross_norm_scale"] = ones()
        p["cross"] = init_attention(gen, cfg, dtype, dev, n)
    return p


def _mlp_width(cfg: ModelConfig) -> int:
    """The hidden width of a block's SwiGLU MLP: an MoE model's leading
    dense blocks take ``dense_d_ff``."""
    return ((cfg.moe.dense_d_ff or cfg.d_ff) if cfg.moe.enabled
            else cfg.d_ff)


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
                 mrope_positions=None, tp=None):
    """Returns (out, cache); the cache is updated in place. ``causal``
    (the encoder's False) and M-RoPE reach the plain attention mixer
    only, as in the reference; an enc-dec decoder block's cache is
    ``{"self": {...}}``."""
    if cfg.family == "ssm":
        return ssm_mod.ssm_block(mp["ssm"], cfg, x, cache=cache, tp=tp)
    if cfg.mla.enabled:
        return mla_block(mp["mla"], cfg, x, positions, cache=cache, pos=pos,
                         tp=tp)
    if cfg.hybrid_parallel_heads:
        # with ``tp`` each branch's output is reduced into the residual's
        # layout before its norm, which is not linear
        a_out, _ = attention_block(
            mp["attn"], cfg, x, positions, window=window,
            cache=cache["attn"] if cache is not None else None, pos=pos,
            tp=tp)
        s_out, _ = ssm_mod.ssm_block(
            mp["ssm"], cfg, x,
            cache=cache["ssm"] if cache is not None else None, tp=tp)
        out = 0.5 * (rms_norm(a_out, mp["attn_out_norm_scale"], cfg.rms_eps)
                     + rms_norm(s_out, mp["ssm_out_norm_scale"],
                                cfg.rms_eps))
        return out, cache
    if isinstance(cache, dict) and "self" in cache:
        cache = cache["self"]
    return attention_block(mp["attn"], cfg, x, positions, causal=causal,
                           window=window, cache=cache, pos=pos,
                           mrope_positions=mrope_positions, tp=tp)


def _cross_attention(params: dict, cfg: ModelConfig, x, enc_out, tp=None):
    """Cross-attention: q from the decoder's ``x``, k and v from the
    encoder's output; no rope, no bias, not causal, from no cache (K6
    over the encoder's frames). With ``tp``, one rank's share: ``x`` in
    the residual's layout, ``enc_out`` whole on every rank (``encode``'s),
    ``wq``, ``wk``, ``wv`` column-cut and ``wo`` row-cut, or whole where
    their widths do not divide the axis; the rank's heads where they
    divide the axis, else its rows of q (every head, the sequence
    dividing the axis) or all of q (a decode step's row) against k and v
    gathered whole, or the rank's cut of the head dims with
    ``qkv_sharding`` off, as ``layers._attention_block_tp`` runs."""
    sharded = sharding.active(tp)
    hd = cfg.resolved_head_dim()
    hq, hkv = cfg.num_heads, cfg.num_kv_heads
    if sharded:
        q, k, v, mode = _tp_qkv(params, _tp_in(x, tp), enc_out, hq, hkv, hd,
                                False, tp)
        if mode == "heads":
            hq, hkv = hq // tp.size, hkv // tp.size
    else:
        q, k, v = (x @ params["wq"], enc_out @ params["wk"],
                   enc_out @ params["wv"])
    b, sq = q.shape[:2]
    se = enc_out.shape[1]
    q, k, v = (q.reshape(b, sq, hq, hd), k.reshape(b, se, hkv, hd),
               v.reshape(b, se, hkv, hd))
    if sharded and mode == "hd":
        out = _attention_hd_cut(q, tp.cut(k, 3), tp.cut(v, 3), tp,
                                causal=False, window=0, q_offset=0,
                                kv_len=None)
    else:
        out = attention_core(q, k, v, causal=False)
    out = out.reshape(b, sq, hq * hd)
    if not sharded:
        return out @ params["wo"]
    return _tp_o_proj(out, params["wo"], mode, tp)


def _block_apply(bp: dict, cfg: ModelConfig, x, positions, window: int,
                 cache, pos: int, mrope_positions=None, enc_out=None,
                 causal: bool = True, tp=None):
    """One transformer block. Returns (x, cache, aux): the cache is
    updated in place, aux is the MoE FFN's load-balancing loss (None
    without MoE). With ``enc_out`` (an enc-dec decoder block), a
    cross-attention onto it follows the mixer. The FFN runs on every
    family, as in the reference (a reduced mamba2 has one); a zero-width
    FFN (full mamba2, ``d_ff`` 0) adds an exact 0 there and is skipped
    here. With ``tp`` the norms run on the residual's layout (a rank's
    rows under sequence parallelism) and the mixer and MLP gather and
    reduce it themselves."""
    h = rms_norm(x, bp["pre_norm_scale"], cfg.rms_eps)
    mix, cache = _mixer_apply(bp["mixer"], cfg, h, positions, window,
                              cache, pos, causal, mrope_positions, tp)
    x = x + mix
    if enc_out is not None:
        hc = rms_norm(x, bp["cross_norm_scale"], cfg.rms_eps)
        x = x + _cross_attention(bp["cross"], cfg, hc, enc_out, tp)
    aux = None
    if "moe" in bp["ffn"]:
        h2 = rms_norm(x, bp["post_norm_scale"], cfg.rms_eps)
        f, aux = moe_mod.moe_ffn(bp["ffn"]["moe"], cfg, h2, tp)
        x = x + f
    elif cfg.d_ff:
        h2 = rms_norm(x, bp["post_norm_scale"], cfg.rms_eps)
        mlp = bp["ffn"]["mlp"]
        # a hidden width the axis does not divide: the whole MLP on the
        # residual's layout, no collective (``mlp_block``)
        cut = sharding.active(tp) and tp.divides(_mlp_width(cfg))
        x = x + mlp_block(mlp, h2, tp if cut else None)
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


def embed_inputs(params: dict, cfg: ModelConfig, batch: dict, tp=None
                 ) -> torch.Tensor:
    """Token embeddings, with the frontend stub's ``embeds`` passed
    through (no ``enc_embeds`` given) and a VLM's ``patch_embeds`` (B, P,
    D) over the first P positions. With ``tp`` the table is this rank's
    rows of the vocab: tokens outside them embed to 0, and the partial
    embeddings are reduced into the residual's layout (reduce-scattered
    by sequence under sequence parallelism, then the patches merged over
    the rank's rows that fall among the first P). A padded vocab the
    axis does not divide is whole on every rank, which embeds the
    residual's rows itself."""
    if cfg.embedding_frontend_stub and "enc_embeds" not in batch \
            and "embeds" in batch:
        return batch["embeds"]
    tokens = batch["tokens"]
    if sharding.active(tp) and not tp.divides(cfg.padded_vocab()):
        # a vocab the axis does not divide: the whole table on every
        # rank, its rows of the residual embedded
        lo = tp.rank * (tokens.shape[1] // tp.size) if tp.seq_cut else 0
        x = params["embed"][tp.cut(tokens, 1) if tp.seq_cut else tokens]
    elif sharding.active(tp):
        table = params["embed"]
        rows = table.shape[0]
        ids = tokens - tp.rank * rows
        mine = (ids >= 0) & (ids < rows)
        x = table[ids.clamp(0, rows - 1)] * mine[..., None].to(table.dtype)
        x = tp.scatter(x, 1) if tp.seq_cut else tp.reduce(x)
        lo = tp.rank * x.shape[1] if tp.seq_cut else 0
    else:
        x = params["embed"][tokens]                     # (B, S, D)
        lo = 0
    if cfg.mrope and "patch_embeds" in batch:
        pe = batch["patch_embeds"].to(x.dtype)
        p = min(max(pe.shape[1] - lo, 0), x.shape[1])
        if p:
            x = torch.cat([pe[:, lo:lo + p], x[:, p:]], dim=1)
    return x


# Activation checkpointing of the stack (the reference's knob,
# ``repro/models/transformer.py``):
#   full -- every block recomputed whole in the backward
#   dots -- the outputs of its matrix products without batch dims kept
#           (``dots_with_no_batch_dims_saveable``), the rest recomputed
#   none -- no checkpoint
_REMAT_POLICY = "full"

#: the products without batch dims: ``x @ W`` of an activation and a
#: weight matrix lowers to these (a 3-D ``x`` folded to 2-D); attention's
#: and the MoE experts' einsums are ``bmm`` / ``baddbmm``, with batch dims
_SAVED_DOTS = frozenset({torch.ops.aten.mm.default,
                         torch.ops.aten.addmm.default})


def set_remat_policy(name: str) -> None:
    global _REMAT_POLICY
    assert name in ("full", "dots", "none"), name
    _REMAT_POLICY = name


def get_remat_policy() -> str:
    return _REMAT_POLICY


@contextlib.contextmanager
def remat_policy(name: str):
    """``set_remat_policy(name)`` inside the ``with`` block; the policy
    found on entry is restored on exit, also when the block raises."""
    before = _REMAT_POLICY
    set_remat_policy(name)
    try:
        yield
    finally:
        set_remat_policy(before)


def dots_policy(ctx, op, *args, **kwargs) -> CheckpointPolicy:
    """The selective-checkpoint policy of ``"dots"``: the output of a
    product without batch dims (``_SAVED_DOTS``) is kept from the forward
    for the recompute, every other op recomputed, as JAX's
    ``dots_with_no_batch_dims_saveable`` decides. Two exceptions keep the
    kept set the reference's: the ops a hand kernel's wrapper runs
    (``roofline.count.in_hand_kernel``: K6 and K7 are one op each in the
    reference, and on the card their launches are invisible to the
    dispatcher, so they are recomputed on every device alike), and a
    product whose output no backward reads (``layers.output_unneeded``:
    the down projection of an MLP, summed into the residual), which the
    reference's partial evaluation drops and the recompute never reaches.
    Decided from the op and the flags alone, so the forward and the
    recompute decide alike."""
    if op in _SAVED_DOTS and not in_hand_kernel() and not output_unneeded():
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _checkpoint_kwargs() -> dict:
    """``torch.utils.checkpoint.checkpoint``'s options under the policy:
    non-reentrant, and under ``"dots"`` the selective contexts of
    ``dots_policy`` (looked up when called)."""
    kw = {"use_reentrant": False}
    if _REMAT_POLICY == "dots":
        kw["context_fn"] = functools.partial(
            create_selective_checkpoint_contexts, dots_policy)
    return kw


def _run_stack(blocks, cfg: ModelConfig, x, positions, checkpointed: bool,
               pos: int = 0, mrope_positions=None, enc_out=None,
               causal: bool = True, tp=None):
    """``blocks`` ((block params, its cache, its window), ...) in turn,
    each checkpointed under the remat policy with ``checkpointed``.
    Returns (x, the MoE layers' summed aux, 0 without MoE)."""
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    kw = _checkpoint_kwargs() if checkpointed else {}
    for bp, cache, window in blocks:
        if checkpointed:
            x, aux = torch.utils.checkpoint.checkpoint(
                _remat_block, bp, x, cfg, positions, window,
                mrope_positions, enc_out, causal, tp, **kw)
        else:
            x, _, aux = _block_apply(bp, cfg, x, positions, window, cache,
                                     pos, mrope_positions, enc_out, causal,
                                     tp)
        if aux is not None:
            aux_total = aux_total + aux
    return x, aux_total


def encode(params: dict, cfg: ModelConfig, enc_embeds: torch.Tensor, *,
           checkpointed: bool = False, tp=None) -> torch.Tensor:
    """The enc-dec encoder over the frontend stub's frame embeddings (B,
    S_enc, D), in the parameters' dtype: not causal, no cache, RoPE over
    0..S_enc-1, no final norm. With ``tp``, one rank's share over the
    encoder's own residual (cut by sequence under sequence parallelism
    when S_enc divides the axis), and the output whole on every rank, as
    the rank's share of every cross-attention reads it (gathered once;
    its gradient summed over the group)."""
    b, se = enc_embeds.shape[:2]
    x = enc_embeds.to(params["embed"].dtype)
    if sharding.active(tp):
        tp = tp.for_seq(se)
        if tp.seq_cut:
            x = tp.cut(x, 1)
    positions = torch.arange(se, dtype=torch.int32,
                             device=x.device).expand(b, se)
    n = cfg.encoder_layers
    blocks = zip(_unstack(params["enc_layers"], n), [None] * n,
                 layer_windows(cfg, n))
    x, _ = _run_stack(blocks, cfg, x, positions, checkpointed, causal=False,
                      tp=tp)
    return _tp_in(x, tp) if sharding.active(tp) else x


def forward(params: dict, cfg: ModelConfig, batch: dict, *, caches=None,
            pos: int = 0, remat: bool = False, tp=None):
    """Full forward. batch keys: tokens (B,S)[, positions,
    mrope_positions (3,B,S), patch_embeds (B,P,D), enc_embeds
    (B,S_enc,D), embeds]. ``pos`` is the host position where the tokens
    enter the caches (0 for prefill). Returns (logits (B, S, V_padded),
    caches, aux); caches are updated in place, aux is the MoE layers'
    summed load-balancing loss (0 without MoE). An enc-dec model runs its
    encoder first, on every call; the leading dense blocks of an MoE
    model run before the stack. ``remat`` checkpoints each block
    (``torch.utils.checkpoint``, non-reentrant) when gradients are being
    recorded, under the remat policy (``set_remat_policy``; ``"none"``
    checkpoints nothing): its activations, or under ``"dots"`` all but
    its products' outputs, are recomputed in the backward, as the
    reference's ``jax.checkpoint`` of the scanned block does. With ``tp``
    (a ``sharding.TensorParallel``) this is one rank's share on its cut
    of ``params`` and ``caches``, and the logits are its cut of the
    vocab, (B, S, V_padded / tp), or all of it, (B, S, V_padded), where
    the padded vocab does not divide the axis (the embedding and head
    are then whole on every rank)."""
    check_supported(cfg)
    tokens = batch["tokens"]
    b, s = tokens.shape
    if sharding.active(tp):
        sharding.check_model_axis(cfg, tp.size)
        tp = tp.for_seq(s)
    positions = batch.get("positions")
    if positions is None:
        positions = (pos + torch.arange(s, dtype=torch.int32,
                                        device=tokens.device)
                     ).expand(b, s)
    mrope_positions = batch.get("mrope_positions")
    checkpointed = (remat and _REMAT_POLICY != "none" and caches is None
                    and torch.is_grad_enabled())
    enc_out = (encode(params, cfg, batch["enc_embeds"],
                      checkpointed=checkpointed, tp=tp)
               if cfg.enc_dec else None)
    x = embed_inputs(params, cfg, batch, tp)
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
                              mrope_positions, enc_out, tp=tp)
    x = rms_norm(x, params["final_norm_scale"], cfg.rms_eps)
    head = (params["embed"].T if cfg.tie_embeddings
            else params["lm_head"])
    if not sharding.active(tp):
        return x @ head, caches, aux_total
    if not tp.divides(cfg.padded_vocab()):
        # a whole head on the residual's rows: the whole vocab's logits
        # of every row on every rank
        logits = x @ head
        return (tp.join(logits, 1) if tp.seq_cut else logits), caches, \
            aux_total
    # the column-parallel head over every row: the logits stay
    # vocab-parallel
    x = tp.gather(x, 1) if tp.seq_cut else tp.copy(x)
    return x @ head, caches, aux_total


def _remat_block(bp: dict, x, cfg: ModelConfig, positions, window: int,
                 mrope_positions=None, enc_out=None, causal: bool = True,
                 tp=None):
    """A block without caches, the function each remat checkpoint
    recomputes: (x, aux)."""
    x, _, aux = _block_apply(bp, cfg, x, positions, window, None, 0,
                             mrope_positions, enc_out, causal, tp)
    return x, aux


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  vocab: int, tp=None) -> torch.Tensor:
    """Mean token cross entropy over the ``vocab``-wide (padded) logits,
    the reference's stable form: the max is held constant for the
    gradient, and the label's logit is picked from the shifted logits.
    With ``tp`` the logits are this rank's cut of the vocab: the max is
    an all-reduce max, and the sum of exps and the picked logit (0 on
    every rank but the label's) are summed over the group, so no rank
    forms the whole vocab; whole logits (a vocab that does not divide
    the axis: ``forward``'s) are every rank's alike, with no
    collective."""
    n = tp.size if sharding.active(tp) else 1
    if logits.shape[-1] == vocab:
        n = 1
    if logits.shape[-1] * n != vocab:
        raise ValueError(f"logits are {logits.shape[-1]} wide on each of "
                         f"{n} ranks, the vocab {vocab}")
    logits = logits.to(torch.float32)
    m = torch.amax(logits, dim=-1, keepdim=True).detach()
    if n > 1:
        m = tp.all_reduce(m.clone(), "max")
    shifted = logits - m
    sum_exp = torch.sum(torch.exp(shifted), dim=-1)
    ids = labels.long()
    if n > 1:
        ids = ids - tp.rank * logits.shape[-1]
        mine = (ids >= 0) & (ids < logits.shape[-1])
        ids = ids.clamp(0, logits.shape[-1] - 1)
    picked = torch.gather(shifted, -1, ids[..., None])[..., 0]
    if n > 1:
        sum_exp = tp.reduce(sum_exp)
        picked = tp.reduce(picked * mine)
    lse = torch.log(sum_exp) + m[..., 0]
    return torch.mean(lse - (picked + m[..., 0]))


def loss_fn(params: dict, cfg: ModelConfig, batch: dict, *,
            remat: bool = False, aux_weight: Optional[float] = None,
            tp=None) -> torch.Tensor:
    """Cross entropy of the forward's logits against ``batch["labels"]``
    over the padded vocab; an MoE model adds its aux loss weighted by
    ``aux_weight`` (default ``cfg.moe.aux_loss_weight``). With ``tp``,
    one rank's share: every rank of the group returns the whole loss."""
    logits, _, aux = forward(params, cfg, batch, remat=remat, tp=tp)
    loss = cross_entropy(logits, batch["labels"], cfg.padded_vocab(), tp)
    if cfg.moe.enabled:
        w = cfg.moe.aux_loss_weight if aux_weight is None else aux_weight
        loss = loss + w * aux
    return loss


# ---------------------------------------------------------------------------
# KV caches (serving)
# ---------------------------------------------------------------------------

def init_caches(cfg: ModelConfig, batch: int, max_seq: int,
                dtype=torch.bfloat16, device=None, tp_size: int = 1) -> dict:
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
    step (``_conv_caches_to``). With ``tp_size`` over 1 a rank's cut: K
    and V hold ``hd / tp_size`` of the head dim, MLA's latent and rope
    key ``1 / tp_size`` of their feature dims, the SSM's conv its
    channels and its state its head dim, each where it divides, as
    ``launch.specs.cache_partition_specs`` cuts them."""
    check_supported(cfg)
    dev = resolve_device(device)
    n = _n_scanned(cfg)
    if tp_size <= 1 or not sharding.model_axis_sharded(cfg):
        tp_size = 1
    caches = {"scan": _layer_caches(cfg, n, batch, max_seq, dtype, dev,
                                    tp_size)}
    if cfg.moe.enabled and cfg.moe.first_dense_layers:
        caches["dense"] = {
            str(i): _layer_caches(cfg, None, batch, max_seq, dtype, dev,
                                  tp_size)
            for i in range(cfg.moe.first_dense_layers)}
    return caches


def _layer_caches(cfg: ModelConfig, n: Optional[int], batch: int,
                  max_seq: int, dtype, dev, tp_size: int) -> dict:
    """The caches of ``n`` stacked layers (``n`` None: one unstacked),
    each feature dim cut to ``1 / tp_size`` where it divides."""
    lead = () if n is None else (n,)

    def cut(dim):
        return dim // tp_size if dim % tp_size == 0 else dim

    def zeros(*shape, dt=dtype):
        return torch.zeros((*lead, *shape), dtype=dt, device=dev)

    if cfg.family == "ssm":
        return ssm_mod.init_ssm_cache(cfg, n, batch, dtype, dev, tp_size)
    if cfg.mla.enabled:
        m = cfg.mla
        return {"c_kv": zeros(batch, max_seq, cut(m.kv_lora_rank)),
                "k_rope": zeros(batch, max_seq, cut(m.qk_rope_head_dim)),
                "pos": zeros(dt=torch.int32)}
    hd = cut(cfg.resolved_head_dim())
    attn = {"k": zeros(batch, max_seq, cfg.num_kv_heads, hd),
            "v": zeros(batch, max_seq, cfg.num_kv_heads, hd),
            "pos": zeros(dt=torch.int32)}
    if cfg.hybrid_parallel_heads:
        return {"attn": attn, "ssm": ssm_mod.init_ssm_cache(
            cfg, n, batch, dtype, dev, tp_size)}
    if cfg.enc_dec:
        return {"self": attn}
    return attn

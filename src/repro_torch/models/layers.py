"""Shared model layers (PyTorch, explicit param dicts).

RMSNorm, RoPE and M-RoPE (qwen2-vl's t/h/w sections), GQA attention
with optional qk-norm / QKV bias / sliding window, DeepSeek-V2's
multi-head latent attention (MLA), and the SwiGLU MLP. Attention from
an empty cache (prefill at position 0, or a forward without caches)
goes through K6 (``kernels.ops.attention``; MLA's at head dims 192 for
q and k, 128 for v); decode attends over the cache
with plain masked attention, the reference's own split (its XLA path
there, ``repro/models/layers.py:_attention_naive``). Projections are
``torch.matmul``, as the reference leaves them to XLA. Given a
``sharding.TensorParallel`` (``tp=``), ``attention_block``,
``mla_block`` and ``mlp_block`` run as one rank of the ``model`` axis on
that rank's cut of their parameters, with the collectives
``models/sharding.py`` sets out in place of the reference's layout
hints.

``set_attention_impl("blockwise", chunk)`` is the reference's lowering
knob (``attention_impl(impl, chunk)`` sets it for a ``with`` block and
restores what it found): attention over more than ``chunk`` keys and more than one query
row then runs ``_attention_blockwise``, an online softmax over key
chunks whose every chunk is checkpointed, so that no (B, H, Sq, Skv)
score tensor lives at once. From an empty cache the forward stays K6 and
only its autograd backward recomputes through ``_attention_blockwise``
(in place of the plain version over whole scores); over a cache the
blockwise function is the forward itself.

The caches are updated in place (the reference returns new ones): a
tinyllama cache at 8 x 552 tokens is ~200 MB, and copying it per layer
and step would dominate decode.
"""
from __future__ import annotations

import contextlib
import functools
from typing import Optional

import torch
import torch.nn.functional as F
import torch.utils.checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models.sharding import active, attention_mode

NEG_INF = -1e30

# Attention lowering (the reference's knob, ``repro/models/layers.py``):
#   naive     -- K6 from an empty cache with a backward over whole scores,
#                plain masked attention over a cache
#   blockwise -- the same K6 forward, its backward recomputed by an online
#                softmax over KV chunks; over a cache that scan itself
_ATTN_IMPL = "naive"
_ATTN_CHUNK = 2048


def set_attention_impl(impl: str, chunk: int = 2048) -> None:
    global _ATTN_IMPL, _ATTN_CHUNK
    assert impl in ("naive", "blockwise"), impl
    _ATTN_IMPL = impl
    _ATTN_CHUNK = chunk


def get_attention_impl() -> str:
    return _ATTN_IMPL


def get_attention_chunk() -> int:
    return _ATTN_CHUNK


@contextlib.contextmanager
def attention_impl(impl: str, chunk: int = 2048):
    """``set_attention_impl(impl, chunk)`` inside the ``with`` block; the
    impl and chunk found on entry are restored on exit, also when the
    block raises."""
    before = (_ATTN_IMPL, _ATTN_CHUNK)
    set_attention_impl(impl, chunk)
    try:
        yield
    finally:
        set_attention_impl(*before)


# Products whose output no backward reads (``output_unneeded``): the
# selective checkpoint of ``transformer.dots_policy`` keeps none of them
_UNNEEDED = 0


def output_unneeded() -> bool:
    """Whether the ops running now make outputs that no backward reads
    (an ``unneeded_output`` block)."""
    return _UNNEEDED > 0


@contextlib.contextmanager
def unneeded_output():
    """Mark the ops of the ``with`` block as making outputs that only
    sums read, whose backward needs no value (an MLP's down projection,
    added into the residual): the reference's partial evaluation saves
    no residual of them."""
    global _UNNEEDED
    _UNNEEDED += 1
    try:
        yield
    finally:
        _UNNEEDED -= 1


def init_dense(gen: torch.Generator, d_in: int, d_out: int, dtype,
               device, *, layers=None) -> torch.Tensor:
    """N(0, 1) * sqrt(2 / (d_in + d_out)), the reference's ``init_dense``
    distribution, drawn from ``gen``; with ``layers`` (an int or a tuple
    of leading dims), a stacked ``(*layers, d_in, d_out)`` draw. Scaled
    in place: a stacked expert leaf is ~19 GB in f32, and a second
    buffer for the product would not fit beside the model."""
    lead = () if layers is None else (
        (layers,) if isinstance(layers, int) else tuple(layers))
    scale = (2.0 / (d_in + d_out)) ** 0.5
    w = torch.randn((*lead, d_in, d_out), generator=gen,
                    dtype=torch.float32, device=device)
    return w.mul_(scale).to(dtype)


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


def _rotate(x: torch.Tensor, angles: torch.Tensor) -> torch.Tensor:
    """x: (B, S, H, d) rotated by angles (B, S, d/2), half against half."""
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float
               ) -> torch.Tensor:
    """x: (B, S, H, d); positions: (B, S) int."""
    freqs = rope_freqs(x.shape[-1], theta, x.device)        # (d/2,)
    return _rotate(x, positions[..., None].to(torch.float32) * freqs)


def mrope_section_ids(half: int, sections) -> list:
    """Which of the t/h/w ids (0/1/2) drives each of the ``half``
    frequency slots: ``sections[i]`` slots of id ``i`` in turn, cut at
    ``half`` and padded with id 2 below it (``jnp.repeat(arange(3),
    sections, total_repeat_length=half)``, as the reference builds it)."""
    ids = [i for i, n in enumerate(sections) for _ in range(n)][:half]
    return ids + [2] * (half - len(ids))


def apply_mrope(x: torch.Tensor, positions: torch.Tensor, theta: float,
                sections) -> torch.Tensor:
    """M-RoPE (qwen2-vl). x: (B, S, H, d); positions: (3, B, S) int, the
    (t, h, w) ids. Each frequency slot of the head-dim halves turns by
    the id its section names (``mrope_section_ids``)."""
    d = x.shape[-1]
    freqs = rope_freqs(d, theta, x.device)                  # (d/2,)
    ids = torch.tensor(mrope_section_ids(d // 2, sections),
                       device=positions.device)
    picked = positions[ids].permute(1, 2, 0)                # (B, S, d/2)
    return _rotate(x, picked.to(torch.float32) * freqs)


# ---------------------------------------------------------------------------
# Attention
# ---------------------------------------------------------------------------

def init_attention(gen: torch.Generator, cfg: ModelConfig, dtype, device,
                   layers) -> dict:
    """Stacked ``(layers, ...)`` attention params of ``cfg`` (``layers``
    None for one unstacked block)."""
    hd = cfg.resolved_head_dim()
    d, qd, kvd = cfg.d_model, cfg.num_heads * hd, cfg.num_kv_heads * hd
    lead = () if layers is None else (layers,)

    def dense(a, b):
        return init_dense(gen, a, b, dtype, device, layers=layers)

    p = {"wq": dense(d, qd), "wk": dense(d, kvd), "wv": dense(d, kvd),
         "wo": dense(qd, d)}
    if cfg.qkv_bias:
        for name, n in (("b_q", qd), ("b_k", kvd), ("b_v", kvd)):
            p[name] = torch.zeros((*lead, n), dtype=dtype, device=device)
    if cfg.qk_norm:
        for name in ("q_norm_scale", "k_norm_scale"):
            p[name] = torch.ones((*lead, hd), dtype=dtype, device=device)
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
    """q: (B,Sq,Hq,d), k: (B,Skv,Hkv,d), v: (B,Skv,Hkv,dv) ->
    (B,Sq,Hq,dv). ``kv_len``: optional (B,) valid length (decode caches).

    Attention from an empty cache (no ``kv_len``; ``q_offset`` the
    position of q's first row, a rank's rows under sequence-parallel
    attention) is K6; attention over a cache is plain masked attention.
    Under ``"blockwise"``, over more than the chunk's keys and more than
    one query row (the reference's rule), K6's backward recomputes
    through ``_attention_blockwise`` and attention over a cache is that
    scan."""
    blockwise = (_ATTN_IMPL == "blockwise" and k.shape[1] > _ATTN_CHUNK
                 and q.shape[1] > 1)
    if kv_len is None:
        backward = (functools.partial(_attention_blockwise,
                                      q_offset=q_offset, kv_len=None,
                                      chunk=_ATTN_CHUNK)
                    if blockwise else None)
        return ops.attention(q, k, v, causal=causal, window=window,
                             q_offset=q_offset, backward=backward)
    if blockwise:
        return _attention_blockwise(q, k, v, causal=causal, window=window,
                                    q_offset=q_offset, kv_len=kv_len,
                                    chunk=_ATTN_CHUNK)
    return _attention_naive(q, k, v, causal=causal, window=window,
                            q_offset=q_offset, kv_len=kv_len)


def _attention_naive(q, k, v, *, causal, window, q_offset, kv_len,
                     scale=None, tp=None):
    """Full-score attention over (B,H,Sq,Skv) f32 scores; GQA by reshape
    to (B, Skv, Hkv, group, d), no repeat of K or V. ``scale`` defaults
    to ``d ** -0.5``. With ``tp`` the head dims are a rank's cut and the
    scores a partial sum (``_summed``)."""
    b, sq, hq, d = q.shape
    _, skv, hkv, _ = k.shape
    dv = v.shape[-1]
    group = hq // hkv
    scale = d ** -0.5 if scale is None else scale
    qg = q.reshape(b, sq, hkv, group, d)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg.to(torch.float32) * scale,
                     k.to(torch.float32))
    if tp is not None:
        s = _summed(s, tp)
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


def _attention_blockwise(q, k, v, *, causal, window, q_offset, kv_len,
                         chunk, scale=None, tp=None):
    """Online-softmax scan over KV chunks, the reference's
    ``_attention_blockwise``: one (B, Hkv, group, Sq, chunk) score block
    at a time instead of the whole S^2 tensor, each chunk's body
    checkpointed (recomputed in the backward, as ``jax.checkpoint(body)``
    under the reference's scan), so its scores live only while that
    chunk is worked on. Shapes as ``attention_core``; ``window`` 0 is
    off; keys at or past ``kv_len`` (or past Skv, the padding of the last
    chunk) are masked.

    The reference's dots take the inputs' own dtype with an f32 product
    (``preferred_element_type``). PyTorch has no such product of bf16
    operands on the CPU, so both dots take operands upcast to f32 on
    every device (q once, each chunk's K and V in its body): the same
    ops on the CPU, the card and ``meta``. P is rounded to q's dtype
    before PV, as the reference casts it. The reference's sharding pins
    have no counterpart: under tensor parallelism q holds this rank's
    heads, or its rows at ``q_offset`` against whole k and v; with ``tp``
    given, the head dims are a rank's cut and each chunk's scores a
    partial sum (``_summed``). ``scale`` defaults to ``d ** -0.5``."""
    b, sq, hq, d = q.shape
    _, skv, hkv, _ = k.shape
    dv = v.shape[-1]
    group = hq // hkv
    nc = -(-skv // chunk)
    pad = nc * chunk - skv
    if pad:
        k = F.pad(k, (0, 0, 0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, 0, 0, pad))
    # q turned once to (b, hkv, g * sq, d), so that each chunk's dot
    # writes (b, hkv, g, sq, chunk) scores with no transpose in the loop
    qt = (q.reshape(b, sq, hkv, group, d).permute(0, 2, 3, 1, 4)
          .to(torch.float32).reshape(b, hkv, group * sq, d))
    q_pos = q_offset + torch.arange(sq, device=q.device)
    valid_len = (kv_len.to(torch.int32) if kv_len is not None else
                 torch.full((b,), skv, dtype=torch.int32, device=q.device))
    m = torch.full((b, hkv, group, sq, 1), NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((b, hkv, group, sq, 1), dtype=torch.float32,
                    device=q.device)
    acc = torch.zeros((b, hkv, group, sq, dv), dtype=torch.float32,
                      device=q.device)
    for ci in range(nc):
        k_blk = k[:, ci * chunk:(ci + 1) * chunk]
        v_blk = v[:, ci * chunk:(ci + 1) * chunk]
        m, l, acc = torch.utils.checkpoint.checkpoint(
            _blockwise_chunk, qt, k_blk, v_blk, m, l, acc, q_pos, valid_len,
            ci * chunk, causal=causal, window=window, p_dtype=q.dtype,
            scale=d ** -0.5 if scale is None else scale, tp=tp,
            use_reentrant=False)
    safe = torch.where(l == 0.0, 1.0, l)
    out = (acc / safe).permute(0, 3, 1, 2, 4)           # (b,sq,hkv,g,dv)
    return out.reshape(b, sq, hq, dv).to(q.dtype)


def _blockwise_chunk(qt, k_blk, v_blk, m, l, acc, q_pos, valid_len, k0, *,
                     causal, window, p_dtype, scale, tp=None):
    """One chunk of ``_attention_blockwise``: the carries (m, l, acc)
    after the keys ``k0 ..`` of ``k_blk`` (b, chunk, hkv, d) and
    ``v_blk`` (b, chunk, hkv, dv), for q turned to (b, hkv, g * sq, d)
    in f32; with ``tp`` the scores summed over its group first."""
    b, hkv, group, sq, dv = acc.shape
    ck = k_blk.shape[1]
    s = torch.matmul(qt, k_blk.permute(0, 2, 3, 1).to(torch.float32))
    s = s.view(b, hkv, group, sq, ck)
    if tp is not None:
        s = _summed(s, tp)
    s = s * scale
    k_pos = k0 + torch.arange(ck, device=qt.device)
    mask = (k_pos[None, None, :] < valid_len[:, None, None]).expand(
        b, sq, ck)
    if causal:
        mask = mask & (q_pos[None, :, None] >= k_pos[None, None, :])
    if window > 0:
        mask = mask & ((q_pos[None, :, None] - k_pos[None, None, :])
                       < window)
    mask = mask[:, None, None]                          # (b,1,1,sq,chunk)
    s = torch.where(mask, s, NEG_INF)
    m_new = torch.maximum(m, torch.amax(s, dim=-1, keepdim=True))
    # masked slots zeroed explicitly: a fully masked chunk would add
    # exp(NEG_INF - NEG_INF) = 1 otherwise
    p = torch.exp(s - m_new) * mask
    alpha = torch.exp(m - m_new)
    l_new = l * alpha + torch.sum(p, dim=-1, keepdim=True)
    pv = torch.matmul(p.to(p_dtype).to(torch.float32).view(
        b, hkv, group * sq, ck), v_blk.permute(0, 2, 1, 3).to(torch.float32))
    return m_new, l_new, acc * alpha + pv.view(b, hkv, group, sq, dv)


def attention_block(params: dict, cfg: ModelConfig, x: torch.Tensor,
                    positions: torch.Tensor, *, causal: bool = True,
                    window: int = 0, cache: Optional[dict] = None,
                    pos: int = 0,
                    mrope_positions: Optional[torch.Tensor] = None,
                    tp=None):
    """Full attention sub-block. Returns (out, cache).

    q and k turn by M-RoPE over ``mrope_positions`` (3, B, S) when the
    config has it and they are given, else by RoPE over ``positions``.
    With ``cache`` ({"k", "v", "pos"} views of one layer), the new keys
    and values are written in place at host position ``pos`` (the cache
    slot, apart from the rotation ids); ``pos == 0`` attends over them
    alone (K6), a later position over the cache. With ``tp`` (a
    ``sharding.TensorParallel``) the block is one rank's share
    (``_attention_block_tp``)."""
    if active(tp):
        return _attention_block_tp(params, cfg, x, positions, causal=causal,
                                   window=window, cache=cache, pos=pos,
                                   mrope_positions=mrope_positions, tp=tp)
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
    if cfg.mrope and mrope_positions is not None:
        q = apply_mrope(q, mrope_positions, cfg.rope_theta,
                        cfg.mrope_sections)
        k = apply_mrope(k, mrope_positions, cfg.rope_theta,
                        cfg.mrope_sections)
    else:
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


def _tp_in(x, tp):
    """A block's input, whole on every rank: the residual's rows gathered
    under sequence parallelism, else the replicated residual."""
    return tp.gather(x, 1) if tp.seq_cut else tp.copy(x)


def _tp_out(y, tp):
    """A row-parallel output's partial sums, reduced into the residual's
    layout: reduce-scattered by sequence, or all-reduced."""
    return tp.scatter(y, 1) if tp.seq_cut else tp.reduce(y)


def _rows_out(y, lo: int, s: int, tp):
    """A block output's rows ``lo ..`` of ``s``, which this rank alone
    computed (its share, ``tp.share``), into the residual's layout: as
    they are where it is cut by sequence (the share is its cut), else
    every row on every rank: all-gathered where ``s`` divides the axis,
    or summed among the other ranks' zeros; the gradient this rank's
    rows of the whole one."""
    if tp.seq_cut:
        return y
    if tp.divides(s):
        return tp.join(y, 1)
    return tp.reduce(F.pad(y, (0, 0, lo, s - lo - y.shape[1])))


def _attention_block_tp(params, cfg: ModelConfig, x, positions, *, causal,
                        window, cache, pos, mrope_positions, tp):
    """One rank's share of ``attention_block`` over the ``model`` axis
    of ``tp``: ``wq``, ``wk``, ``wv`` (and their biases) column-cut,
    ``wo`` row-cut, or whole where their widths do not divide the axis
    (``_tp_qkv``, ``_tp_o_proj``). q, k and v are projections of the
    whole input. Then, by ``attention_mode``:

    * heads: the rank's columns are its q and kv heads;
    * rows (heads that do not divide, a sequence that does): q's
      columns all-to-all into the rank's rows of every head (a whole
      ``wq`` projects those rows alone), attended at ``q_offset`` = their
      first position over k and v gathered whole (or projected whole);
      the output all-to-all back into columns, or through a whole ``wo``
      as the rank's rows;
    * replicated (neither divides, as a decode step's one row): q, k and
      v whole, every head attended, the rank's columns kept (its share
      of the rows through a whole ``wo``);
    * hd (``qkv_sharding`` off, the heads not dividing, the head dim
      dividing): q, k and v gathered whole, each rank scores its cut of
      every head's head dim and the scores are summed over the group
      (``_attention_hd_cut``), the rank's columns of the output kept.

    With a cache the new keys and values are gathered whole and the
    rank's cut (the head dim, as ``cache_partition_specs`` cuts it, or
    all of it where it does not divide) written; a later step attends
    over the cut cache where it lies (``_attention_hd_cut``), or over a
    whole one as the unsharded step does."""
    n, r = tp.size, tp.rank
    b = x.shape[0]
    hd = cfg.resolved_head_dim()
    hq, hkv = cfg.num_heads, cfg.num_kv_heads
    h = _tp_in(x, tp)
    s = h.shape[1]
    q, k, v, mode = _tp_qkv(params, h, h, hq, hkv, hd, cfg.qkv_bias, tp)
    hq_l, hkv_l = (hq // n, hkv // n) if mode == "heads" else (hq, hkv)
    q_offset, q_pos, q_mpos = 0, positions, mrope_positions
    if mode == "rows":
        q_offset = r * (s // n)
        q_pos = tp.cut(positions, 1)
        if mrope_positions is not None:
            q_mpos = tp.cut(mrope_positions, 2)
    sq = q.shape[1]
    q = q.reshape(b, sq, hq_l, hd)
    k = k.reshape(b, s, hkv_l, hd)
    v = v.reshape(b, s, hkv_l, hd)
    if cfg.qk_norm:
        q = rms_norm(q, params["q_norm_scale"], cfg.rms_eps)
        k = rms_norm(k, params["k_norm_scale"], cfg.rms_eps)
    if cfg.mrope and mrope_positions is not None:
        q = apply_mrope(q, q_mpos, cfg.rope_theta, cfg.mrope_sections)
        k = apply_mrope(k, mrope_positions, cfg.rope_theta,
                        cfg.mrope_sections)
    else:
        q = apply_rope(q, q_pos, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)

    kv_len = None
    if cache is not None:
        ck, cv = cache["k"], cache["v"]
        # the whole new keys and values, and this rank's cut of them
        k_all, v_all = ((tp.gather(k, 2), tp.gather(v, 2))
                        if mode == "heads" else (k, v))
        cut_hd = ck.shape[-1] != hd
        if cut_hd:
            k_all, v_all = tp.cut(k_all, 3), tp.cut(v_all, 3)
        ck[:, pos:pos + s] = k_all.to(ck.dtype)
        cv[:, pos:pos + s] = v_all.to(cv.dtype)
        cache["pos"].fill_(pos + s)
        if pos == 0:
            k, v = k.to(ck.dtype).to(q.dtype), v.to(cv.dtype).to(q.dtype)
        elif cut_hd:
            # q whole (every head, every row of the step) on every rank
            if mode == "heads":
                q = tp.all_gather(q.contiguous(), 2)
            elif mode == "rows":
                q = tp.all_gather(q.contiguous(), 1)
            kv_len = torch.full((b,), pos + s, dtype=torch.int32,
                                device=x.device)
            out = _attention_hd_cut(q, ck.to(q.dtype), cv.to(q.dtype), tp,
                                    causal=causal, window=window,
                                    q_offset=pos, kv_len=kv_len)
            return _tp_o_proj(out, params["wo"], "hd", tp), cache
        else:
            k_c, v_c = ck, cv
            if mode == "heads":
                k_c = k_c.narrow(2, r * hkv_l, hkv_l)
                v_c = v_c.narrow(2, r * hkv_l, hkv_l)
            k, v = k_c.to(q.dtype), v_c.to(q.dtype)
            q_offset += pos
            kv_len = torch.full((b,), pos + s, dtype=torch.int32,
                                device=x.device)
    if mode == "hd":
        out = _attention_hd_cut(q, tp.cut(k, 3), tp.cut(v, 3), tp,
                                causal=causal, window=window,
                                q_offset=q_offset, kv_len=kv_len)
    else:
        out = attention_core(q, k.contiguous(), v.contiguous(),
                             causal=causal, window=window,
                             q_offset=q_offset, kv_len=kv_len)
    out = out.reshape(b, sq, hq_l * hd)
    return _tp_o_proj(out, params["wo"], mode, tp), cache


def _tp_qkv(params, hq_in, hkv_in, hq: int, hkv: int, hd: int, bias: bool,
            tp):
    """q from ``hq_in`` (B, Sq, D) and k, v from ``hkv_in`` (B, Skv, D),
    both whole on every rank, laid out for ``sharding.attention_mode``'s
    scheme: (q, k, v, mode). A column-cut projection gives the rank's
    columns: "heads" keeps them as its heads; "rows" (the heads do not
    divide the axis, Sq does) all-to-alls q's into the rank's rows of
    every head and gathers k's and v's whole; "replicated" (neither
    divides, as a decode step's one row) and "hd" (the head dims are cut
    later, after the rotation) gather all three whole. A projection the
    axis leaves whole (its width does not divide it; never under "heads"
    or "hd") gives every column: q's of the rank's rows alone under
    "rows"."""
    n = tp.size
    mode = attention_mode(hq, hkv, hq_in.shape[1], hd, hd, n)

    def proj(x, w, b):
        y = x @ params[w]
        return y + params[b] if bias else y

    if mode == "rows" and not tp.divides(hq * hd):
        q = proj(tp.cut(hq_in, 1), "wq", "b_q")
    else:
        q = proj(hq_in, "wq", "b_q")
        if mode == "rows":
            q = tp.all_to_all(q, 1, 2)
        elif mode != "heads" and tp.divides(hq * hd):
            q = tp.gather(q, 2)
    k, v = proj(hkv_in, "wk", "b_k"), proj(hkv_in, "wv", "b_v")
    if mode != "heads" and tp.divides(hkv * hd):
        k, v = tp.gather(k, 2), tp.gather(v, 2)
    return q, k, v, mode


def _tp_attention_out(out, mode: str, tp):
    """The attention output (B, Sq, cols) of ``_tp_qkv``'s ``mode`` back
    in the rank's columns, for the row-parallel o-projection."""
    if mode == "rows":
        return tp.all_to_all(out, 2, 1)
    if mode in ("replicated", "hd"):
        return tp.cut(out, 2)
    return out


def _tp_o_proj(out, wo, mode: str, tp):
    """The attention output ``out`` (B, Sq, ·) in ``mode``'s layout (the
    rank's heads for "heads", its rows of every head for "rows", every
    row and head otherwise) through the o-projection ``wo``, into the
    residual's layout. A row-cut ``wo`` takes the rank's columns
    (``_tp_attention_out``) and its partial sums are reduced
    (``_tp_out``). A whole ``wo`` (its rows do not divide the axis, as
    ``wq``'s columns do not; never under "heads" or "hd") takes the
    rank's rows of the output, or its share of every row
    (``tp.share``), into ``_rows_out``."""
    if mode in ("heads", "hd") or wo.shape[0] != out.shape[-1]:
        return _tp_out(_tp_attention_out(out, mode, tp) @ wo, tp)
    if mode == "rows":
        rows = out.shape[1]
        return _rows_out(out @ wo, tp.rank * rows, rows * tp.size, tp)
    s = out.shape[1]
    lo, hi = tp.share(s)
    return _rows_out(out[:, lo:hi] @ wo, lo, s, tp)


def _summed(s, tp):
    """Partial scores summed over ``tp``'s group (``reduce``), with
    their gradient summed back (``copy``): every rank's softmax feeds
    its own columns of V, so each holds only its share of dP."""
    return tp.copy(tp.reduce(s))


def _attention_hd_cut(q, kc, vc, tp, *, causal, window, q_offset, kv_len):
    """Attention of whole ``q`` (B, Sq, Hq, d) over k and v cut on the
    head dim (``kc`` (B, S, Hkv, d / n), ``vc`` (B, S, Hkv, dv / n),
    every head) -> (B, Sq, Hq * dv), whole on every rank: each rank
    scores q's columns of its cut against its own, the (B, Hkv, group,
    Sq, S) partial scores are summed over the group, and P against the
    rank's columns of V is gathered over the head dim; differentiable
    (``_summed``, ``tp.gather``). Under ``"blockwise"`` (more than the
    chunk's keys, more than one row) the online softmax over key chunks,
    one sum of (B, Hkv, group, Sq, chunk) scores a chunk; else whole f32
    scores, as ``_attention_naive``; keys at or past ``kv_len`` masked.
    This is the reference's lowering without its q/k/v pins
    (``--no-qkv-shard``, ``sharding.attention_mode``'s "hd") and how a
    decode step reads a cache cut on the head dim where it lies: it
    sends its scores and its output, Hq (S + dv) values a row, where
    the whole cache is S Hkv (d + dv). No K6: its softmax would need
    the sum in the middle."""
    b, sq, hq, d = q.shape
    qc = q.narrow(3, tp.rank * kc.shape[-1], kc.shape[-1])
    kw = dict(causal=causal, window=window, q_offset=q_offset,
              kv_len=kv_len, scale=d ** -0.5, tp=tp)
    if _ATTN_IMPL == "blockwise" and kc.shape[1] > _ATTN_CHUNK and sq > 1:
        out = _attention_blockwise(qc, kc, vc, chunk=_ATTN_CHUNK, **kw)
    else:
        out = _attention_naive(qc, kc, vc, **kw)
    return tp.gather(out, 3).reshape(b, sq, -1)


# ---------------------------------------------------------------------------
# MLA (DeepSeek-V2 multi-head latent attention)
# ---------------------------------------------------------------------------

def init_mla(gen: torch.Generator, cfg: ModelConfig, dtype, device,
             layers) -> dict:
    """Stacked ``(layers, ...)`` MLA params of ``cfg`` (``layers`` None
    for one unstacked block)."""
    m, d, h = cfg.mla, cfg.d_model, cfg.num_heads

    def dense(a, b):
        return init_dense(gen, a, b, dtype, device, layers=layers)

    lead = () if layers is None else (layers,)
    return {
        "wq": dense(d, h * m.qk_head_dim),
        "w_dkv": dense(d, m.kv_lora_rank),
        "w_kr": dense(d, m.qk_rope_head_dim),
        "kv_norm_scale": torch.ones((*lead, m.kv_lora_rank), dtype=dtype,
                                    device=device),
        "w_uk": dense(m.kv_lora_rank, h * m.qk_nope_head_dim),
        "w_uv": dense(m.kv_lora_rank, h * m.v_head_dim),
        "wo": dense(h * m.v_head_dim, d),
    }


def mla_block(params: dict, cfg: ModelConfig, x: torch.Tensor,
              positions: torch.Tensor, *, cache: Optional[dict] = None,
              pos: int = 0, tp=None):
    """MLA: the KV cache is the compressed ``c_kv`` (kv_lora_rank) and the
    one rope key shared by all heads, per token. Returns (out, cache).

    With ``cache`` ({"c_kv", "k_rope", "pos"} views of one layer), the new
    tokens' entries are written in place at host position ``pos``;
    ``pos == 0`` attends over them alone (K6 at head dims 192/128), a
    later position up-projects the whole cache and attends plainly with
    ``kv_len`` masking, as the reference does (no weight absorption).

    With ``tp`` the block is one rank's share over the ``model`` axis:
    ``wq``, ``w_uk``, ``w_uv`` column-cut, ``wo`` row-cut, the input
    gathered whole (``_tp_in``) and the output reduced (``_tp_out``);
    ``w_dkv`` and ``kv_norm_scale`` whole, so the latent ``c_kv`` is whole
    on every rank; ``w_kr`` column-cut, its rank's rope dims gathered
    whole before they turn (``_rotate`` pairs dim ``i`` with ``i + d /
    2``). Attention runs by ``sharding.attention_mode`` of the heads, as
    the reference's ``attention_seq_mode(h, h)``: the rank's heads where
    they divide the axis; else the rank's rows of q (its columns, cut
    mid-head where a head's 192 do not divide, all-to-all into whole
    rows of every head) at ``q_offset`` their first position against K
    and V up-projected on the rank's columns and gathered whole; every
    row for a sequence that does not divide the axis; or, with
    ``qkv_sharding`` off, every head on the rank's cut of the head dims
    (``_attention_hd_cut``). A cache holds the rank's cut of the rope
    key's feature dim (it divides the axis, as ``w_kr``'s does) and of
    the latent's where it divides
    (``launch.specs.cache_partition_specs``); a later step scores the
    cut where it lies (``_mla_latent_scores``) and never gathers it."""
    m = cfg.mla
    sharded = active(tp)
    if sharded:
        x = _tp_in(x, tp)
    b, s, _ = x.shape
    h = cfg.num_heads
    mode = (attention_mode(h, h, s, m.qk_head_dim, m.v_head_dim, tp.size)
            if sharded else None)
    # which of the column projections the axis leaves whole (never under
    # "heads" but ``w_kr``, whose 64 columns need not divide it)
    whole = ({w: not tp.divides(h * dim) for w, dim in (
        ("wq", m.qk_head_dim), ("w_uk", m.qk_nope_head_dim),
        ("w_uv", m.v_head_dim))} if sharded else {})
    if mode == "rows" and whole["wq"]:
        q = tp.cut(x, 1) @ params["wq"]
    else:
        q = x @ params["wq"]
        if mode == "rows":
            q = tp.all_to_all(q, 1, 2)
        elif mode in ("replicated", "hd") and not whole["wq"]:
            q = tp.gather(q, 2)
    q_offset, q_pos = 0, positions
    if mode == "rows":
        q_offset, q_pos = tp.rank * (s // tp.size), tp.cut(positions, 1)
    h_l = h // tp.size if mode == "heads" else h
    sq = q.shape[1]
    q = q.reshape(b, sq, h_l, m.qk_head_dim)
    q_nope, q_rope = torch.split(
        q, [m.qk_nope_head_dim, m.qk_rope_head_dim], dim=-1)
    q_rope = apply_rope(q_rope, q_pos, cfg.rope_theta)

    c_kv = rms_norm(x @ params["w_dkv"], params["kv_norm_scale"],
                    cfg.rms_eps)                        # (b, s, r)
    k_rope = x @ params["w_kr"]
    if sharded and tp.divides(m.qk_rope_head_dim):
        k_rope = tp.gather(k_rope, 2)
    k_rope = apply_rope(k_rope[:, :, None, :], positions,
                        cfg.rope_theta)                 # (b, s, 1, dr)

    kv_len = None
    if cache is not None:
        cc, cr = cache["c_kv"], cache["k_rope"]
        cut_c = cc.shape[-1] != m.kv_lora_rank
        cut_r = cr.shape[-1] != m.qk_rope_head_dim
        cc[:, pos:pos + s] = (tp.cut(c_kv, 2) if cut_c else c_kv).to(
            cc.dtype)
        cr[:, pos:pos + s] = (tp.cut(k_rope[:, :, 0], 2) if cut_r else
                              k_rope[:, :, 0]).to(cr.dtype)
        cache["pos"].fill_(pos + s)
        if pos == 0:
            # the new tokens as the cache holds them (a bf16 cache), as
            # the reference attends over its cache; no copy for f32
            c_kv = c_kv.to(cc.dtype).to(x.dtype)
            k_rope = k_rope.to(cr.dtype).to(x.dtype)
        elif sharded:
            if mode == "rows":
                # every row of the step on every rank
                q_nope, q_rope = (tp.all_gather(t.contiguous(), 1)
                                  for t in (q_nope, q_rope))
            out = _mla_latent_scores(params, cfg, q_nope, q_rope, cc, cr,
                                     cut_c, cut_r, tp, pos, x.dtype,
                                     heads=mode == "heads")
            return _tp_o_proj(out, params["wo"], "replicated"
                              if whole["w_uv"] else "heads", tp), cache
        else:
            c_kv, k_rope = cc.to(x.dtype), cr.to(x.dtype)[:, :, None]
            q_offset = pos
            kv_len = torch.full((b,), pos + s, dtype=torch.int32,
                                device=x.device)
    skv = c_kv.shape[1]
    k_nope = c_kv @ params["w_uk"]
    v = c_kv @ params["w_uv"]
    if sharded and mode != "heads":
        if not whole["w_uk"]:
            k_nope = tp.gather(k_nope, 2)
        if not whole["w_uv"]:
            v = tp.gather(v, 2)
    k_nope = k_nope.reshape(b, skv, h_l, m.qk_nope_head_dim)
    v = v.reshape(b, skv, h_l, m.v_head_dim)
    k = torch.cat([k_nope, k_rope.expand(b, skv, h_l, m.qk_rope_head_dim)],
                  dim=-1)
    qfull = torch.cat([q_nope, q_rope], dim=-1)
    # MLA scales by the full qk head dim (the attention's default)
    if mode == "hd":
        out = _attention_hd_cut(qfull, tp.cut(k, 3), tp.cut(v, 3), tp,
                                causal=True, window=0, q_offset=0,
                                kv_len=None)
    else:
        out = attention_core(qfull, k, v, causal=True, q_offset=q_offset,
                             kv_len=kv_len)
    out = out.reshape(b, sq, h_l * m.v_head_dim)
    if not sharded:
        return out @ params["wo"], cache
    return _tp_o_proj(out, params["wo"], mode, tp), cache


def _rank_columns(w, total: int, tp):
    """The rank's column cut ``w`` (r, total / n) of a column-parallel
    matrix in place among zeros, (r, total): a product with every
    head's rows then holds the rank's share of the whole product."""
    out = w.new_zeros((w.shape[0], total))
    out.narrow(1, tp.rank * w.shape[1], w.shape[1]).copy_(w)
    return out


def _mla_latent_scores(params, cfg: ModelConfig, q_nope, q_rope, cc, cr,
                       cut_c: bool, cut_r: bool, tp, pos: int, dtype,
                       heads: bool = True):
    """MLA over a cache for the queries (``q_nope``, ``q_rope``: (B, Sq,
    H / n, ·) of the rank's heads with ``heads``, else (B, Sq, H, ·) of
    every head, at positions ``pos ..``), the cache ``cr`` (B, S, dr /
    n with ``cut_r``, else dr) and ``cc`` (B, S, r / n with ``cut_c``,
    else r) -> the rank's columns of the output, (B, Sq, H * dv / n), or
    all of it where ``w_uv`` is whole (its columns do not divide the
    axis). The reference's sums in another order: ``q_nope_h . (c_kv
    W_uk_h)`` is ``(q_nope_h W_uk_h^T) . c_kv``, so every head's query
    goes into latent space where its ``w_uk`` columns lie: on the rank
    that holds the head, all-gathered over the heads with ``q_rope`` (a
    few hundred values a row); or, with heads that do not divide the axis
    (a head's columns cut between ranks), each rank's share of every
    head's latent query from its columns, summed over the group (or all
    of it on every rank from a whole ``w_uk``). Each rank scores every
    head against its cut of the rope key and of the latent, and the
    partial scores are all-reduced; a part the axis leaves whole is
    scored on every rank after the reduce. After the softmax each rank
    forms ``P . c_kv[cut]``, which is all-gathered over the latent's
    dims, and applies its columns of ``w_uv`` (or all of them). f32
    scores and products, causal at ``pos`` (the slots past the step are
    masked with it), as ``_attention_naive``."""
    m = cfg.mla
    b, sq, h_l, _ = q_nope.shape
    r = m.kv_lora_rank
    skv = cc.shape[1]
    f32 = torch.float32
    if heads:
        w_uk = params["w_uk"].to(f32).reshape(r, h_l, m.qk_nope_head_dim)
        q_lat = torch.einsum("bqhn,rhn->bqhr", q_nope.to(f32), w_uk)
        q_lat = tp.all_gather(q_lat.contiguous(), 2)    # (b, sq, h, r)
        q_rot = tp.all_gather(q_rope.to(f32).contiguous(), 2)
    elif params["w_uk"].shape[-1] == h_l * m.qk_nope_head_dim:
        q_lat = torch.einsum("bqhn,rhn->bqhr", q_nope.to(f32),
                             params["w_uk"].to(f32).reshape(
                                 r, h_l, m.qk_nope_head_dim))
        q_rot = q_rope.to(f32)
    else:
        w_uk = _rank_columns(params["w_uk"].to(f32),
                             h_l * m.qk_nope_head_dim, tp)
        q_lat = torch.einsum("bqhn,rhn->bqhr", q_nope.to(f32),
                             w_uk.reshape(r, h_l, m.qk_nope_head_dim))
        q_lat = tp.all_reduce(q_lat.contiguous())
        q_rot = q_rope.to(f32)
    c = cc.to(dtype).to(f32)
    kr = cr.to(dtype).to(f32)
    scale = m.qk_head_dim ** -0.5

    def scores(qq, kk):
        return torch.einsum("bqhr,bkr->bhqk", qq * scale, kk)

    cut = [(q, k) for q, k, is_cut in ((q_rot, kr, cut_r), (q_lat, c, cut_c))
           if is_cut]
    s = None
    for qq, kk in cut:
        part = scores(tp.cut(qq, 3), kk)
        s = part if s is None else s + part
    if s is not None:
        s = tp.all_reduce(s)
    for qq, kk, is_cut in ((q_rot, kr, cut_r), (q_lat, c, cut_c)):
        if not is_cut:
            part = scores(qq, kk)
            s = part if s is None else s + part
    mask = _causal_window_mask(sq, skv, pos, 0, True, c.device)
    s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    lat = torch.einsum("bhqk,bkr->bqhr", p, c)
    if cut_c:
        lat = tp.all_gather(lat.contiguous(), 3)        # (b, sq, h, r)
    if heads:
        w_uv = params["w_uv"].to(f32).reshape(r, h_l, m.v_head_dim)
        out = torch.einsum("bqhr,rhv->bqhv", tp.cut(lat, 2), w_uv)
        return out.reshape(b, sq, h_l * m.v_head_dim).to(dtype)
    if params["w_uv"].shape[-1] == h_l * m.v_head_dim:
        out = torch.einsum("bqhr,rhv->bqhv", lat, params["w_uv"].to(
            f32).reshape(r, h_l, m.v_head_dim))
        return out.reshape(b, sq, h_l * m.v_head_dim).to(dtype)
    w_uv = _rank_columns(params["w_uv"].to(f32), h_l * m.v_head_dim, tp)
    out = torch.einsum("bqhr,rhv->bqhv", lat,
                       w_uv.reshape(r, h_l, m.v_head_dim))
    return tp.cut(out.reshape(b, sq, h_l * m.v_head_dim), 2).to(dtype)


# ---------------------------------------------------------------------------
# SwiGLU MLP
# ---------------------------------------------------------------------------

def init_mlp(gen: torch.Generator, d_model: int, d_ff: int, dtype, device,
             layers) -> dict:
    def dense(a, b):
        return init_dense(gen, a, b, dtype, device, layers=layers)

    return {"w_gate": dense(d_model, d_ff), "w_up": dense(d_model, d_ff),
            "w_down": dense(d_ff, d_model)}


def mlp_block(params: dict, x: torch.Tensor, tp=None) -> torch.Tensor:
    """SwiGLU. With ``tp``, one rank's share: ``w_gate`` and ``w_up``
    column-cut on the whole input, ``w_down`` row-cut, its partial sums
    reduced into the residual's layout. The three share their hidden
    width, so an axis it does not divide leaves all three whole: the
    caller then passes no ``tp`` and the rank runs the MLP on its own
    rows of the residual (every row, without sequence parallelism), with
    no collective. Every caller sums the output into the residual, so
    the down projection's is ``unneeded_output``."""
    if active(tp):
        x = _tp_in(x, tp)
    h = F.silu(x @ params["w_gate"]) * (x @ params["w_up"])
    with unneeded_output():
        y = h @ params["w_down"]
    return _tp_out(y, tp) if active(tp) else y

"""Blockwise (flash) attention — the serving path's prefill kernel (K6
``flash_attention``).

Online-softmax attention with causal and sliding-window masks, GQA (q
head ``h`` reads kv head ``h // group``) and a zero output for a row that
sees no key. On the H100 a CUDA call takes one of four hand-written
kernels, as ``flash_attention_route`` says:

* ``"wgmma"`` (``csrc/flash_attention_sm90.cu``), bf16 at the served head
  dims with more than 64 query rows: FlashAttention-3's shape, a block of
  one producer and two consumer warpgroups per (sequence, q head, 128-row
  q tile), K/V streamed by TMA through a ring of 64-key stages (96 at
  head dim 64), QK^T and PV by ``wgmma`` (P split into two bf16 halves)
  and the online softmax in the accumulator registers;
* ``"wgmma_tf32"`` (``csrc/flash_attention_sm90_tf32.cu``), f32 at the
  served head dims with more than 64 query rows: the same shape in
  3xTF32, every operand K-major (a pre-pass writes K's TF32 lo part
  and V transposed, hi and lo, into scratch that ``_launch``
  allocates), one consumer warpgroup per 64-row q tile, 32-key stages;
* ``"split_kv"`` (``csrc/flash_attention_splitkv.cu``), bf16 and f32 at
  the served head dims with 64 query rows or fewer (a decode step): a
  block per (sequence, kv head, key split) whose rows are the GQA
  group's q heads times the query rows, the visible keys cut into the
  splits ``split_kv_plan`` chooses and streamed by ``cp.async`` through
  a ring of 64-key stages, the splits merged by a second kernel with
  log-sum-exp weights in split order;
* ``"mma_sync"`` (``csrc/flash_attention.cu``), head dims 16 and 32: a
  4-warp block per 64-row q tile, 64-key K/V tiles double-buffered by
  ``cp.async``, ``mma.sync`` products (3xTF32 in f32). split_kv shares
  its tile arithmetic (``csrc/flash_attention_mma.cuh``).

All four stay within the reference's f32 tolerance (plus one bf16 step
in bf16), mask ragged edges themselves (any ``Sq``, ``Skv`` runs without
padding) and never repeat K/V per q head. Each takes ``q_offset``, the
position of q's first row among the keys (a rank's rows of a
sequence-parallel attention): it shifts the causal and window masks and
the key tiles a q tile skips. They take 16-byte aligned
tensors. V and the output may be narrower than q and k for a listed pair
of head dims (MLA's 192 for q and k, 128 for v).

``flash_attention`` runs the plain PyTorch version for tensors on the
CPU, launches a CUDA kernel for tensors on the GPU and, for tensors on
the ``meta`` device (the dry-run's), returns an output of the kernel's
shape and dtype and launches nothing; ``flash_attention.launches``
counts the launches and ``flash_attention.route_launches`` the launches
of each route. On every device the result carries a ``grad_fn`` whose
backward recomputes the plain version, or the function its caller hands
down as ``backward`` (the models' blockwise scan), and differentiates it
(``_FlashAttention``); the forward stays the kernel. An active
``roofline.count.OpCounter`` is charged ``flash_attention_cost`` per
call, whatever the device.
"""
from __future__ import annotations

import functools
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.kernels import _build
from repro_torch.roofline.count import charge

NEG_INF = -1e30

#: (q and k head dim, v and output head dim) pairs the mma.sync kernel is
#: instantiated for: the square dims, and MLA's nope + rope / v
HEAD_DIMS = ((16, 16), (32, 32), (64, 64), (128, 128), (192, 128))
#: the pairs the wgmma kernels are instantiated for: the served ones
SM90_HEAD_DIMS = ((64, 64), (128, 128), (192, 128))
ROUTES = ("wgmma", "wgmma_tf32", "mma_sync", "split_kv")
#: split_kv_plan's keys a tile
SPLIT_KV_TILE = 64

_DTYPES = (torch.float32, torch.bfloat16)


def _as_bshd(x: torch.Tensor) -> torch.Tensor:
    """(BH, S, d) -> a (BH, S, 1, d) view; (B, S, H, d) passes through."""
    if x.ndim == 3:
        return x.unsqueeze(2)
    if x.ndim != 4:
        raise ValueError(f"expected (BH, S, d) or (B, S, H, d), got "
                         f"{tuple(x.shape)}")
    return x


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor,
                          v: torch.Tensor, *, causal: bool = True,
                          window: int = 0,
                          scale: Optional[float] = None,
                          q_offset: int = 0) -> torch.Tensor:
    """q: (B, Sq, Hq, d), k: (B, Skv, Hkv, d), v: (B, Skv, Hkv, dv) ->
    (B, Sq, Hq, dv), the reference oracle's arithmetic
    (``kernels/ref.py:ref_attention``): f32 scores of ``q * scale``
    against k, ``-1e30`` where masked, softmax, zeros for a row with no
    visible key, cast to q's dtype. GQA groups q heads onto kv heads by
    a reshape, not a repeat. ``q_offset``: the position of q's first row,
    so that a slice of the rows of a longer call (whose scores would not
    fit) is computed as that call computes it."""
    b, sq, hq, d = q.shape
    _, skv, hkv, _ = k.shape
    dv = v.shape[-1]
    group = hq // hkv
    scale = scale if scale is not None else d ** -0.5
    qg = q.reshape(b, sq, hkv, group, d).to(torch.float32) * scale
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg, k.to(torch.float32))
    q_pos = q_offset + torch.arange(sq, device=q.device)[:, None]
    k_pos = torch.arange(skv, device=q.device)[None, :]
    mask = torch.ones((sq, skv), dtype=torch.bool, device=q.device)
    if causal:
        mask &= q_pos >= k_pos
    if window > 0:
        mask &= (q_pos - k_pos) < window
    s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhgqk,bkhd->bqhgd", p, v.to(torch.float32))
    out = torch.where(mask.any(dim=-1)[None, :, None, None, None], out,
                      torch.zeros_like(out))
    return out.reshape(b, sq, hq, dv).to(q.dtype)


def visible_pairs(sq: int, skv: int, causal: bool, window: int,
                  q_offset: int = 0) -> int:
    """(q, k) pairs of one head that the mask lets through: query ``i``
    (at position ``q_offset + i``) sees key ``j`` when ``j <=`` its
    position (causal) and its position ``- j < window`` (a window), as
    ``flash_attention_plain`` masks."""
    i = q_offset + np.arange(sq, dtype=np.int64)
    hi = np.minimum(i, skv - 1) if causal else np.full(sq, skv - 1)
    lo = np.maximum(i - window + 1, 0) if window > 0 else 0
    return int(np.clip(hi - lo + 1, 0, None).sum())


def flash_attention_cost(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool = True, window: int = 0,
                         q_offset: int = 0):
    """(flops, bytes) of one call, the function's own work: 2 (d + dv)
    flops per visible (q, k) pair and q head, and q, k and v read and
    the output written once each. Any of the layouts ``flash_attention``
    takes."""
    q4, k4, v4 = _as_bshd(q), _as_bshd(k), _as_bshd(v)
    b, sq, hq, d = q4.shape
    skv, hkv, dv = k4.shape[1], k4.shape[2], v4.shape[-1]
    flops = 2 * (d + dv) * visible_pairs(sq, skv, causal, window,
                                         q_offset) * b * hq
    nbytes = q.element_size() * b * (d + dv) * (sq * hq + skv * hkv)
    return flops, nbytes


def flash_attention_route(dtype: torch.dtype, d: int, dv: int,
                          sq: int) -> str:
    """The kernel a CUDA call of this dtype, (q/k, v) head dims and query
    rows goes to: ``"wgmma"``, ``"wgmma_tf32"``, ``"split_kv"`` or
    ``"mma_sync"``.

    * At ``SM90_HEAD_DIMS`` with more than 64 rows, bf16 goes to
      ``wgmma`` (TMA boxes and swizzle atoms of 64 columns, 128-row
      tiles) and f32 to ``wgmma_tf32``: 3xTF32 is three products, and
      each is a TF32 ``wgmma`` (the lo parts and V's transpose come from
      a pre-pass, since TF32 ``wgmma`` reads K-major operands only). At
      65-128 f32 rows the TF32 route's device time is at or under
      ``mma_sync``'s: seamless's encoder (8 x 128 rows over 128 frames,
      16 heads of 64, not causal) 0.0178 ms against 0.0180-0.0190, 8 x
      128 causal rows at 128/128 GQA 7 0.054 against 0.095 (``PERF.md``
      §6, ``tools/k6_drift.py``).
    * Either dtype there at 64 rows or fewer (a decode step; seamless's
      cross-attention, one row over the encoder's frames) goes to
      ``split_kv``. Such a call is bound by the bytes of K and V, so it
      wants many blocks streaming keys and each key read once: split_kv
      packs the GQA group's rows into one tile (K and V read once per kv
      head) and cuts the keys into splits, where ``mma_sync`` runs one
      block per (sequence, q head) over all keys with one real row in
      its 64 (seamless's cut decode: 8 blocks on 132 SMs).
    * Either dtype at (16, 16) and (32, 32) goes to ``mma_sync``: under
      one swizzle atom of 128 bytes."""
    if (d, dv) in SM90_HEAD_DIMS:
        if sq > 64:
            return "wgmma" if dtype == torch.bfloat16 else "wgmma_tf32"
        return "split_kv"
    return "mma_sync"


def split_kv_plan(b: int, hq: int, hkv: int, sq: int, skv: int,
                  causal: bool, window: int, q_offset: int, *,
                  wave: int) -> tuple[int, int]:
    """(splits, keys_per_split) of a ``split_kv`` call. The keys some row
    can see, ``[lo, hi)`` (``lo`` the first row's window edge rounded
    down to a tile, ``hi`` the last row's causal bound or Skv), are cut
    into runs of ``keys_per_split`` keys from ``lo``, a whole number of
    64-key tiles each, the last one ragged. The rule: the fewest tiles a
    split with which the call's blocks (B x Hkv x the 64-row tiles of its
    Hq / Hkv x Sq packed rows, times the splits) still fit one ``wave``,
    the blocks the card holds at once, so that every SM streams K and V
    with no second, partial wave behind them (on an H100 a plan of 1.2
    waves ran 1.6x slower than one of a wave, ``PERF.md`` §6); one split,
    with no merge pass after it, when the keys fit in one tile or the
    blocks alone fill the wave. A block's tiles run one after another on
    one warp, so even two tiles go faster as two splits and a merge
    (seamless's f32 cross decode over 128 frames on an H100: 0.0107 ms
    against 0.0155 as one split, ``PERF.md`` §6). The launcher refuses a
    plan that leaves a key out or starts a split at or past ``hi``."""
    lo = (max(0, q_offset - window + 1) // SPLIT_KV_TILE * SPLIT_KV_TILE
          if window > 0 else 0)
    hi = min(skv, q_offset + sq) if causal else skv
    tiles = max(0, -(-(hi - lo) // SPLIT_KV_TILE))
    blocks = b * hkv * -(-(hq // hkv * sq) // 64)
    most = wave // max(blocks, 1)
    if tiles <= 1 or most <= 1:
        return 1, max(tiles, 1) * SPLIT_KV_TILE
    per = -(-tiles // min(tiles, most))
    return -(-tiles // per), per * SPLIT_KV_TILE


def tf32_scratch_words(b: int, skv: int, hkv: int, d: int, dv: int) -> int:
    """f32 words of the ``wgmma_tf32`` route's scratch, the launcher's own
    count (``reconic_flash_attention_sm90_tf32_scratch_words``): K's TF32
    lo part in K's layout (K itself is the hi part the tensor cores read),
    and V transposed to (B, Hkv, dv, Skv8), hi and lo, with Skv rounded up
    to a multiple of 8; 0 for head dims the kernel is not built for."""
    return int(_build.library()
               .reconic_flash_attention_sm90_tf32_scratch_words(
                   b, hkv, skv, d, dv))


@functools.lru_cache(maxsize=None)
def splitkv_wave(dtype: torch.dtype, d: int, dv: int, warps: int) -> int:
    """The blocks of ``warps`` warps (one a 16-row part of the call's
    packed rows, at most 4) of the ``split_kv`` kernel of this dtype and
    head dims that the current card holds at once, by CUDA's occupancy
    calculator (``reconic_flash_attention_splitkv_wave``):
    ``split_kv_plan``'s wave. Raises where the card cannot say."""
    wave = int(_build.library().reconic_flash_attention_splitkv_wave(
        d, dv, int(dtype == torch.bfloat16), warps))
    if wave <= 0:
        raise RuntimeError(f"reconic_flash_attention_splitkv_wave: CUDA "
                           f"error {-wave}")
    return wave


def splitkv_scratch_words(b: int, hq: int, sq: int, dv: int,
                          splits: int) -> int:
    """f32 words of the ``split_kv`` route's scratch, the launcher's own
    count (``reconic_flash_attention_splitkv_scratch_words``): each
    output row's unnormalised O (dv words) and its (m, l) per split; 0
    for one split, which writes the output itself."""
    return int(_build.library()
               .reconic_flash_attention_splitkv_scratch_words(
                   b, hq, sq, dv, splits))


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    scale: Optional[float] = None, q_offset: int = 0,
                    backward: Optional[Callable] = None) -> torch.Tensor:
    """q: (BH, Sq, d), k: (BH, Skv, d), v: (BH, Skv, dv) -> (BH, Sq, dv);
    or, with GQA, q: (B, Sq, Hq, d), k: (B, Skv, Hkv, d), v: (B, Skv,
    Hkv, dv) -> (B, Sq, Hq, dv) with ``Hq % Hkv == 0``. On the GPU ``(d,
    dv)`` is one of ``HEAD_DIMS``. f32 or bf16 inputs of one dtype,
    computed in f32, output in the input dtype. ``window`` 0 means no
    window; ``scale`` defaults to ``d ** -0.5``. ``q_offset`` (>= 0) is
    the position of q's first row among the keys.

    ``backward``: None (the plain version), or a function ``f(q, k, v, *,
    causal, window)`` of (B, S, H, d) tensors that computes the same
    attention at the default scale (and takes ``q_offset=`` too, where
    the call has one); the autograd backward recomputes through it and
    differentiates it. It takes no ``scale``, so it cannot be given with
    one."""
    squeeze = q.ndim == 3
    q4, k4, v4 = _as_bshd(q), _as_bshd(k), _as_bshd(v)
    b, sq, hq, d = q4.shape
    bk, skv, hkv, dk = k4.shape
    dv = v4.shape[-1]
    if (bk, d) != (b, dk) or tuple(v4.shape[:3]) != tuple(k4.shape[:3]) \
            or hkv == 0 or hq % hkv:
        raise ValueError(f"bad attention shapes q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention: unsupported dtypes {q.dtype}, "
                        f"{k.dtype}, {v.dtype}")
    if window < 0 or q_offset < 0:
        raise ValueError(f"window and q_offset must be >= 0, got {window}, "
                         f"{q_offset}")
    if backward is not None and scale is not None:
        raise ValueError("flash_attention: a backward function computes "
                         "the default scale; give no scale with it")
    scale = scale if scale is not None else d ** -0.5
    if {t.device.type for t in (q, k, v)} not in ({"cpu"}, {"meta"}):
        if (d, dv) not in HEAD_DIMS:
            raise ValueError(f"flash_attention: head_dim {d} with v "
                             f"head_dim {dv} not in {HEAD_DIMS}")
        # grid.y takes at most 65535 blocks: mma_sync's (sequence, q head)
        # pairs, wgmma's 128-row q tiles; wgmma_tf32's one grid dimension
        # takes 2^31 - 1 blocks of 64 rows, split_kv's grid.x as many
        # (sequence, kv head) pairs (its 64-row tiles of a GQA group's
        # rows and its splits stay far under 65535)
        route = flash_attention_route(q.dtype, d, dv, sq)
        if route == "split_kv":
            if b * hkv > 2 ** 31 - 1:
                raise ValueError(f"flash_attention: B * Hkv = {b * hkv} "
                                 f">= 2^31")
        elif route == "wgmma":
            if -(-sq // 128) > 65535:
                raise ValueError(f"flash_attention: Sq = {sq} is over 65535 "
                                 f"tiles of 128 rows")
        elif route == "wgmma_tf32":
            if b * hq * -(-sq // 64) > 2 ** 31 - 1:
                raise ValueError(f"flash_attention: B * Hq * ceil(Sq / 64) "
                                 f"= {b * hq * -(-sq // 64)} >= 2^31")
        elif b * hq > 65535:
            raise ValueError(f"flash_attention: B * Hq = {b * hq} > 65535")
        _build.check_cuda("flash_attention", q4, k4, v4)
        for name, t in (("q", q4), ("k", k4), ("v", v4)):
            if t.data_ptr() % 16:
                raise ValueError(f"flash_attention: {name} is not 16-byte "
                                 f"aligned (the kernel loads 16-byte rows)")
    with charge("flash_attention", flash_attention_cost, q4, k4, v4,
                causal=causal, window=window, q_offset=q_offset):
        out = _FlashAttention.apply(q4, k4, v4, causal, window, scale,
                                    q_offset, backward)
    return out[:, :, 0] if squeeze else out


class _FlashAttention(torch.autograd.Function):
    """K6 as an autograd op: the forward launches the CUDA kernel (the
    plain version on the CPU, a shape-only output on ``meta``); the
    backward recomputes ``flash_attention_plain`` (or the caller's
    ``backward`` function) on the saved inputs and returns its gradients
    (the JAX package trains through plain attention too). Under
    ``no_grad`` it is the bare forward."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, scale, q_offset, backward):
        b, sq, hq, d = q.shape
        _, skv, hkv, dv = v.shape
        ctx.save_for_backward(q, k, v)
        ctx.opts = (causal, window, scale, q_offset, backward)
        if q.device.type == "cpu":
            # laid out as the kernel writes it, so that later ops see the
            # same strides on every device
            return flash_attention_plain(q, k, v, causal=causal,
                                         window=window, scale=scale,
                                         q_offset=q_offset).contiguous()
        out = q.new_empty((b, sq, hq, dv))
        if out.numel() and q.device.type == "cuda":
            _launch(flash_attention_route(q.dtype, d, dv, sq), q, k, v, out,
                    causal, window, scale, q_offset)
        return out

    @staticmethod
    def backward(ctx, grad_out):
        causal, window, scale, q_offset, recompute = ctx.opts
        inputs = [t.detach().requires_grad_() for t in ctx.saved_tensors]
        with torch.enable_grad():
            if recompute is None:
                out = flash_attention_plain(*inputs, causal=causal,
                                            window=window, scale=scale,
                                            q_offset=q_offset)
            else:
                # q_offset only where there is one: a function written
                # for attention from the first row may not take it
                kw = {"q_offset": q_offset} if q_offset else {}
                out = recompute(*inputs, causal=causal, window=window, **kw)
            grads = torch.autograd.grad(out, inputs, grad_out)
        return (*grads, None, None, None, None, None)


def _launch(route, q, k, v, out, causal, window, scale, q_offset=0):
    """Launch ``route``'s kernel on (B, S, H, d) CUDA tensors that
    ``flash_attention`` checked, and count it."""
    b, sq, hq, d = q.shape
    _, skv, hkv, dv = v.shape
    if route == "wgmma":
        _build.launch("reconic_flash_attention_sm90", q.data_ptr(),
                      k.data_ptr(), v.data_ptr(), out.data_ptr(), b, hq, hkv,
                      sq, skv, d, dv, int(causal), int(window),
                      int(q_offset), float(np.float32(scale)),
                      _build.stream_ptr(q.device))
    elif route == "wgmma_tf32":
        words = tf32_scratch_words(b, skv, hkv, d, dv)
        scratch = torch.empty(words, dtype=torch.float32, device=q.device)
        _build.launch("reconic_flash_attention_sm90_tf32", q.data_ptr(),
                      k.data_ptr(), v.data_ptr(), out.data_ptr(),
                      scratch.data_ptr(), words, b, hq, hkv, sq, skv, d, dv,
                      int(causal), int(window), int(q_offset),
                      float(np.float32(scale)), _build.stream_ptr(q.device))
    elif route == "split_kv":
        warps = -(-min(hq // hkv * sq, 64) // 16)
        splits, per = split_kv_plan(
            b, hq, hkv, sq, skv, causal, window, q_offset,
            wave=splitkv_wave(q.dtype, d, dv, warps))
        words = splitkv_scratch_words(b, hq, sq, dv, splits)
        scratch = (torch.empty(words, dtype=torch.float32, device=q.device)
                   if words else None)
        _build.launch("reconic_flash_attention_splitkv", q.data_ptr(),
                      k.data_ptr(), v.data_ptr(), out.data_ptr(),
                      scratch.data_ptr() if words else 0, words, b, hq, hkv,
                      sq, skv, d, dv, int(causal), int(window),
                      int(q_offset), float(np.float32(scale)),
                      int(q.dtype == torch.bfloat16), splits, per,
                      _build.stream_ptr(q.device))
    else:
        _build.launch("reconic_flash_attention", q.data_ptr(), k.data_ptr(),
                      v.data_ptr(), out.data_ptr(), b, hq, hkv, sq, skv, d,
                      dv, int(causal), int(window), int(q_offset),
                      float(np.float32(scale)),
                      int(q.dtype == torch.bfloat16),
                      _build.stream_ptr(q.device))
    flash_attention.launches += 1
    flash_attention.route_launches[route] += 1


def reset_launches() -> None:
    """Set ``flash_attention``'s launch counts, the total and each
    route's, to 0."""
    flash_attention.launches = 0
    flash_attention.route_launches = dict.fromkeys(ROUTES, 0)


reset_launches()

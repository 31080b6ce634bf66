"""The numerics of K6's tensor-core routes and of K5's f32 contract,
emulated in PyTorch on the CPU and held against the JAX reference.

K6 runs QK^T and PV on the tensor cores (``csrc/flash_attention.cu``):

* f32 as 3xTF32: ``x_hi = tf32_rna(x)``, ``x_lo = tf32_rna(x - x_hi)``
  (``cvt.rna.tf32.f32``: 10 mantissa bits, nearest, ties away from zero)
  and ``a.b ~ a_lo.b_hi + a_hi.b_lo + a_hi.b_hi``: the mma.sync route
  (``csrc/flash_attention.cu``) and the TF32 wgmma route
  (``csrc/flash_attention_sm90_tf32.cu``), whose split is the same but
  for K's: Q * scale split on chip, V's hi and lo by a pre-pass, P's
  from the raw S accumulators, while K's hi part is K itself, which the
  tensor cores read as TF32 by dropping its low 13 bits (truncation,
  measured on an H100), and K's lo part ``tf32_rna(K - trunc(K))``. Its
  PV goes into fresh accumulators every 32 keys, added to O in f32 with
  the online softmax's rescale (``"wgmma_tf32"`` below models that tile
  by tile);
* bf16 with exact bf16 x bf16 products and P split into
  ``P_hi = bf16(p)`` and ``P_lo = bf16(p - P_hi)``, two PV products: the
  route of both the mma.sync kernel and the wgmma kernel
  (``csrc/flash_attention_sm90.cu``), which chose the split over a single
  bf16 P on ``test_bf16_routes_against_the_bf16_contract``;
* the split_kv route (``csrc/flash_attention_splitkv.cu``): either of the
  two above over each key split of the port's ``split_kv_plan``, the
  splits merged with log-sum-exp weights in split order
  (``attention_split_kv``), held against ``ref_attention`` and the
  Pallas kernel in interpret mode.

The emulation runs each product as the kernel's chain of ``mma`` calls:
k in chunks of the mma depth (8 for TF32, 16 for bf16), each chunk's
products summed exactly (float64 holds a product of two TF32 or bf16
values and their short sums exactly) and added to an f32 accumulator,
one rounding per ``mma``. The softmax between the products is f32, as in
the kernel; its tiling by 64 keys moves a result by a few f32 steps and
is left out. Tolerances: 2e-4 against ``repro.kernels.ref.ref_attention``
(the reference's own), and 1e-5 against a float64 oracle, which the GPU
test ``test_cuda_flash_attention_f32_is_not_tf32`` holds the kernel to:
3xTF32 meets it and a single TF32 product misses it here, so that test
tells the two apart.

These tests check the arithmetic of the kernels' design, emulated here,
and of ``repro_torch`` only ``split_kv_plan``, whose splits the split_kv
emulation takes: the kernels themselves are held by the GPU tests of
``tests/test_torch_cuda.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref
from repro.kernels.flash_attention import flash_attention as jax_fa
from repro_torch.kernels.flash_attention import split_kv_plan

TOL = 2e-4
ORACLE_TOL = 1e-5


def tf32_rna(x: torch.Tensor) -> torch.Tensor:
    """``cvt.rna.tf32.f32`` on an f32 tensor: keep 10 mantissa bits,
    rounding to nearest with ties away from zero (on the magnitude, which
    the low 31 bits of the pattern hold)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def tf32_trunc(x: torch.Tensor) -> torch.Tensor:
    """An f32 tensor as the tensor cores read it for a TF32 product: its
    low 13 bits dropped."""
    return (x.contiguous().view(torch.int32) & -0x2000).view(torch.float32)


def _mma_chain(pairs, kc):
    """Sum of ``a @ b`` over ``pairs``, as a chain of mma calls: for each
    k chunk of ``kc``, each pair's chunk product in turn is summed exactly
    and added to the f32 accumulator with one rounding."""
    a0, b0 = pairs[0]
    acc = torch.zeros(a0.shape[:-1] + b0.shape[-1:], dtype=torch.float32)
    for k0 in range(0, a0.shape[-1], kc):
        for a, b in pairs:
            part = a[..., k0:k0 + kc].double() @ b[..., k0:k0 + kc, :].double()
            acc = (acc.double() + part).float()
    return acc


def mm_3xtf32(a, b):
    ah, bh = tf32_rna(a), tf32_rna(b)
    al, bl = tf32_rna(a - ah), tf32_rna(b - bh)
    return _mma_chain([(al, bh), (ah, bl), (ah, bh)], 8)


def mm_1xtf32(a, b):
    return _mma_chain([(tf32_rna(a), tf32_rna(b))], 8)


def _mask(sq, skv, causal, window, q_offset=0):
    q_pos = q_offset + torch.arange(sq)[:, None]
    k_pos = torch.arange(skv)[None, :]
    mask = torch.ones((sq, skv), dtype=torch.bool)
    if causal:
        mask &= q_pos >= k_pos
    if window > 0:
        mask &= (q_pos - k_pos) < window
    return mask


def _attention_wgmma_tf32(q, k, v, *, causal, window, bn=32):
    """The TF32 wgmma kernel's arithmetic: S in 3xTF32 (one rounding per
    8-deep k step and product; K's hi part truncated, its lo part the
    rounded rest), then per ``bn``-key tile the online softmax, P split
    into TF32 hi and lo, PV in 3xTF32 into fresh accumulators, and ``O =
    (O + PV_prev) * alpha`` in f32."""
    scale = q.shape[-1] ** -0.5
    qs = q * scale
    q_hi, kt = tf32_rna(qs), k.transpose(-1, -2)
    k_hi = tf32_trunc(kt)
    s_all = _mma_chain([(tf32_rna(qs - q_hi), k_hi),
                        (q_hi, tf32_rna(kt - k_hi)), (q_hi, k_hi)], 8)
    mask = _mask(q.shape[1], k.shape[1], causal, window)
    s_all = torch.where(mask, s_all, torch.full_like(s_all, -1e30))
    m = torch.full(s_all.shape[:-1] + (1,), -1e30)
    den = torch.zeros_like(m)
    o = torch.zeros(q.shape[:-1] + v.shape[-1:])
    pv = None
    for k0 in range(0, k.shape[1], bn):
        s = s_all[..., k0:k0 + bn]
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        alpha = torch.exp(m - m_new)
        p = torch.where(mask[:, k0:k0 + bn], torch.exp(s - m_new),
                        torch.zeros_like(s))
        den = den * alpha + p.sum(-1, keepdim=True)
        m = m_new
        if pv is not None:
            o = (o + pv) * alpha
        p_hi, vt = tf32_rna(p), v[:, k0:k0 + bn]
        v_hi = tf32_rna(vt)
        pv = _mma_chain([(tf32_rna(p - p_hi), v_hi),
                         (p_hi, tf32_rna(vt - v_hi)), (p_hi, v_hi)], 8)
    if pv is not None:
        o = o + pv
    return torch.where(den > 0, o / den, torch.zeros_like(o))


def attention_emulated(q, k, v, route, *, causal, window=0):
    """q: (BH, Sq, d), k/v: (BH, Skv, d), f32 (bf16 values widened for
    the bf16 routes) -> (BH, Sq, d) f32, by ``route``: "3xtf32" (the
    mma.sync route), "wgmma_tf32" and "bf16" as the kernels compute,
    "tf32" (one TF32 product) and "bf16_single_p" (P rounded to bf16
    once) as they do not."""
    if route == "wgmma_tf32":
        return _attention_wgmma_tf32(q, k, v, causal=causal, window=window)
    d = q.shape[-1]
    scale = d ** -0.5
    kt = k.transpose(-1, -2)
    if route in ("bf16", "bf16_single_p"):
        s = _mma_chain([(q, kt)], 16) * scale
    elif route == "3xtf32":
        s = mm_3xtf32(q * scale, kt)
    else:
        s = mm_1xtf32(q * scale, kt)
    mask = _mask(q.shape[1], k.shape[1], causal, window)
    s = torch.where(mask, s, torch.full_like(s, -1e30))
    m = s.amax(-1, keepdim=True)
    p = torch.where(mask, torch.exp(s - m), torch.zeros_like(s))
    den = p.sum(-1, keepdim=True)
    if route == "bf16":
        p_hi = p.bfloat16().float()
        p_lo = (p - p_hi).bfloat16().float()
        o = _mma_chain([(p_lo, v), (p_hi, v)], 16)
    elif route == "bf16_single_p":
        o = _mma_chain([(p.bfloat16().float(), v)], 16)
    elif route == "3xtf32":
        o = mm_3xtf32(p, v)
    else:
        o = mm_1xtf32(p, v)
    return torch.where(den > 0, o / den, torch.zeros_like(o))


def attention_f64(q, k, v, *, causal, window=0):
    d = q.shape[-1]
    s = (q.double() * d ** -0.5) @ k.double().transpose(-1, -2)
    mask = _mask(q.shape[1], k.shape[1], causal, window)
    s = s.masked_fill(~mask, float("-inf"))
    o = torch.softmax(s, dim=-1) @ v.double()
    return torch.where(mask.any(-1)[None, :, None], o, torch.zeros_like(o))


def _inputs(seed, b, sq, skv, hq, hkv, d, bf16):
    """(B*Hq, S, d) q, k, v from a seed, KV heads repeated per q head (the
    layout ``ref_attention`` takes); bf16 values widened to f32."""
    rng = np.random.default_rng(seed)
    q = torch.from_numpy(rng.standard_normal((b, sq, hq, d), np.float32))
    k, v = (torch.from_numpy(rng.standard_normal((b, skv, hkv, d),
                                                 np.float32))
            for _ in "kv")
    if bf16:
        q, k, v = (t.bfloat16().float() for t in (q, k, v))
    k, v = (t.repeat_interleave(hq // hkv, dim=2) for t in (k, v))
    return tuple(t.transpose(1, 2).reshape(b * hq, -1, d).contiguous()
                 for t in (q, k, v))


# (b, sq, skv, hq, hkv, d, causal, window): the flash-attention cases of
# tests/test_kernels.py, then 2 x 512 x (8 q heads over 1) x 64 causal and
# the served head dims 128 and 192 (with a window)
CASES = [
    (3, 128, 128, 1, 1, 16, True, 0),
    (3, 128, 128, 1, 1, 16, False, 0),
    (3, 256, 256, 1, 1, 16, True, 0),
    (3, 256, 256, 1, 1, 16, False, 0),
    (3, 64, 192, 1, 1, 16, False, 0),
    (2, 128, 128, 1, 1, 8, True, 32),
    (2, 64, 64, 4, 4, 16, True, 0),
    (2, 64, 64, 4, 2, 16, True, 0),
    (2, 64, 64, 8, 1, 16, True, 0),
    (2, 512, 512, 8, 1, 64, True, 0),
    (1, 256, 256, 4, 1, 128, True, 0),
    (1, 200, 200, 4, 4, 192, True, 64),
]


def test_tf32_trunc_split_is_within_twice_the_rounded_split():
    """K's split on the TF32 wgmma route: hi = K with its low 13 bits
    dropped, lo = tf32_rna(K - hi). hi + lo is K to 2^-21 of |K| (the
    rounded split's 2^-22, doubled)."""
    y = torch.from_numpy(np.random.default_rng(6).standard_normal(
        4096).astype(np.float32))
    hi = tf32_trunc(y)
    lo = tf32_rna(y - hi)
    assert torch.equal(hi.view(torch.int32) & 0x1FFF,
                       torch.zeros_like(hi, dtype=torch.int32))
    assert bool((hi.abs() <= y.abs()).all())
    assert bool(((hi.double() + lo.double() - y.double()).abs()
                 <= 2.0 ** -21 * y.double().abs()).all())


def test_tf32_rna_rounds_to_nearest_ties_away():
    x = torch.tensor([1 + 2.0 ** -11, -(1 + 2.0 ** -11), 1 + 2.0 ** -12,
                      1 + 3 * 2.0 ** -12, 3.0, -0.0], dtype=torch.float32)
    want = torch.tensor([1 + 2.0 ** -10, -(1 + 2.0 ** -10), 1.0,
                         1 + 2.0 ** -10, 3.0, -0.0], dtype=torch.float32)
    got = tf32_rna(x)
    assert torch.equal(got, want) and torch.equal(got.signbit(),
                                                  want.signbit())
    y = torch.from_numpy(np.random.default_rng(5).standard_normal(
        4096).astype(np.float32))
    hi = tf32_rna(y)
    lo = tf32_rna(y - hi)
    assert torch.equal(hi.view(torch.int32) & 0x1FFF,
                       torch.zeros_like(hi, dtype=torch.int32))
    assert bool(((hi.double() + lo.double() - y.double()).abs()
                 <= 2.0 ** -22 * y.double().abs()).all())


@pytest.mark.parametrize("route", ["3xtf32", "bf16", "wgmma_tf32"])
@pytest.mark.parametrize("b,sq,skv,hq,hkv,d,causal,window", CASES)
def test_emulated_route_matches_reference(route, b, sq, skv, hq, hkv, d,
                                          causal, window):
    q, k, v = _inputs(sq + d + hq, b, sq, skv, hq, hkv, d, route == "bf16")
    want = np.asarray(ref.ref_attention(
        jnp.asarray(q.numpy()), jnp.asarray(k.numpy()),
        jnp.asarray(v.numpy()), causal=causal, window=window))
    got = attention_emulated(q, k, v, route, causal=causal, window=window)
    err = np.abs(got.numpy() - want).max()
    assert err < TOL, err


def test_f64_oracle_tells_3xtf32_from_single_tf32():
    """At 2 x 512 x (8 over 1) x 64, causal: 3xTF32 within 1e-5 of the
    float64 oracle, a single TF32 product over it."""
    q, k, v = _inputs(11, 2, 512, 512, 8, 1, 64, False)
    want = attention_f64(q, k, v, causal=True)
    err3 = (attention_emulated(q, k, v, "3xtf32", causal=True).double()
            - want).abs().max().item()
    err1 = (attention_emulated(q, k, v, "tf32", causal=True).double()
            - want).abs().max().item()
    assert err3 <= ORACLE_TOL < err1, (err3, err1)


# (b, sq, skv, hq, hkv, d, dv, causal, window): the TF32 wgmma kernel's
# head-dim pairs, causal over GQA groups and MLA's with a window
WGMMA_TF32_DIMS = [
    (1, 512, 512, 8, 1, 64, 64, True, 0),
    (1, 300, 300, 4, 1, 128, 128, True, 0),
    (1, 256, 200, 4, 4, 192, 128, False, 0),
    (1, 256, 256, 4, 4, 192, 128, True, 100),
]


@pytest.mark.parametrize("b,sq,skv,hq,hkv,d,dv,causal,window",
                         WGMMA_TF32_DIMS)
def test_wgmma_tf32_within_the_f64_oracle(b, sq, skv, hq, hkv, d, dv,
                                          causal, window):
    """The TF32 wgmma kernel's tile-by-tile arithmetic at its head-dim
    pairs: within the float64 oracle's 1e-5 (what
    ``test_cuda_flash_attention_f32_is_not_tf32`` holds the kernel to)
    where a single TF32 product misses it, and within
    ``ref_attention``'s 2e-4."""
    q, k, v = _inputs(sq + d + dv + hq, b, sq, skv, hq, hkv, d, False)
    v = v[..., :dv].contiguous()
    got = attention_emulated(q, k, v, "wgmma_tf32", causal=causal,
                             window=window)
    want = attention_f64(q, k, v, causal=causal, window=window)
    err = (got.double() - want).abs().max().item()
    err1 = (attention_emulated(q, k, v, "tf32", causal=causal,
                               window=window).double()
            - want).abs().max().item()
    assert err <= ORACLE_TOL < err1, (err, err1)
    ref_out = np.asarray(ref.ref_attention(
        jnp.asarray(q.numpy()), jnp.asarray(k.numpy()),
        jnp.asarray(v.numpy()), causal=causal, window=window))
    assert np.abs(got.numpy() - ref_out).max() < TOL


def test_p_split_beats_a_single_bf16_p():
    """bf16 inputs at 2 x 512 x (8 over 1) x 64, causal: with P split in
    two bf16 halves PV is the f32 ``p @ v`` to within the oracle's 1e-5;
    P rounded to bf16 once is not."""
    q, k, v = _inputs(12, 2, 512, 512, 8, 1, 64, True)
    want = attention_f64(q, k, v, causal=True)
    err2 = (attention_emulated(q, k, v, "bf16", causal=True).double()
            - want).abs().max().item()
    err1 = (attention_emulated(q, k, v, "bf16_single_p",
                               causal=True).double()
            - want).abs().max().item()
    assert err2 <= ORACLE_TOL < err1, (err2, err1)


# (b, sq, skv, hq, hkv, d, dv, causal, window): the head-dim pairs of the
# wgmma kernel, causal over GQA groups, and MLA's not causal
SERVED_DIMS = [
    (1, 512, 512, 8, 1, 64, 64, True, 0),
    (1, 512, 512, 4, 1, 128, 128, True, 0),
    (1, 256, 256, 4, 4, 192, 128, True, 0),
    (1, 128, 320, 4, 1, 192, 128, False, 0),
]


@pytest.mark.parametrize("b,sq,skv,hq,hkv,d,dv,causal,window", SERVED_DIMS)
def test_bf16_routes_against_the_bf16_contract(b, sq, skv, hq, hkv, d, dv,
                                               causal, window):
    """The ground for the wgmma kernel's split P, at its head-dim pairs:
    each bf16 route's output, rounded to bf16 as the kernel stores it,
    against ``ref_attention`` on the same bf16 inputs rounded the same
    way (what the GPU tests hold the kernel to): the split P within 2e-4
    plus one bf16 step (2^-7 of |want|) everywhere, a single bf16 P over
    it on some outputs."""
    q, k, v = _inputs(sq + d + dv + hq, b, sq, skv, hq, hkv, d, True)
    v = v[..., :dv].contiguous()
    want = torch.from_numpy(np.array(ref.ref_attention(
        jnp.asarray(q.numpy()), jnp.asarray(k.numpy()),
        jnp.asarray(v.numpy()), causal=causal, window=window))
    ).bfloat16().float()
    limit = TOL + 2.0 ** -7 * want.abs()
    over = {}
    for route in ("bf16", "bf16_single_p"):
        got = attention_emulated(q, k, v, route, causal=causal,
                                 window=window).bfloat16().float()
        over[route] = ((got - want).abs() / limit).max().item()
    assert over["bf16"] <= 1.0 < over["bf16_single_p"], over


@pytest.mark.parametrize("m,k,n", [(512, 16, 512), (64, 1024, 64)])
def test_single_tf32_product_misses_k5_tolerance(m, k, n):
    """K5's tolerance, ``1e-5 * k / 128`` against an f32 product, rules
    out TF32: one TF32 product misses it where an f32 chain of fmaf in k
    order (K5's sum) meets it."""
    rng = np.random.default_rng(m + k)
    x = torch.from_numpy(rng.standard_normal((m, k), np.float32))
    y = torch.from_numpy(rng.standard_normal((k, n), np.float32))
    want = x @ y
    tol = 1e-5 * k / 128
    chain = torch.zeros((m, n), dtype=torch.float32)
    for kk in range(k):
        chain = (chain.double() + x[:, kk:kk + 1].double()
                 * y[kk:kk + 1].double()).float()
    assert bool(((chain - want).abs() <= tol + tol * want.abs()).all())
    tf32 = (tf32_rna(x).double() @ tf32_rna(y).double()).float()
    assert not bool(((tf32 - want).abs() <= tol + tol * want.abs()).all())


def attention_split_kv(q, k, v, route, *, causal, window, q_offset, plan):
    """The split_kv kernel's arithmetic (``csrc/flash_attention_splitkv.cu``)
    on (BH, Sq, d) q and (BH, Skv, d | dv) k / v, f32 (bf16 values widened
    for ``route == "bf16"``): S over all keys as the kernel's mma chain
    (bf16: exact products, scaled after; "3xtf32": of q * scale), the
    plan's splits ``(splits, keys_per_split)`` laid from the first row's
    window edge rounded down to a 64-key tile, and per split the running
    max m, the denominator l and the unnormalised O = P V (bf16: P split
    in two bf16 halves; f32: 3xTF32), then the merge in split order in
    f32: weights exp(m_s - M) over the splits with l_s > 0, O = sum w O_s
    / sum w l_s, 0 for a row that sees no key. Each split's softmax runs
    over its keys at once (the kernel's 64-key tiling within a split moves
    a result by a few f32 steps and is left out, as above)."""
    splits, per = plan
    sq, skv = q.shape[1], k.shape[1]
    scale = q.shape[-1] ** -0.5
    kt = k.transpose(-1, -2)
    if route == "bf16":
        s = _mma_chain([(q, kt)], 16) * scale
    else:
        s = mm_3xtf32(q * scale, kt)
    mask = _mask(sq, skv, causal, window, q_offset)
    s = torch.where(mask, s, torch.full_like(s, -1e30))
    lo = max(0, q_offset - window + 1) // 64 * 64 if window > 0 else 0
    parts = []
    for i in range(splits):
        a, b = lo + i * per, min(lo + (i + 1) * per, skv)
        if a >= b:
            continue                       # a split past Skv sees no key
        ss, seen = s[..., a:b], mask[:, a:b]
        m = ss.amax(-1, keepdim=True)
        p = torch.where(seen, torch.exp(ss - m), torch.zeros_like(ss))
        if route == "bf16":
            p_hi = p.bfloat16().float()
            p_lo = (p - p_hi).bfloat16().float()
            o = _mma_chain([(p_lo, v[:, a:b]), (p_hi, v[:, a:b])], 16)
        else:
            o = mm_3xtf32(p, v[:, a:b])
        parts.append((m, p.sum(-1, keepdim=True), o))
    out = torch.zeros(q.shape[:-1] + v.shape[-1:])
    if not parts:
        return out
    big = torch.full_like(parts[0][0], -1e30)
    for m, l, _ in parts:
        big = torch.where(l > 0, torch.maximum(big, m), big)
    num, den = torch.zeros_like(out), torch.zeros_like(parts[0][1])
    for m, l, o in parts:
        w = torch.where(l > 0, torch.exp(m - big), torch.zeros_like(m))
        num = num + w * o
        den = den + w * l
    return torch.where(den > 0, num / den, out)


def _ref_at_offset(q, k, v, causal, window, q_offset):
    """``ref_attention`` of q's rows at positions ``q_offset ..``: the
    rows behind zero rows that take positions 0 .. q_offset - 1."""
    qf = torch.cat([torch.zeros((q.shape[0], q_offset, q.shape[2])), q], 1)
    out = ref.ref_attention(*(jnp.asarray(t.numpy()) for t in (qf, k, v)),
                            causal=causal, window=window)
    return torch.from_numpy(np.array(out))[:, q_offset:]


def _pallas_at_offset(q, k, v, window, q_offset, b):
    """The JAX package's Pallas kernel in interpret mode on the rows at
    positions ``q_offset ..``, causal, where they are the keys' last
    (``q_offset + Sq == Skv``, so the keys it pads to a block stay
    masked): through ``ops.attention`` up to 128 keys, and over more as
    ``ops.attention`` runs it, padded to blocks of 128 (its own choice
    at 1000 keys, blocks of 8, would take minutes in interpret mode)."""
    bh, sq, d = q.shape
    skv, dv = k.shape[1], v.shape[-1]
    assert q_offset + sq == skv and d == dv
    qf = torch.cat([torch.zeros((bh, q_offset, d)), q], 1)
    if skv <= 128:
        four = [t.reshape(b, bh // b, skv, d).transpose(1, 2).numpy()
                for t in (qf, k, v)]
        out = jops.attention(*map(jnp.asarray, four), causal=True,
                             window=window)
        out = np.array(out).transpose(0, 2, 1, 3).reshape(bh, skv, d)
    else:
        pad = -skv % 128
        qf, kp, vp = (torch.nn.functional.pad(t, (0, 0, 0, pad))
                      for t in (qf, k, v))
        out = np.array(jax_fa(*(jnp.asarray(t.numpy()) for t in (qf, kp, vp)),
                              causal=True, window=window, block_q=128,
                              block_k=128, interpret=True))[:, :skv]
    return torch.from_numpy(out)[:, q_offset:]


# (b, sq, skv, hq, hkv, d, dv, causal, window, q_offset, splits): 1, 3 and
# 64 rows over 1, 100 and 1000 keys at GQA groups 1, 4 and 8, causal at
# the keys' last rows, with a window of 16, not causal, and rows that see
# no key; one split (1), several (> 1) and a ragged last split ("ragged":
# one sequence and head over 33960 keys, 531 tiles in 266 splits of 2)
# as split_kv_plan cuts them at the wave of an H100 in bf16 at head dim 64
# (4 one-warp blocks on each of 132 SMs)
H100_WAVE = 4 * 132
SPLIT_KV_CASES = [
    (1, 1, 1, 1, 1, 64, 64, True, 0, 0, 1),
    (1, 1, 100, 4, 1, 64, 64, True, 0, 99, 2),
    (1, 3, 100, 8, 1, 64, 64, True, 16, 97, 1),
    (1, 1, 1000, 1, 1, 64, 64, True, 0, 999, 16),
    (1, 64, 1000, 4, 1, 64, 64, True, 0, 936, 16),
    (1, 1, 33960, 1, 1, 64, 64, False, 0, 0, "ragged"),
    (1, 1, 1000, 4, 4, 64, 64, False, 0, 0, 16),
    (3, 3, 1000, 8, 1, 192, 128, True, 0, 997, 16),
    (2, 3, 100, 8, 1, 192, 128, False, 0, 0, 2),
    (1, 64, 1000, 8, 8, 192, 128, True, 16, 936, 2),
    (1, 3, 100, 4, 1, 64, 64, True, 16, 120, 1),
    (2, 64, 100, 8, 8, 64, 64, True, 16, 90, 1),
]


@pytest.mark.parametrize("route", ["3xtf32", "bf16"], ids=["f32", "bf16"])
@pytest.mark.parametrize("b,sq,skv,hq,hkv,d,dv,causal,window,q_offset,want",
                         SPLIT_KV_CASES)
def test_split_kv_emulation_matches_the_reference(route, b, sq, skv, hq, hkv,
                                                  d, dv, causal, window,
                                                  q_offset, want):
    """The split_kv route's arithmetic over the splits the port's
    ``split_kv_plan`` gives each case, against ``ref_attention`` (and,
    where the rows are the keys' last and q and v share a head dim, the
    Pallas kernel in interpret mode) on the same inputs: f32 within 2e-4,
    bf16 (inputs bf16 values, the output rounded to bf16 as the kernel
    stores it, the reference's rounded the same way) within 2e-4 plus one
    bf16 step. A row that sees no key is 0."""
    plan = split_kv_plan(b, hq, hkv, sq, skv, causal, window, q_offset,
                         wave=H100_WAVE)
    splits, per = plan
    if want == "ragged":
        assert splits > 1 and per > 64
        assert (skv - 1) // 64 + 1 < splits * (per // 64)
    else:
        assert splits == want
    bf16 = route == "bf16"
    q, k, v = _inputs(sq + skv + hq + d + q_offset, b, sq, skv, hq, hkv, d,
                      bf16)
    v = v[..., :dv].contiguous()
    got = attention_split_kv(q, k, v, route, causal=causal, window=window,
                             q_offset=q_offset, plan=plan)
    wants = [_ref_at_offset(q, k, v, causal, window, q_offset)]
    if causal and q_offset + sq == skv and d == dv:
        wants.append(_pallas_at_offset(q, k, v, window, q_offset, b))
    blind = ~_mask(sq, skv, causal, window, q_offset).any(-1)
    assert bool((got[:, blind] == 0).all())
    for want_ in wants:
        if bf16:
            g, w = got.bfloat16().float(), want_.bfloat16().float()
            over = ((g - w).abs() / (TOL + 2.0 ** -7 * w.abs())).max()
            assert over <= 1.0, over
        else:
            err = (got - want_).abs().max().item()
            assert err < TOL, err

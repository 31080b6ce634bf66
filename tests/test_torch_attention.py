"""K6 ``flash_attention`` and ``ops.attention`` of the port against the
JAX package, on the CPU.

The same inputs, made with numpy from seeds, go through the JAX Pallas
kernel in interpret mode (``ops.attention`` on a CPU backend runs it so)
and through the port's wrappers, which take their plain PyTorch version
for CPU tensors. The cases are those of ``tests/test_kernels.py``'s
flash-attention section. Tolerance 2e-4, the reference's own: the sums
run in another order. bf16 inputs are held two ways: in f32 (the bf16
values widened) within 2e-4, and in bf16 within 2e-4 plus one bf16 step
of the result (2^-7 relative: bf16 keeps 8 significant bits), because
two f32 results 2e-7 apart can round to neighbouring bf16 values.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref
from repro.kernels.flash_attention import flash_attention as jax_fa
from repro_torch.kernels import ops as tops
from repro_torch.kernels.flash_attention import (HEAD_DIMS, ROUTES,
                                                 SM90_HEAD_DIMS,
                                                 flash_attention,
                                                 flash_attention_plain,
                                                 flash_attention_route,
                                                 split_kv_plan)

TOL = 2e-4


def _randn(seed, shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _t(x):
    return torch.from_numpy(np.asarray(x, np.float32))


@pytest.mark.parametrize("sq,skv,blocks", [(128, 128, (64, 64)),
                                           (256, 256, (128, 64)),
                                           (64, 192, (32, 64))])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_matches_jax_kernel(sq, skv, blocks, causal):
    q, k, v = (_randn(s, (3, n, 16)) for s, n in ((1, sq), (2, skv),
                                                   (3, skv)))
    bq, bk = blocks
    want = np.asarray(jax_fa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             causal=causal, block_q=bq, block_k=bk,
                             interpret=True))
    got = flash_attention(_t(q), _t(k), _t(v), causal=causal)
    assert got.shape == (3, sq, 16) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)


def test_flash_attention_sliding_window_matches_jax_kernel():
    q, k, v = (_randn(s, (2, 128, 8)) for s in (4, 5, 6))
    want = np.asarray(jax_fa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             causal=True, window=32, block_q=32, block_k=32,
                             interpret=True))
    got = flash_attention(_t(q), _t(k), _t(v), causal=True, window=32)
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("hq,hkv", [(4, 4), (4, 2), (8, 1)])
def test_attention_gqa_matches_jax_ops(hq, hkv):
    q = _randn(7, (2, 64, hq, 16))
    k, v = _randn(8, (2, 64, hkv, 16)), _randn(9, (2, 64, hkv, 16))
    want = np.asarray(jops.attention(jnp.asarray(q), jnp.asarray(k),
                                     jnp.asarray(v), causal=True,
                                     block_q=32, block_k=32))
    got = tops.attention(_t(q), _t(k), _t(v), causal=True)
    assert got.shape == (2, 64, hq, 16)
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)
    # the GQA mapping is the reference's repeat of each kv head
    group = hq // hkv
    kr, vr = np.repeat(k, group, axis=2), np.repeat(v, group, axis=2)
    flat = [x.transpose(0, 2, 1, 3).reshape(2 * hq, 64, 16)
            for x in (q, kr, vr)]
    oracle = np.asarray(ref.ref_attention(*map(jnp.asarray, flat),
                                          causal=True))
    np.testing.assert_allclose(
        got.numpy().transpose(0, 2, 1, 3).reshape(2 * hq, 64, 16), oracle,
        rtol=TOL, atol=TOL)


def test_attention_bf16_matches_jax_ops():
    q, k, v = (_randn(s, (2, 64, 2, 16)) for s in (10, 11, 12))
    jb = [jnp.asarray(x, jnp.bfloat16) for x in (q, k, v)]
    tb = [_t(x).to(torch.bfloat16) for x in (q, k, v)]
    want = jops.attention(*jb, causal=True, block_q=32, block_k=32)
    got = tops.attention(*tb, causal=True)
    assert got.dtype == torch.bfloat16
    want32 = np.asarray(want.astype(jnp.float32))
    got32 = got.to(torch.float32).numpy()
    assert np.isfinite(got32).all()
    np.testing.assert_allclose(got32, want32, rtol=2.0 ** -7, atol=TOL)
    # the algorithm on the same (bf16-valued) inputs, in f32
    want_f = np.asarray(jops.attention(*(x.astype(jnp.float32) for x in jb),
                                       causal=True, block_q=32, block_k=32))
    got_f = tops.attention(*(x.to(torch.float32) for x in tb), causal=True)
    np.testing.assert_allclose(got_f.numpy(), want_f, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("sq,skv,window", [(1000, 1000, 0), (63, 63, 5),
                                           (1, 40, 0)])
def test_attention_ragged_lengths_match_oracle(sq, skv, window):
    """No padding to block multiples: lengths that divide no block size
    match the reference oracle (which pads nothing either)."""
    q, k, v = (_randn(s, (1, n, 2, 16)) for s, n in ((13, sq), (14, skv),
                                                     (15, skv)))
    got = tops.attention(_t(q), _t(k), _t(v), causal=sq == skv,
                         window=window)
    flat = [x.transpose(0, 2, 1, 3).reshape(2, -1, 16) for x in (q, k, v)]
    want = np.asarray(ref.ref_attention(*map(jnp.asarray, flat),
                                        causal=sq == skv, window=window))
    np.testing.assert_allclose(
        got.numpy().transpose(0, 2, 1, 3).reshape(2, sq, 16), want,
        rtol=TOL, atol=TOL)


def test_row_without_visible_key_is_zero():
    """An empty key axis leaves every row without a visible key: each
    row is 0, as the oracle's safe divide gives."""
    q = _t(_randn(16, (1, 4, 1, 16)))
    kv = torch.zeros((1, 0, 1, 16))
    out = tops.attention(q, kv, kv, causal=False)
    assert out.shape == (1, 4, 1, 16) and not out.any()


def test_plain_version_is_the_wrapper_on_cpu():
    q, k, v = (_t(_randn(s, (2, 33, 4, 32))) for s in (17, 18, 19))
    before = flash_attention.launches
    got = flash_attention(q, k[:, :, :2].contiguous(),
                          v[:, :, :2].contiguous(), window=7)
    assert flash_attention.launches == before      # no kernel on the CPU
    want = flash_attention_plain(q, k[:, :, :2], v[:, :, :2], window=7)
    assert torch.equal(got, want)


@pytest.mark.parametrize("dtype,d,dv,sq,route", [
    (torch.bfloat16, 64, 64, 32768, "wgmma"),
    (torch.bfloat16, 128, 128, 65, "wgmma"),
    (torch.bfloat16, 192, 128, 8192, "wgmma"),
    (torch.bfloat16, 64, 64, 64, "split_kv"),
    (torch.bfloat16, 64, 64, 1, "split_kv"),
    (torch.bfloat16, 16, 16, 4096, "mma_sync"),
    (torch.bfloat16, 32, 32, 4096, "mma_sync"),
    (torch.float32, 64, 64, 32768, "wgmma_tf32"),
    (torch.float32, 128, 128, 512, "wgmma_tf32"),
    (torch.float32, 192, 128, 512, "wgmma_tf32"),
    (torch.float32, 64, 64, 128, "wgmma_tf32"),
    (torch.float32, 64, 64, 65, "wgmma_tf32"),
    (torch.float32, 128, 128, 64, "split_kv"),
])
def test_route_of_each_call_class(dtype, d, dv, sq, route):
    """Which kernel a CUDA call goes to: bf16 at the served head dims with
    more than 64 rows to the wgmma kernel, f32 there with more than 64
    rows to the TF32 wgmma kernel, either dtype there with 64 rows or
    fewer to split_kv, head dims 16 and 32 to mma.sync."""
    assert flash_attention_route(dtype, d, dv, sq) == route


@pytest.mark.parametrize("sq", [1, 64, 65, 128, 129, 32768])
@pytest.mark.parametrize("d,dv", HEAD_DIMS)
def test_f32_routing_table(d, dv, sq):
    """f32 takes the TF32 wgmma kernel at the served head dims over 64
    rows, bf16 the bf16 wgmma kernel there; either takes split_kv at
    those dims at 64 rows or fewer, and mma.sync (3xTF32 in f32) at head
    dims 16 and 32."""
    served = (d, dv) in SM90_HEAD_DIMS
    short = "split_kv" if served else "mma_sync"
    assert flash_attention_route(torch.float32, d, dv, sq) == (
        "wgmma_tf32" if served and sq > 64 else short)
    assert flash_attention_route(torch.bfloat16, d, dv, sq) == (
        "wgmma" if served and sq > 64 else short)
    assert set(SM90_HEAD_DIMS) <= set(HEAD_DIMS)
    assert ROUTES == ("wgmma", "wgmma_tf32", "mma_sync", "split_kv")


@pytest.mark.parametrize("b,sq,skv,hq,hkv,d,dv", [
    (8, 512, 512, 16, 16, 192, 128),
    (2, 200, 65, 8, 4, 64, 64),
    (1, 129, 0, 2, 1, 128, 128),
])
def test_tf32_launch_passes_the_scratch_it_allocates(monkeypatch, b, sq,
                                                     skv, hq, hkv, d, dv):
    """The TF32 route's scratch has one account, the kernel library's:
    ``_launch`` asks it for the words (``tf32_scratch_words``), allocates
    that many and passes the count to the entry point, which refuses a
    smaller one. Run on CPU tensors with the library and the launch
    stood in for, so that only the wrapper's side is held here (the
    card's tests hold the count and the refusal)."""
    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_attention as fa
    words = 7 * b * hkv * (skv + d + dv) + 3
    asked, launched = [], []

    class Library:
        def reconic_flash_attention_sm90_tf32_scratch_words(self, *args):
            asked.append(args)
            return words

    monkeypatch.setattr(_build, "library", Library)
    monkeypatch.setattr(_build, "stream_ptr", lambda device: 0)
    monkeypatch.setattr(_build, "launch",
                        lambda name, *args: launched.append((name, args)))
    q, k, v = (torch.zeros(shape) for shape in ((b, sq, hq, d),
                                               (b, skv, hkv, d),
                                               (b, skv, hkv, dv)))
    out = torch.empty((b, sq, hq, dv))
    before = dict(flash_attention.route_launches)
    fa._launch("wgmma_tf32", q, k, v, out, True, 0, d ** -0.5)
    assert asked == [(b, hkv, skv, d, dv)]
    [(name, args)] = launched
    assert name == "reconic_flash_attention_sm90_tf32"
    assert args[:4] == (q.data_ptr(), k.data_ptr(), v.data_ptr(),
                        out.data_ptr())
    assert args[5:12] == (words, b, hq, hkv, sq, skv, d) and args[12] == dv
    assert flash_attention.route_launches == {
        **before, "wgmma_tf32": before["wgmma_tf32"] + 1}


def _visible(sq, skv, causal, window, q_offset):
    """The keys some query row sees, by the plain version's mask."""
    i = q_offset + np.arange(sq)[:, None]
    j = np.arange(skv)[None, :]
    seen = np.ones((sq, skv), bool)
    if causal:
        seen &= i >= j
    if window > 0:
        seen &= i - j < window
    return np.flatnonzero(seen.any(0))


@pytest.mark.parametrize("sq", [1, 3, 64])
@pytest.mark.parametrize("b,hq,hkv", [(1, 1, 1), (8, 1, 1), (8, 32, 4),
                                      (2, 25, 5), (8, 32, 8)])
def test_split_kv_plan_covers_the_visible_keys_once(b, hq, hkv, sq):
    """``split_kv_plan`` over a grid of key counts, masks and offsets: at
    least one split, each a whole number of 64-key tiles, the runs laid
    from the first row's window edge rounded down to a tile (where the
    launcher starts them) holding every visible key in exactly one run,
    no run starting past the last visible key (one split when none is
    visible), one split when the keys fit in one tile or the blocks alone
    fill a wave (the blocks the card holds at once: 1, 3 and 4 on each
    of 132 SMs here), else the blocks of all splits within the wave with
    the fewest tiles a split that keeps them there, and the same answer
    on every call."""
    for skv, wave in ((0, 528), (1, 396), (63, 528), (100, 132),
                      (1000, 528), (8192, 396), (32768, 528),
                      (32768, 132)):
        for causal, window in ((True, 0), (False, 0), (True, 16),
                               (True, 1024)):
            for off in {0, max(skv - sq, 0), skv + 5}:
                args = (b, hq, hkv, sq, skv, causal, window, off)
                splits, per = split_kv_plan(*args, wave=wave)
                assert split_kv_plan(*args, wave=wave) == (splits, per)
                assert splits >= 1 and per >= 64 and per % 64 == 0
                keys = _visible(sq, skv, causal, window, off)
                if not keys.size:
                    assert splits == 1, args
                    continue
                lo = max(0, off - window + 1) // 64 * 64 if window else 0
                run = (keys - lo) // per
                assert run.min() >= 0 and run.max() < splits, args
                assert lo + (splits - 1) * per <= keys.max(), args
                tiles = -(-(keys.max() + 1 - lo) // 64)
                most = wave // (b * hkv * -(-(hq // hkv * sq) // 64))
                if tiles <= 1 or most <= 1:
                    assert splits == 1, args
                else:
                    assert splits <= most, args
                    fewer = per // 64 - 1
                    assert fewer == 0 or -(-tiles // fewer) > most, args


def test_split_kv_plan_at_the_decode_shapes():
    """The plan at phase 2's decode shapes, at the waves an H100 reports
    for them (4 one-warp blocks an SM in bf16 at head dim 64, 3 at 128
    and in f32 at 64; ``splitkv_wave``): seamless's cut cross decode (8 x
    1 over 8192 frames, one head) in 64 splits of 2 tiles (512 blocks),
    its f32 decode over 128 frames in 2 of 1, tinyllama's decode at slot
    32767 (8 x 4 kv heads) in 16 of 32 tiles, qwen3-4b's (8 x 8 kv heads
    of 128) in 6 of 86, the last of 82, hymba's window of 1024 keys (8 x
    5 kv heads) in 8 of 2."""
    assert split_kv_plan(8, 1, 1, 1, 8192, False, 0, 0,
                         wave=528) == (64, 128)
    assert split_kv_plan(8, 16, 16, 1, 128, False, 0, 0,
                         wave=396) == (2, 64)
    assert split_kv_plan(8, 32, 4, 1, 32768, True, 0, 32767,
                         wave=528) == (16, 2048)
    assert split_kv_plan(8, 32, 8, 1, 32768, True, 0, 32767,
                         wave=396) == (6, 5504)
    assert split_kv_plan(8, 25, 5, 1, 32768, True, 1024, 32767,
                         wave=528) == (8, 128)


@pytest.mark.parametrize("b,sq,skv,hq,hkv,d,dv,causal,window,q_offset", [
    (8, 1, 8192, 1, 1, 64, 64, False, 0, 0),
    (8, 1, 128, 16, 16, 64, 64, False, 0, 0),
    (2, 3, 1000, 8, 1, 192, 128, True, 16, 997),
])
def test_split_kv_launch_passes_its_plan_and_scratch(
        monkeypatch, b, sq, skv, hq, hkv, d, dv, causal, window, q_offset):
    """``_launch("split_kv")`` passes ``split_kv_plan``'s splits and keys
    a split at the wave the card holds (``splitkv_wave``, asked for the
    call's warps: one a 16-row part of its packed rows, at most 4), and
    a scratch of the library's own count
    (``splitkv_scratch_words``) when there are several splits, none for
    one; each call counts once on its route. CPU tensors, with the
    library and the launch stood in for: the card's tests hold the kernel
    and its refusals."""
    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_attention as fa
    asked, launched = [], []

    class Library:
        def reconic_flash_attention_splitkv_scratch_words(self, *args):
            asked.append(args)
            return 0 if args[-1] == 1 else 3 * args[-1] + 5

    monkeypatch.setattr(_build, "library", Library)
    monkeypatch.setattr(_build, "stream_ptr", lambda device: 0)
    monkeypatch.setattr(_build, "launch",
                        lambda name, *args: launched.append((name, args)))
    waves = []
    monkeypatch.setattr(fa, "splitkv_wave",
                        lambda *args: waves.append(args) or 396)
    q, k, v = (torch.zeros(shape) for shape in ((b, sq, hq, d),
                                               (b, skv, hkv, d),
                                               (b, skv, hkv, dv)))
    out = torch.empty((b, sq, hq, dv))
    before = dict(flash_attention.route_launches)
    fa._launch("split_kv", q, k, v, out, causal, window, d ** -0.5,
               q_offset)
    assert waves == [(q.dtype, d, dv, -(-min(hq // hkv * sq, 64) // 16))]
    splits, per = split_kv_plan(b, hq, hkv, sq, skv, causal, window,
                                q_offset, wave=396)
    assert asked == [(b, hq, sq, dv, splits)]
    [(name, args)] = launched
    assert name == "reconic_flash_attention_splitkv"
    assert args[:4] == (q.data_ptr(), k.data_ptr(), v.data_ptr(),
                        out.data_ptr())
    words = 0 if splits == 1 else 3 * splits + 5
    assert (args[4] != 0) == (splits > 1) and args[5] == words
    assert args[6:13] == (b, hq, hkv, sq, skv, d, dv)
    assert args[13:16] == (int(causal), window, q_offset)
    assert args[17:20] == (0, splits, per)
    assert flash_attention.route_launches == {
        **before, "split_kv": before["split_kv"] + 1}


def test_bad_arguments_raise():
    q = torch.zeros((1, 8, 4, 16))
    with pytest.raises(ValueError, match="shapes"):
        flash_attention(q, torch.zeros((1, 8, 3, 16)),
                        torch.zeros((1, 8, 3, 16)))
    with pytest.raises(TypeError):
        flash_attention(q, q.double(), q.double())
    with pytest.raises(ValueError, match="window"):
        flash_attention(q, q, q, window=-1)
    assert HEAD_DIMS == ((16, 16), (32, 32), (64, 64), (128, 128),
                         (192, 128))


def test_ragged_non_causal_keys_are_masked_unlike_reference_padding():
    """The reference's ``ops.attention`` zero-pads a key length that no
    block divides (13 -> 128) and, without a causal mask, lets the
    padded zero keys into the softmax; its oracle ``ref_attention`` does
    not. The port pads nothing and matches the oracle. Pins the
    reference's deviation (ROADMAP Queue 3) next to the port's result."""
    q, k, v = (_randn(s, (1, 13, 2, 16)) for s in (20, 21, 22))
    flat = [jnp.asarray(x.transpose(0, 2, 1, 3).reshape(2, 13, 16))
            for x in (q, k, v)]
    oracle = np.asarray(ref.ref_attention(*flat, causal=False)).reshape(
        1, 2, 13, 16).transpose(0, 2, 1, 3)
    got = tops.attention(_t(q), _t(k), _t(v), causal=False).numpy()
    np.testing.assert_allclose(got, oracle, rtol=TOL, atol=TOL)
    ref_ops = np.asarray(jops.attention(*map(jnp.asarray, (q, k, v)),
                                        causal=False))
    assert np.abs(ref_ops - oracle).max() > 0.1


def _bf16_close(got, want):
    """bf16 results within 2e-4 plus one bf16 step of the result."""
    got32 = got.to(torch.float32).numpy()
    want32 = np.asarray(want.astype(jnp.float32))
    assert np.isfinite(got32).all()
    np.testing.assert_allclose(got32, want32, rtol=2.0 ** -7, atol=TOL)


@pytest.mark.parametrize("hq,hkv", [(8, 2), (7, 1), (16, 2)])
def test_plain_bf16_at_head_dim_128_matches_jax_ops(hq, hkv):
    """K6's plain version in bf16 at the served head dim 128 with GQA 4
    (qwen3-4b), 7 (qwen2-vl-7b) and 8 (qwen2.5-3b) against the JAX
    Pallas kernel in interpret mode, causal, with a ragged length."""
    q = _randn(30, (1, 100, hq, 128))
    k, v = _randn(31, (1, 100, hkv, 128)), _randn(32, (1, 100, hkv, 128))
    jb = [jnp.asarray(x, jnp.bfloat16) for x in (q, k, v)]
    want = jops.attention(*jb, causal=True, block_q=32, block_k=32)
    got = flash_attention_plain(*(_t(x).to(torch.bfloat16)
                                  for x in (q, k, v)), causal=True)
    assert got.dtype == torch.bfloat16 and got.shape == (1, 100, hq, 128)
    _bf16_close(got, want)


def test_plain_bf16_at_mla_heads_matches_jax_attention():
    """K6's plain version in bf16 at MLA's q and k 192 wide, v 128, 16
    heads, causal, against the reference's attention (its model's
    ``attention_core``: ``ops.attention`` takes one head dim for q, k
    and v)."""
    from repro.models.layers import attention_core as jax_attention
    q, k = _randn(33, (2, 40, 16, 192)), _randn(34, (2, 40, 16, 192))
    v = _randn(35, (2, 40, 16, 128))
    jb = [jnp.asarray(x, jnp.bfloat16) for x in (q, k, v)]
    want = jax_attention(*jb, causal=True)
    got = flash_attention_plain(*(_t(x).to(torch.bfloat16)
                                  for x in (q, k, v)), causal=True)
    assert got.dtype == torch.bfloat16 and got.shape == (2, 40, 16, 128)
    _bf16_close(got, want)


@pytest.mark.parametrize("causal,window", [(True, 0), (True, 6),
                                           (False, 0)])
def test_plain_row_slice_at_its_offset_is_the_whole_call(causal, window):
    """``q_offset``: the plain version over a slice of the query rows,
    given their offset, equals those rows of the whole call (how the
    card's checks hold K6 at 32k rows, whose scores would not fit)."""
    q, k, v = (_t(_randn(s, (2, 50, 4, 16))).to(torch.bfloat16)
               for s in (36, 37, 38))
    whole = flash_attention_plain(q, k, v, causal=causal, window=window)
    for r0, r1 in ((0, 7), (20, 33), (42, 50)):
        part = flash_attention_plain(q[:, r0:r1], k, v, causal=causal,
                                     window=window, q_offset=r0)
        assert torch.equal(part, whole[:, r0:r1])

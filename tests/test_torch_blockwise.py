"""The blockwise-attention knob of the port (``set_attention_impl``,
``_attention_blockwise``) against the JAX package, on the CPU.

The same inputs, made with numpy from seeds, go through the reference's
``repro/models/layers.py`` and the port's ``repro_torch/models/layers.py``.
The reference's own blockwise tests (``tests/test_parallelism.py``:
blockwise against naive, decode with ``kv_len``, finite gradients at a
window, the model's logits under both impls) run on the port at their
tolerances (2e-5; 3e-5 for logits); beside them the port's blockwise
function is held against the reference's blockwise and naive ones
within 2e-5 (f32; bf16 within one bf16 step of the largest output),
with a ragged last chunk and MLA's v narrower than q and k. Gradients
are held to ``jax.grad`` of the reference's blockwise function, and
``loss_fn`` and its gradients under ``"blockwise"`` to the reference's
under the same setting, within ``tests/test_torch_train.py``'s 1e-5
(loss, relative) and 2e-5 of each gradient leaf's largest |value|. In
the port the blockwise impl changes only what K6's backward recomputes
(and attention over a cache); its forward stays K6, so the logits and
K6's forward are the same under both impls.

Every test that sets the impl restores ``"naive"`` in both packages
(the ``impl`` fixture).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models as JM
from repro.configs.registry import get_config as jax_config
from repro.models import layers as JL
from repro_torch._tree import tree_leaves
from repro_torch.configs.registry import get_config
from repro_torch.data.pipeline import DataConfig, SyntheticPipeline
from repro_torch.kernels import ops
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.models import (forward, init_params, loss_fn,
                                params_from_jax)
from repro_torch.models import layers as TL

TOL = 2e-5
LOGITS_TOL = 3e-5
LOSS_RTOL = 1e-5
GRAD_TOL = 2e-5

CASES = [(True, 0), (True, 24), (False, 0)]


@pytest.fixture
def impl():
    """Sets both packages' impl with ``impl(name, chunk)``; restores
    ``"naive"`` in both after the test."""
    def set_both(name, chunk=2048):
        JL.set_attention_impl(name, chunk)
        TL.set_attention_impl(name, chunk)
    with TL.attention_impl("naive"):
        try:
            yield set_both
        finally:
            JL.set_attention_impl("naive")


def _randn(seed, *shapes):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


def _both(fn_j, fn_t, arrays, dtype=np.float32, **kw):
    """``fn_j`` on jnp arrays and ``fn_t`` on torch tensors of ``arrays``
    (cast to ``dtype``), each as f32 numpy."""
    jd = jnp.bfloat16 if dtype == "bf16" else jnp.float32
    td = torch.bfloat16 if dtype == "bf16" else torch.float32
    want = fn_j(*[jnp.asarray(a).astype(jd) for a in arrays], **kw)
    got = fn_t(*[torch.from_numpy(a).to(td) for a in arrays], **kw)
    return (got.float().numpy(), np.asarray(want.astype(jnp.float32)))


def _count_chunks(monkeypatch) -> list:
    """A list that gains an entry each time a blockwise chunk's body runs
    (forward, or its recompute in a backward)."""
    calls, real = [], TL._blockwise_chunk
    monkeypatch.setattr(TL, "_blockwise_chunk",
                        lambda *a, **kw: calls.append(1) or real(*a, **kw))
    return calls


def _bf16_step(x) -> float:
    """One bf16 step at |x|: 2^(exponent - 7), bf16 keeping 8 bits."""
    return float(2.0 ** (np.floor(np.log2(np.abs(x))) - 7))


# ---------------------------------------------------------------------------
# the reference's blockwise tests (tests/test_parallelism.py), on the port
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("causal,window", CASES)
def test_blockwise_equals_naive(causal, window):
    q, k, v = [torch.from_numpy(a) for a in _randn(
        0, (2, 96, 4, 16), (2, 96, 2, 16), (2, 96, 2, 16))]
    a = TL._attention_naive(q, k, v, causal=causal, window=window,
                            q_offset=0, kv_len=None)
    b = TL._attention_blockwise(q, k, v, causal=causal, window=window,
                                q_offset=0, kv_len=None, chunk=32)
    np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=TOL, atol=TOL)


def test_blockwise_decode_with_kv_len():
    q, k, v = [torch.from_numpy(a) for a in _randn(
        1, (2, 1, 4, 16), (2, 96, 2, 16), (2, 96, 2, 16))]
    kv_len = torch.tensor([50, 70])
    a = TL._attention_naive(q, k, v, causal=True, window=0, q_offset=49,
                            kv_len=kv_len)
    b = TL._attention_blockwise(q, k, v, causal=True, window=0,
                                q_offset=49, kv_len=kv_len, chunk=32)
    np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("window", [0, 16])
def test_blockwise_grads_finite_dynamic_window(window):
    qn, kn, vn = _randn(2, (1, 64, 2, 8), (1, 64, 2, 8), (1, 64, 2, 8))
    q = torch.from_numpy(qn).requires_grad_()
    k, v = torch.from_numpy(kn), torch.from_numpy(vn)
    out = TL._attention_blockwise(q, k, v, causal=True, window=window,
                                  q_offset=0, kv_len=None, chunk=16)
    (g,) = torch.autograd.grad(out.sum(), (q,))
    assert bool(torch.isfinite(g).all())

    def f(qq):
        return JL._attention_blockwise(
            qq, jnp.asarray(kn), jnp.asarray(vn), causal=True,
            window=jnp.int32(window), q_offset=0, kv_len=None,
            chunk=16).sum()

    want = np.asarray(jax.grad(f)(jnp.asarray(qn)))
    np.testing.assert_allclose(g.numpy(), want, rtol=0,
                               atol=GRAD_TOL * np.abs(want).max())


def test_model_forward_same_under_blockwise(impl):
    """Whole-model logits identical under both attention lowerings."""
    cfg = get_config("tiny")
    params = init_params(cfg, 0, device="cpu")
    tokens = torch.from_numpy(np.random.default_rng(1).integers(
        0, 256, (2, 64)).astype(np.int32))
    impl("naive")
    a, _, _ = forward(params, cfg, {"tokens": tokens})
    impl("blockwise", 16)
    b, _, _ = forward(params, cfg, {"tokens": tokens})
    np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=LOGITS_TOL,
                               atol=LOGITS_TOL)


# ---------------------------------------------------------------------------
# the port's blockwise function against the reference's
# ---------------------------------------------------------------------------

SHAPES = {"square": ((2, 96, 4, 16), (2, 96, 2, 16), (2, 96, 2, 16)),
          "ragged": ((2, 100, 4, 16), (2, 100, 2, 16), (2, 100, 2, 16)),
          "mla_dv": ((2, 96, 4, 24), (2, 96, 2, 24), (2, 96, 2, 16))}


@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("causal,window", CASES)
@pytest.mark.parametrize("ref", ["blockwise", "naive"])
def test_blockwise_matches_the_reference(ref, causal, window, shape):
    kw = dict(causal=causal, window=window, q_offset=0, kv_len=None)
    fn_j = (functools.partial(JL._attention_blockwise, chunk=32)
            if ref == "blockwise" else JL._attention_naive)
    got, want = _both(fn_j, functools.partial(TL._attention_blockwise,
                                              chunk=32),
                      _randn(3, *SHAPES[shape]), **kw)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("causal,window", CASES)
def test_blockwise_bf16_matches_the_reference(causal, window):
    """bf16 inputs: the scores in f32 from the bf16 values, P rounded to
    bf16 before PV, on both sides; within one bf16 step of the largest
    output (two f32 sums in another order can round apart)."""
    got, want = _both(functools.partial(JL._attention_blockwise, chunk=32),
                      functools.partial(TL._attention_blockwise, chunk=32),
                      _randn(4, (2, 96, 4, 16), (2, 96, 2, 16),
                             (2, 96, 2, 16)), dtype="bf16", causal=causal,
                      window=window, q_offset=0, kv_len=None)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=_bf16_step(np.abs(want).max()))


def test_blockwise_decode_matches_the_reference():
    kv_len = np.array([50, 70], np.int32)
    arrays = _randn(5, (2, 1, 4, 16), (2, 96, 2, 16), (2, 96, 2, 16))
    want = JL._attention_blockwise(*map(jnp.asarray, arrays), causal=True,
                                   window=0, q_offset=49,
                                   kv_len=jnp.asarray(kv_len), chunk=32)
    got = TL._attention_blockwise(*map(torch.from_numpy, arrays),
                                  causal=True, window=0, q_offset=49,
                                  kv_len=torch.from_numpy(kv_len), chunk=32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)


@pytest.mark.parametrize("shape", ["square", "ragged", "mla_dv"])
@pytest.mark.parametrize("window", [0, 16])
def test_blockwise_grads_match_jax(window, shape):
    """q, k and v's gradients of a weighted sum of the output equal
    ``jax.grad`` of the reference's blockwise function within 2e-5 of
    each gradient's largest |value|."""
    qn, kn, vn = _randn(6, *SHAPES[shape])
    wn, = _randn(7, qn.shape[:3] + vn.shape[-1:])

    def f(q, k, v):
        return (JL._attention_blockwise(
            q, k, v, causal=True, window=jnp.int32(window), q_offset=0,
            kv_len=None, chunk=32) * jnp.asarray(wn)).sum()

    want = jax.grad(f, argnums=(0, 1, 2))(*map(jnp.asarray, (qn, kn, vn)))
    inputs = [torch.from_numpy(a).requires_grad_() for a in (qn, kn, vn)]
    out = TL._attention_blockwise(*inputs, causal=True, window=window,
                                  q_offset=0, kv_len=None, chunk=32)
    got = torch.autograd.grad((out * torch.from_numpy(wn)).sum(), inputs)
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert bool(torch.isfinite(g).all())
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=GRAD_TOL * np.abs(w).max())


# ---------------------------------------------------------------------------
# dispatch: K6's backward, attention over a cache
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", ["square", "ragged", "mla_dv"])
@pytest.mark.parametrize("causal,window", CASES)
def test_k6_backward_under_blockwise_equals_naive(impl, monkeypatch, causal,
                                                  window, shape):
    """``attention_core`` from an empty cache is K6 under both impls:
    the same forward, no plain-attention fallback; under ``"blockwise"``
    its backward recomputes the scan over chunks of 32 keys, and its
    gradients equal the naive backward's within 2e-5 of each largest
    |value|."""
    arrays = _randn(8, *SHAPES[shape])
    wt = torch.from_numpy(_randn(9, arrays[0].shape[:3]
                                 + arrays[2].shape[-1:])[0])
    outs, grads = {}, {}
    chunks = _count_chunks(monkeypatch)
    for name in ("naive", "blockwise"):
        impl(name, 32)
        inputs = [torch.from_numpy(a).requires_grad_() for a in arrays]
        outs[name] = TL.attention_core(*inputs, causal=causal, window=window)
        assert outs[name].grad_fn.name().startswith("_FlashAttention")
        assert not chunks                       # the forward is K6's
        grads[name] = torch.autograd.grad((outs[name] * wt).sum(), inputs)
    # each chunk of 32 keys run by the recompute, then again in its own
    # backward (the checkpoint)
    assert len(chunks) == 2 * -(-arrays[1].shape[1] // 32)
    assert torch.equal(outs["naive"], outs["blockwise"])
    for g, w in zip(grads["blockwise"], grads["naive"]):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=0,
                                   atol=GRAD_TOL * w.abs().max().item())


def test_ops_attention_takes_the_backward_function():
    """``ops.attention(backward=)`` hands the function to K6's backward
    and leaves the forward K6's; a scale cannot be given beside it."""
    arrays = _randn(10, (1, 80, 2, 16), (1, 80, 1, 16), (1, 80, 1, 16))
    seen = []

    def recompute(q, k, v, *, causal, window):
        seen.append((tuple(q.shape), causal, window))
        return TL._attention_blockwise(q, k, v, causal=causal, window=window,
                                       q_offset=0, kv_len=None, chunk=32)

    inputs = [torch.from_numpy(a).requires_grad_() for a in arrays]
    out = ops.attention(*inputs, causal=True, window=8, backward=recompute)
    assert seen == []
    torch.autograd.grad(out.sum(), inputs)
    assert seen == [((1, 80, 2, 16), True, 8)]
    with pytest.raises(ValueError, match="default scale"):
        flash_attention(*inputs, scale=0.5, backward=recompute)


@pytest.mark.parametrize("sq,skv,chunk,blockwise", [
    (8, 96, 32, True),         # over a cache, more keys than a chunk
    (8, 96, 96, False),        # no more keys than a chunk: naive
    (1, 96, 32, False),        # decode: naive, as the reference
])
def test_attention_over_a_cache_follows_the_reference_rule(
        impl, monkeypatch, sq, skv, chunk, blockwise):
    """Over a cache (``q_offset``, ``kv_len``) the port dispatches as the
    reference's ``attention_core``: the scan only under ``"blockwise"``
    with more keys than the chunk and more than one query row; each
    result within 2e-5 of the reference's under the same setting."""
    arrays = _randn(11, (2, sq, 4, 16), (2, skv, 2, 16), (2, skv, 2, 16))
    kv_len = np.array([60, 90], np.int32)
    impl("blockwise", chunk)
    calls = []
    real = TL._attention_blockwise
    monkeypatch.setattr(TL, "_attention_blockwise",
                        lambda *a, **kw: calls.append(1) or real(*a, **kw))
    want = JL.attention_core(*map(jnp.asarray, arrays), causal=True,
                             window=0, q_offset=52,
                             kv_len=jnp.asarray(kv_len))
    got = TL.attention_core(*map(torch.from_numpy, arrays), causal=True,
                            window=0, q_offset=52,
                            kv_len=torch.from_numpy(kv_len))
    assert bool(calls) == blockwise
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)


# ---------------------------------------------------------------------------
# the loss and its gradients under "blockwise", against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["tiny", "hymba-1.5b-smoke"])
@pytest.mark.parametrize("remat", [False, True])
def test_loss_and_grads_under_blockwise_match_jax(impl, monkeypatch, arch,
                                                   remat):
    chunks = _count_chunks(monkeypatch)
    jc, tc = jax_config(arch), get_config(arch)
    jp = JM.init_params(jc, jax.random.PRNGKey(0))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    batch = SyntheticPipeline(DataConfig(seed=3, vocab_size=tc.vocab_size,
                                         batch=2, seq_len=32)).batch_at(0)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    impl("blockwise", 16)
    want, jgrads = jax.value_and_grad(
        lambda p: JM.loss_fn(p, jc, jb, remat=remat))(jp)
    leaves = [t.requires_grad_() for t in tree_leaves(tp)]
    loss = loss_fn(tp, tc, tb, remat=remat)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                materialize_grads=True)
    assert abs(float(loss.detach()) - float(want)) <= \
        LOSS_RTOL * abs(float(want))
    assert chunks, "the backward never ran the blockwise scan"
    for g, w, name in zip(grads, jax.tree.leaves(jgrads),
                          jax.tree_util.tree_leaves_with_path(jgrads)):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=GRAD_TOL * np.abs(w).max(initial=0.0),
                                   err_msg=str(name[0]))


def test_blockwise_backward_runs_on_meta(impl):
    """The checkpointed chunks run on ``meta`` (the dry-run's device):
    the loss's gradients there have the parameters' shapes."""
    cfg = dataclasses.replace(get_config("tiny"), num_layers=1)
    params = init_params(cfg, 0, device="meta")
    tokens = torch.zeros((2, 48), dtype=torch.int32, device="meta")
    impl("blockwise", 16)
    leaves = [t.requires_grad_() for t in tree_leaves(params)]
    loss = loss_fn(params, cfg, {"tokens": tokens, "labels": tokens},
                   remat=True)
    grads = torch.autograd.grad(loss, leaves)
    assert [g.shape for g in grads] == [p.shape for p in leaves]


def test_set_attention_impl_refuses_an_unknown_impl():
    with pytest.raises(AssertionError):
        TL.set_attention_impl("flash")
    assert TL.get_attention_impl() == "naive"

"""The port's dense serving path against the JAX package, on the CPU.

The JAX package's parameters (``repro.models.init_params``) go through
``params_from_jax``, so both packages compute on the same weights; token
ids come from numpy seeds. Tolerances: logits within 5e-5 of JAX's (the
reference's own prefill/decode bound in ``tests/test_models.py``; the
matmuls and attention sums run in another order), greedy tokens equal.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models as JM
import repro.models.transformer as JT
import repro.serve as JS
from repro.configs.registry import get_config as jax_config
from repro_torch.configs.registry import ARCHS, get_config
from repro_torch.launch.serve import run
from repro_torch.models import (forward, init_caches, init_params,
                                layer_windows, params_from_jax)
from repro_torch.models.transformer import check_supported
from repro_torch.serve import decode_step, greedy_generate, prefill_step

DENSE = ["tiny", "tinyllama-1.1b-smoke", "qwen2.5-3b-smoke",
         "qwen3-4b-smoke"]
TOL = 5e-5


def _swa(cfg):
    """A 3-layer sliding-window variant (layer 1 windowed, 0 and 2
    global) to take the window path through both packages."""
    return dataclasses.replace(cfg, name=cfg.name + "-swa", num_layers=3,
                               attention_kind="swa", sliding_window=5)


def _pair(arch, swa=False):
    jc, tc = jax_config(arch), get_config(arch)
    if swa:
        jc, tc = _swa(jc), _swa(tc)
    params = JM.init_params(jc, jax.random.PRNGKey(0))
    tp = params_from_jax(jax.tree.map(np.asarray, params), device="cpu")
    return jc, tc, params, tp


def _tokens(cfg, b, s, seed=0):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (b, s)).astype(np.int32)


@pytest.mark.parametrize("arch", DENSE)
def test_forward_logits_match_jax(arch):
    jc, tc, jp, tp = _pair(arch)
    tok = _tokens(jc, 2, 32)
    want, _, _ = JM.forward(jp, jc, {"tokens": jnp.asarray(tok)})
    got, caches, aux = forward(tp, tc, {"tokens": torch.from_numpy(tok)})
    assert caches is None and float(aux) == 0.0
    assert got.shape == (2, 32, tc.padded_vocab())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)


def test_sliding_window_forward_matches_jax():
    jc, tc, jp, tp = _pair("tiny", swa=True)
    assert layer_windows(tc, 3) == list(np.asarray(JT.layer_windows(jc, 3)))
    assert layer_windows(tc, 3) == [0, 5, 0]
    tok = _tokens(jc, 2, 24, seed=3)
    want, _, _ = JM.forward(jp, jc, {"tokens": jnp.asarray(tok)})
    got, _, _ = forward(tp, tc, {"tokens": torch.from_numpy(tok)})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)


@pytest.mark.parametrize("arch,swa", [("tiny", False),
                                      ("tinyllama-1.1b-smoke", False),
                                      ("qwen2.5-3b-smoke", False),
                                      ("tiny", True)])
def test_prefill_decode_matches_full_forward(arch, swa):
    """The invariant of ``tests/test_models.py``: prefill 12 tokens, then
    decode 4 teacher-forced; every step's logits equal the full forward's
    at that position within 5e-5. The port's steps also match JAX's."""
    jc, tc, jp, tp = _pair(arch, swa)
    tok = _tokens(tc, 2, 16, seed=1)
    toks = torch.from_numpy(tok)
    full, _, _ = forward(tp, tc, {"tokens": toks})
    caches = init_caches(tc, 2, 16, torch.float32, device="cpu")
    lg, caches = prefill_step(tp, tc, {"tokens": toks[:, :12]}, caches)
    assert caches["scan"]["pos"].tolist() == [12] * tc.num_layers
    jcache = JM.init_caches(jc, 2, 16, jnp.float32)
    jlg, jcache = JS.prefill_step(jp, jc, {"tokens": jnp.asarray(tok[:, :12])},
                                  jcache)
    errs = [float((lg[:, -1] - full[:, 11]).abs().max())]
    np.testing.assert_allclose(lg.numpy(), np.asarray(jlg), rtol=TOL,
                               atol=TOL)
    for i in range(12, 16):
        lg, caches = decode_step(tp, tc, toks[:, i:i + 1], caches, i)
        jlg, jcache = JS.decode_step(jp, jc, jnp.asarray(tok[:, i:i + 1]),
                                     jcache, jnp.int32(i))
        errs.append(float((lg[:, 0] - full[:, i]).abs().max()))
        np.testing.assert_allclose(lg.numpy(), np.asarray(jlg), rtol=TOL,
                                   atol=TOL)
    assert max(errs) < TOL, f"{arch}: decode mismatch {errs}"
    for key in ("k", "v", "pos"):
        np.testing.assert_allclose(caches["scan"][key].numpy(),
                                   np.asarray(jcache["scan"][key]),
                                   rtol=TOL, atol=TOL)


@pytest.mark.parametrize("arch", ["tiny", "qwen3-4b-smoke"])
def test_greedy_tokens_equal_jax(arch):
    jc, tc, jp, tp = _pair(arch)
    tok = _tokens(jc, 2, 8, seed=2)
    want = JS.greedy_generate(jp, jc, jnp.asarray(tok), max_new=6,
                              max_seq=24)
    got = greedy_generate(tp, tc, torch.from_numpy(tok), max_new=6,
                          max_seq=24)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_attention_from_empty_cache_runs_k6_path():
    """Prefill from position 0 and a forward without caches take the K6
    wrapper once per layer; decode does not (plain attention over the
    cache). On the CPU the wrapper runs its plain version and counts no
    launch, so the calls are counted here by wrapping it."""
    import repro_torch.kernels.ops as ops
    tc = get_config("tiny")
    tp = init_params(tc, 0, device="cpu")
    calls = []
    inner = ops._fa.flash_attention

    def counting(*a, **kw):
        calls.append(a[0].shape)
        return inner(*a, **kw)

    ops._fa.flash_attention = counting
    try:
        toks = torch.from_numpy(_tokens(tc, 2, 9))
        forward(tp, tc, {"tokens": toks})
        assert len(calls) == tc.num_layers
        caches = init_caches(tc, 2, 16, torch.float32, device="cpu")
        _, caches = prefill_step(tp, tc, {"tokens": toks}, caches)
        assert len(calls) == 2 * tc.num_layers
        decode_step(tp, tc, toks[:, :1], caches, 9)
        assert len(calls) == 2 * tc.num_layers
    finally:
        ops._fa.flash_attention = inner


def test_init_caches_keys_and_shapes_match_jax():
    for arch in DENSE:
        jc, tc = jax_config(arch), get_config(arch)
        want = JM.init_caches(jc, 3, 20, jnp.float32)
        got = init_caches(tc, 3, 20, torch.float32, device="cpu")
        assert set(got) == set(want) == {"scan"}
        assert set(got["scan"]) == set(want["scan"]) == {"k", "v", "pos"}
        for key in ("k", "v", "pos"):
            assert tuple(got["scan"][key].shape) == want["scan"][key].shape
            assert str(got["scan"][key].dtype).split(".")[-1] == str(
                want["scan"][key].dtype)


def test_init_params_tree_and_distribution():
    """The port's own init: the reference's tree, shapes and dtypes, and
    its init_dense scale sqrt(2 / (d_in + d_out))."""
    jc, tc = jax_config("tinyllama-1.1b-smoke"), get_config(
        "tinyllama-1.1b-smoke")
    want = jax.tree.map(lambda x: (x.shape, str(x.dtype)),
                        JM.init_params(jc, jax.random.PRNGKey(0)))

    def shapes(tree):
        if isinstance(tree, dict):
            return {k: shapes(v) for k, v in tree.items()}
        return (tuple(tree.shape), str(tree.dtype).split(".")[-1])

    tp = init_params(tc, 7, device="cpu")
    assert shapes(tp) == want
    w = tp["layers"]["ffn"]["mlp"]["w_gate"]
    assert abs(float(w.std()) - (2.0 / (64 + 128)) ** 0.5) < 0.01
    again = init_params(tc, 7, device="cpu")
    assert torch.equal(again["embed"], tp["embed"])      # seeded


@pytest.mark.parametrize("arch", [a + "-smoke" for a in ARCHS])
def test_every_registry_arch_builds(arch):
    """Every architecture of the registry is admitted: the port's own
    ``init_params`` and ``init_caches`` give the JAX package's trees,
    shapes and dtypes (``enc_layers`` / ``dec_layers`` and ``{"self"}``
    caches for enc-dec, QKV biases for qwen2-vl, ...)."""
    jc, tc = jax_config(arch), get_config(arch)

    def shapes(tree):
        if isinstance(tree, dict):
            return {k: shapes(v) for k, v in tree.items()}
        return (tuple(tree.shape), str(tree.dtype).split(".")[-1])

    want = shapes(jax.eval_shape(
        lambda: JM.init_params(jc, jax.random.PRNGKey(0))))
    assert shapes(init_params(tc, 1, device="cpu")) == want
    want = shapes(JM.init_caches(jc, 2, 8, jnp.float32))
    assert shapes(init_caches(tc, 2, 8, torch.float32, device="cpu")) == want


def test_unknown_family_raises():
    for arch in ("deepseek-v2-lite-16b-smoke", "phi3.5-moe-42b-smoke"):
        check_supported(get_config(arch))          # the MoE configs pass
    cfg = dataclasses.replace(get_config("tiny"), family="diffusion")
    with pytest.raises(NotImplementedError, match="family 'diffusion'"):
        init_params(cfg, device="cpu")
    with pytest.raises(NotImplementedError, match="not ported"):
        init_caches(cfg, 1, 8, device="cpu")


def test_registry_matches_reference():
    for arch in list(ARCHS) + ["tiny"]:
        assert dataclasses.asdict(get_config(arch)) == dataclasses.asdict(
            jax_config(arch))
        assert dataclasses.asdict(get_config(arch + "-smoke" if arch in ARCHS
                                             else arch)) == \
            dataclasses.asdict(jax_config(arch + "-smoke" if arch in ARCHS
                                          else arch))


def test_serve_launcher_on_cpu():
    res = run("tiny", n_requests=3, prompt_len=8, gen_len=4, max_seq=20,
              device="cpu")
    assert res["device"] == "cpu" and res["requests"] == 3
    assert res["output_shape"] == [3, 4] and res["no_nans"]
    assert res["prefill_s"] > 0 and res["decode_tokens_per_s"] > 0

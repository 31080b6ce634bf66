"""The port's M-RoPE and VLM serving path (qwen2-vl) against the JAX
package, on the CPU.

``apply_mrope`` with distinct t/h/w ids, the attention block, the patch
merge, the forward, prefill + decode with each step's M-RoPE ids passed
through ``decode_step(extra=)``, greedy tokens, and the loss with its
gradients. Two configs: ``qwen2-vl-7b-smoke``, whose head dim 16 leaves
8 frequency slots, all on the t section (sections (16, 24, 24) cut at 8),
and a head-dim-128 variant with the full config's 64 slots, where the h
and w sections turn by their own ids. Weights come from the JAX package
through ``params_from_jax`` (QKV biases redrawn so that they are not
zero), inputs from numpy seeds (``serve.inputs.model_inputs``: one image
on a grid, then text, as in Qwen2-VL). Tolerance: ``TOL = 5e-5``, as in
``tests/test_torch_models.py`` (sums in another order); greedy tokens
equal.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models as JM
import repro.models.layers as JL
import repro.models.transformer as JT
import repro.serve as JS
from repro.configs.base import ShapeConfig
from repro.configs.registry import get_config as jax_config
from repro.launch.specs import serve_input_specs
from repro_torch.configs.registry import get_config
from repro_torch.launch.serve import run
from repro_torch.models import (forward, init_caches, init_params, loss_fn,
                                params_from_jax)
from repro_torch.models.layers import (apply_mrope, apply_rope,
                                       attention_block, mrope_section_ids)
from repro_torch.models.transformer import embed_inputs
from repro_torch.serve import (decode_step, greedy_generate, model_inputs,
                               prefill_step, step_inputs)
from repro_torch.serve.inputs import image_grid, mrope_ids

from _torch_serving import greedy_jax, greedy_port, shapes, to_jnp, tokens

ARCH = "qwen2-vl-7b-smoke"
TOL = 5e-5


def _hd128(cfg):
    """qwen2-vl at head dim 128 (the full config's sections all in use):
    2 layers, d_model 256, 2 q heads over 1 kv head."""
    return dataclasses.replace(cfg, name="qwen2-vl-7b-hd128", d_model=256,
                               num_heads=2, num_kv_heads=1, head_dim=128)


CONFIGS = {"smoke": lambda c: c, "hd128": _hd128}


def _configs(which):
    return (CONFIGS[which](jax_config(ARCH)),
            CONFIGS[which](get_config(ARCH)))


def _biased(jp, seed):
    """``jp`` with every QKV bias redrawn N(0, 0.1) (the init's are 0)."""
    rng = np.random.default_rng(seed)

    def redraw(tree):
        if isinstance(tree, dict):
            return {k: (jnp.asarray(rng.normal(0, 0.1, v.shape), v.dtype)
                        if k.startswith("b_") else redraw(v))
                    for k, v in tree.items()}
        return tree

    return redraw(jp)


def _pair(which):
    jc, tc = _configs(which)
    jp = _biased(JM.init_params(jc, jax.random.PRNGKey(0)), 9)
    return jc, tc, jp, params_from_jax(jax.tree.map(np.asarray, jp),
                                       device="cpu")


@pytest.mark.parametrize("half,sections", [
    (8, (16, 24, 24)), (64, (16, 24, 24)), (8, (2, 2, 2)), (6, (3, 0, 0)),
    (4, (0, 0, 0)), (10, (1, 2, 3))])
def test_section_ids_match_jnp_repeat(half, sections):
    """Slots past ``half`` cut, short sections padded with id 2, as
    ``jnp.repeat(arange(3), sections, total_repeat_length=half)``."""
    want = jnp.repeat(jnp.arange(3), jnp.array(sections),
                      total_repeat_length=half)
    assert mrope_section_ids(half, sections) == np.asarray(want).tolist()


@pytest.mark.parametrize("d,sections", [(16, (16, 24, 24)),
                                        (128, (16, 24, 24)),
                                        (32, (2, 2, 2)), (64, (4, 4, 4))])
def test_apply_mrope_matches_jax(d, sections):
    """Distinct t, h and w ids for every token, so that each section's
    slots turn by their own id."""
    rng = np.random.default_rng(d)
    x = rng.standard_normal((2, 7, 3, d)).astype(np.float32)
    ids = rng.integers(0, 4096, (3, 2, 7)).astype(np.int32)
    assert (ids[0] != ids[1]).any() and (ids[1] != ids[2]).any()
    want = JL.apply_mrope(jnp.asarray(x), jnp.asarray(ids), 1e6, sections)
    got = apply_mrope(torch.from_numpy(x), torch.from_numpy(ids), 1e6,
                      sections)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)
    if d == 128:
        # each of t, h, w moves the output where its section is
        for sec in range(3):
            moved = ids.copy()
            moved[sec] += 1
            other = apply_mrope(torch.from_numpy(x),
                                torch.from_numpy(moved), 1e6, sections)
            assert not torch.equal(other, got)


def test_equal_ids_are_plain_rope():
    """With t = h = w for every token, M-RoPE is RoPE over those ids,
    bit for bit."""
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.standard_normal((2, 5, 2, 128)).astype(
        np.float32))
    pos = torch.from_numpy(rng.integers(0, 500, (2, 5)).astype(np.int32))
    got = apply_mrope(x, pos[None].expand(3, 2, 5), 1e6, (16, 24, 24))
    assert torch.equal(got, apply_rope(x, pos, 1e6))


def test_mrope_ids_follow_the_image_then_text_layout():
    """128 patches: one frame (t 0) on an 8 x 16 grid, h the row and w
    the column; the text after them at t = h = w = 16, 17, ..."""
    assert image_grid(128) == (8, 16) and image_grid(3) == (3, 1)
    ids = mrope_ids(2, 140, 128, device="cpu")
    assert ids.shape == (3, 2, 140) and ids.dtype == torch.int32
    assert torch.equal(ids[:, 0], ids[:, 1])
    assert (ids[0, 0, :128] == 0).all()
    assert ids[1, 0, :128].tolist() == [i // 16 for i in range(128)]
    assert ids[2, 0, :128].tolist() == [i % 16 for i in range(128)]
    assert (ids[:, 0, 128:] == torch.arange(16, 28)).all()


@pytest.mark.parametrize("kind,s", [("prefill", 32), ("decode", 1)])
def test_inputs_follow_the_reference_serving_layout(kind, s):
    """``model_inputs`` gives what ``serve_input_specs`` lays out: ids
    (3, B, S) and patches (B, S / vision_patches_ratio, D) for prefill,
    ids (3, B, 1) for a decode step."""
    jc, tc = _configs("smoke")
    specs = serve_input_specs(jc, ShapeConfig("t", 32, 4, kind), kind)
    start = 0 if kind == "prefill" else 32
    got = step_inputs(model_inputs(tc, 4, 32, 33, device="cpu"), start,
                      start + s)
    assert set(got) == set(specs) - {"tokens", "pos", "caches"}
    for key, val in got.items():
        assert tuple(val.shape) == specs[key].shape, key


@pytest.mark.parametrize("which", ["smoke", "hd128"])
def test_attention_block_matches_jax(which):
    """The block with M-RoPE ids and QKV biases, without a cache and
    over one (prefill of 10 at slot 0, then 1 and 3 tokens): the cache
    slot is the host ``pos``, the rotation the ids given."""
    jc, tc = _configs(which)
    jp = _biased(JL.init_attention(jax.random.PRNGKey(2), jc, jnp.float32),
                 3)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    rng = np.random.default_rng(4)
    b, max_seq = 2, 16
    hd = tc.resolved_head_dim()
    jcache = {"k": jnp.zeros((b, max_seq, tc.num_kv_heads, hd)),
              "v": jnp.zeros((b, max_seq, tc.num_kv_heads, hd)),
              "pos": jnp.int32(0)}
    cache = {k: torch.from_numpy(np.array(v)) for k, v in jcache.items()}
    for start, s in ((0, 10), (10, 1), (11, 3)):
        x = rng.standard_normal((b, s, tc.d_model)).astype(np.float32)
        pos = np.broadcast_to(np.arange(start, start + s, dtype=np.int32),
                              (b, s))
        ids = rng.integers(0, 64, (3, b, s)).astype(np.int32)
        want, jcache = JL.attention_block(
            jp, jc, jnp.asarray(x), jnp.asarray(pos), cache=jcache,
            mrope_positions=jnp.asarray(ids))
        got, cache = attention_block(
            tp, tc, torch.from_numpy(x), torch.from_numpy(pos.copy()),
            cache=cache, pos=start, mrope_positions=torch.from_numpy(ids))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                                   atol=TOL)
        for key in ("k", "v"):
            np.testing.assert_allclose(cache[key].numpy(),
                                       np.asarray(jcache[key]), rtol=TOL,
                                       atol=TOL)
    x = rng.standard_normal((b, 5, tc.d_model)).astype(np.float32)
    ids = rng.integers(0, 64, (3, b, 5)).astype(np.int32)
    pos = np.zeros((b, 5), np.int32)
    want, _ = JL.attention_block(jp, jc, jnp.asarray(x), jnp.asarray(pos),
                                 mrope_positions=jnp.asarray(ids))
    got, _ = attention_block(tp, tc, torch.from_numpy(x),
                             torch.from_numpy(pos),
                             mrope_positions=torch.from_numpy(ids))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)


def test_patch_merge_matches_jax():
    """``patch_embeds`` (B, P, D) replace the first P token embeddings."""
    jc, tc, jp, tp = _pair("smoke")
    tok = tokens(jc, 2, 9)
    pe = np.random.default_rng(2).standard_normal(
        (2, 3, jc.d_model)).astype(np.float32)
    batch = {"tokens": tok, "patch_embeds": pe}
    want = JT.embed_inputs(jp, jc, to_jnp(batch))
    got = embed_inputs(tp, tc, {k: torch.from_numpy(v)
                                for k, v in batch.items()})
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert torch.equal(got[:, :3], torch.from_numpy(pe))
    assert torch.equal(got[:, 3:], tp["embed"][torch.from_numpy(tok[:, 3:])])


def test_init_params_and_caches_match_jax():
    """The port's own init and caches: the reference's tree (QKV biases,
    no cross, a plain ``{"k", "v", "pos"}`` cache), shapes and dtypes."""
    jc, tc = _configs("smoke")
    want = shapes(jax.eval_shape(
        lambda: JM.init_params(jc, jax.random.PRNGKey(0))))
    tp = init_params(tc, 3, device="cpu")
    assert shapes(tp) == want
    assert {"b_q", "b_k", "b_v"} <= set(tp["layers"]["mixer"]["attn"])
    got = init_caches(tc, 3, 20, torch.float32, device="cpu")
    assert shapes(got) == shapes(JM.init_caches(jc, 3, 20, jnp.float32))
    assert set(got["scan"]) == {"k", "v", "pos"}


@pytest.mark.parametrize("which", ["smoke", "hd128"])
def test_forward_logits_match_jax(which):
    jc, tc, jp, tp = _pair(which)
    tok = tokens(jc, 2, 24)
    batch = {"tokens": torch.from_numpy(tok),
             **model_inputs(tc, 2, 24, seed=1, device="cpu")}
    assert (batch["mrope_positions"][1] != batch["mrope_positions"][2]).any()
    want, _, _ = JM.forward(jp, jc, to_jnp(batch))
    got, caches, aux = forward(tp, tc, batch)
    assert caches is None and float(aux) == 0.0
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)
    # the ids matter: the same tokens at plain positions differ
    plain, _, _ = forward(tp, tc, {k: v for k, v in batch.items()
                                   if k != "mrope_positions"})
    assert float((plain - got).abs().max()) > 1e-3


@pytest.mark.parametrize("which", ["smoke", "hd128"])
def test_prefill_decode_matches_full_forward_and_jax(which):
    """Prefill 12 tokens (4 patches, then text) and decode 4
    teacher-forced, each step with its ids: every step's logits equal
    the full forward's and JAX's steps within TOL, the caches JAX's."""
    jc, tc, jp, tp = _pair(which)
    tok = tokens(tc, 2, 16, seed=1)
    toks = torch.from_numpy(tok)
    inp = model_inputs(tc, 2, 12, 16, seed=2, device="cpu")
    full, _, _ = forward(tp, tc, {"tokens": toks,
                                  **step_inputs(inp, 0, 16)})
    caches = init_caches(tc, 2, 16, torch.float32, device="cpu")
    jcache = JM.init_caches(jc, 2, 16, jnp.float32)
    pre = {"tokens": toks[:, :12], **step_inputs(inp, 0, 12)}
    lg, caches = prefill_step(tp, tc, pre, caches)
    jlg, jcache = JS.prefill_step(jp, jc, to_jnp(pre), jcache)
    np.testing.assert_allclose(lg.numpy(), np.asarray(jlg), rtol=TOL,
                               atol=TOL)
    errs = [float((lg[:, -1] - full[:, 11]).abs().max())]
    for i in range(12, 16):
        ex = step_inputs(inp, i, i + 1)
        assert set(ex) == {"mrope_positions"}
        lg, caches = decode_step(tp, tc, toks[:, i:i + 1], caches, i,
                                 extra=ex)
        jlg, jcache = JS.decode_step(jp, jc, jnp.asarray(tok[:, i:i + 1]),
                                     jcache, jnp.int32(i), extra=to_jnp(ex))
        errs.append(float((lg[:, 0] - full[:, i]).abs().max()))
        np.testing.assert_allclose(lg.numpy(), np.asarray(jlg), rtol=TOL,
                                   atol=TOL)
    assert max(errs) < TOL, errs
    for key in ("k", "v", "pos"):
        np.testing.assert_allclose(caches["scan"][key].numpy(),
                                   np.asarray(jcache["scan"][key]),
                                   rtol=TOL, atol=TOL)


@pytest.mark.parametrize("which", ["smoke", "hd128"])
def test_greedy_tokens_equal_jax(which):
    """With the image and its ids through ``prefill_step`` and
    ``decode_step(extra=)`` on both packages, and tokens alone through
    ``greedy_generate`` (RoPE over positions, as the reference's)."""
    jc, tc, jp, tp = _pair(which)
    prompt = tokens(tc, 2, 8, seed=2)
    inp = model_inputs(tc, 2, 8, 14, seed=3, device="cpu")
    np.testing.assert_array_equal(
        greedy_port(tc, tp, prompt, inp, 6, 24),
        greedy_jax(jc, jp, prompt, inp, 6, 24))
    want = JS.greedy_generate(jp, jc, jnp.asarray(prompt), max_new=6,
                              max_seq=24)
    got = greedy_generate(tp, tc, torch.from_numpy(prompt), max_new=6,
                          max_seq=24)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("which", ["smoke", "hd128"])
def test_loss_and_grads_match_jax(which):
    jc, tc, jp, tp = _pair(which)
    tok = tokens(jc, 2, 13, seed=4)
    batch = {"tokens": torch.from_numpy(tok[:, :-1]),
             "labels": torch.from_numpy(tok[:, 1:]),
             **model_inputs(tc, 2, 12, seed=5, device="cpu")}
    jloss, jgrads = jax.value_and_grad(
        lambda p: JT.loss_fn(p, jc, to_jnp(batch)))(jp)
    leaves = jax.tree_util.tree_leaves(tp)
    for leaf in leaves:
        leaf.requires_grad_(True)
    loss = loss_fn(tp, tc, batch)
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=TOL,
                               atol=TOL)
    grads = torch.autograd.grad(loss, leaves)
    want = jax.tree_util.tree_leaves(jgrads)
    assert len(grads) == len(want)
    for g, w in zip(grads, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=TOL,
                                   atol=TOL)


def test_k6_runs_once_per_layer_in_prefill_and_none_in_decode():
    """The K6 wrapper (counted by wrapping it: on the CPU it runs its
    plain version and counts no launch) runs once per layer, causal, in
    a forward and a prefill; a decode step attends over the cache
    plainly."""
    import repro_torch.kernels.ops as ops
    tc = get_config(ARCH)
    tp = init_params(tc, 0, device="cpu")
    calls = []
    inner = ops._fa.flash_attention

    def counting(*a, **kw):
        calls.append((a[0].shape, a[1].shape, kw.get("causal")))
        return inner(*a, **kw)

    ops._fa.flash_attention = counting
    try:
        toks = torch.from_numpy(tokens(tc, 2, 9))
        inp = model_inputs(tc, 2, 8, 10, seed=1, device="cpu")
        forward(tp, tc, {"tokens": toks, **step_inputs(inp, 0, 9)})
        want = [((2, 9, 4, 16), (2, 9, 2, 16), True)] * tc.num_layers
        assert calls == want
        caches = init_caches(tc, 2, 16, torch.float32, device="cpu")
        _, caches = prefill_step(tp, tc, {"tokens": toks,
                                          **step_inputs(inp, 0, 9)}, caches)
        assert calls == 2 * want
        decode_step(tp, tc, toks[:, :1], caches, 9,
                    extra=step_inputs(inp, 9, 10))
        assert calls == 2 * want
    finally:
        ops._fa.flash_attention = inner


def test_serve_launcher_on_cpu():
    """The launcher feeds tokens alone, as the reference's: qwen2-vl then
    turns by RoPE over positions."""
    res = run(ARCH, n_requests=3, prompt_len=8, gen_len=4, max_seq=20,
              device="cpu")
    assert res["output_shape"] == [3, 4] and res["no_nans"]

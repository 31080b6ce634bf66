"""The port's MoE models against the JAX package, on the CPU.

Routing, slot assignment, the expert FFN and the whole MoE models
(deepseek-v2-lite-16b-smoke: MLA, shared experts, a leading dense block;
phi3.5-moe-42b-smoke: GQA attention, routed experts only) on the same
weights (``params_from_jax``) and inputs made from numpy seeds.
Tolerance: ``TOL = 5e-5`` (the reference's own prefill/decode bound in
``tests/test_models.py``; the products sum in another order); expert
choices, slots and greedy tokens equal.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models as JM
import repro.models.moe as JMoE
import repro.models.transformer as JT
import repro.serve as JS
from repro.configs.registry import get_config as jax_config
from repro_torch.configs.registry import get_config
from repro_torch.launch.serve import run
from repro_torch.models import (forward, init_caches, init_params, loss_fn,
                                params_from_jax)
from repro_torch.models import moe
from repro_torch.serve import decode_step, greedy_generate, prefill_step

MOE = ["deepseek-v2-lite-16b-smoke", "phi3.5-moe-42b-smoke"]
TOL = 5e-5


def _no_drops(cfg):
    """``cfg`` with capacity_factor 8: no token is dropped at these sizes,
    so prefill + decode can equal the full forward."""
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=8.0))


def _pair(arch, no_drops=False):
    jc, tc = jax_config(arch), get_config(arch)
    if no_drops:
        jc, tc = _no_drops(jc), _no_drops(tc)
    params = JM.init_params(jc, jax.random.PRNGKey(0))
    tp = params_from_jax(jax.tree.map(np.asarray, params), device="cpu")
    return jc, tc, params, tp


def _tokens(cfg, b, s, seed=0):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (b, s)).astype(np.int32)


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _shapes(tree):
    if isinstance(tree, dict):
        return {k: _shapes(v) for k, v in tree.items()}
    return (tuple(tree.shape), str(tree.dtype).split(".")[-1])


def _jax_loss(params, cfg, batch, aux_weight=None):
    return JT.loss_fn(params, cfg, {k: jnp.asarray(v) for k, v in
                                    batch.items()}, aux_weight=aux_weight)


@pytest.mark.parametrize("arch,t,d", [
    ("deepseek-v2-lite-16b-smoke", 48, 64),
    ("phi3.5-moe-42b-smoke", 48, 64),
    ("deepseek-v2-lite-16b", 200, 96),      # 64 experts, top-6
    ("phi3.5-moe-42b", 100, 96),            # 16 experts, top-2
])
def test_route_matches_jax(arch, t, d):
    """The same experts in the same (descending) order, the renormalised
    gates and the Switch aux loss within TOL."""
    cfg = jax_config(arch)
    rng = np.random.default_rng(3)
    x = rng.standard_normal((t, d)).astype(np.float32)
    w = (rng.standard_normal((d, cfg.moe.num_experts))
         * (2.0 / (d + cfg.moe.num_experts)) ** 0.5).astype(np.float32)
    jidx, jgate, jaux = JMoE.route(jnp.asarray(w), jnp.asarray(x), cfg)
    idx, gate, aux = moe.route(_t(w), _t(x), get_config(arch))
    assert idx.shape == (t, cfg.moe.top_k)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_allclose(gate.numpy(), np.asarray(jgate), rtol=TOL,
                               atol=TOL)
    assert np.all(np.diff(gate.numpy(), axis=-1) <= 0)      # descending
    np.testing.assert_allclose(float(aux), float(jaux), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("t,k,e,cap", [
    (64, 2, 4, 32),          # tests/test_models.py's case
    (64, 2, 4, 9),           # capacity drops most assignments
    (200, 6, 64, 6),         # deepseek's k and E at a drop-heavy capacity
    (5, 2, 16, 2),
])
def test_dispatch_indices_match_jax(t, k, e, cap):
    """Slot positions and the keep mask equal JAX's, including the
    dropped assignments; at most ``cap`` kept per expert, each at a
    distinct position."""
    rng = np.random.default_rng(1)
    idx = rng.integers(0, e, (t, k)).astype(np.int32)
    jpos, jkeep = JMoE._dispatch_indices(jnp.asarray(idx), k, e, cap)
    pos, keep = moe._dispatch_indices(_t(idx).long(), k, e, cap)
    np.testing.assert_array_equal(pos.numpy(), np.asarray(jpos))
    np.testing.assert_array_equal(keep.numpy(), np.asarray(jkeep))
    pos, keep = pos.numpy(), keep.numpy()
    assert (~keep).any() == bool(np.bincount(idx.ravel(), minlength=e).max()
                                 > cap)
    for ee in range(e):
        kept = keep & (idx == ee)
        assert kept.sum() <= cap
        ps = pos[kept]
        assert len(set(ps.tolist())) == len(ps)


@pytest.mark.parametrize("arch", MOE)
@pytest.mark.parametrize("capacity_factor", [0.5, 8.0])
def test_moe_ffn_matches_jax(arch, capacity_factor):
    """The MoE FFN (routing, dispatch, experts, combine, shared experts)
    on the same weights: the output and aux within TOL, with a capacity
    under the mean load (assignments dropped: E * C < k * T) and with
    drops off."""
    jc, tc = jax_config(arch), get_config(arch)
    jc, tc = (dataclasses.replace(c, moe=dataclasses.replace(
        c.moe, capacity_factor=capacity_factor)) for c in (jc, tc))
    jp = JMoE.init_moe(jax.random.PRNGKey(4), jc, jnp.float32)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    x = np.random.default_rng(5).standard_normal(
        (3, 16, jc.d_model)).astype(np.float32)
    want, jaux = JMoE.moe_ffn(jp, jc, jnp.asarray(x))
    got, aux = moe.moe_ffn(tp, tc, _t(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=TOL, atol=TOL)
    idx, _, _ = moe.route(tp["router"], _t(x).reshape(-1, tc.d_model), tc)
    _, keep = moe._dispatch_indices(idx, tc.moe.top_k, tc.moe.num_experts,
                                    moe._capacity(48, tc))
    # half the mean load drops assignments; 8x drops none here
    assert bool(keep.all()) == (capacity_factor == 8.0)


@pytest.mark.parametrize("arch", MOE)
def test_init_params_tree_matches_jax(arch):
    """The port's own init: the reference's tree (``dense_blocks``, the
    MLA or attention mixer, the MoE FFN with its f32 router), shapes and
    dtypes; the expert stacks drawn at ``init_dense``'s scale."""
    jc, tc = jax_config(arch), get_config(arch)
    want = _shapes(jax.eval_shape(
        lambda: JM.init_params(jc, jax.random.PRNGKey(0))))
    tp = init_params(tc, 3, device="cpu")
    assert _shapes(tp) == want
    w = tp["layers"]["ffn"]["moe"]["experts"]["w_gate"]
    m = tc.moe
    assert abs(float(w.std()) - (2.0 / (64 + m.expert_d_ff)) ** 0.5) < 0.01


@pytest.mark.parametrize("arch", MOE)
def test_forward_logits_and_aux_match_jax(arch):
    jc, tc, jp, tp = _pair(arch)
    tok = _tokens(jc, 2, 24)
    want, _, jaux = JM.forward(jp, jc, {"tokens": jnp.asarray(tok)})
    got, caches, aux = forward(tp, tc, {"tokens": torch.from_numpy(tok)})
    assert caches is None and got.shape == (2, 24, tc.padded_vocab())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)
    assert float(aux) > 0
    np.testing.assert_allclose(float(aux), float(jaux), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("arch", MOE)
def test_init_caches_keys_and_shapes_match_jax(arch):
    jc, tc = jax_config(arch), get_config(arch)
    want = JM.init_caches(jc, 3, 20, jnp.float32)
    got = init_caches(tc, 3, 20, torch.float32, device="cpu")
    assert _shapes(got) == _shapes(want)
    if tc.mla.enabled:
        assert set(got) == {"scan", "dense"}
        assert set(got["scan"]) == {"c_kv", "k_rope", "pos"}
    else:
        assert set(got) == {"scan"}


@pytest.mark.parametrize("arch", MOE)
def test_prefill_decode_matches_full_forward(arch):
    """``tests/test_models.py``'s invariant at capacity_factor 8 (no
    drops): prefill 12 tokens, decode 4 teacher-forced; every step's
    logits equal the full forward's within TOL, and JAX's steps."""
    jc, tc, jp, tp = _pair(arch, no_drops=True)
    tok = _tokens(tc, 2, 16, seed=1)
    toks = torch.from_numpy(tok)
    full, _, _ = forward(tp, tc, {"tokens": toks})
    caches = init_caches(tc, 2, 16, torch.float32, device="cpu")
    lg, caches = prefill_step(tp, tc, {"tokens": toks[:, :12]}, caches)
    jcache = JM.init_caches(jc, 2, 16, jnp.float32)
    jlg, jcache = JS.prefill_step(jp, jc, {"tokens": jnp.asarray(tok[:, :12])},
                                  jcache)
    np.testing.assert_allclose(lg.numpy(), np.asarray(jlg), rtol=TOL,
                               atol=TOL)
    errs = [float((lg[:, -1] - full[:, 11]).abs().max())]
    for i in range(12, 16):
        lg, caches = decode_step(tp, tc, toks[:, i:i + 1], caches, i)
        jlg, jcache = JS.decode_step(jp, jc, jnp.asarray(tok[:, i:i + 1]),
                                     jcache, jnp.int32(i))
        errs.append(float((lg[:, 0] - full[:, i]).abs().max()))
        np.testing.assert_allclose(lg.numpy(), np.asarray(jlg), rtol=TOL,
                                   atol=TOL)
    assert max(errs) < TOL, f"{arch}: decode mismatch {errs}"
    got = jax.tree_util.tree_leaves(jax.tree.map(np.asarray, caches))
    want = jax.tree_util.tree_leaves(jax.tree.map(np.asarray, jcache))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("arch", MOE)
def test_loss_and_grads_with_aux_match_jax(arch):
    """``loss_fn`` adds ``aux_loss_weight * aux`` as the reference does;
    the loss and every parameter's gradient within TOL of JAX's (with a
    large aux weight, so that the aux term's gradient shows)."""
    jc, tc, jp, tp = _pair(arch)
    tok = _tokens(jc, 2, 17, seed=4)
    batch = {"tokens": tok[:, :-1], "labels": tok[:, 1:]}
    jloss, jgrads = jax.value_and_grad(
        lambda p: _jax_loss(p, jc, batch, 0.5))(jp)
    leaves = jax.tree_util.tree_leaves(tp)
    for leaf in leaves:
        leaf.requires_grad_(True)
    loss = loss_fn(tp, tc, {k: torch.from_numpy(v) for k, v in
                            batch.items()}, aux_weight=0.5)
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=TOL,
                               atol=TOL)
    grads = torch.autograd.grad(loss, leaves)
    want = jax.tree_util.tree_leaves(jgrads)
    assert len(grads) == len(want)
    for g, w in zip(grads, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=TOL,
                                   atol=TOL)
    # the default weight is the config's, and without it the loss is CE
    with torch.no_grad():
        plain = loss_fn(tp, tc, {k: torch.from_numpy(v) for k, v in
                                 batch.items()}, aux_weight=0.0)
        dflt = loss_fn(tp, tc, {k: torch.from_numpy(v) for k, v in
                                batch.items()})
    np.testing.assert_allclose(float(dflt), float(_jax_loss(jp, jc, batch)),
                               rtol=TOL, atol=TOL)
    assert float(loss.detach()) > float(dflt) > float(plain)


@pytest.mark.parametrize("arch", MOE)
def test_greedy_tokens_equal_jax(arch):
    jc, tc, jp, tp = _pair(arch)
    tok = _tokens(jc, 2, 8, seed=2)
    want = JS.greedy_generate(jp, jc, jnp.asarray(tok), max_new=6,
                              max_seq=24)
    got = greedy_generate(tp, tc, torch.from_numpy(tok), max_new=6,
                          max_seq=24)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_serve_launcher_on_cpu():
    res = run("deepseek-v2-lite-16b-smoke", n_requests=3, prompt_len=8,
              gen_len=4, max_seq=20, device="cpu")
    assert res["device"] == "cpu" and res["requests"] == 3
    assert res["output_shape"] == [3, 4] and res["no_nans"]
    assert res["prefill_s"] > 0 and res["decode_tokens_per_s"] > 0


@pytest.mark.parametrize("arch", MOE)
def test_remat_loss_and_grads_equal_plain(arch):
    """``remat`` checkpoints each block (the dense block's too) and
    carries the MoE aux through the checkpoint: the loss with the aux
    term and every gradient equal the unchecked forward's."""
    _, tc, _, tp = _pair(arch)
    tok = _tokens(tc, 2, 13, seed=6)
    batch = {"tokens": torch.from_numpy(tok[:, :-1]),
             "labels": torch.from_numpy(tok[:, 1:])}
    leaves = jax.tree_util.tree_leaves(tp)
    for leaf in leaves:
        leaf.requires_grad_(True)
    out = []
    for remat in (False, True):
        loss = loss_fn(tp, tc, batch, remat=remat, aux_weight=0.5)
        out.append((loss.detach(), torch.autograd.grad(loss, leaves)))
    torch.testing.assert_close(out[1][0], out[0][0], rtol=0, atol=0)
    for g, e in zip(out[1][1], out[0][1]):
        torch.testing.assert_close(g, e, rtol=1e-6, atol=1e-7)

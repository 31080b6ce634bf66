"""The port's ``model`` axis for the MoE family (expert-parallel routed
experts, MLA head-parallel with its latent cache cut on its feature dim)
against the JAX package, on the CPU.

* The cuts: ``model_axis_sharded`` admits every family (the MoE one
  with or without MLA, enc-dec, SSM and hybrid heads among them); the
  ZeRO-1 free dim of every leaf of phi3.5-moe-42b's and
  deepseek-v2-lite-16b's cut (the 4-D expert stacks among them) is the
  reference's ``zero1_specs`` over its sanitized specs. The specs and
  cuts of each leaf and cache are held in ``tests/test_torch_tp.py``.
* Gloo runs (``run_peers``, ``tests/_torch_tp_ranks.py``) on (1, 2),
  (1, 4) and (2, 2) data x model meshes of three small configs
  (``_torch_tp_ranks.moe_configs``: ``tiny-moe``, ``tiny-mla`` and the
  deepseek-like ``tiny-ds``), sequence parallelism off and on: the
  logits gathered over the model ranks, the loss with its aux term and
  the gradients gathered whole (on the global batch, against the JAX
  package's ``loss_fn``), one ``make_train_step(mesh)`` step with and
  without ZeRO-1, and prefill then four decode steps over the cut
  latent cache, each against the JAX package. Every run is at the
  configs' own capacity factor (1.25), and ``test_assignments_drop``
  asserts that the reference drops assignments on these batches.

Which routing the train steps are held to: the reference's pjit step
(``make_train_step``) routes the global (micro)batch at once, with the
capacity of all its tokens; its ``shard_map`` step
(``make_bucketed_train_step``) routes each data shard alone. At drops
the two are different functions
(``test_data_shard_routing_differs_from_the_global_batch`` shows that
these batches tell them apart). So the port's ``make_train_step(mesh)``
(a data rank's rows routed as a part of the global batch, the per-expert
counts exchanged over the data group) is held to the reference's
``make_train_step`` gradients on the global batch, in one microbatch and
in two (the global batch split first); the port's psum step is held to
the per-shard function: the mean of ``loss_fn`` and its gradients over
the data shards. On (1, n) meshes the two are the same.

Tolerances: ``tests/test_torch_tp.py``'s (5e-5 on logits, the loss
within 1e-5 relative, gradient leaves within 2e-5 of the leaf's largest
|value|, parameters within 1e-5 of the JAX package's clip and AdamW on
the step's own gradients).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_tp_ranks as R
import repro.models as JM
import repro.models.moe as JMOE
import repro.train as JTR
import repro.train.optimizer as JOPT
from repro.configs.base import MLAConfig as JMLAConfig
from repro.configs.base import MoEConfig as JMoEConfig
from repro.configs.base import TrainConfig as JTrainConfig
from repro.configs.registry import ARCHS as J_ARCHS
from repro.configs.registry import get_config as jax_config
from repro.launch import specs as JS
from repro.models.sharding import param_specs as j_param_specs
from repro.serve.serve_step import decode_step as j_decode
from repro.serve.serve_step import prefill_step as j_prefill
from repro.train.train_step import _microbatch_grads as J_mb_grads
from repro_torch._tree import tree_leaves
from repro_torch.configs.registry import get_config
from repro_torch.launch.mesh import run_peers
from repro_torch.models import init_params, sharding
from repro_torch.train.optimizer import zero1_specs
from test_torch_tp import (GRAD_TOL, LOGIT_TOL, LOSS_RTOL, PARAM_TOL,
                           SPAWN_TIMEOUT_S, _close_tree, _j_mesh, _jb,
                           _tuples)

MESHES = ((1, 2), (1, 4), (2, 2))
CONFIGS = ("tiny-moe", "tiny-mla", "tiny-ds")
SPS = (False, True)
BATCH, SEQ, SERVE_B = 4, 16, 2


# ---------------------------------------------------------------------------
# which families are cut, and ZeRO-1 within the cut
# ---------------------------------------------------------------------------

def _whole_and_built(cfg, axis):
    """``check_model_axis(cfg, axis)``'s whole leaves, each one that
    ``param_specs`` cuts over ``model`` but ``whole_specs`` leaves whole,
    and the last rank's cut built on ``meta`` at the shapes the specs
    give (the whole leaves at their whole shape)."""
    got = sharding.check_model_axis(cfg, axis)
    whole, specs = sharding.whole_specs(cfg, axis)
    rules = dict(sharding._leaf_paths(sharding.param_specs(whole), ""))
    kept = dict(sharding._leaf_paths(specs, ""))
    assert got == tuple(p for p in rules if sharding.model_dims(rules[p])
                        and not sharding.model_dims(kept[p]))
    cut = init_params(cfg, 0, torch.bfloat16, "meta", tp_rank=axis - 1,
                      tp_size=axis)
    assert [tuple(t.shape) for _, t in sharding._leaf_paths(cut, "")] == [
        sharding.cut_shape(w.shape, kept[p], axis)
        for p, w in sharding._leaf_paths(whole, "")]
    held = dict(sharding._leaf_paths(cut, ""))
    for p in got:
        assert held[p].shape == dict(sharding._leaf_paths(whole, ""))[p].shape
    return got


@pytest.mark.parametrize("arch,cut", [
    ("phi3.5-moe-42b", True), ("deepseek-v2-lite-16b", True),
    ("tiny-moe", True), ("tinyllama-1.1b", True),
    ("seamless-m4t-large-v2", True), ("mamba2-370m", True),
    ("hymba-1.5b", True), ("tiny-ssm", True)])
def test_model_axis_sharded_families(arch, cut):
    """Every family is cut, and splits over a model axis of 16 (4 for
    ``tiny-moe``'s 4 experts): the Mamba-2 mixer's ``in_proj`` may stay
    whole (hymba-1.5b's 6482 columns, ``tiny-ssm``'s 296). Over an axis
    of 7, which divides no projection, expert count or vocab of these,
    every such leaf is held whole (``whole_specs``) and the cut builds."""
    cfg = get_config(arch)
    assert sharding.model_axis_sharded(cfg) == cut
    axis = 4 if arch == "tiny-moe" else 16
    sharding.check_model_axis(cfg, axis)
    _, specs = sharding.whole_specs(cfg, axis)
    whole = [p for p, s in sharding._leaf_paths(specs, "")
             if p.endswith("in_proj") and not sharding.model_dims(s)]
    assert bool(whole) == (arch in ("hymba-1.5b", "tiny-ssm")), whole
    got = _whole_and_built(cfg, 7)
    assert got
    if cfg.moe.enabled:
        assert any("/experts/" in p for p in got), got


def test_mla_splits_over_an_axis_its_heads_do_not_divide():
    """MLA runs head-parallel where its heads divide the axis and by rows
    where they do not: deepseek's 16 heads split over 16 model ranks and
    over 32 (the reference's custom ``8x32:data,model`` mesh), where
    every other leaf divides; its smoke config's 4 experts do not divide
    16 (nor do its 8 rope dims), and are held whole beside the cut
    MLA."""
    for axis in (16, 32):
        assert _whole_and_built(get_config("deepseek-v2-lite-16b"),
                                axis) == ()
    got = _whole_and_built(get_config("deepseek-v2-lite-16b-smoke"), 16)
    assert {p.split("/")[-1] for p in got if "/experts/" in p} == {
        "w_gate", "w_up", "w_down"}, got
    assert all("/experts/" in p or p.endswith("w_kr") for p in got), got


@pytest.mark.parametrize("arch", ["phi3.5-moe-42b", "deepseek-v2-lite-16b"])
def test_cut_dtypes_are_the_whole_draws(arch):
    """A rank's cut drawn at its own shape keeps ``init_params``' dtypes:
    the router in f32 whatever the parameters' dtype."""
    cfg = get_config(arch)
    whole = init_params(cfg, 0, torch.bfloat16, "meta")
    cut = init_params(cfg, 0, torch.bfloat16, "meta", tp_rank=3,
                      tp_size=16)
    assert [t.dtype for t in tree_leaves(cut)] == \
        [t.dtype for t in tree_leaves(whole)]
    assert torch.float32 in {t.dtype for t in tree_leaves(cut)}


@pytest.mark.parametrize("mesh", ["single", "multi"])
@pytest.mark.parametrize("arch", ["phi3.5-moe-42b", "deepseek-v2-lite-16b"])
def test_zero1_free_dims_equal_the_reference(arch, mesh):
    """ZeRO-1 over the data-parallel ranks of a rank's cut (the port's
    steps take ``zero1_specs`` of the cut's own ``param_specs``) cuts
    each leaf, the 4-D expert stacks among them, on the dim the
    reference's ``zero1_specs`` of its sanitized specs over the whole
    shapes picks."""
    jm = _j_mesh(mesh)
    axes = tuple(a for a in ("pod", "data") if a in jm.axis_names)
    size = int(np.prod([jm.shape[a] for a in axes]))
    jp = jax.eval_shape(functools.partial(
        JM.init_params, J_ARCHS[arch], dtype=jnp.bfloat16),
        jax.random.PRNGKey(0))
    want = jax.tree.leaves(_tuples(JOPT.zero1_specs(
        jp, JS.sanitize_specs(j_param_specs(jp), jp, jm), axes, size)),
        is_leaf=lambda x: isinstance(x, tuple))
    cut = init_params(get_config(arch), 0, torch.bfloat16, "meta",
                      tp_rank=15, tp_size=16)
    got = tree_leaves(zero1_specs(cut, sharding.param_specs(cut), axes,
                                  size))
    dp = axes if len(axes) > 1 else axes[0]
    assert [s.index(dp) if dp in s else None for s in got] == \
        [s.index(dp) if dp in s else None for s in want]
    experts = [s for p, s in zip(sharding._leaf_paths(cut, ""), got)
               if "experts" in p[0]]
    assert len(experts) == 3 and all(len(s) == 4 for s in experts)


# ---------------------------------------------------------------------------
# gloo runs against the JAX package
# ---------------------------------------------------------------------------

def _jcfg(name):
    """The JAX package's twin of ``R.moe_configs()[name]``."""
    return dataclasses.replace(jax_config("tiny"), name=name,
                               **R.moe_fields(name, JMLAConfig, JMoEConfig))


def _inputs(cfg, b, s, seed):
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, cfg.vocab_size, (b, s)).astype(
                np.int32),
            "labels": rng.integers(0, cfg.vocab_size, (b, s)).astype(
                np.int32)}


@functools.lru_cache(maxsize=None)
def _world(name):
    """(JAX params, numpy params, the train batch, the serving prompt)."""
    jp = JM.init_params(_jcfg(name), jax.random.PRNGKey(0))
    batch = _inputs(_jcfg(name), BATCH, SEQ, 1)
    prompt = _inputs(_jcfg(name), SERVE_B, R.PROMPT + R.DECODE, 2)
    prompt.pop("labels")
    return jp, jax.tree.map(np.asarray, jp), batch, prompt


@pytest.fixture(scope="module", params=MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
def ranks(request):
    shape = request.param
    worlds = {n: _world(n) for n in CONFIGS}
    out = run_peers(R.tp_cases, shape[0] * shape[1], device="cpu",
                    timeout_s=SPAWN_TIMEOUT_S,
                    args=(shape, {n: w[1] for n, w in worlds.items()},
                          {n: w[2] for n, w in worlds.items()},
                          {n: w[3] for n, w in worlds.items()}, "moe"))
    return shape, out


def _shards(batch, n):
    """The ``n`` data ranks' rows of ``batch``."""
    m = batch["tokens"].shape[0] // n
    return [{k: v[i * m:(i + 1) * m] for k, v in batch.items()}
            for i in range(n)]


@functools.lru_cache(maxsize=None)
def _ref_global(name, microbatches):
    """The JAX package's pjit step's loss and gradients on the global
    batch (``train_step._microbatch_grads``: the batch split into
    ``microbatches`` first, each routed whole)."""
    jp, _, batch, _ = _world(name)
    loss, grads = J_mb_grads(jp, _jcfg(name), _jb(batch), JTrainConfig(
        microbatches=microbatches, remat=False))
    return float(loss), jax.tree.map(np.asarray, grads)


@functools.lru_cache(maxsize=None)
def _ref_loss_grads(name, shards=1):
    """The JAX package's loss (with the aux term) and gradients: the mean
    over ``shards`` data shards of the batch, each routed alone."""
    jp, _, batch, _ = _world(name)
    fn = jax.value_and_grad(lambda p, b: JM.loss_fn(p, _jcfg(name), b))
    outs = [fn(jp, _jb(b)) for b in _shards(batch, shards)]
    loss = sum(float(o[0]) for o in outs) / shards
    grads = jax.tree.map(lambda *g: sum(np.asarray(x) for x in g) / shards,
                         *[o[1] for o in outs])
    return loss, grads


def _ref_update(name, grads):
    jp = _world(name)[0]
    tcfg = JTrainConfig(learning_rate=3e-3, warmup_steps=1, total_steps=20,
                        remat=False)
    g = jax.tree.map(jnp.asarray, grads)
    p, _ = JOPT.adamw_update(JOPT.clip_by_global_norm(g, tcfg.grad_clip)[0],
                             JTR.init_adam(jp), jp, tcfg)
    return jax.tree.map(np.asarray, p)


@functools.lru_cache(maxsize=None)
def _ref_serve(name):
    jp, _, _, prompt = _world(name)
    jcfg = _jcfg(name)
    full = _jb(prompt)
    caches = JM.init_caches(jcfg, SERVE_B, R.MAX_SEQ, jnp.float32)
    lg, caches = j_prefill(jp, jcfg, dict(
        full, tokens=full["tokens"][:, :R.PROMPT]), caches)
    outs = [np.asarray(lg)]
    for pos in range(R.PROMPT, R.PROMPT + R.DECODE):
        lg, caches = j_decode(jp, jcfg, full["tokens"][:, pos:pos + 1],
                              caches, jnp.int32(pos))
        outs.append(np.asarray(lg))
    return outs


def _whole(cuts, name, n):
    _, specs = sharding.whole_specs(R.moe_configs()[name], n)
    tree = sharding.gather_tree(
        [jax.tree.map(torch.from_numpy, c) for c in cuts], specs, n)
    return jax.tree.map(lambda t: t.numpy(), tree)


@pytest.mark.parametrize("shards", [1, 2], ids=["global", "per_shard"])
@pytest.mark.parametrize("name", ["tiny-moe", "tiny-ds"])
def test_assignments_drop(name, shards, monkeypatch):
    """At the configs' capacity factor the reference drops assignments on
    the test's batch, routed whole and by data shard: the runs below
    hold the drops, not a routing with room for every token."""
    kept = []
    real = JMOE._dispatch_indices

    def spy(*args):
        pos, keep = real(*args)
        # the layers run under ``lax.scan``: read ``keep`` by callback
        jax.debug.callback(lambda k: kept.append(np.asarray(k)), keep)
        return pos, keep

    monkeypatch.setattr(JMOE, "_dispatch_indices", spy)
    jp, _, batch, _ = _world(name)
    for b in _shards(batch, shards):
        JM.loss_fn(jp, _jcfg(name), _jb(b))
    assert _jcfg(name).moe.capacity_factor == 1.25
    assert kept and all(not k.all() for k in kept), \
        [int((~k).sum()) for k in kept]


@pytest.mark.parametrize("name", ["tiny-moe", "tiny-ds"])
def test_data_shard_routing_differs_from_the_global_batch(name):
    """The data axis's routing, pinned as it stands: the reference's
    forward over the whole batch and over its two data shards, each
    routed alone (the port's mesh step), give logits far apart, since
    the capacity follows the routed token count and so the drops
    differ. The train steps below are held to the per-shard function."""
    jp, _, batch, _ = _world(name)
    whole = np.asarray(JM.forward(jp, _jcfg(name), _jb(batch))[0])
    shards = np.concatenate(
        [np.asarray(JM.forward(jp, _jcfg(name), _jb(b))[0])
         for b in _shards(batch, 2)], axis=0)
    assert whole.shape == shards.shape
    assert np.abs(whole - shards).max() > 100 * LOGIT_TOL, \
        np.abs(whole - shards).max()


@pytest.mark.parametrize("sp", SPS, ids=["sp_off", "sp_on"])
@pytest.mark.parametrize("name", CONFIGS)
def test_gathered_logits_match_the_reference(ranks, name, sp):
    shape, out = ranks
    jp, _, batch, _ = _world(name)
    want = np.asarray(JM.forward(jp, _jcfg(name), _jb(batch))[0])
    for row in range(shape[0]):
        got = np.concatenate([r[name, sp, "logits"] for r in out
                              if r["coords"][0] == row], axis=-1)
        np.testing.assert_allclose(got, want, rtol=LOGIT_TOL, atol=LOGIT_TOL)


@pytest.mark.parametrize("sp", SPS, ids=["sp_off", "sp_on"])
@pytest.mark.parametrize("name", CONFIGS)
def test_loss_and_whole_gradients_match_the_reference(ranks, name, sp):
    """Every rank's loss (the aux term counted once) and its gradients
    (its cut's, the router's, ``w_dkv``'s and the norms' summed over the
    model group, gathered back whole) against ``jax.value_and_grad`` of
    the JAX package's ``loss_fn`` on the global batch."""
    _, out = ranks
    loss, grads = _ref_loss_grads(name)
    for r in out:
        assert abs(r[name, sp, "loss"] - loss) <= LOSS_RTOL * abs(loss)
        _close_tree(r[name, sp, "grads"], grads, GRAD_TOL, "grads")
        # sequence parallelism reduce-scatters the residual on top of
        # the rope key's gather (its backward) and rows-mode attention
        if sp:
            rs = [r[name, s, "forward_collectives"].get("reduce-scatter", 0)
                  for s in (False, True)]
            assert rs[1] > rs[0], rs


def _check_step(out, shape, name, sp, key, loss, grads):
    """Each data row's step ``key``: every rank's loss, the step's
    gradients gathered whole and their global norm against ``loss`` and
    ``grads``, the parameters against the JAX package's clip and AdamW on
    the step's gradients."""
    for row in range(shape[0]):
        mine = [r for r in out if r["coords"][0] == row]
        for r in mine:
            assert abs(r[name, sp, key]["loss"] - loss) <= \
                LOSS_RTOL * abs(loss)
        synced = _whole([r[name, sp, key]["grads"] for r in mine], name,
                        shape[1])
        _close_tree(synced, grads, GRAD_TOL, "step grads")
        norm = np.sqrt(sum(float(np.square(g.astype(np.float64)).sum())
                           for g in jax.tree.leaves(synced)))
        for r in mine:
            assert abs(r[name, sp, key]["norm"] - norm) <= 1e-5 * norm
        whole = _whole([r[name, sp, key]["params"] for r in mine], name,
                       shape[1])
        _close_tree(whole, _ref_update(name, synced), PARAM_TOL, "params",
                    rel=False)


@pytest.mark.parametrize("zero1", [False, True], ids=["plain", "zero1"])
@pytest.mark.parametrize("sp", SPS, ids=["sp_off", "sp_on"])
@pytest.mark.parametrize("name", CONFIGS)
def test_train_step_on_cuts_matches_the_reference(ranks, name, sp, zero1):
    """One ``make_train_step(mesh)`` step on each rank's cut, the cuts
    gathered whole, against the JAX package's pjit step on the global
    batch (the module docstring): the loss and the step's gradients
    against its ``_microbatch_grads``, the parameters against its clip
    and AdamW on the step's gradients; the global norm counts each
    expert leaf once."""
    shape, out = ranks
    loss, grads = _ref_global(name, 1)
    _check_step(out, shape, name, sp, f"step zero1={zero1}", loss, grads)


@pytest.mark.parametrize("sp", SPS, ids=["sp_off", "sp_on"])
@pytest.mark.parametrize("name", CONFIGS)
def test_train_step_in_microbatches_matches_the_reference(ranks, name, sp):
    """``make_train_step(mesh)`` in two microbatches: a rank's i-th is
    data shard r of the global batch's i-th, routed as a part of it, held
    to the JAX package's pjit step in two microbatches."""
    shape, out = ranks
    loss, grads = _ref_global(name, 2)
    _check_step(out, shape, name, sp, "step mb=2", loss, grads)


@pytest.mark.parametrize("sp", SPS, ids=["sp_off", "sp_on"])
@pytest.mark.parametrize("name", CONFIGS)
def test_psum_step_holds_the_per_shard_function(ranks, name, sp):
    """The psum step (``make_bucketed_train_step(sync="psum")``, the
    reference's ``shard_map`` step) routes each data shard alone: held to
    the mean of the JAX package's ``loss_fn`` and gradients over the data
    shards."""
    shape, out = ranks
    loss, grads = _ref_loss_grads(name, shape[0])
    _check_step(out, shape, name, sp, "psum", loss, grads)


@pytest.mark.parametrize("name", CONFIGS)
def test_prefill_and_decode_match_the_reference(ranks, name):
    """Prefill of 12 tokens and 4 decode steps on each rank's cut of the
    weights and of the caches (MLA's latent and rope key cut on their
    feature dims where they divide the axis, scored where they lie), the
    logits gathered over the model ranks, against the JAX package's
    ``prefill_step`` and ``decode_step``."""
    shape, out = ranks
    want = _ref_serve(name)
    n = shape[1]
    for row in range(shape[0]):
        mine = [r for r in out if r["coords"][0] == row]
        for i, w in enumerate(want):
            got = np.concatenate([r[name, "serve"][0][i] for r in mine],
                                 axis=-1)
            np.testing.assert_allclose(got, w, rtol=LOGIT_TOL,
                                       atol=LOGIT_TOL, err_msg=f"step {i}")
    cfg = R.moe_configs()[name]
    shapes = out[0][name, "serve"][1]
    if cfg.mla.enabled:
        r, dr = cfg.mla.kv_lora_rank, cfg.mla.qk_rope_head_dim
        assert shapes["c_kv"][-1] == (r // n if r % n == 0 else r)
        assert shapes["k_rope"][-1] == dr // n
    else:
        assert shapes["k"][-1] == cfg.resolved_head_dim() // n


def test_ranks_of_a_model_group_agree(ranks):
    """The loss and whole gradients of every rank are the same bits."""
    _, out = ranks
    for name in CONFIGS:
        for r in out[1:]:
            assert r[name, True, "loss"] == out[0][name, True, "loss"]
            for a, b in zip(jax.tree.leaves(r[name, True, "grads"]),
                            jax.tree.leaves(out[0][name, True, "grads"])):
                assert np.array_equal(a, b)

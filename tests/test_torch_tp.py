"""The port's ``model`` axis (Megatron tensor and sequence parallelism for
the dense and VLM families) against the JAX package, on the CPU.

* The cuts: for each of the ten archs (every family's ``model`` axis is
  cut), the spec of every parameter leaf over
  ``model`` (``sharding.model_specs``) equals the reference's ``sanitize_specs(param_specs(...))`` on its
  ``jax.eval_shape`` shapes, on the (16, 16) and (2, 16, 16) meshes;
  every rank's cut (``init_params(tp_rank=, tp_size=)`` on ``meta``,
  ``sharding.shard_tree``) has the shape those specs give, and the caches
  of ``init_caches(tp_size=)`` the shape ``cache_partition_specs`` gives.
* Gloo runs (``run_peers``, ``tests/_torch_tp_ranks.py``) on (1, 2),
  (1, 4) and (2, 2) data x model meshes, three small configs chosen so
  that both attention modes occur (``tiny``: heads at 2, rows at 4;
  ``tiny-h8``: heads at 2 and 4; ``tiny-vl``: the VLM family), sequence
  parallelism off and on: the logits gathered over the model ranks, the
  loss, the gradients gathered whole, one ``make_train_step(mesh)`` step
  with and without ZeRO-1 (parameters gathered whole), and prefill then
  four decode steps, each against the JAX package's ``forward``,
  ``loss_fn``, plain train step and serving steps on the global batch.

Tolerances: ``tests/test_torch_models.py``'s 5e-5 on logits (relative
and absolute); ``tests/test_torch_train.py``'s loss within 1e-5
relative, gradient leaves within 2e-5 of the leaf's largest |value|,
parameters within 1e-5. A first AdamW step moves an entry by lr * g /
(|g| + eps), which for a gradient within its rounding of zero differs
by up to 2 lr between two correct gradients (the port's plain step on
one device sits 1.4e-4 off the JAX package's on these batches); so a
step's parameters are held within 1e-5 of the JAX package's clip and
AdamW applied to the step's own gradients, and those gradients within
2e-5 of the JAX package's, as ``tests/test_torch_mesh_train.py`` holds
its compressed step.
"""
import dataclasses
import functools
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_tp_ranks as R
import repro.models as JM
import repro.train as JTR
import repro.train.optimizer as JOPT
from repro.configs.base import TrainConfig as JTrainConfig
from repro.configs.registry import ARCHS as J_ARCHS
from repro.configs.registry import get_config as jax_config
from repro.launch import specs as JS
from repro.models.sharding import param_specs as j_param_specs
from repro.serve.serve_step import decode_step as j_decode
from repro.serve.serve_step import prefill_step as j_prefill
from repro_torch._tree import tree_leaves
from repro_torch.configs.registry import get_config
from repro_torch.launch.dryrun import mesh_config
from repro_torch.launch.mesh import run_peers
from repro_torch.models import init_caches, init_params, sharding

LOGIT_TOL = 5e-5
LOSS_RTOL = 1e-5
GRAD_TOL = 2e-5
PARAM_TOL = 1e-5
SPAWN_TIMEOUT_S = 300
ARCHS = ("tinyllama-1.1b", "qwen2.5-3b", "qwen3-4b", "qwen1.5-32b",
         "qwen2-vl-7b", "phi3.5-moe-42b", "deepseek-v2-lite-16b",
         "seamless-m4t-large-v2", "mamba2-370m", "hymba-1.5b")
MESHES = ((1, 2), (1, 4), (2, 2))
CONFIGS = ("tiny", "tiny-h8", "tiny-vl")
SPS = (False, True)
BATCH, SEQ, SERVE_B = 4, 16, 2


def _j_mesh(kind):
    m = mesh_config(kind)
    return SimpleNamespace(axis_names=m.axes, shape=dict(zip(m.axes,
                                                             m.shape)))


def _tuples(tree):
    if isinstance(tree, dict):
        return {k: _tuples(v) for k, v in tree.items()}
    return tuple(tree)


def _model_only(spec: tuple) -> tuple:
    """A spec with its entries other than ``model`` dropped."""
    return tuple(e if e == "model" else None for e in spec)


# ---------------------------------------------------------------------------
# the cuts
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _ref_params(arch):
    return jax.eval_shape(functools.partial(
        JM.init_params, J_ARCHS[arch], dtype=jnp.bfloat16),
        jax.random.PRNGKey(0))


@pytest.mark.parametrize("mesh", ["single", "multi"])
@pytest.mark.parametrize("arch", ARCHS)
def test_param_cuts_equal_the_reference(arch, mesh):
    """Each leaf's spec over ``model`` is the reference's sanitized spec,
    and rank 0's and rank 15's cuts have the shapes it gives."""
    cfg = get_config(arch)
    jp = _ref_params(arch)
    want = _tuples(JS.sanitize_specs(j_param_specs(jp), jp, _j_mesh(mesh)))
    whole, specs = sharding.whole_specs(cfg, 16)
    assert jax.tree.map(_model_only, want,
                        is_leaf=lambda x: isinstance(x, tuple)) == specs
    jshapes = [tuple(x.shape) for x in jax.tree.leaves(jp)]
    jspecs = jax.tree.leaves(want, is_leaf=lambda x: isinstance(x, tuple))
    for rank in (0, 15):
        cut = init_params(cfg, 0, torch.bfloat16, "meta", tp_rank=rank,
                          tp_size=16)
        got = [tuple(t.shape) for t in tree_leaves(cut)]
        assert got == [sharding.cut_shape(s, sp, 16)
                       for s, sp in zip(jshapes, jspecs)]
    assert sharding.model_axis_sharded(cfg)


@pytest.mark.parametrize("mesh", ["single", "multi"])
@pytest.mark.parametrize("arch", ARCHS)
def test_cache_cuts_equal_the_reference(arch, mesh):
    """``init_caches(tp_size=16)`` holds the cut of every cache leaf that
    the reference's ``cache_partition_specs`` gives over ``model``."""
    cfg = get_config(arch)
    jc = jax.eval_shape(functools.partial(
        JM.init_caches, J_ARCHS[arch], 8, 64, jnp.bfloat16))
    specs = _tuples(JS.cache_partition_specs(jc, _j_mesh(mesh), 8))
    got = init_caches(cfg, 8, 64, torch.bfloat16, "meta", tp_size=16)
    for (path, t), (_, spec), jt in zip(
            sharding._leaf_paths(got, ""), sharding._leaf_paths(specs, ""),
            jax.tree.leaves(jc)):
        want = sharding.cut_shape(jt.shape, _model_only(spec), 16)
        assert tuple(t.shape) == want, path
    assert any(sharding.model_dims(s) for _, s in
               sharding._leaf_paths(specs, ""))


def test_shard_and_gather_are_inverse():
    """``gather_tree`` of every rank's ``shard_tree`` is the whole tree."""
    cfg = R.tp_configs()["tiny-vl"]
    whole = init_params(cfg, 3, torch.float32, "cpu")
    _, specs = sharding.whole_specs(cfg, 4)
    cuts = [sharding.shard_tree(whole, specs, r, 4) for r in range(4)]
    back = sharding.gather_tree(cuts, specs, 4)
    for a, b in zip(tree_leaves(back), tree_leaves(whole)):
        assert torch.equal(a, b)


def test_attention_seq_mode_is_the_reference_rule():
    assert not sharding.attention_seq_mode(32, 8, 8)
    assert sharding.attention_seq_mode(16, 2, 16)      # qwen2.5-3b
    assert sharding.attention_seq_mode(40, 40, 16)     # qwen1.5-32b
    assert not sharding.attention_seq_mode(40, 40, 1)


# ---------------------------------------------------------------------------
# gloo runs against the JAX package
# ---------------------------------------------------------------------------

def _jcfg(name):
    """The JAX package's twin of ``R.tp_configs()[name]``."""
    tiny = jax_config("tiny")
    return {"tiny": tiny,
            "tiny-h8": dataclasses.replace(tiny, name="tiny-h8",
                                           num_heads=8, num_kv_heads=4),
            "tiny-vl": dataclasses.replace(
                tiny, name="tiny-vl", family="vlm", mrope=True,
                mrope_sections=(2, 3, 3), qkv_bias=True, qk_norm=False,
                vision_patches_ratio=4)}[name]


def _inputs(cfg, b, s, seed):
    """Seeded tokens and labels (B, S); for a VLM the M-RoPE ids of a 2 x
    ``s / 8`` image grid then text, and ``s / 4`` patch embeddings."""
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32),
           "labels": rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)}
    if cfg.mrope:
        n_img = s // cfg.vision_patches_ratio
        t = np.arange(s)
        ids = np.stack([np.where(t < n_img, 0, t - n_img + 2),
                        np.where(t < n_img, t // 2, t - n_img + 2),
                        np.where(t < n_img, t % 2, t - n_img + 2)])
        out["mrope_positions"] = np.broadcast_to(
            ids[:, None], (3, b, s)).astype(np.int32).copy()
        out["patch_embeds"] = rng.standard_normal(
            (b, n_img, cfg.d_model)).astype(np.float32)
    return out


@functools.lru_cache(maxsize=None)
def _world(name):
    """(JAX params, numpy params, the train batch, the serving prompt)."""
    jcfg = _jcfg(name)
    jp = JM.init_params(jcfg, jax.random.PRNGKey(0))
    batch = _inputs(jcfg, BATCH, SEQ, 1)
    prompt = _inputs(jcfg, SERVE_B, R.PROMPT + R.DECODE, 2)
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
                          {n: w[3] for n, w in worlds.items()}))
    return shape, out


def _model_ranks(shape, out):
    """The results of data row 0's model ranks, in model order."""
    return [r for r in out if r["coords"][0] == 0]


def _jb(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


@functools.lru_cache(maxsize=None)
def _ref_loss_grads(name):
    jp, _, batch, _ = _world(name)
    jcfg = _jcfg(name)
    loss, grads = jax.value_and_grad(
        lambda p: JM.loss_fn(p, jcfg, _jb(batch)))(jp)
    return float(loss), jax.tree.map(np.asarray, grads)


def _ref_update(name, grads):
    """The JAX package's clip and AdamW step from its weights on
    ``grads`` (numpy leaves)."""
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
    first = dict(full, tokens=full["tokens"][:, :R.PROMPT])
    if jcfg.mrope:
        first["mrope_positions"] = full["mrope_positions"][..., :R.PROMPT]
    lg, caches = j_prefill(jp, jcfg, first, caches)
    outs = [np.asarray(lg)]
    for pos in range(R.PROMPT, R.PROMPT + R.DECODE):
        extra = ({"mrope_positions": full["mrope_positions"][..., pos:pos + 1]}
                 if jcfg.mrope else None)
        lg, caches = j_decode(jp, jcfg, full["tokens"][:, pos:pos + 1],
                              caches, jnp.int32(pos), extra=extra)
        outs.append(np.asarray(lg))
    return outs


def _whole(cuts, name, n):
    _, specs = sharding.whole_specs(R.tp_configs()[name], n)
    tree = sharding.gather_tree(
        [jax.tree.map(torch.from_numpy, c) for c in cuts], specs, n)
    return jax.tree.map(lambda t: t.numpy(), tree)


def _close_tree(got, want, tol, what, rel=True):
    got, want = jax.tree.leaves(got), jax.tree.leaves(want)
    assert len(got) == len(want), what
    for g, w in zip(got, want):
        assert g.shape == w.shape, what
        scale = max(float(np.abs(w).max()), 1e-30) if rel else 1.0
        np.testing.assert_allclose(g, w, rtol=0, atol=tol * scale,
                                   err_msg=what)


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
    """Every rank's loss and gradients (its cut's gradients, the partial
    ones summed over the model group, gathered back whole) against
    ``jax.value_and_grad`` of the JAX package's ``loss_fn``; the
    attention mode the heads give shows in the collectives sent."""
    shape, out = ranks
    loss, grads = _ref_loss_grads(name)
    cfg = R.tp_configs()[name]
    seq_mode = sharding.attention_seq_mode(cfg.num_heads, cfg.num_kv_heads,
                                           shape[1])
    for r in out:
        assert abs(r[name, sp, "loss"] - loss) <= LOSS_RTOL * abs(loss)
        _close_tree(r[name, sp, "grads"], grads, GRAD_TOL, "grads")
        sent = r[name, sp, "forward_collectives"]
        assert ("all-to-all" in sent) == seq_mode, sent
        assert ("reduce-scatter" in sent) == (sp or seq_mode), sent


@pytest.mark.parametrize("zero1", [False, True], ids=["plain", "zero1"])
@pytest.mark.parametrize("sp", SPS, ids=["sp_off", "sp_on"])
@pytest.mark.parametrize("name", CONFIGS)
def test_train_step_on_cuts_matches_the_reference(ranks, name, sp, zero1):
    """One ``make_train_step(mesh)`` step on each rank's cut, the cuts
    gathered whole, against the JAX package's plain step on the global
    batch: the loss and the step's gradients against the JAX package's,
    the parameters against its clip and AdamW on those gradients; under
    ZeRO-1 ``m`` is cut over ``data`` within the model cut."""
    shape, out = ranks
    loss, grads = _ref_loss_grads(name)
    key = f"step zero1={zero1}"
    for row in range(shape[0]):
        mine = [r for r in out if r["coords"][0] == row]
        for r in mine:
            got = r[name, sp, key]
            assert abs(got["loss"] - loss) <= LOSS_RTOL * abs(loss)
        synced = _whole([r[name, sp, key]["grads"] for r in mine], name,
                        shape[1])
        _close_tree(synced, grads, GRAD_TOL, "step grads")
        whole = _whole([r[name, sp, key]["params"] for r in mine], name,
                       shape[1])
        _close_tree(whole, _ref_update(name, synced), PARAM_TOL, "params",
                    rel=False)
    whole, specs = sharding.whole_specs(R.tp_configs()[name], shape[1])
    cut = [sharding.cut_shape(w.shape, s, shape[1]) for (_, w), (_, s) in
           zip(sharding._leaf_paths(whole, ""),
               sharding._leaf_paths(specs, ""))]
    got = out[0][name, sp, key]["m_shapes"]
    if zero1 and shape[0] > 1:
        # at most one dim of each model cut halved over the data axis
        assert got != cut
        for g, c in zip(got, cut):
            assert sum(a != b for a, b in zip(g, c)) <= 1, (g, c)
    else:
        assert got == cut


@pytest.mark.parametrize("name", CONFIGS)
def test_prefill_and_decode_match_the_reference(ranks, name):
    """Prefill of 12 tokens and 4 decode steps on each rank's cut of the
    weights and of the caches (K and V cut on the head dim), the logits
    gathered over the model ranks, against the JAX package's
    ``prefill_step`` and ``decode_step``."""
    shape, out = ranks
    want = _ref_serve(name)
    cfg = R.tp_configs()[name]
    n = shape[1]
    for row in range(shape[0]):
        mine = [r for r in out if r["coords"][0] == row]
        for i, w in enumerate(want):
            got = np.concatenate([r[name, "serve"][0][i] for r in mine],
                                 axis=-1)
            np.testing.assert_allclose(got, w, rtol=LOGIT_TOL,
                                       atol=LOGIT_TOL, err_msg=f"step {i}")
    hd = cfg.resolved_head_dim()
    assert out[0][name, "serve"][1]["k"][-1] == (hd // n if hd % n == 0
                                                 else hd)


def test_ranks_of_a_model_group_agree(ranks):
    """The loss and whole gradients of every rank are the same bits."""
    _, out = ranks
    for name in CONFIGS:
        for r in out[1:]:
            assert r[name, True, "loss"] == out[0][name, True, "loss"]
            for a, b in zip(jax.tree.leaves(r[name, True, "grads"]),
                            jax.tree.leaves(out[0][name, True, "grads"])):
                assert np.array_equal(a, b)


# ---------------------------------------------------------------------------
# K6's query offset on the CPU
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("sq,skv,causal,window,q_offset", [
    (16, 64, True, 0, 0), (16, 64, True, 0, 37), (16, 64, True, 8, 48),
    (7, 30, False, 0, 5), (10, 12, True, 4, 20)])
def test_visible_pairs_count_the_offset(sq, skv, causal, window, q_offset):
    """``visible_pairs`` (the cost K6 is charged) counts the mask of
    ``flash_attention_plain(q_offset=)``."""
    from repro_torch.kernels.flash_attention import visible_pairs
    i = q_offset + np.arange(sq)[:, None]
    j = np.arange(skv)[None, :]
    mask = np.ones((sq, skv), bool)
    if causal:
        mask &= i >= j
    if window:
        mask &= (i - j) < window
    assert visible_pairs(sq, skv, causal, window, q_offset) == mask.sum()


@pytest.mark.parametrize("window", [0, 24])
def test_offset_rows_with_the_blockwise_backward(window):
    """A rank's rows at an offset through ``ops.attention`` under the
    blockwise backward (``attention_core`` over more keys than the chunk)
    give the rows and gradients of the whole call's plain version."""
    from repro_torch.kernels.flash_attention import flash_attention_plain
    from repro_torch.models import layers
    g = torch.Generator().manual_seed(3)
    q = torch.randn(2, 64, 4, 16, generator=g)
    k, v = (torch.randn(2, 64, 2, 16, generator=g) for _ in range(2))
    rows = slice(40, 56)
    leaves = [t.clone().requires_grad_() for t in (q[:, rows], k, v)]
    with layers.attention_impl("blockwise", 16):
        out = layers.attention_core(*leaves, causal=True, window=window,
                                    q_offset=40)
    grads = torch.autograd.grad(out.square().sum(), leaves)
    ref = [t.clone().requires_grad_() for t in (q, k, v)]
    whole = flash_attention_plain(*ref, causal=True, window=window)
    torch.testing.assert_close(out, whole[:, rows], rtol=1e-5, atol=1e-6)
    want = torch.autograd.grad(whole[:, rows].square().sum(), ref)
    for got, w in zip(grads, (want[0][:, rows], want[1], want[2])):
        torch.testing.assert_close(got, w, rtol=1e-5, atol=1e-6)

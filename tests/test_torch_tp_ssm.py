"""The port's ``model`` axis for the SSM family and hybrid heads (the
Mamba-2 mixer on the reference's column, conv and row cuts, its conv
cache cut on the channels and its state on the head dim) against the JAX
package, on the CPU.

Gloo runs (``run_peers``, ``tests/_torch_tp_ranks.py``) on (1, 2), (1, 4)
and (2, 2) data x model meshes of three small configs
(``_torch_tp_ranks.ssm_configs``), chosen so that a head-parallel scan,
a scan of every head on every rank, a whole ``in_proj`` and a whole
conv, an ``out_proj`` cut that straddles the heads and sequence-parallel
attention rows under a window all occur: ``tiny-ssm``, ``tiny-ssm-odd``
and ``tiny-hybrid``. Sequence parallelism off and on: the logits
gathered over the model ranks, the loss and the gradients gathered whole
(on the global batch, against the JAX package's ``loss_fn``), one
``make_train_step(mesh)`` step with and without ZeRO-1, and prefill then
four decode steps over the cut caches, each against the JAX package.
The specs and cuts of each leaf and cache of mamba2-370m and hymba-1.5b
are held in ``tests/test_torch_tp.py``.

Tolerances: ``tests/test_torch_tp.py``'s (5e-5 on logits, the loss
within 1e-5 relative, gradient leaves within 2e-5 of the leaf's largest
|value|, parameters within 1e-5 of the JAX package's clip and AdamW on
the step's own gradients).
"""
import functools

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
from repro.configs.registry import get_config as jax_config
from repro.serve.serve_step import decode_step as j_decode
from repro.serve.serve_step import prefill_step as j_prefill
from repro_torch.launch.mesh import run_peers
from repro_torch.models import sharding
from repro_torch.models.ssm import head_parallel
from test_torch_tp import (GRAD_TOL, LOGIT_TOL, LOSS_RTOL, PARAM_TOL,
                           SPAWN_TIMEOUT_S, _jb)

MESHES = ((1, 2), (1, 4), (2, 2))
CONFIGS = ("tiny-ssm", "tiny-ssm-odd", "tiny-hybrid")
SPS = (False, True)
BATCH, SEQ, SERVE_B = 4, 16, 2


def _jcfg(name):
    """The JAX package's twin of ``R.ssm_configs()[name]``."""
    return R.ssm_config(name, jax_config)


# ---------------------------------------------------------------------------
# the JAX package's side, shared with tests/test_torch_tp_encdec.py
# ---------------------------------------------------------------------------

def inputs(cfg, b, s, seed):
    """Seeded tokens and labels (B, S); for an enc-dec model ``s / 4``
    frames of N(0, 1) embeddings."""
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32),
           "labels": rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)}
    if cfg.enc_dec:
        out["enc_embeds"] = rng.standard_normal(
            (b, s // cfg.encoder_seq_ratio, cfg.d_model)).astype(np.float32)
    return out


def world(jcfg):
    """(JAX params, numpy params, the train batch, the serving prompt,
    with ``PROMPT / 4`` frames for an enc-dec model)."""
    jp = JM.init_params(jcfg, jax.random.PRNGKey(0))
    batch = inputs(jcfg, BATCH, SEQ, 1)
    prompt = inputs(jcfg, SERVE_B, R.PROMPT + R.DECODE, 2)
    prompt.pop("labels")
    if jcfg.enc_dec:
        prompt["enc_embeds"] = prompt["enc_embeds"][
            :, :R.PROMPT // jcfg.encoder_seq_ratio]
    return jp, jax.tree.map(np.asarray, jp), batch, prompt


def spawn(shape, worlds, kind):
    return run_peers(R.tp_cases, shape[0] * shape[1], device="cpu",
                     timeout_s=SPAWN_TIMEOUT_S,
                     args=(shape, {n: w[1] for n, w in worlds.items()},
                           {n: w[2] for n, w in worlds.items()},
                           {n: w[3] for n, w in worlds.items()}, kind))


def ref_loss_grads(jcfg, w):
    loss, grads = jax.value_and_grad(
        lambda p: JM.loss_fn(p, jcfg, _jb(w[2])))(w[0])
    return float(loss), jax.tree.map(np.asarray, grads)


def ref_update(w, grads):
    """The JAX package's clip and AdamW step from its weights on
    ``grads`` (numpy leaves)."""
    tcfg = JTrainConfig(learning_rate=3e-3, warmup_steps=1, total_steps=20,
                        remat=False)
    g = jax.tree.map(jnp.asarray, grads)
    p, _ = JOPT.adamw_update(JOPT.clip_by_global_norm(g, tcfg.grad_clip)[0],
                             JTR.init_adam(w[0]), w[0], tcfg)
    return jax.tree.map(np.asarray, p)


def ref_serve(jcfg, w):
    """The JAX package's prefill of PROMPT tokens and DECODE steps (an
    enc-dec model's frames with each)."""
    full = _jb(w[3])
    caches = JM.init_caches(jcfg, SERVE_B, R.MAX_SEQ, jnp.float32)
    lg, caches = j_prefill(w[0], jcfg, dict(
        full, tokens=full["tokens"][:, :R.PROMPT]), caches)
    outs = [np.asarray(lg)]
    extra = {"enc_embeds": full["enc_embeds"]} if jcfg.enc_dec else None
    for pos in range(R.PROMPT, R.PROMPT + R.DECODE):
        lg, caches = j_decode(w[0], jcfg, full["tokens"][:, pos:pos + 1],
                              caches, jnp.int32(pos), extra=extra)
        outs.append(np.asarray(lg))
    return outs


def close_tree(got, want, tol, what, rel=True):
    """``test_torch_tp._close_tree`` over trees that may hold empty leaves
    (a full-width SSM's zero-width FFN): those are held by shape alone."""
    got, want = jax.tree.leaves(got), jax.tree.leaves(want)
    assert len(got) == len(want), what
    for g, w in zip(got, want):
        assert g.shape == w.shape, what
        if w.size:
            scale = max(float(np.abs(w).max()), 1e-30) if rel else 1.0
            np.testing.assert_allclose(g, w, rtol=0, atol=tol * scale,
                                       err_msg=what)


def gathered(cuts, cfg, n):
    """Whole numpy leaves from the model ranks' cuts, in rank order."""
    _, specs = sharding.whole_specs(cfg, n)
    tree = sharding.gather_tree(
        [jax.tree.map(torch.from_numpy, c) for c in cuts], specs, n)
    return jax.tree.map(lambda t: t.numpy(), tree)


def check_logits(out, shape, name, sp, want):
    for row in range(shape[0]):
        got = np.concatenate([r[name, sp, "logits"] for r in out
                              if r["coords"][0] == row], axis=-1)
        np.testing.assert_allclose(got, want, rtol=LOGIT_TOL, atol=LOGIT_TOL)


def check_loss_grads(out, name, sp, loss, grads):
    for r in out:
        assert abs(r[name, sp, "loss"] - loss) <= LOSS_RTOL * abs(loss)
        close_tree(r[name, sp, "grads"], grads, GRAD_TOL, "grads")


def check_step(out, shape, cfg, w, sp, zero1, loss, grads):
    """One ``make_train_step(mesh)`` step on each rank's cut, the cuts
    gathered whole: the loss and gradients against ``loss`` and
    ``grads``, the parameters against the JAX package's clip and AdamW
    on the step's gradients."""
    key = f"step zero1={zero1}"
    for row in range(shape[0]):
        mine = [r for r in out if r["coords"][0] == row]
        for r in mine:
            assert abs(r[cfg.name, sp, key]["loss"] - loss) <= \
                LOSS_RTOL * abs(loss)
        synced = gathered([r[cfg.name, sp, key]["grads"] for r in mine],
                          cfg, shape[1])
        close_tree(synced, grads, GRAD_TOL, "step grads")
        whole = gathered([r[cfg.name, sp, key]["params"] for r in mine],
                         cfg, shape[1])
        close_tree(whole, ref_update(w, synced), PARAM_TOL, "params",
                    rel=False)


def check_serve(out, shape, name, want):
    for row in range(shape[0]):
        mine = [r for r in out if r["coords"][0] == row]
        for i, w in enumerate(want):
            got = np.concatenate([r[name, "serve"][0][i] for r in mine],
                                 axis=-1)
            np.testing.assert_allclose(got, w, rtol=LOGIT_TOL,
                                       atol=LOGIT_TOL, err_msg=f"step {i}")


def check_agree(out, names):
    """The loss and whole gradients of every rank are the same bits."""
    for name in names:
        for r in out[1:]:
            assert r[name, True, "loss"] == out[0][name, True, "loss"]
            for a, b in zip(jax.tree.leaves(r[name, True, "grads"]),
                            jax.tree.leaves(out[0][name, True, "grads"])):
                assert np.array_equal(a, b)


# ---------------------------------------------------------------------------
# gloo runs against the JAX package
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _world(name):
    return world(_jcfg(name))


@pytest.fixture(scope="module", params=MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
def ranks(request):
    shape = request.param
    return shape, spawn(shape, {n: _world(n) for n in CONFIGS}, "ssm")


@functools.lru_cache(maxsize=None)
def _ref_loss_grads(name):
    return ref_loss_grads(_jcfg(name), _world(name))


def test_configs_take_both_scan_layouts():
    """The configs hold what the runs are meant to show: a head-parallel
    scan at 2 and 4 ranks (``tiny-ssm``), every head on every rank at 4
    (``tiny-ssm-odd`` with its conv whole, ``tiny-hybrid`` with its
    ``in_proj`` whole), ``out_proj`` cut, the hybrid's attention by
    rows."""
    cfgs = R.ssm_configs()
    assert head_parallel(cfgs["tiny-ssm"], 4)
    for name, whole in (("tiny-ssm-odd", "conv_w"),
                        ("tiny-hybrid", "in_proj")):
        cfg = cfgs[name]
        assert head_parallel(cfg, 2) and not head_parallel(cfg, 4)
        _, specs = sharding.whole_specs(cfg, 4)
        kept = {p.split("/")[-1]: sharding.model_dims(s)
                for p, s in sharding._leaf_paths(specs, "")
                if "/ssm/" in p}
        assert [k for k in ("in_proj", "conv_w") if not kept[k]] == [whole]
        assert kept["out_proj"] == [1]
    hy = cfgs["tiny-hybrid"]
    assert sharding.attention_seq_mode(hy.num_heads, hy.num_kv_heads, 2)


@pytest.mark.parametrize("sp", SPS, ids=["sp_off", "sp_on"])
@pytest.mark.parametrize("name", CONFIGS)
def test_gathered_logits_match_the_reference(ranks, name, sp):
    shape, out = ranks
    jp, _, batch, _ = _world(name)
    want = np.asarray(JM.forward(jp, _jcfg(name), _jb(batch))[0])
    check_logits(out, shape, name, sp, want)


@pytest.mark.parametrize("sp", SPS, ids=["sp_off", "sp_on"])
@pytest.mark.parametrize("name", CONFIGS)
def test_loss_and_whole_gradients_match_the_reference(ranks, name, sp):
    """Every rank's loss and gradients (its cut's, the SSM mixer's whole
    leaves and, under sequence parallelism, the norms summed over the
    model group, gathered back whole) against ``jax.value_and_grad`` of
    the JAX package's ``loss_fn`` on the global batch."""
    _, out = ranks
    check_loss_grads(out, name, sp, *_ref_loss_grads(name))


@pytest.mark.parametrize("zero1", [False, True], ids=["plain", "zero1"])
@pytest.mark.parametrize("sp", SPS, ids=["sp_off", "sp_on"])
@pytest.mark.parametrize("name", CONFIGS)
def test_train_step_on_cuts_matches_the_reference(ranks, name, sp, zero1):
    shape, out = ranks
    check_step(out, shape, R.ssm_configs()[name], _world(name), sp, zero1,
               *_ref_loss_grads(name))


@pytest.mark.parametrize("name", CONFIGS)
def test_prefill_and_decode_match_the_reference(ranks, name):
    """Prefill of 12 tokens and 4 decode steps on each rank's cut of the
    weights and of the caches (the conv cache cut on its channels, the
    state on its head dim, a hybrid's K and V on theirs), the logits
    gathered over the model ranks, against the JAX package's
    ``prefill_step`` and ``decode_step``."""
    shape, out = ranks
    check_serve(out, shape, name, ref_serve(_jcfg(name), _world(name)))
    cfg, n = R.ssm_configs()[name], shape[1]
    s = cfg.ssm
    conv = s.d_inner(cfg.d_model) + 2 * s.n_groups * s.d_state
    shapes = out[0][name, "serve"][1]
    pre = "ssm/" if cfg.hybrid_parallel_heads else ""
    assert shapes[pre + "conv"][-1] == (conv // n if conv % n == 0
                                        else conv)
    assert shapes[pre + "ssm"][-2] == s.head_dim // n


def test_ranks_of_a_model_group_agree(ranks):
    _, out = ranks
    check_agree(out, CONFIGS)

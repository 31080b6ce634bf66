"""Leaves that do not divide the ``model`` axis, held whole on every rank
beside cut ones, against the JAX package unsharded, on the CPU.

* ``sharding.check_model_axis`` raises for no registry arch, smoke
  config or tiny config at any model axis from 2 to 256, and returns the
  leaves that ``param_specs`` puts on ``model`` but ``sanitize_specs``
  leaves whole (``whole_leaves``); a family that is not ported still
  raises. ``partial_grad_leaf`` reads a whole leaf's rule from its
  spec. A rank's cut with whole leaves saves and restores
  (``checkpoint.CheckpointManager``) bit for bit.
* Gloo runs (``run_peers``, ``_torch_tp_ranks.whole_cases``) of
  ``_torch_tp_ranks.WHOLE_MESHES``: on a (2, 3) data x model mesh,
  train-100m's widths (``wq``/``wo`` cut beside ``wk``/``wv``, the MLP
  and the vocab whole), deepseek-v2-lite-16b-smoke (MLA by rows with
  ``w_kr``, ``w_uk``, ``w_uv`` and ``wo`` whole, the dense MLP, the
  experts and the shared experts whole), ``tiny-ssm`` (``in_proj``,
  ``conv_w``, ``out_proj``, ``embed`` and ``lm_head`` whole),
  seamless-m4t-large-v2-smoke (every attention projection of the
  encoder, the decoder and the cross-attention whole) and
  hymba-1.5b-smoke (attention and SSM whole); on a (1, 8) mesh
  ``tiny-moe`` and deepseek-v2-lite-16b-smoke, their experts whole beside
  cut attention. Sequence parallelism off and on: the logits (gathered
  over the model ranks where the vocab is cut), the loss and the
  gradients gathered whole, prefill then four decode steps, and on the
  data x model mesh train-100m's ``make_train_step(mesh)`` step under
  ZeRO-1 (the whole leaves' optimizer state cut over ``data``), each
  against the JAX package's ``forward``, ``loss_fn``, clip and AdamW and
  serving steps on the global batch (each jitted). The train sequences
  of train-100m, seamless and ``tiny-ssm`` do not divide the axis of 3
  (every row attended on every rank, a whole o-projection or
  ``out_proj`` taking each rank's share of the rows); the others' do (by
  rows, K6 at the rank's offset), as every prefill's does at 3.

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

import _torch_tp_ranks as R
import repro.models as JM
import repro.train as JTR
import repro.train.optimizer as JOPT
from repro.configs.base import TrainConfig as JTrainConfig
from repro.configs.registry import get_config as jax_config
from repro.serve.serve_step import decode_step as j_decode
from repro.serve.serve_step import prefill_step as j_prefill
from repro_torch.configs.registry import _EXTRA, ARCHS, get_config
from repro_torch.launch.mesh import run_peers
from repro_torch.models import sharding
from test_torch_tp import GRAD_TOL, LOGIT_TOL, LOSS_RTOL, PARAM_TOL, \
    SPAWN_TIMEOUT_S, _jb
from test_torch_tp_ssm import close_tree, gathered, inputs

BATCH, SERVE_B = 4, 2
#: train tokens a sequence: 32 does not divide the axis of 3, 48 does.
#: ``tiny-ssm`` takes 32: over 48 (three chunks) its ``a_log`` gradient
#: sits 1.9e-5 of itself off the JAX package's unsharded, near the 2e-5
#: bound, the scan's summation order alone (at 16 and 32, 3e-6)
SEQ = {"train-100m-l2": 32, "seamless-m4t-large-v2-smoke": 32,
       "tiny-ssm": 32}
SEQ_DEFAULT = 48
SPS = (False, True)
#: the runs' configs of which an axis of 3 divides no leaf
ALL_WHOLE = ("seamless-m4t-large-v2-smoke", "hymba-1.5b-smoke")
CASES = [(shape, name) for shape, names in R.WHOLE_MESHES.items()
         for name in names]
CONFIGS = (list(ARCHS) + [f"{a}-smoke" for a in ARCHS] + sorted(_EXTRA))


def _id(case):
    return f"{case[0][0]}x{case[0][1]}-{case[1]}"


# ---------------------------------------------------------------------------
# the rule
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", CONFIGS)
def test_every_config_splits_over_every_axis(name):
    """No registry, smoke or tiny config raises at a model axis of 2 to
    256; the leaves it returns are exactly those the sanitized specs
    leave whole though ``param_specs`` cuts them."""
    cfg = get_config(name)
    for axis in range(2, 257):
        got = sharding.check_model_axis(cfg, axis)
        assert got == sharding.whole_leaves(cfg, axis)
    whole, specs = sharding.whole_specs(cfg, 3)
    rules = dict(sharding._leaf_paths(sharding.param_specs(whole), ""))
    kept = dict(sharding._leaf_paths(specs, ""))
    assert sharding.whole_leaves(cfg, 3) == tuple(
        p for p in rules if sharding.model_dims(rules[p])
        and not sharding.model_dims(kept[p]))


def test_an_unported_family_still_raises():
    cfg = dataclasses.replace(get_config("tiny"), name="tiny-rnn",
                              family="rnn")
    with pytest.raises(NotImplementedError, match="not ported"):
        sharding.check_model_axis(cfg, 4)


def test_partial_grad_leaf_reads_the_spec():
    """A leaf the axis leaves whole though its spec cuts it is summed
    over the group, but on the residual's layout (the vocab, a dense
    MLP) only where the residual is cut by sequence; a replicated leaf
    keeps the name rules."""
    col, row, rep = (None, "model"), ("model", None), (None, None)
    for path in ("layers/mixer/attn/wk", "layers/mixer/attn/wo",
                 "layers/ffn/moe/experts/w_up",
                 "layers/ffn/moe/shared/w_down", "layers/mixer/mla/w_kr",
                 "layers/mixer/ssm/out_proj", "layers/mixer/ssm/in_proj"):
        for sp in SPS:
            assert sharding.partial_grad_leaf(path, sp, col)
    for path in ("embed", "lm_head", "layers/ffn/mlp/w_gate",
                 "dense_blocks/0/ffn/mlp/w_down"):
        for sp in SPS:
            assert sharding.partial_grad_leaf(path, sp, row) == sp
    assert sharding.partial_grad_leaf("layers/ffn/moe/router", False, rep)
    assert not sharding.partial_grad_leaf("layers/pre_norm_scale", False,
                                          rep)
    assert sharding.partial_grad_leaf("layers/pre_norm_scale", True, rep)


@pytest.mark.parametrize("case", CASES, ids=_id)
def test_the_runs_hold_whole_leaves_beside_cut_ones(case):
    """Each run's config keeps some leaves whole and cuts others over its
    mesh's model axis (``tiny-ssm``'s only its zero-width FFN), but for
    the smoke widths of seamless and hymba, which divide nothing at 3:
    each of their ranks holds the whole model and computes its share of
    the rows (its leaves' gradients summed over the group)."""
    (_, n), name = case
    cfg = R.whole_config(name)
    got = sharding.check_model_axis(cfg, n)
    _, specs = sharding.whole_specs(cfg, n)
    assert got
    assert any(sharding.model_dims(s) for _, s in sharding._leaf_paths(
        specs, "")) == (name not in ALL_WHOLE or n != 3)


# ---------------------------------------------------------------------------
# gloo runs against the JAX package
# ---------------------------------------------------------------------------

def _jcfg(name):
    return R.whole_config(name, jax_config)


@functools.lru_cache(maxsize=None)
def _world(name):
    """(JAX params, numpy params, the train batch, the serving prompt,
    with ``PROMPT / 4`` frames for an enc-dec model)."""
    jcfg = _jcfg(name)
    jp = JM.init_params(jcfg, jax.random.PRNGKey(0))
    batch = inputs(jcfg, BATCH, SEQ.get(name, SEQ_DEFAULT), 1)
    prompt = inputs(jcfg, SERVE_B, R.PROMPT + R.DECODE, 2)
    prompt.pop("labels")
    if jcfg.enc_dec:
        prompt["enc_embeds"] = prompt["enc_embeds"][
            :, :R.PROMPT // jcfg.encoder_seq_ratio]
    return jp, jax.tree.map(np.asarray, jp), batch, prompt


@functools.lru_cache(maxsize=None)
def _spawn(shape):
    worlds = {n: _world(n) for n in R.WHOLE_MESHES[shape]}
    return run_peers(R.whole_cases, shape[0] * shape[1], device="cpu",
                     timeout_s=SPAWN_TIMEOUT_S,
                     args=(shape, {n: w[1] for n, w in worlds.items()},
                           {n: w[2] for n, w in worlds.items()},
                           {n: w[3] for n, w in worlds.items()}))


# the JAX package's side, each function jitted (a MoE model's eager
# backward takes ten times as long on this CPU)

@functools.lru_cache(maxsize=None)
def _ref_logits(name):
    w, cfg = _world(name), _jcfg(name)
    fwd = jax.jit(lambda p, b: JM.forward(p, cfg, b)[0])
    return np.asarray(fwd(w[0], _jb(w[2])))


@functools.lru_cache(maxsize=None)
def _ref_loss_grads(name):
    w, cfg = _world(name), _jcfg(name)
    loss, grads = jax.jit(jax.value_and_grad(
        lambda p, b: JM.loss_fn(p, cfg, b)))(w[0], _jb(w[2]))
    return float(loss), jax.tree.map(np.asarray, grads)


def _ref_update(name, grads):
    """The JAX package's clip and AdamW step from its weights on
    ``grads`` (numpy leaves)."""
    tcfg = JTrainConfig(learning_rate=3e-3, warmup_steps=1, total_steps=20,
                        remat=False)

    def update(g, p):
        g = JOPT.clip_by_global_norm(g, tcfg.grad_clip)[0]
        return JOPT.adamw_update(g, JTR.init_adam(p), p, tcfg)[0]

    p = jax.jit(update)(jax.tree.map(jnp.asarray, grads), _world(name)[0])
    return jax.tree.map(np.asarray, p)


@functools.lru_cache(maxsize=None)
def _ref_serve(name):
    """The JAX package's prefill of PROMPT tokens and DECODE steps (an
    enc-dec model's frames with each)."""
    w, cfg = _world(name), _jcfg(name)
    full = _jb(w[3])
    prefill = jax.jit(lambda p, b, c: j_prefill(p, cfg, b, c))
    decode = jax.jit(lambda p, t, c, pos, extra: j_decode(
        p, cfg, t, c, pos, extra=extra))
    caches = JM.init_caches(cfg, SERVE_B, R.MAX_SEQ, jnp.float32)
    lg, caches = prefill(w[0], dict(full, tokens=full["tokens"][:, :R.PROMPT]),
                         caches)
    outs = [np.asarray(lg)]
    extra = {"enc_embeds": full["enc_embeds"]} if cfg.enc_dec else None
    for pos in range(R.PROMPT, R.PROMPT + R.DECODE):
        lg, caches = decode(w[0], full["tokens"][:, pos:pos + 1], caches,
                            jnp.int32(pos), extra)
        outs.append(np.asarray(lg))
    return outs


def _row(out, row=0):
    """The ranks of a data row, in model order."""
    return sorted((r for r in out if r["coords"][0] == row),
                  key=lambda r: r["coords"][1])


def _vocab(parts, want):
    """The model ranks' logits as the whole vocab's: concatenated where
    each holds its cut, else each rank's own (every rank holds them
    whole) held alike."""
    if parts[0].shape[-1] == want.shape[-1]:
        for p in parts[1:]:
            np.testing.assert_array_equal(p, parts[0])
        return parts[0]
    return np.concatenate(parts, axis=-1)


@pytest.mark.parametrize("sp", SPS, ids=["sp_off", "sp_on"])
@pytest.mark.parametrize("case", CASES, ids=_id)
def test_logits_match_the_reference(case, sp):
    shape, name = case
    want = _ref_logits(name)
    got = _vocab([r[name, sp, "logits"] for r in _row(_spawn(shape))], want)
    np.testing.assert_allclose(got, want, rtol=LOGIT_TOL, atol=LOGIT_TOL)


@pytest.mark.parametrize("sp", SPS, ids=["sp_off", "sp_on"])
@pytest.mark.parametrize("case", CASES, ids=_id)
def test_loss_and_whole_gradients_match_the_reference(case, sp):
    """Every rank's loss and gradients (its cut's, a whole leaf's summed
    over the model group where the rank computed it on its share,
    gathered back whole) against ``jax.value_and_grad`` of the JAX
    package's ``loss_fn``."""
    shape, name = case
    loss, grads = _ref_loss_grads(name)
    for r in _row(_spawn(shape)):
        assert abs(r[name, sp, "loss"] - loss) <= LOSS_RTOL * abs(loss)
        close_tree(r[name, sp, "grads"], grads, GRAD_TOL, "grads")


@pytest.mark.parametrize("case", CASES, ids=_id)
def test_prefill_and_decode_match_the_reference(case):
    """Prefill of 12 tokens (by rows at 3, every row at 8) and 4 decode
    steps on each rank's cut of the weights and of the caches (a whole
    head dim or latent kept whole), against the JAX package's
    ``prefill_step`` and ``decode_step``."""
    shape, name = case
    want = _ref_serve(name)
    row = _row(_spawn(shape))
    for i, w in enumerate(want):
        got = _vocab([r[name, "serve"][0][i] for r in row], w)
        np.testing.assert_allclose(got, w, rtol=LOGIT_TOL, atol=LOGIT_TOL,
                                   err_msg=f"step {i}")


def test_zero1_step_on_the_data_axis():
    """One ``make_train_step(mesh)`` step under ZeRO-1 on each rank's cut
    of the (2, 3) mesh (train-100m's widths: the vocab, the MLP, ``wk``
    and ``wv`` whole): the loss, the step's gradients gathered whole and
    the parameters after it against the JAX package on the global
    batch, the other data row's the same bits; ``m`` is cut over
    ``data`` within the model cut, a whole leaf's too."""
    shape, name = (2, 3), R.WHOLE_STEP
    out = _spawn(shape)
    loss, grads = _ref_loss_grads(name)
    cfg = R.whole_config(name)
    key = "step zero1=True"
    rows = [_row(out, row) for row in range(shape[0])]
    for r in rows[0] + rows[1]:
        assert abs(r[name, True, key]["loss"] - loss) <= LOSS_RTOL * abs(loss)
    synced = gathered([r[name, True, key]["grads"] for r in rows[0]], cfg,
                      shape[1])
    close_tree(synced, grads, GRAD_TOL, "step grads")
    whole = gathered([r[name, True, key]["params"] for r in rows[0]], cfg,
                     shape[1])
    close_tree(whole, _ref_update(name, synced), PARAM_TOL, "params",
               rel=False)
    for a, b in zip(rows[0], rows[1]):
        for x, y in zip(jax.tree.leaves(a[name, True, key]["params"]),
                        jax.tree.leaves(b[name, True, key]["params"])):
            assert np.array_equal(x, y)
    full, specs = sharding.whole_specs(cfg, shape[1])
    cuts = {p: sharding.cut_shape(w.shape, s, shape[1]) for (p, w), (_, s)
            in zip(sharding._leaf_paths(full, ""),
                   sharding._leaf_paths(specs, ""))}
    got = dict(zip(cuts, out[0][name, True, key]["m_shapes"]))
    for p, c in cuts.items():
        assert sum(a != b for a, b in zip(got[p], c)) <= 1, (p, got[p], c)
    assert any(got[p] != cuts[p] for p in sharding.whole_leaves(
        cfg, shape[1])), got


@pytest.mark.parametrize("case", [((1, 8), "tiny-moe"),
                                  ((2, 3), "train-100m-l2")], ids=_id)
def test_a_cut_with_whole_leaves_checkpoints(case, tmp_path):
    """The last model rank's cut, its whole leaves among cut ones, saved
    and restored onto a template of its own shapes: every leaf back bit
    for bit, the whole ones at their whole shape."""
    import torch
    from repro_torch.checkpoint.checkpoint import CheckpointManager
    from repro_torch.models import init_params
    (_, n), name = case
    cfg = R.whole_config(name)
    cut = init_params(cfg, 3, torch.float32, "cpu", tp_rank=n - 1,
                      tp_size=n)
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, cut)
    back, step = mgr.restore(jax.tree.map(torch.zeros_like, cut))
    assert step == 1
    whole = dict(sharding._leaf_paths(sharding.whole_specs(cfg, n)[0], ""))
    got = dict(sharding._leaf_paths(back, ""))
    for p, t in sharding._leaf_paths(cut, ""):
        assert torch.equal(got[p], t), p
    for p in sharding.whole_leaves(cfg, n):
        assert got[p].shape == whole[p].shape, p

"""The port's training path against the JAX package, on the CPU: the data
pipeline, AdamW and its schedule, the loss and its gradient, the plain
train step, checkpoints and the train launcher.

Inputs come from numpy seeds; model weights are the JAX package's
(``repro.models.init_params``) carried over by ``params_from_jax``.
Tolerances:

- data batches and checkpoint leaves byte-equal;
- ``lr_schedule``, ``clip_by_global_norm`` and ``adamw_update`` within
  1e-6 (f32 arithmetic in the reference's order; XLA and PyTorch may
  round a ``pow`` or ``cos`` one ulp apart, and the norm's sum runs in
  another order);
- the loss within 1e-5 relative, each gradient leaf within 2e-5 of the
  leaf's largest |value| (the forward sums in another order, within the
  reference's 5e-5 on logits, and the backward compounds it);
- after 3 train steps, losses within 1e-5 relative and parameters
  within 1e-5: at lr 1e-3 an Adam step moves an entry by about
  lr * sign(g), and the gradients agree far closer than their
  magnitudes, so the parameters stay close.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models as JM
from repro.checkpoint.checkpoint import CheckpointManager as JCheckpoint
from repro.configs.base import TrainConfig as JTrainConfig
from repro.configs.registry import get_config as jax_config
from repro.data.pipeline import DataConfig as JDataConfig
from repro.data.pipeline import SyntheticPipeline as JPipeline
from repro.data.pipeline import input_batch_for as j_input_batch_for
from repro.configs.base import SHAPES as J_SHAPES
import repro.train as JTR
import repro.train.optimizer as JOPT
from repro_torch._tree import tree_leaves
from repro_torch.checkpoint.checkpoint import CheckpointManager
from repro_torch.configs.base import SHAPES, TrainConfig
from repro_torch.configs.registry import get_config
from repro_torch.data.pipeline import (DataConfig, SyntheticPipeline,
                                       input_batch_for)
from repro_torch.launch.train import run
from repro_torch.models import init_params, loss_fn, params_from_jax
from repro_torch.train import init_adam, make_train_step
from repro_torch.train.optimizer import (AdamState, adamw_update,
                                         clip_by_global_norm, global_norm,
                                         lr_schedule)

LOSS_RTOL = 1e-5
GRAD_TOL = 2e-5
PARAM_TOL = 1e-5
OPT_TOL = 1e-6


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _pair(arch, **replace):
    jc, tc = jax_config(arch), get_config(arch)
    if replace:
        jc = dataclasses.replace(jc, **replace)
        tc = dataclasses.replace(tc, **replace)
    jp = JM.init_params(jc, jax.random.PRNGKey(0))
    return jc, tc, jp, params_from_jax(_np(jp), device="cpu")


def _batch(vocab, b, s, seed):
    return SyntheticPipeline(DataConfig(seed=seed, vocab_size=vocab,
                                        batch=b, seq_len=s)).batch_at(0)


def _both(batch):
    return ({k: jnp.asarray(v) for k, v in batch.items()},
            {k: torch.from_numpy(v) for k, v in batch.items()})


def _leaves_close(got_tree, want_tree, tol, what):
    got, want = tree_leaves(got_tree), jax.tree.leaves(want_tree)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        g, w = g.detach().numpy(), np.asarray(w)
        assert g.shape == w.shape and g.dtype == w.dtype, what
        np.testing.assert_allclose(g, w, rtol=0, atol=tol, err_msg=what)


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 7, 123])
@pytest.mark.parametrize("structured", [True, False])
def test_pipeline_batches_byte_equal(seed, structured):
    kw = dict(seed=seed, vocab_size=32000, batch=3, seq_len=17,
              structured=structured)
    mine, ref = SyntheticPipeline(DataConfig(**kw)), JPipeline(
        JDataConfig(**kw))
    for step in range(5):
        got, want = mine.batch_at(step), ref.batch_at(step)
        assert sorted(got) == sorted(want) == ["labels", "tokens"]
        for k in want:
            assert got[k].dtype == want[k].dtype
            assert got[k].tobytes() == want[k].tobytes(), (seed, step, k)
    resumed = next(mine.resume_from(3))
    assert resumed["tokens"].tobytes() == ref.batch_at(3)["tokens"].tobytes()


def test_input_batch_for_byte_equal():
    got = input_batch_for(get_config("tiny"), SHAPES["train_4k"], seed=2)
    want = j_input_batch_for(jax_config("tiny"), J_SHAPES["train_4k"],
                             seed=2)
    for k in want:
        assert got[k].tobytes() == want[k].tobytes()


# ---------------------------------------------------------------------------
# optimizer
# ---------------------------------------------------------------------------

def test_lr_schedule_matches_jax():
    cfg = dict(learning_rate=3e-3, warmup_steps=5, total_steps=40)
    mine, ref = lr_schedule(TrainConfig(**cfg)), JOPT.lr_schedule(
        JTrainConfig(**cfg))
    for step in range(0, 45):
        got = float(mine(torch.tensor(step, dtype=torch.int32)))
        want = float(ref(jnp.int32(step)))
        assert abs(got - want) <= OPT_TOL * cfg["learning_rate"], step


def _random_tree(rng):
    return {"w": rng.standard_normal((6, 5)).astype(np.float32),
            "b": rng.standard_normal((5,)).astype(np.float32) * 1e-3,
            "layers": {"k": rng.standard_normal((2, 4, 3)).astype(
                np.float32)}}


@pytest.mark.parametrize("max_norm", [0.5, 1e3])
def test_clip_by_global_norm_matches_jax(max_norm):
    g = _random_tree(np.random.default_rng(1))
    got, norm = clip_by_global_norm(params_from_jax(g, device="cpu"),
                                    max_norm)
    want, jnorm = JOPT.clip_by_global_norm(jax.tree.map(jnp.asarray, g),
                                           max_norm)
    assert abs(float(norm) - float(jnorm)) <= OPT_TOL * float(jnorm)
    assert abs(float(global_norm(got)) - float(JOPT.global_norm(want))) \
        <= OPT_TOL * float(jnorm)
    _leaves_close(got, want, OPT_TOL, "clip")


def test_adamw_update_matches_jax_over_steps():
    """Four updates from zero state on a tree with a vector leaf (no
    decay) and matrices (decayed), through warmup into the cosine."""
    rng = np.random.default_rng(2)
    cfg = dict(learning_rate=1e-2, warmup_steps=2, total_steps=6,
               weight_decay=0.1)
    tcfg, jcfg = TrainConfig(**cfg), JTrainConfig(**cfg)
    p_np = _random_tree(rng)
    params, jparams = params_from_jax(p_np, device="cpu"), jax.tree.map(
        jnp.asarray, p_np)
    opt, jopt = init_adam(params), JOPT.init_adam(jparams)
    assert opt.step.dtype == torch.int32 and int(opt.step) == 0
    for _ in range(4):
        g_np = _random_tree(rng)
        params, opt = adamw_update(params_from_jax(g_np, device="cpu"),
                                   opt, params, tcfg)
        jparams, jopt = JOPT.adamw_update(
            jax.tree.map(jnp.asarray, g_np), jopt, jparams, jcfg)
        assert int(opt.step) == int(jopt.step)
        _leaves_close(params, jparams, OPT_TOL, "params")
        _leaves_close(opt.m, jopt.m, OPT_TOL, "m")
        _leaves_close(opt.v, jopt.v, OPT_TOL, "v")


# ---------------------------------------------------------------------------
# loss and gradients
# ---------------------------------------------------------------------------

LOSS_CASES = [("tiny", {}), ("tiny-ssm", {}), ("hymba-1.5b-smoke", {}),
              ("mamba2-370m-smoke", {"vocab_size": 50280})]


@pytest.mark.parametrize("arch,replace", LOSS_CASES,
                         ids=[a + ("-vocab50280" if r else "")
                              for a, r in LOSS_CASES])
@pytest.mark.parametrize("remat", [False, True])
def test_loss_and_grads_match_jax(arch, replace, remat):
    jc, tc, jp, tp = _pair(arch, **replace)
    if replace:      # the vocab pads: 50280 -> 50432 logits
        assert tc.padded_vocab() == 50432 != tc.vocab_size
    jb, tb = _both(_batch(tc.vocab_size, 2, 32, seed=3))
    want, jgrads = jax.value_and_grad(
        lambda p: JM.loss_fn(p, jc, jb, remat=remat))(jp)
    leaves = [t.requires_grad_() for t in tree_leaves(tp)]
    loss = loss_fn(tp, tc, tb, remat=remat)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                materialize_grads=True)
    got = loss.detach()
    assert abs(float(got) - float(want)) <= LOSS_RTOL * abs(float(want))
    for g, w, name in zip(grads, jax.tree.leaves(jgrads),
                          jax.tree_util.tree_leaves_with_path(jgrads)):
        w = np.asarray(w)
        scale = float(np.abs(w).max(initial=0.0))
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=GRAD_TOL * scale,
                                   err_msg=str(name[0]))


def test_cross_entropy_over_padded_vocab_matches_jax():
    """Logits wider than the vocab (padding columns hold values too):
    the port's CE over all padded columns equals the reference's."""
    from repro.models.transformer import cross_entropy as j_ce
    from repro_torch.models import cross_entropy
    rng = np.random.default_rng(4)
    logits = (rng.standard_normal((2, 5, 512)) * 4).astype(np.float32)
    labels = rng.integers(0, 500, (2, 5)).astype(np.int32)
    got = cross_entropy(torch.from_numpy(logits), torch.from_numpy(labels),
                        512)
    want = j_ce(jnp.asarray(logits), jnp.asarray(labels), 512)
    assert abs(float(got) - float(want)) <= LOSS_RTOL * float(want)
    with pytest.raises(ValueError):
        cross_entropy(torch.from_numpy(logits), torch.from_numpy(labels),
                      500)


# ---------------------------------------------------------------------------
# the train step
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("microbatches", [1, 2])
def test_train_steps_match_jax(microbatches):
    jc, tc, jp, tp = _pair("tiny")
    cfg = dict(learning_rate=1e-3, warmup_steps=1, total_steps=10,
               remat=True, microbatches=microbatches)
    jstep = jax.jit(JTR.make_train_step(jc, JTrainConfig(**cfg)))
    step = make_train_step(tc, TrainConfig(**cfg))
    jo, to = JTR.init_adam(jp), init_adam(tp)
    pipe = SyntheticPipeline(DataConfig(seed=1, vocab_size=tc.vocab_size,
                                        batch=4, seq_len=16))
    for i in range(3):
        jb, tb = _both(pipe.batch_at(i))
        jl, jp, jo = jstep(jp, jo, jb)
        tl, tp, to = step(tp, to, tb)
        assert abs(float(tl) - float(jl)) <= LOSS_RTOL * abs(float(jl)), i
    _leaves_close(tp, jp, PARAM_TOL, "params after 3 steps")
    assert int(to.step) == int(jo.step) == 3


def test_train_step_keeps_grads_when_asked():
    tc = get_config("tiny")
    params = init_params(tc, 0, device="cpu")
    step = make_train_step(tc, TrainConfig(learning_rate=1e-3))
    b = _both(_batch(tc.vocab_size, 2, 8, seed=0))[1]
    step(params, init_adam(params), b)
    assert step.last_grads is None
    step.keep_grads = True
    step(params, init_adam(params), b)
    assert [g.shape for g in tree_leaves(step.last_grads)] == \
        [p.shape for p in tree_leaves(params)]


def test_training_memorizes_tiny():
    """The reference's ``test_system.py`` memorisation case."""
    cfg = get_config("tiny")
    tcfg = TrainConfig(learning_rate=3e-3, warmup_steps=2, total_steps=30,
                       remat=True)
    params = init_params(cfg, 0, device="cpu")
    opt = init_adam(params)
    step = make_train_step(cfg, tcfg)
    pipe = SyntheticPipeline(DataConfig(seed=0, vocab_size=cfg.vocab_size,
                                        batch=4, seq_len=32))
    b = {k: torch.from_numpy(v) for k, v in pipe.batch_at(0).items()}
    losses = []
    for _ in range(20):
        loss, params, opt = step(params, opt, b)
        losses.append(float(loss))
    assert losses[-1] < 0.7 * losses[0], losses


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------

def test_checkpoint_restart_bitexact(tmp_path):
    """Train 6 steps == train 3 + save/restore + 3 more, bit-exactly (the
    reference's ``test_system.py`` case; on the CPU the embedding's
    backward is deterministic)."""
    cfg = get_config("tiny")
    tcfg = TrainConfig(learning_rate=1e-3, warmup_steps=1, total_steps=10)
    pipe = SyntheticPipeline(DataConfig(seed=1, vocab_size=cfg.vocab_size,
                                        batch=2, seq_len=16))
    step = make_train_step(cfg, tcfg)

    def train(n0, n1, params, opt):
        for i in range(n0, n1):
            b = {k: torch.from_numpy(v) for k, v in pipe.batch_at(i).items()}
            _, params, opt = step(params, opt, b)
        return params, opt

    p0 = init_params(cfg, 0, device="cpu")
    o0 = init_adam(p0)
    pa, _ = train(0, 6, p0, o0)
    pb, ob = train(0, 3, p0, o0)
    cm = CheckpointManager(str(tmp_path))
    cm.save(3, (pb, ob), blocking=False)
    cm.wait()
    (pr, orr), s = cm.restore((pb, ob))
    assert s == 3 and isinstance(orr, AdamState)
    assert orr.step.dtype == torch.int32 and int(orr.step) == 3
    pb2, _ = train(3, 6, pr, orr)
    for a, b in zip(tree_leaves(pa), tree_leaves(pb2)):
        assert torch.equal(a, b)


def test_checkpoint_layout_gc_and_target_device(tmp_path):
    cfg = get_config("tiny")
    params = init_params(cfg, 0, device="cpu")
    cm = CheckpointManager(str(tmp_path), keep=2)
    for s in (1, 2, 3):
        cm.save(s, params, blocking=(s != 2))
        cm.wait()
    assert cm.all_steps() == [2, 3] and cm.latest_step() == 3
    names = sorted(p.name for p in (tmp_path / "step_00000003").iterdir())
    assert names == ["manifest.json", "shard_00000.npz"]
    with np.load(tmp_path / "step_00000003" / "shard_00000.npz") as z:
        assert "layers%mixer%attn%wq" in z.files
    restored, s = cm.restore(params, target_device="cpu")
    assert s == 3
    for a, b in zip(tree_leaves(params), tree_leaves(restored)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    with pytest.raises(FileNotFoundError):
        CheckpointManager(str(tmp_path / "empty")).restore(params)


def test_jax_checkpoint_restores_into_the_port(tmp_path):
    """A (params, AdamState) checkpoint written by the JAX package's
    manager comes back leaf for leaf, bit-equal, through the port's."""
    jc, tc, jp, tp = _pair("tiny")
    jo = JTR.init_adam(jp)
    jstep = jax.jit(JTR.make_train_step(jc, JTrainConfig(
        learning_rate=1e-3, warmup_steps=1)))
    jb, _ = _both(_batch(tc.vocab_size, 2, 8, seed=5))
    _, jp, jo = jstep(jp, jo, jb)
    JCheckpoint(str(tmp_path)).save(1, (jp, jo))
    template = (tp, init_adam(tp))
    (rp, ro), s = CheckpointManager(str(tmp_path)).restore(template)
    assert s == 1 and int(ro.step) == 1
    for got, want in zip(tree_leaves(rp) + tree_leaves(ro.m)
                         + tree_leaves(ro.v),
                         jax.tree.leaves(jp) + jax.tree.leaves(jo.m)
                         + jax.tree.leaves(jo.v)):
        assert got.numpy().tobytes() == np.asarray(want).tobytes()


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------

def test_train_launcher_loss_falls_on_cpu(tmp_path):
    res = run("tiny", steps=12, batch=4, seq=32, lr=3e-3, device="cpu",
              ckpt_dir=str(tmp_path), log_every=100)
    assert res["last_loss"] < res["first_loss"], res
    assert set(res) == {"arch", "steps", "first_loss", "last_loss",
                        "mean_step_s", "total_s", "buckets", "traffic"}
    assert res["buckets"] == 1 and res["traffic"]["bulk_grad"]["count"] == 12
    assert CheckpointManager(str(tmp_path)).latest_step() == 12


def test_train_launcher_without_device_needs_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is the GPU")
    with pytest.raises(RuntimeError, match="CUDA"):
        run("tiny", steps=1, batch=2, seq=8)

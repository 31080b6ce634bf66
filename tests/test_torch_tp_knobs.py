"""The reference's last lowering knobs over the port's ``model`` axis,
against the JAX package on the CPU.

* MLA over a model axis its heads do not divide
  (``_torch_tp_ranks.knob_configs``' ``ds-h4``: deepseek-v2-lite-16b's
  smoke structure, 4 heads, at a model axis of 8): the rank's rows of q
  (its column cut, half a head wide, all-to-all into whole rows) against
  K and V gathered whole, as the reference's sequence-parallel
  attention runs it; and the same model with ``qkv_sharding`` off (the
  head dims cut, the scores summed).
* ``--no-qkv-shard`` (``sharding.set_qkv_sharding(False)``, the
  reference's baseline lowering): ``tiny``, whose 2 KV heads do not
  divide a model axis of 4, on the ranks' cuts of the head dim with the
  partial scores all-reduced, under the naive and the blockwise impl.

One spawn of 8 gloo ranks (``run_peers``, ``knob_cases``) runs each mesh
in turn: the logits gathered over the model ranks, the loss and the
gradients gathered whole on the global batch (remat under the ``dots``
policy, sequence parallelism off and on), and prefill then decode steps,
each against the JAX package unsharded under the same impl and remat
policy (its switches set and restored in ``finally``). The dry-run
record of a cut ``tiny`` train cell with the flag off holds the
reckoned score all-reduces.

Tolerances: ``tests/test_torch_tp.py``'s (5e-5 on logits, the loss
within 1e-5 relative, gradient leaves within 2e-5 of the leaf's largest
|value|).
"""
import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import _torch_tp_ranks as R
import repro.models as JM
import repro.models.layers as JL
import repro.models.transformer as JT
from repro.configs.registry import get_config as jax_config
from repro.serve.serve_step import decode_step as j_decode
from repro.serve.serve_step import prefill_step as j_prefill
from repro_torch.configs.base import ShapeConfig
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import run_peers
from repro_torch.models import sharding
from test_torch_tp import (GRAD_TOL, LOGIT_TOL, LOSS_RTOL, SPAWN_TIMEOUT_S,
                           _close_tree, _jb)

BATCH, SEQ, SERVE_B = 2, 16, 2
#: (config, knob, JAX attention impl) of every run
RUNS = (("ds-h4", "rows", "naive"), ("ds-h4", "hd", "naive"),
        ("tiny", "hd", "naive"), ("tiny", "hd blockwise", "blockwise"))


def _inputs(cfg, b, s, seed):
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, cfg.vocab_size, (b, s)).astype(
                np.int32),
            "labels": rng.integers(0, cfg.vocab_size, (b, s)).astype(
                np.int32)}


@functools.lru_cache(maxsize=None)
def _world(name):
    """(JAX config, JAX params, numpy params, the batch, the prompt)."""
    cfg = R.knob_configs(jax_config)[name]
    jp = JM.init_params(cfg, jax.random.PRNGKey(0))
    batch = _inputs(cfg, BATCH, SEQ, 1)
    prompt = _inputs(cfg, SERVE_B, R.KNOB_PROMPT + R.KNOB_DECODE, 2)
    prompt.pop("labels")
    return cfg, jp, jax.tree.map(np.asarray, jp), batch, prompt


def _jax_switches(impl):
    """Set the JAX package's attention impl and the ``dots`` remat policy;
    returns the function that restores their defaults."""
    JL.set_attention_impl(impl, R.KNOB_CHUNK)
    JT.set_remat_policy("dots")

    def restore():
        JL.set_attention_impl("naive")
        JT.set_remat_policy("full")
    return restore


@functools.lru_cache(maxsize=None)
def _ref(name, impl):
    """The JAX package's logits, loss and gradients (remat under ``dots``)
    and serving logits, unsharded, under ``impl``."""
    cfg, jp, _, batch, prompt = _world(name)
    restore = _jax_switches(impl)
    try:
        logits = np.asarray(JM.forward(jp, cfg, _jb(batch))[0])
        loss, grads = jax.value_and_grad(
            lambda p: JM.loss_fn(p, cfg, _jb(batch), remat=True))(jp)
        toks = jnp.asarray(prompt["tokens"])
        caches = JM.init_caches(cfg, SERVE_B, R.KNOB_MAX_SEQ, jnp.float32)
        lg, caches = j_prefill(jp, cfg, {"tokens": toks[:, :R.KNOB_PROMPT]},
                               caches)
        serve = [np.asarray(lg)]
        for pos in range(R.KNOB_PROMPT, R.KNOB_PROMPT + R.KNOB_DECODE):
            lg, caches = j_decode(jp, cfg, toks[:, pos:pos + 1], caches,
                                  jnp.int32(pos))
            serve.append(np.asarray(lg))
    finally:
        restore()
    return logits, float(loss), jax.tree.map(np.asarray, grads), serve


@pytest.fixture(scope="module")
def ranks():
    worlds = {n: _world(n) for n in R.KNOB_MESHES}
    return run_peers(R.knob_cases, 8, device="cpu",
                     timeout_s=SPAWN_TIMEOUT_S,
                     args=({n: w[2] for n, w in worlds.items()},
                           {n: w[3] for n, w in worlds.items()},
                           {n: w[4] for n, w in worlds.items()}))


def _model_rows(out, name):
    """The ranks of ``name``'s mesh grouped by data row, each row's ranks
    in model order."""
    rows = {}
    for r in out:
        rows.setdefault(r[name, "coords"][0], []).append(r)
    return [sorted(rs, key=lambda r: r[name, "coords"][1])
            for rs in rows.values()]


def test_the_knobs_pick_their_modes():
    """The modes the runs exercise: MLA's 4 heads at 8 by rows (or on
    the head dim's cut with the knob off), ``tiny``'s 2 KV heads at 4 on
    the head dim's cut with it off and by rows with it on."""
    ds, tiny = R.knob_configs()["ds-h4"], R.knob_configs()["tiny"]
    sharding.check_model_axis(ds, 8)
    m = ds.mla
    assert sharding.attention_mode(4, 4, SEQ, m.qk_head_dim, m.v_head_dim,
                                   8) == "rows"
    assert sharding.attention_mode(4, 4, 1, m.qk_head_dim, m.v_head_dim,
                                   8) == "replicated"
    hd = tiny.resolved_head_dim()
    assert sharding.attention_mode(4, 2, SEQ, hd, hd, 4) == "rows"
    with sharding.qkv_sharding(False):
        assert sharding.attention_mode(4, 4, SEQ, m.qk_head_dim,
                                       m.v_head_dim, 8) == "hd"
        assert sharding.attention_mode(4, 2, SEQ, hd, hd, 4) == "hd"
        assert sharding.attention_mode(4, 2, SEQ, hd, hd, 2) == "heads"
        assert sharding.attention_mode(4, 2, SEQ, 12, 12, 8) == "rows"
    assert sharding.qkv_sharding_enabled()


@pytest.mark.parametrize("name,knob,impl", RUNS)
def test_gathered_logits_match_the_reference(ranks, name, knob, impl):
    want = _ref(name, impl)[0]
    for row in _model_rows(ranks, name):
        got = np.concatenate([r[name, knob, "logits"] for r in row],
                             axis=-1)
        np.testing.assert_allclose(got, want, rtol=LOGIT_TOL,
                                   atol=LOGIT_TOL)


@pytest.mark.parametrize("sp", [False, True], ids=["sp_off", "sp_on"])
@pytest.mark.parametrize("name,knob,impl", RUNS)
def test_loss_and_whole_gradients_match_the_reference(ranks, name, knob,
                                                      impl, sp):
    """Every rank's loss and its gradients gathered back whole, under the
    ``dots`` remat policy on both sides; the "rows" run moves q and the
    output by all-to-all, the "hd" runs send none (they sum scores)."""
    _, loss, grads, _ = _ref(name, impl)
    for r in ranks:
        assert abs(r[name, knob, sp, "loss"] - loss) <= LOSS_RTOL * abs(loss)
        _close_tree(r[name, knob, sp, "grads"], grads, GRAD_TOL, "grads")
    sent = ranks[0][name, knob, sp, "collectives"]
    assert ("all-to-all" in sent) == (knob == "rows"), sent


@pytest.mark.parametrize("name,knob,impl", RUNS)
def test_prefill_and_decode_match_the_reference(ranks, name, knob, impl):
    want = _ref(name, impl)[3]
    for row in _model_rows(ranks, name):
        for step, w in enumerate(want):
            got = np.concatenate([r[name, knob, "serve"][step] for r in row],
                                 axis=-1)
            np.testing.assert_allclose(got, w, rtol=LOGIT_TOL,
                                       atol=LOGIT_TOL, err_msg=str(step))


@pytest.mark.parametrize("impl", ["naive", "blockwise"])
def test_dryrun_record_holds_the_score_all_reduces(impl):
    """``tiny``'s train cell cut over a model axis of 4 under
    ``--no-qkv-shard``: each attention layer all-reduces its whole f32
    scores, (B, Hq, S, S) of the data share, in the forward, the remat
    recompute and the backward (its dP); blockwise, one (B, Hq, S, chunk)
    all-reduce a key chunk in each and in the chunk's own recompute (each
    chunk is checkpointed inside the block); and no K6 call."""
    cfg = R.knob_configs()["tiny"]
    shape = ShapeConfig("train_64", 64, 8, "train")
    chunk = 16
    mesh = dryrun.mesh_config("2x4:data,model")
    with sharding.qkv_sharding(False), \
            dryrun.layers.attention_impl(impl, chunk):
        fn, inputs, plan = dryrun.build_cell(cfg, shape, mesh,
                                             dryrun.train_config())
        counts = dryrun.trace(fn, inputs)
    b = shape.global_batch // 2
    keys = shape.seq_len if impl == "naive" else chunk
    score = b * cfg.num_heads * shape.seq_len * keys * 4
    sums = [nb for (op, nb, _), ax in zip(plan.collectives,
                                          plan.collective_axes)
            if op == "all-reduce" and ax == ("model",) and nb == score]
    passes = 3 if impl == "naive" else 4
    assert len(sums) == passes * cfg.num_layers * shape.seq_len // keys, \
        len(sums)
    assert "flash_attention" not in counts["kernels"]


def test_dryrun_takes_the_knobs(tmp_path):
    """The reference's dry-run flags run: ``--no-qkv-shard`` and
    ``--remat-policy dots`` on a cut ``tiny`` cell write an ``ok`` record
    naming them; the settings found before are restored after."""
    assert dryrun.main(["--arch", "tiny", "--shape", "train_4k", "--mesh",
                        "2x2:data,model", "--out", str(tmp_path),
                        "--no-qkv-shard", "--remat-policy", "dots"]) == 0
    (path,) = tmp_path.glob("*.json")
    rec = json.loads(path.read_text())
    assert rec["ok"], rec.get("error")
    assert rec["qkv_shard"] is False and rec["remat_policy"] == "dots"
    assert sharding.qkv_sharding_enabled()
    assert dryrun.transformer.get_remat_policy() == "full"

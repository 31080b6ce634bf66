"""The port's ``model`` axis for the encoder-decoder family (the encoder
over its own residual, the cross-attention's ``wq``, ``wk``, ``wv``
column-cut and ``wo`` row-cut over the encoder's output gathered whole,
the decoder's ``{"self": ...}`` caches cut on the head dim) against the
JAX package, on the CPU.

Gloo runs (``run_peers``, ``tests/_torch_tp_ranks.py``) on (1, 2), (1, 4)
and (2, 2) data x model meshes of two small configs of seamless-m4t's
structure (``_torch_tp_ranks.encdec_configs``): ``tiny-encdec``, whose
heads divide both axes as seamless-m4t-large-v2's 16 do 16 ranks, and
``tiny-encdec-gqa``, whose attention runs by rows at 4 ranks and with
every head on every rank over a 3-frame prompt. Sequence parallelism off
and on (the encoder's 4 frames cut by sequence too): the logits gathered
over the model ranks, the loss and the gradients gathered whole (on the
global batch, against the JAX package's ``loss_fn``), one
``make_train_step(mesh)`` step with and without ZeRO-1, and prefill then
four decode steps, the frames with each, as the reference re-runs its
encoder. The specs and cuts of every leaf and cache of
seamless-m4t-large-v2 are held in ``tests/test_torch_tp.py``.

Tolerances: ``tests/test_torch_tp.py``'s (5e-5 on logits, the loss
within 1e-5 relative, gradient leaves within 2e-5 of the leaf's largest
|value|, parameters within 1e-5 of the JAX package's clip and AdamW on
the step's own gradients).
"""
import dataclasses
import functools

import numpy as np
import pytest

import _torch_tp_ranks as R
import repro.models as JM
from repro.configs.registry import get_config as jax_config
from repro_torch.models import sharding
from test_torch_tp import _jb
from test_torch_tp_ssm import (check_agree, check_logits, check_loss_grads,
                               check_serve, check_step, ref_loss_grads,
                               ref_serve, spawn, world)

MESHES = ((1, 2), (1, 4), (2, 2))
CONFIGS = ("tiny-encdec", "tiny-encdec-gqa")
SPS = (False, True)


def _jcfg(name):
    """The JAX package's twin of ``R.encdec_configs()[name]``."""
    return dataclasses.replace(jax_config("seamless-m4t-large-v2-smoke"),
                               name=name, **R.encdec_fields(name))


@functools.lru_cache(maxsize=None)
def _world(name):
    return world(_jcfg(name))


@pytest.fixture(scope="module", params=MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
def ranks(request):
    shape = request.param
    return shape, spawn(shape, {n: _world(n) for n in CONFIGS}, "encdec")


@functools.lru_cache(maxsize=None)
def _ref_loss_grads(name):
    return ref_loss_grads(_jcfg(name), _world(name))


def test_configs_take_every_attention_mode():
    """Heads at 2 and 4 ranks for ``tiny-encdec``; by rows at 4 for
    ``tiny-encdec-gqa``, whose 3-frame prompt (and a decode step's row)
    does not divide the axis."""
    cfgs = R.encdec_configs()
    a, b = cfgs["tiny-encdec"], cfgs["tiny-encdec-gqa"]
    for n in (2, 4):
        assert not sharding.attention_seq_mode(a.num_heads, a.num_kv_heads,
                                               n)
    assert not sharding.attention_seq_mode(b.num_heads, b.num_kv_heads, 2)
    assert sharding.attention_seq_mode(b.num_heads, b.num_kv_heads, 4)
    assert R.PROMPT // a.encoder_seq_ratio % 2


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
    """Every rank's loss and gradients (its cut's, the norms of the
    encoder's and the decoder's residuals summed over the model group
    under sequence parallelism, gathered back whole) against
    ``jax.value_and_grad`` of the JAX package's ``loss_fn``."""
    _, out = ranks
    check_loss_grads(out, name, sp, *_ref_loss_grads(name))


@pytest.mark.parametrize("zero1", [False, True], ids=["plain", "zero1"])
@pytest.mark.parametrize("sp", SPS, ids=["sp_off", "sp_on"])
@pytest.mark.parametrize("name", CONFIGS)
def test_train_step_on_cuts_matches_the_reference(ranks, name, sp, zero1):
    shape, out = ranks
    check_step(out, shape, R.encdec_configs()[name], _world(name), sp,
               zero1, *_ref_loss_grads(name))


@pytest.mark.parametrize("name", CONFIGS)
def test_prefill_and_decode_match_the_reference(ranks, name):
    """Prefill of 12 tokens over 3 frames and 4 decode steps (the encoder
    re-run by each) on each rank's cut of the weights and of the
    decoder's caches, the logits gathered over the model ranks, against
    the JAX package's ``prefill_step`` and ``decode_step``."""
    shape, out = ranks
    check_serve(out, shape, name, ref_serve(_jcfg(name), _world(name)))
    cfg = R.encdec_configs()[name]
    assert out[0][name, "serve"][1]["self/k"][-1] == \
        cfg.resolved_head_dim() // shape[1]


def test_ranks_of_a_model_group_agree(ranks):
    _, out = ranks
    check_agree(out, CONFIGS)

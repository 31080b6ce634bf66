"""The reference's ``--remat-policy dots`` in the port (selective
activation checkpointing, ``models.transformer.set_remat_policy``)
against the JAX package, on the CPU.

* For the smoke config of each family (dense, MoE with MLA, SSM, hybrid,
  enc-dec, VLM): ``loss_fn(remat=True)`` under ``remat_policy("dots")``
  against the JAX package's under ``set_remat_policy("dots")`` (set and
  restored in ``finally``), the loss within 1e-5 relative and each
  gradient leaf within 2e-5 of its largest |value|
  (``tests/test_torch_train.py``'s); and the port's gradients under
  ``dots`` and under ``none`` bit-equal to its own under ``full``.
* The kept set: one block of each family, checkpointed under
  ``dots_policy``, keeps the outputs of the products the reference's
  block keeps under ``dots_with_no_batch_dims_saveable`` (its residuals
  beyond the arguments and constants, as ``saved_residuals`` lists
  them), shape for shape, each flattened to (rows, columns).
* On ``meta``, a cut ``tiny`` train cell's FLOPs under ``dots`` are
  ``full``'s less the forward FLOPs of the kept products, exactly, and
  its predicted peak is higher.
"""
import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax._src import ad_checkpoint as jad
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

import repro.models as JM
import repro.models.transformer as JT
from repro.configs.registry import get_config as jax_config
from repro_torch._tree import tree_leaves
from repro_torch.configs.base import ShapeConfig
from repro_torch.configs.registry import get_config
from repro_torch.data.pipeline import DataConfig, SyntheticPipeline
from repro_torch.launch import dryrun
from repro_torch.models import init_params, loss_fn, params_from_jax
from repro_torch.models import transformer as T
from repro_torch.serve.inputs import model_inputs

LOSS_RTOL = 1e-5
GRAD_TOL = 2e-5
#: one smoke config a family
ARCHS = ("tiny", "deepseek-v2-lite-16b-smoke", "mamba2-370m-smoke",
         "hymba-1.5b-smoke", "seamless-m4t-large-v2-smoke",
         "qwen2-vl-7b-smoke")
#: the batch of ``tests/test_torch_train.py``'s loss parity (2 x 32 of
#: the synthetic pipeline at seed 3), with a family's frames or patches
B, S = 2, 32


def _batch(cfg, seed=3):
    out = dict(SyntheticPipeline(DataConfig(
        seed=seed, vocab_size=cfg.vocab_size, batch=B,
        seq_len=S)).batch_at(0))
    extra = model_inputs(cfg, B, S, seed=seed, device="cpu")
    out.update({k: v.numpy() for k, v in extra.items()})
    return out


@functools.lru_cache(maxsize=None)
def _world(arch):
    jc = jax_config(arch)
    jp = JM.init_params(jc, jax.random.PRNGKey(0))
    return jc, jp, jax.tree.map(np.asarray, jp), _batch(get_config(arch))


@functools.lru_cache(maxsize=None)
def _port_grads(arch, policy):
    _, _, np_params, batch = _world(arch)
    params = params_from_jax(np_params, device="cpu")
    leaves = [t.requires_grad_() for t in tree_leaves(params)]
    with T.remat_policy(policy):
        loss = loss_fn(params, get_config(arch),
                       {k: torch.from_numpy(v) for k, v in batch.items()},
                       remat=True)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                    materialize_grads=True)
    return float(loss.detach()), grads


@pytest.mark.parametrize("arch", ARCHS)
def test_dots_loss_and_grads_match_jax(arch):
    jc, jp, _, batch = _world(arch)
    JT.set_remat_policy("dots")
    try:
        want, jgrads = jax.value_and_grad(lambda p: JM.loss_fn(
            p, jc, {k: jnp.asarray(v) for k, v in batch.items()},
            remat=True))(jp)
    finally:
        JT.set_remat_policy("full")
    loss, grads = _port_grads(arch, "dots")
    assert abs(loss - float(want)) <= LOSS_RTOL * abs(float(want))
    for g, w, name in zip(grads, jax.tree.leaves(jgrads),
                          jax.tree_util.tree_leaves_with_path(jgrads)):
        w = np.asarray(w)
        scale = float(np.abs(w).max(initial=0.0))
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=GRAD_TOL * scale,
                                   err_msg=str(name[0]))


@pytest.mark.parametrize("policy", ["dots", "none"])
@pytest.mark.parametrize("arch", ARCHS)
def test_policy_grads_equal_full_bit_for_bit(arch, policy):
    """What a policy keeps or recomputes is the same value on the CPU:
    the loss and every gradient equal ``full``'s exactly."""
    loss, grads = _port_grads(arch, "full")
    loss_p, grads_p = _port_grads(arch, policy)
    assert loss_p == loss
    for a, b in zip(grads_p, grads):
        assert torch.equal(a, b)


def _rows_cols(shape):
    return (math.prod(shape[:-1]), shape[-1])


def _jax_kept(arch):
    """The shapes of the residuals the reference's first stacked block
    keeps under ``dots_with_no_batch_dims_saveable`` beyond its arguments
    and constants."""
    jc, jp, _, _ = _world(arch)
    key = "dec_layers" if jc.enc_dec else "layers"
    bp = jax.tree.map(lambda a: a[0], jp[key])
    x = jnp.ones((B, S, jc.d_model), jnp.float32)
    pos = jnp.broadcast_to(jnp.arange(S, dtype=jnp.int32), (B, S))
    enc = jnp.ones((B, S // 4, jc.d_model)) if jc.enc_dec else None

    def body(bp, x):
        y, _, aux = JT._block_apply(bp, jc, x, pos, jnp.int32(0), None, None,
                                    enc_out=enc)
        return jnp.sum(y) + aux

    fn = jax.checkpoint(
        body, policy=jax.checkpoint_policies.dots_with_no_batch_dims_saveable)
    return sorted(_rows_cols(aval.shape)
                  for aval, why in jad.saved_residuals(fn, bp, x)
                  if "from the argument" not in why
                  and "from a constant" not in why)


def _port_kept(arch):
    """The output shapes ``dots_policy`` marks ``MUST_SAVE`` in the port's
    first stacked block, checkpointed as ``_run_stack`` does, and the
    block's backward run through the recompute."""
    cfg = get_config(arch)
    params = init_params(cfg, 0, torch.float32, "cpu")
    bp = T._layer(params["dec_layers" if cfg.enc_dec else "layers"], 0)
    x = torch.ones((B, S, cfg.d_model), requires_grad=True)
    pos = torch.arange(S, dtype=torch.int32).expand(B, S)
    enc = torch.ones((B, S // 4, cfg.d_model)) if cfg.enc_dec else None
    kept = []

    def policy(ctx, op, *args, **kwargs):
        out = T.dots_policy(ctx, op, *args, **kwargs)
        if out == CheckpointPolicy.MUST_SAVE and not ctx.is_recompute:
            kept.append(_rows_cols(tuple(ctx.op_output.shape)))
        return out

    contexts = functools.partial(create_selective_checkpoint_contexts,
                                 policy)
    y, aux = checkpoint(T._remat_block, bp, x, cfg, pos, 0, None, enc, True,
                        None, use_reentrant=False, context_fn=contexts)
    (y.sum() + (aux if aux is not None else 0)).backward()
    return sorted(kept)


@pytest.mark.parametrize("arch", ARCHS)
def test_kept_products_are_the_references(arch):
    """The router's ``x @ router_w`` and MLA's ``c_kv @ w_uk`` kept, the
    expert and attention einsums recomputed, K6 and K7 recomputed, an
    MLP's down projection (read by no backward) not kept, as in the
    reference."""
    want = _jax_kept(arch)
    assert want
    assert _port_kept(arch) == want


def test_dots_flops_are_full_less_the_kept_products(monkeypatch):
    """A cut ``tiny`` train cell on ``meta``: the recompute under
    ``dots`` skips exactly the kept products' forward FLOPs, and the
    kept outputs raise the predicted peak."""
    kept = []
    real = T.dots_policy

    def policy(ctx, op, *args, **kwargs):
        out = real(ctx, op, *args, **kwargs)
        if out == CheckpointPolicy.MUST_SAVE and not ctx.is_recompute:
            a, b = args[-2], args[-1]
            kept.append(2 * a.shape[0] * a.shape[1] * b.shape[1])
        return out

    monkeypatch.setattr(T, "dots_policy", policy)
    shape = ShapeConfig("train_128", 128, 8, "train")
    mesh = dryrun.mesh_config("2x2:data,model")
    counts = {}
    for name in ("full", "dots"):
        with T.remat_policy(name):
            fn, inputs, _ = dryrun.build_cell(get_config("tiny"), shape, mesh,
                                              dryrun.train_config())
            counts[name] = dryrun.trace(fn, inputs)
    assert kept
    assert counts["dots"]["flops"] == counts["full"]["flops"] - sum(kept)
    assert counts["dots"]["peak_bytes"] > counts["full"]["peak_bytes"]
    assert counts["dots"]["kernels"] == counts["full"]["kernels"]

"""bf16 serving of both packages side by side, for the port's bf16
parity tests (``test_torch_bf16_serve.py`` for the attention decoders,
``test_torch_bf16_serve_mixers.py`` for the SSM, hybrid, MoE + MLA and
enc-dec families).

``served`` builds the JAX package's bf16 weights, carries them over with
``params_from_jax`` and runs both packages' bf16 forward and prefill +
decode on the same token ids and the same bf16 frames and patches, with
the reference's own gap between its bf16 and f32 runs (its weights
widened exactly). ``check_forward``, ``check_steps`` and
``check_cell_counts`` are the assertions each test file parametrizes.
``gap_by_depth`` gives both packages' bf16-against-f32 gap of a full-width
config cut in depth; run as a script it prints them:

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/_torch_bf16.py \
        mamba2-370m 256 1 4 12 48
"""
import dataclasses
import functools
import sys

import jax
import jax.numpy as jnp
import numpy as np
import torch

import repro.models as JM
import repro.serve as JS
from repro.configs.registry import get_config as jax_config
from repro_torch._tree import tree_leaves
from repro_torch.configs.base import MeshConfig, ShapeConfig, TrainConfig
from repro_torch.configs.registry import get_config
from repro_torch.launch.dryrun import build_cell, trace
from repro_torch.models import forward, init_caches, params_from_jax
from repro_torch.serve import (decode_step, model_inputs, prefill_step,
                               step_inputs)

B, PROMPT, STEPS = 2, 32, 4
# the forward runs over whole 16-token chunks where the model scans
N_FWD = 48


def _jnp(d, dtype):
    """``step_inputs``' share as JAX arrays: floats in ``dtype``."""
    return {k: (jnp.asarray(v.float().numpy(), dtype) if v.is_floating_point()
                else jnp.asarray(v.numpy())) for k, v in d.items()}


@functools.lru_cache(maxsize=None)
def served(arch):
    """Both packages' bf16 runs of ``arch`` on the same weights and inputs,
    and the reference's bf16-against-f32 gap, as numpy: (g of the
    forward, g of the steps, JAX bf16 forward, port bf16 forward, JAX
    steps, port steps, port caches)."""
    jc, tc = jax_config(arch), get_config(arch)
    jp = JM.init_params(jc, jax.random.PRNGKey(0), dtype=jnp.bfloat16)
    jp32 = jax.tree.map(lambda x: x.astype(jnp.float32), jp)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    tok = np.random.default_rng(1).integers(
        0, jc.vocab_size, (B, N_FWD)).astype(np.int32)
    inp = {k: v.to(torch.bfloat16) if v.is_floating_point() else v
           for k, v in model_inputs(tc, B, PROMPT, N_FWD, seed=2,
                                    device="cpu").items()}
    n = PROMPT + STEPS

    def jax_fwd(params, dtype):
        out = JM.forward(params, jc, {"tokens": jnp.asarray(tok),
                                      **_jnp(step_inputs(inp, 0, N_FWD),
                                             dtype)})[0]
        return np.asarray(out.astype(jnp.float32))[:, :n]

    want16, want32 = jax_fwd(jp, jnp.bfloat16), jax_fwd(jp32, jnp.float32)
    got = forward(tp, tc, {"tokens": torch.from_numpy(tok),
                           **step_inputs(inp, 0, N_FWD)})[0]
    assert got.dtype == torch.bfloat16
    got = got.float().numpy()[:, :n]

    def steps(params, dtype, port):
        """Prefill of PROMPT tokens, then STEPS teacher-forced decode
        steps, on caches of ``dtype``: (B, 1 + STEPS, V) logits."""
        if port:
            caches = init_caches(tc, B, n, torch.bfloat16, device="cpu")
            lg, caches = prefill_step(
                params, tc, {"tokens": torch.from_numpy(tok[:, :PROMPT]),
                             **step_inputs(inp, 0, PROMPT)}, caches)
        else:
            caches = JM.init_caches(jc, B, n, dtype)
            lg, caches = JS.prefill_step(
                params, jc, {"tokens": jnp.asarray(tok[:, :PROMPT]),
                             **_jnp(step_inputs(inp, 0, PROMPT), dtype)},
                caches)
        out = [lg]
        for i in range(PROMPT, n):
            if port:
                lg, caches = decode_step(
                    params, tc, torch.from_numpy(tok[:, i:i + 1]), caches,
                    i, extra=step_inputs(inp, i, i + 1))
            else:
                lg, caches = JS.decode_step(
                    params, jc, jnp.asarray(tok[:, i:i + 1]), caches,
                    jnp.int32(i), extra=_jnp(step_inputs(inp, i, i + 1),
                                             dtype))
            out.append(lg)
        if port:
            return torch.cat(out, dim=1).float().numpy(), caches
        return np.asarray(jnp.concatenate(out, axis=1).astype(
            jnp.float32)), caches

    got_steps, caches = steps(tp, None, True)
    want_steps16, _ = steps(jp, jnp.bfloat16, False)
    want_steps32, _ = steps(jp32, jnp.float32, False)
    g_fwd = float(np.abs(want16 - want32).max())
    g_steps = float(np.abs(want_steps16 - want_steps32).max())
    return (g_fwd, g_steps, want16, got, want_steps16, got_steps, caches)


def check_forward(arch):
    """The port's bf16 forward within 2 g of the reference's."""
    g, _, want, got, _, _, _ = served(arch)
    assert g > 0 and np.isfinite(got).all()
    err = float(np.abs(got - want).max())
    assert err <= 2 * g, f"{arch}: bf16 forward off JAX's by {err}, 2 g = " \
                         f"{2 * g}"


def check_steps(arch):
    """The prefill's logits and each decode step's, on bf16 caches, held
    against the reference's steps in bf16; the caches stay bf16 (an SSM
    state f32, as the reference keeps it)."""
    _, g, _, _, want, got, caches = served(arch)
    assert g > 0 and np.isfinite(got).all()
    assert got.shape == want.shape == (B, 1 + STEPS, got.shape[-1])
    err = float(np.abs(got - want).max())
    assert err <= 2 * g, f"{arch}: bf16 steps off JAX's by {err}, 2 g = " \
                         f"{2 * g}"

    def dtypes(tree, key=""):
        if isinstance(tree, dict):
            return {d for k, v in tree.items() for d in dtypes(v, k)}
        return {(key, tree.dtype)}

    for key, dtype in dtypes(caches):
        want_dtype = {"pos": torch.int32, "ssm": torch.float32}.get(
            key, torch.bfloat16)
        assert dtype == want_dtype, (arch, key, dtype)


def check_cell_counts(arch, kind):
    """``build_cell`` in bf16 at a reduced length: the operation counter's
    FLOPs, bytes and kernel charges equal on ``meta`` and on the CPU (a
    decode cell over caches of seeded values at its last slot)."""
    cfg = get_config(arch)
    shape = ShapeConfig(f"{kind}_32", 32, 2, kind)
    mesh = MeshConfig((1,), ("data",))
    tcfg = TrainConfig(param_dtype="bfloat16")
    meta = trace(*build_cell(cfg, shape, mesh, tcfg)[:2])
    fn, inputs, _ = build_cell(cfg, shape, mesh, tcfg, device="cpu", seed=3)
    if kind == "decode":
        caches = inputs[2]
        leaves = [t for t in tree_leaves(caches) if t.is_floating_point()]
        assert leaves and all(bool(t.abs().sum() > 0) for t in leaves)
    cpu = trace(fn, inputs)
    for key in ("flops", "bytes", "kernels"):
        assert meta[key] == cpu[key], (arch, kind, key)
    assert meta["flops"] > 0
    logits = fn()[0]
    assert logits.dtype == torch.bfloat16
    assert bool(torch.isfinite(logits.float()).all())


def gap_by_depth(arch, layers, seq):
    """``arch`` at full width cut to ``layers`` layers, one sequence of
    ``seq`` tokens: the reference's bf16 weights widened exactly to f32,
    and the forward's logits in bf16 against f32 in each package, on the
    same weights and tokens: (the reference's gap, the port's gap, the
    reference's f32 logits' largest |value|)."""
    jc = dataclasses.replace(jax_config(arch), num_layers=layers)
    tc = dataclasses.replace(get_config(arch), num_layers=layers)
    jp = JM.init_params(jc, jax.random.PRNGKey(0), dtype=jnp.bfloat16)
    jp32 = jax.tree.map(lambda x: x.astype(jnp.float32), jp)
    tok = np.random.default_rng(1).integers(
        0, jc.vocab_size, (1, seq)).astype(np.int32)

    def jax_fwd(params):
        out = JM.forward(params, jc, {"tokens": jnp.asarray(tok)})[0]
        return np.asarray(out.astype(jnp.float32))

    def port_fwd(params):
        tp = params_from_jax(jax.tree.map(np.asarray, params), device="cpu")
        with torch.no_grad():
            out = forward(tp, tc, {"tokens": torch.from_numpy(tok)})[0]
        return out.float().numpy()

    j16, j32 = jax_fwd(jp), jax_fwd(jp32)
    p16, p32 = port_fwd(jp), port_fwd(jp32)
    return (float(np.abs(j16 - j32).max()), float(np.abs(p16 - p32).max()),
            float(np.abs(j32).max()))


if __name__ == "__main__":
    arch, seq = sys.argv[1], int(sys.argv[2])
    for n in map(int, sys.argv[3:]):
        ref, port, scale = gap_by_depth(arch, n, seq)
        print(f"{arch} layers={n} seq={seq} reference_gap={ref} "
              f"port_gap={port} logit_scale={scale} "
              f"reference_gap_over_scale={ref / scale}", flush=True)

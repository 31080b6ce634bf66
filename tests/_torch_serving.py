"""Both packages' serving steps side by side, for the port's parity tests
of the families that take inputs beside the tokens
(``test_torch_encdec.py``, ``test_torch_mrope.py``).

``pair`` builds the JAX package's weights and carries them over with
``params_from_jax``; ``greedy`` runs one package's greedy loop over
``prefill_step`` and ``decode_step(extra=)`` with each step's share of
``serve.inputs.model_inputs`` (the reference's ``greedy_generate`` feeds
tokens alone); ``step_fns`` gives each package's steps to it.
"""
import jax
import jax.numpy as jnp
import numpy as np
import torch

import repro.models as JM
import repro.serve as JS
from repro_torch.models import init_caches, params_from_jax
from repro_torch.serve import decode_step, prefill_step, step_inputs


def pair(jc, seed=0):
    """(JAX params of ``jc``, the same as the port's tensors on the CPU)."""
    jp = JM.init_params(jc, jax.random.PRNGKey(seed))
    return jp, params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")


def tokens(cfg, b, s, seed=0):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (b, s)).astype(np.int32)


def to_jnp(d):
    return {k: jnp.asarray(v.numpy() if isinstance(v, torch.Tensor) else v)
            for k, v in d.items()}


def shapes(tree):
    if isinstance(tree, dict):
        return {k: shapes(v) for k, v in tree.items()}
    return (tuple(tree.shape), str(tree.dtype).split(".")[-1])


def step_fns(jc, tc, jp, tp):
    """(JAX's, the port's) (init_caches, prefill, decode, argmax, array
    from numpy) for ``greedy``."""
    jax_fns = (lambda b, m: JM.init_caches(jc, b, m, jnp.float32),
               lambda batch, c: JS.prefill_step(jp, jc, batch, c),
               lambda tok, c, i, ex: JS.decode_step(
                   jp, jc, tok, c, jnp.int32(i), extra=ex),
               lambda lg: jnp.argmax(lg[:, -1], axis=-1)[:, None],
               jnp.asarray)
    torch_fns = (lambda b, m: init_caches(tc, b, m, torch.float32,
                                          device="cpu"),
                 lambda batch, c: prefill_step(tp, tc, batch, c),
                 lambda tok, c, i, ex: decode_step(tp, tc, tok, c, i,
                                                   extra=ex),
                 lambda lg: torch.argmax(lg[:, -1], dim=-1)[:, None],
                 torch.from_numpy)
    return jax_fns, torch_fns


def greedy(fns, prompt, inputs, max_new, max_seq):
    """(B, max_new) greedy tokens of ``prompt`` (numpy) through one
    package's ``fns``, each step given its share of ``inputs``."""
    init, prefill, decode, argmax, conv = fns

    def share(start, stop):
        return {k: conv(v.numpy())
                for k, v in step_inputs(inputs, start, stop).items()}

    b, s = prompt.shape
    lg, caches = prefill({"tokens": conv(prompt), **share(0, s)},
                         init(b, max_seq))
    tok = argmax(lg)
    out = [np.asarray(tok)]
    for i in range(s, s + max_new - 1):
        lg, caches = decode(tok, caches, i, share(i, i + 1))
        tok = argmax(lg)
        out.append(np.asarray(tok))
    return np.concatenate(out, axis=1)

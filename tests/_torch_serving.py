"""Both packages' serving steps side by side, for the port's parity tests
of the families that take inputs beside the tokens
(``test_torch_encdec.py``, ``test_torch_mrope.py``).

``pair`` builds the JAX package's weights and carries them over with
``params_from_jax``; ``greedy_jax`` and ``greedy_port`` run each
package's greedy loop over ``prefill_step`` and ``decode_step(extra=)``
with each step's share of ``serve.inputs.model_inputs`` (the reference's
``greedy_generate`` feeds tokens alone; the port's loop is
``serve.greedy_with_inputs``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import torch

import repro.models as JM
import repro.serve as JS
from repro_torch.models import params_from_jax
from repro_torch.serve import greedy_with_inputs, step_inputs


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


def greedy_jax(jc, jp, prompt, inputs, max_new, max_seq):
    """(B, max_new) greedy tokens of ``prompt`` (numpy) through the JAX
    package's ``prefill_step`` and ``decode_step(extra=)``, each step
    given its share of ``inputs`` (its ``greedy_generate`` feeds tokens
    alone, and it has no loop with inputs)."""
    def share(start, stop):
        return {k: jnp.asarray(v.numpy())
                for k, v in step_inputs(inputs, start, stop).items()}

    b, s = prompt.shape
    lg, caches = JS.prefill_step(
        jp, jc, {"tokens": jnp.asarray(prompt), **share(0, s)},
        JM.init_caches(jc, b, max_seq, jnp.float32))
    tok = jnp.argmax(lg[:, -1], axis=-1)[:, None]
    out = [np.asarray(tok)]
    for i in range(s, s + max_new - 1):
        lg, caches = JS.decode_step(jp, jc, tok, caches, jnp.int32(i),
                                    extra=share(i, i + 1))
        tok = jnp.argmax(lg[:, -1], axis=-1)[:, None]
        out.append(np.asarray(tok))
    return np.concatenate(out, axis=1)


def greedy_port(tc, tp, prompt, inputs, max_new, max_seq, **kv):
    """The same through the port's ``serve.greedy_with_inputs`` on the
    CPU (``kv``: its cache handoff arguments), as numpy."""
    return greedy_with_inputs(tp, tc, torch.from_numpy(prompt), inputs,
                              max_new, max_seq, **kv).numpy()

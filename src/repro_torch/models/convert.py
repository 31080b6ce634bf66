"""Parameters of the JAX package as the port's parameters.

``params_from_jax`` takes the reference's param pytree with numpy leaves
(``jax.tree.map(np.asarray, params)``; the layer dimension stacked first,
as ``repro/models/transformer.py:_stack_layers`` leaves it) and returns
the same nested dicts of tensors, which is the port's layout. So the port
computes exactly what the JAX package computes on the same weights, which
is how the tests hold one against the other. With ``tp_size`` over 1 the
tree carried over is then cut to rank ``tp_rank``'s share of the
``model`` axis (``sharding.shard_tree`` by ``sharding.model_specs``), so
that both packages compute from the same weights. Nothing here imports
JAX.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.models import sharding


def _leaf(x, device) -> torch.Tensor:
    arr = np.asarray(x)
    if arr.dtype.name == "bfloat16":          # ml_dtypes, unknown to torch
        return torch.from_numpy(arr.astype(np.float32)).to(
            device=device, dtype=torch.bfloat16)
    return torch.from_numpy(np.array(arr)).to(device)  # a writable copy


def params_from_jax(np_params, device=None, *, tp_rank: int = 0,
                    tp_size: int = 1):
    """Nested dicts of numpy arrays -> the same dicts of tensors on
    ``device`` (``None`` -> the GPU), dtypes kept; with ``tp_size`` over
    1, rank ``tp_rank``'s cut of them over the ``model`` axis."""
    dev = resolve_device(device)

    def conv(tree):
        if isinstance(tree, dict):
            return {k: conv(v) for k, v in tree.items()}
        return _leaf(tree, dev)

    params = conv(np_params)
    if tp_size > 1:
        params = sharding.shard_tree(
            params, sharding.model_specs(params, tp_size), tp_rank, tp_size)
    return params

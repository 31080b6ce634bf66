"""AdamW (decoupled weight decay) — hand-rolled, pure functions over
param pytrees (nested dicts of tensors), as ``repro/train/optimizer.py``.

Decay applies to matrices only; the bias corrections are computed in
f32 from the step, an int32 tensor on the params' device. The
reference's ZeRO-1 helpers (``zero1_leaf_spec``, ``zero1_specs``,
``constrain``) lay out optimizer state over a JAX mesh's data axis; they
wait for the multi-card port (``torch.distributed`` across cards), and
one card holds the whole state.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Tuple

import torch

from repro_torch._tree import tree_leaves, tree_map, tree_unflatten
from repro_torch.configs.base import TrainConfig


class AdamState(NamedTuple):
    step: torch.Tensor
    m: dict
    v: dict


def init_adam(params) -> AdamState:
    zeros = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                           device=p.device), params)
    device = tree_leaves(params)[0].device
    return AdamState(step=torch.zeros((), dtype=torch.int32, device=device),
                     m=zeros, v=tree_map(torch.clone, zeros))


def lr_schedule(tcfg: TrainConfig) -> Callable:
    def lr(step):
        step = step.to(torch.float32)
        warm = tcfg.learning_rate * (step + 1) / max(tcfg.warmup_steps, 1)
        total = max(tcfg.total_steps, 1)
        frac = torch.clamp((step - tcfg.warmup_steps)
                           / max(total - tcfg.warmup_steps, 1), 0.0, 1.0)
        cos = tcfg.learning_rate * 0.5 * (1 + torch.cos(torch.pi * frac))
        return torch.where(step < tcfg.warmup_steps, warm, cos)
    return lr


def global_norm(tree) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(x.to(torch.float32)))
                          for x in tree_leaves(tree)))


def clip_by_global_norm(grads, max_norm: float):
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / (norm + 1e-9), max=1.0)
    return tree_map(lambda g: (g * scale).to(g.dtype), grads), norm


def adamw_update(grads, state: AdamState, params,
                 tcfg: TrainConfig) -> Tuple[dict, AdamState]:
    step = state.step + 1
    lr = lr_schedule(tcfg)(step)
    b1, b2, eps = tcfg.beta1, tcfg.beta2, tcfg.eps
    bc1 = 1 - b1 ** step.to(torch.float32)
    bc2 = 1 - b2 ** step.to(torch.float32)

    def upd(g, m, v, p):
        g32 = g.to(torch.float32)
        m_new = b1 * m + (1 - b1) * g32
        v_new = b2 * v + (1 - b2) * g32 * g32
        update = (m_new / bc1) / (torch.sqrt(v_new / bc2) + eps)
        if p.ndim >= 2:  # decoupled decay on matrices only
            update = update + tcfg.weight_decay * p.to(torch.float32)
        return (p.to(torch.float32) - lr * update).to(p.dtype), m_new, v_new

    out = [upd(g, m, v, p) for g, m, v, p in zip(
        tree_leaves(grads), tree_leaves(state.m), tree_leaves(state.v),
        tree_leaves(params))]
    new_p = tree_unflatten(params, [o[0] for o in out])
    new_m = tree_unflatten(params, [o[1] for o in out])
    new_v = tree_unflatten(params, [o[2] for o in out])
    return new_p, AdamState(step, new_m, new_v)

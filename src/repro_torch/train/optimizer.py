"""AdamW (decoupled weight decay) — hand-rolled, pure functions over
param pytrees (nested dicts of tensors), as ``repro/train/optimizer.py``.

Decay applies to matrices only; the bias corrections are computed in
f32 from the step, an int32 tensor on the params' device.

ZeRO-1 (``zero1_leaf_spec``, ``zero1_specs``) lays the optimizer state
out over the data-parallel ranks of a mesh: each leaf is cut along its
largest free dimension that the data-parallel size divides, and each
rank keeps one cut. The reference's ``constrain`` (sharding constraints
that XLA lowers to a slice and an all-gather) becomes the pair those
lower to: ``zero1_shard`` takes this rank's cut of each leaf, and
``zero1_gather`` all-gathers the cuts back into whole leaves.
``zero1_init`` cuts whole optimizer state once, when a ZeRO-1 run
starts; the ZeRO-1 step takes and returns the cut form only.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Tuple

import torch
import torch.distributed as dist

from repro_torch._tree import tree_leaves, tree_map, tree_unflatten
from repro_torch.configs.base import TrainConfig
from repro_torch.launch.mesh import PlanGroup, dp_axes, dp_rank, dp_size
from repro_torch.models.sharding import param_specs


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


# ---------------------------------------------------------------------------
# ZeRO-1 sharding of optimizer state
# ---------------------------------------------------------------------------

def zero1_leaf_spec(spec: tuple, shape: tuple, dp_axes: tuple,
                    dp_size: int) -> tuple:
    """Add dp sharding on the largest divisible unsharded axis."""
    if dp_size <= 1 or not shape:
        return spec
    entries = list(spec) + [None] * (len(shape) - len(spec))
    best, best_dim = -1, -1
    for i, (e, dim) in enumerate(zip(entries, shape)):
        if e is None and dim % dp_size == 0 and dim > best_dim:
            best, best_dim = i, dim
    if best < 0:
        return spec
    entries[best] = dp_axes if len(dp_axes) > 1 else dp_axes[0]
    return tuple(entries)


def zero1_specs(params, p_specs, dp_axes: tuple, dp_size: int):
    """Optimizer-state specs = param specs + dp shard (ZeRO-1)."""
    return tree_map(
        lambda p, s: zero1_leaf_spec(s, tuple(p.shape), dp_axes, dp_size),
        params, p_specs)


def _shard_dim(spec: tuple, dp_axes: tuple) -> Optional[int]:
    """The dimension a ZeRO-1 spec cuts over ``dp_axes`` (None: whole)."""
    entry = dp_axes if len(dp_axes) > 1 else dp_axes[0]
    return spec.index(entry) if entry in spec else None


def zero1_shard(tree, specs, dp_axes: tuple, index: int, size: int):
    """Data-parallel rank ``index``'s cut of each whole leaf of ``tree``:
    one of ``size`` equal cuts along the dimension its spec shards (a
    leaf its spec leaves whole is kept whole)."""
    def cut(x, spec):
        d = _shard_dim(spec, dp_axes)
        if d is None or size == 1:
            return x
        n = x.shape[d] // size
        return x.narrow(d, index * n, n).contiguous()
    return tree_map(cut, tree, specs)


def zero1_init(opt: AdamState, mesh) -> AdamState:
    """This rank's ZeRO-1 cut of whole optimizer state (``init_adam``'s,
    or a step's without ZeRO-1): ``m`` and ``v`` cut as ``zero1_specs``
    lays them over the data-parallel ranks of ``mesh``."""
    axes, size = dp_axes(mesh), dp_size(mesh)
    specs = zero1_specs(opt.m, param_specs(opt.m), axes, size)
    index = dp_rank(mesh)
    return AdamState(opt.step, zero1_shard(opt.m, specs, axes, index, size),
                     zero1_shard(opt.v, specs, axes, index, size))


def zero1_gather(tree, specs, dp_axes: tuple, group):
    """Whole leaves from each rank's cut: every cut is ``broadcast`` by
    its owner in ``group`` (rank order = cut order) and set in place.
    A broadcast is a byte copy (a summed zero padding would turn
    ``-0.0`` into ``+0.0``) and gloo takes CUDA tensors for it. On a
    ``PlanGroup`` (the dry-run's) this rank is its rank 0 and the
    broadcasts of a leaf are recorded as one all-gather of its cut."""
    plan = isinstance(group, PlanGroup)
    size = group.size if plan else dist.get_world_size(group)
    me = 0 if plan else dist.get_rank(group)
    ranks = None if plan else [dist.get_global_rank(group, r)
                               for r in range(size)]

    def gather(x, spec):
        d = _shard_dim(spec, dp_axes)
        if d is None or size == 1:
            return x
        if plan:
            group.record("all-gather", x)
        cuts = []
        for r in range(size):
            c = x if r == me else torch.empty_like(x)
            if not plan:
                dist.broadcast(c, src=ranks[r], group=group)
            cuts.append(c)
        return torch.cat(cuts, dim=d)
    return tree_map(gather, tree, specs)

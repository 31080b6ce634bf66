"""Mixture-of-Experts FFN with capacity-based top-k routing.

The port of ``repro/models/moe.py``. Routing: router logits in f32,
softmax, top-k (descending, as ``lax.top_k``) with the gates
renormalised, per-expert capacity ``C = max(int(k*T/E *
capacity_factor), k)``; a token's assignments past an expert's capacity
are dropped (its residual passes through), the Switch/GShard policy. A
Switch-style load-balancing aux loss is returned for the trainer.

Token -> slot assignment is sort arithmetic (a stable argsort by expert
and ``searchsorted`` for each expert's segment start), dispatch is a
gather into ``(E, C, d)`` expert buffers, the experts are stacked
``(E, d_in, d_out)`` SwiGLU products (``torch.einsum``, batched over E,
as the reference leaves them to XLA outside Pallas), and the combine is
a gate-weighted gather and sum.

Given a ``sharding.TensorParallel`` (``tp=``) the FFN is one rank's share
of the reference's expert parallelism over the ``model`` axis: the rank
holds ``E / n`` experts (``(E / n, d_in, d_out)`` stacks, the
reference's ``experts/*`` spec) and its column and row cuts of the
shared experts. It gathers the residual's rows first (``layers._tp_in``),
so that ``route``, ``_capacity`` and ``_dispatch_indices`` see the same
``T`` tokens in the same order as the unsharded call, dispatches only to
its own experts' ``(E / n, C, d)`` buffers, and reduces its partial sum
(its experts' combine plus its shared-expert columns) into the
residual's layout (``layers._tp_out``). Where the axis does not divide
the experts (or the shared experts' width) they are whole on every
rank, which combines its share of the ``T`` tokens, a partial sum
reduced in the same way. The router and the aux loss are
computed alike on every rank; the aux term's gradient goes through
``TensorParallel.once``, and the router's gradient, the combine's gates
of the rank's experts, is summed over the group by the train step
(``sharding.partial_grad_leaf``).

Within ``global_routing(group)`` (``train.make_train_step`` on a mesh,
over its data-parallel group) a rank routes its rows as the reference's
pjit step routes the global batch, data rank r's rows after ranks
0..r-1's: the ranks exchange their per-expert assignment counts (one
all-gather of E counts, no tokens), an assignment's position in its
expert is the earlier ranks' count plus its own position, the capacity
is ``_capacity(T_global)``, and the aux loss takes the global ``me`` (a
mean over the group that carries its gradient) and ``ce``. A rank still
runs only its own kept assignments, in buffers of ``min(C(T_global),
T)`` slots an expert: the most it can keep of one expert, since a token
takes an expert once (the reference's device holds ``C(T_global)``
slots of each of its experts). On a ``launch.mesh.PlanGroup`` (the
dry-run's) the other ranks' counts are stand-ins, copies of this
rank's, and the share is data rank 0, with no rank before it.
"""
from __future__ import annotations

import contextlib
from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.launch import mesh as _mesh
from repro_torch.models.layers import (_tp_in, _tp_out, init_dense, init_mlp,
                                       mlp_block)
from repro_torch.models.sharding import active

#: the data-parallel group ``moe_ffn`` routes over (``global_routing``)
_DATA = None


@contextlib.contextmanager
def global_routing(group):
    """Within the block, ``moe_ffn`` routes each rank's rows as a part of
    the global batch of the data-parallel ``group`` (None, or a group of
    one rank: its own rows alone); restored after."""
    global _DATA
    before = _DATA
    _DATA = (group if group is not None and _mesh.group_size(group) > 1
             else None)
    try:
        yield
    finally:
        _DATA = before


class _MeanOver(torch.autograd.Function):
    """The mean of ``x`` over the ranks of ``group``; the gradient the
    mean over the group too, so that the data step's mean of the ranks'
    gradients carries each rank's part of a term every rank adds
    alike."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        n = _mesh.group_size(group)
        return _mesh.all_reduce(x.detach().clone(), group) / n

    @staticmethod
    def backward(ctx, g):
        n = _mesh.group_size(ctx.group)
        return _mesh.all_reduce(g.detach().clone(), ctx.group) / n, None


def init_moe(gen: torch.Generator, cfg: ModelConfig, dtype, device,
             layers) -> dict:
    """Stacked ``(layers, ...)`` MoE params of ``cfg``: the router (f32
    whatever ``dtype``, as in the reference), the ``(layers, E, d_in,
    d_out)`` expert stacks and, with shared experts, their MLP."""
    m, d = cfg.moe, cfg.d_model
    lead = () if layers is None else (layers,)

    def expert_stack(d_in, d_out):
        return init_dense(gen, d_in, d_out, dtype, device,
                          layers=(*lead, m.num_experts))

    p = {
        "router": init_dense(gen, d, m.num_experts, torch.float32, device,
                             layers=layers),
        "experts": {
            "w_gate": expert_stack(d, m.expert_d_ff),
            "w_up": expert_stack(d, m.expert_d_ff),
            "w_down": expert_stack(m.expert_d_ff, d),
        },
    }
    if m.num_shared_experts:
        p["shared"] = init_mlp(gen, d, m.shared_d_ff, dtype, device, layers)
    return p


def _capacity(tokens: int, cfg: ModelConfig) -> int:
    m = cfg.moe
    c = int(m.top_k * tokens / m.num_experts * m.capacity_factor)
    return max(c, m.top_k)


def route(router_w: torch.Tensor, x2d: torch.Tensor, cfg: ModelConfig):
    """x2d: (T, d). Returns (expert_idx (T, k) int64, gate_w (T, k),
    aux_loss)."""
    m = cfg.moe
    logits = x2d.to(torch.float32) @ router_w           # (T, E)
    probs = torch.softmax(logits, dim=-1)
    gate_w, expert_idx = torch.topk(probs, m.top_k, dim=-1, sorted=True)
    gate_w = gate_w / torch.sum(gate_w, dim=-1, keepdim=True)
    # Switch-style aux loss: E * sum_e f_e * P_e. The count adds exact
    # 1.0s, so its order does not matter; unlike ``torch.bincount`` it
    # does not wait for the device to size its output.
    me = torch.mean(probs, dim=0)                       # (E,)
    flat = expert_idx.reshape(-1)
    ce = torch.zeros((m.num_experts,), dtype=torch.float32,
                     device=x2d.device).index_add_(
        0, flat, torch.ones(flat.shape, dtype=torch.float32,
                            device=x2d.device)) / (x2d.shape[0] * m.top_k)
    aux = m.num_experts * torch.sum(me * ce)
    return expert_idx, gate_w, aux


def _dispatch_indices(expert_idx: torch.Tensor, k: int, e: int, cap: int):
    """Slot assignment. expert_idx: (T, k).

    Returns (slot_pos (T, k), keep (T, k)): each assignment's position
    within its expert's capacity buffer, in token order, and whether it
    fits."""
    t = expert_idx.shape[0]
    dev = expert_idx.device
    flat_e = expert_idx.reshape(-1)                     # (T*k,)
    # stable sort by expert; position within expert via index arithmetic
    order = torch.argsort(flat_e, stable=True)          # (T*k,)
    sorted_e = flat_e[order]
    seg_starts = torch.searchsorted(
        sorted_e, torch.arange(e, dtype=sorted_e.dtype, device=dev))
    pos_sorted = torch.arange(t * k, device=dev) - seg_starts[sorted_e]
    pos = torch.empty((t * k,), dtype=torch.int32, device=dev)
    pos[order] = pos_sorted.to(torch.int32)
    keep = pos < cap
    return pos.reshape(t, k), keep.reshape(t, k)


def moe_ffn(params: dict, cfg: ModelConfig, x: torch.Tensor, tp=None
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, d) -> (out, aux_loss). With ``tp``, one rank's share:
    ``x`` in the residual's layout (a rank's rows under sequence
    parallelism), ``params`` the rank's cut, the output in ``x``'s
    layout and the aux loss whole on every rank. Experts that do not
    divide the axis are whole: every rank runs all E on their capacity
    buffers of all T tokens, routed as the unsharded call routes them,
    and combines its share of the tokens (``tp.share``); so do whole
    shared experts."""
    m = cfg.moe
    sharded = active(tp)
    if sharded:
        x = _tp_in(x, tp)
    b, s, d = x.shape
    t = b * s
    e = m.num_experts
    we = params["experts"]
    e_l = we["w_gate"].shape[0]                         # this rank's experts
    # experts the axis does not divide: all E on every rank, each
    # combining its share of the tokens only
    whole = sharded and e_l == e
    x2d = x.reshape(t, d)
    cap = _capacity(t, cfg)

    expert_idx, gate_w, aux = route(params["router"], x2d, cfg)
    pos, keep = _dispatch_indices(expert_idx, m.top_k, e, cap)
    slots = cap                                         # an expert's buffer
    if _DATA is not None:
        slots, keep, aux = _global_routing(params["router"], x2d, cfg,
                                           expert_idx, pos, _DATA)

    # flat slot id per assignment; dropped ones park on a dummy slot
    slot = torch.where(keep, expert_idx * slots + pos,
                       torch.full_like(expert_idx, e * slots))  # (T, k)
    flat_slot = slot.reshape(-1)

    # dispatch: scatter token ids into slots, then gather tokens. Every
    # kept assignment has a slot of its own; the dropped ones all write
    # the dummy slot, in an order that is unspecified on CUDA (and in the
    # reference), which is harmless only because that slot is cut off
    # right after.
    token_of_slot = torch.full((e * slots + 1,), t, dtype=torch.int64,
                               device=x.device)
    token_of_slot[flat_slot] = torch.arange(
        t, device=x.device).repeat_interleave(m.top_k)
    n_slots = e_l * slots
    lo = tp.rank * n_slots if sharded and not whole else 0
    # this rank's experts' slots (the dummy dropped); ``index_select``,
    # whose backward adds into the rows in parallel, where the backward
    # of indexing accumulates an index's duplicates (the empty slots'
    # padding row) one after another
    token_of_slot = token_of_slot[lo:lo + n_slots]
    x_pad = torch.cat([x2d, x2d.new_zeros((1, d))], dim=0)
    xe = x_pad.index_select(0, token_of_slot).reshape(e_l, slots, d)
    del x_pad

    # expert computation (per-expert SwiGLU)
    h = F.silu(torch.einsum("ecd,edf->ecf", xe, we["w_gate"]))
    h = h * torch.einsum("ecd,edf->ecf", xe, we["w_up"])
    ye = torch.einsum("ecf,efd->ecd", h, we["w_down"])
    del xe, h

    # combine: each of the rank's slots adds its expert's output times its
    # assignment's gate into its token's row, in f32 (the reference
    # gathers every token's k slots; under ``tp`` that gather would point
    # the other ranks' (n - 1) / n of them at one zero row, whose
    # gradient is accumulated one assignment at a time)
    if whole:
        t_lo, t_hi = tp.share(t)
        tok = torch.arange(t, device=x.device)[:, None]
        keep = keep & (tok >= t_lo) & (tok < t_hi)
    w = torch.where(keep, gate_w, torch.zeros_like(gate_w))
    local = flat_slot - lo
    mine = (local >= 0) & (local < n_slots)
    gate_of_slot = w.new_zeros(n_slots + 1).index_put(
        (torch.where(mine, local, torch.full_like(local, n_slots)),),
        w.reshape(-1))[:n_slots]
    out = torch.zeros((t + 1, d), dtype=torch.float32,
                      device=x.device).index_add(
        0, token_of_slot,
        ye.reshape(n_slots, d).float() * gate_of_slot[:, None])
    out = out[:t].to(ye.dtype)

    if "shared" in params:
        # with ``tp`` the rank's columns of the shared experts: a partial
        # sum too, reduced with the experts'; where their width does not
        # divide the axis, all of them on the rank's share of the tokens
        if sharded and not tp.divides(m.shared_d_ff):
            s_lo, s_hi = tp.share(t)
            out = out + F.pad(mlp_block(params["shared"], x2d[s_lo:s_hi]),
                              (0, 0, s_lo, t - s_hi))
        else:
            out = out + mlp_block(params["shared"], x2d)
    out = out.reshape(b, s, d)
    if sharded:
        return _tp_out(out, tp), tp.once(aux)
    return out, aux


def _global_routing(router_w, x2d, cfg: ModelConfig, expert_idx, pos,
                    group):
    """This rank's routing as a part of the global batch of ``group``
    (``global_routing``): (the buffer slots an expert, which assignments
    are kept, the global aux loss). ``pos`` is each assignment's position
    among this rank's own, the same order the global one takes after the
    earlier ranks' assignments."""
    m = cfg.moe
    t, e = x2d.shape[0], m.num_experts
    n, r = _mesh.group_size(group), _mesh.group_rank(group)
    flat = expert_idx.reshape(-1)
    counts = torch.zeros((e,), dtype=torch.int64,
                         device=x2d.device).index_add_(
        0, flat, torch.ones_like(flat))
    every = _mesh.all_gather(counts, group, 0).reshape(n, e)
    cap = _capacity(t * n, cfg)
    keep = (every[:r].sum(0)[expert_idx] + pos) < cap
    # the aux loss of the global batch: its mean router probabilities
    # (this rank's mean, averaged over the group with its gradient) and
    # its assignment fractions
    probs = torch.softmax(x2d.to(torch.float32) @ router_w, dim=-1)
    me = _MeanOver.apply(torch.mean(probs, dim=0), group)
    ce = every.sum(0).to(torch.float32) / (t * n * m.top_k)
    return min(cap, t), keep, e * torch.sum(me * ce)

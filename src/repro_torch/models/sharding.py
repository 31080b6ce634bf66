"""Sharding rules: logical roles -> per-dimension mesh axis names.

The port of ``repro/models/sharding.py``'s parameter rules, as pure
functions: a spec is a tuple with one entry per dimension, ``None`` for
a replicated dimension, an axis name, or a tuple of axis names (the
entries of the reference's ``PartitionSpec``). Specs are derived from
leaf *paths* by role rules (Megatron-style TP):

  column-parallel (out dim on 'model'):  wq wk wv w_gate w_up lm_head
                                         w_uk w_uv w_qa w_qb in_proj
                                         conv_w embed(d dim)
  row-parallel    (in dim on 'model'):   wo w_down out_proj
  expert-parallel (E dim on 'model'):    experts/* 3-D weights
  replicated:                            norms, scalars, small biases

A rank of a mesh with a ``model`` axis holds the cut of each leaf that
these specs give after ``launch.specs.sanitize_specs`` (``shard_tree``;
``gather_tree`` puts a tree of cuts back together), and ZeRO-1
(``train.optimizer``) reads the same specs to find each leaf's free
dimension for the data-parallel shard.

The reference's activation rules are XLA layout hints (``shard``,
``shard_residual``, ``shard_attention_qkv``, ``shard_attention_out``):
the port computes the same function with explicit collectives over the
rank's ``model`` group instead, through ``TensorParallel``:

* the residual stream is replicated or, under sequence parallelism
  (``TrainConfig.sequence_parallel``, when the sequence divides the
  axis), cut by sequence; a block gathers it before its column-parallel
  projections and reduce-scatters its row-parallel output (Megatron-SP),
  or takes a replicated input and all-reduces its output;
* attention is head-parallel when ``attention_seq_mode`` says the heads
  divide the axis; otherwise each rank takes its rows of q (an
  all-to-all of the column-parallel projection) against k and v gathered
  whole, and an all-to-all turns the output back to columns for the
  row-parallel o-projection; over a sequence that does not divide the
  axis (decode) every rank attends with every head and keeps its
  columns; with ``qkv_sharding`` off (the reference's baseline) each
  rank scores its cut of every head's head dim and the scores are
  summed over the group (``attention_mode``);
* the embedding is vocab-parallel (a masked local gather, then a
  reduce), the LM head column-parallel, and ``cross_entropy`` reduces
  the max, the sum of exps and the picked logit over the group, never
  forming the whole vocab on a rank (but where the padded vocab does
  not divide the axis, below);
* MoE is expert-parallel (``models.moe.moe_ffn``): every rank routes
  all the tokens of the gathered input, as the unsharded call does, runs
  only its ``E / n`` experts on their capacity buffers, and the partial
  sums over its experts (and its columns of the shared experts) are
  reduced into the residual's layout; the aux loss, the same on every
  rank, sends its gradient through ``once``;
* MLA (``models.layers.mla_block``): ``wq``, ``w_uk``, ``w_uv`` and
  ``w_kr`` column-cut, ``w_dkv`` and ``kv_norm_scale`` whole, the rope
  key gathered whole before it turns; head-parallel where its heads
  divide the axis, else by attention's other modes (the rank's rows of
  q against K and V gathered whole); its cache is cut on the latent's
  and the rope key's feature dims, and decode scores the cut where it
  lies;
* the Mamba-2 mixer (``models.ssm.ssm_block``): the rank's columns of
  ``in_proj`` (or the whole leaf, where its width does not divide the
  axis) and of the conv are gathered whole; the scan is head-parallel
  when the heads divide the axis (every head on every rank otherwise),
  the gate norm's sum of squares reduced over the group, ``out_proj``
  row-cut; the conv cache is cut on its channels and the state on its
  head dim, and decode updates the state's cut where it lies;
* hybrid heads run both mixers on their cuts, each output reduced before
  its own norm; the enc-dec encoder is the same blocks over its own
  residual, and the cross-attention reads the encoder's output gathered
  whole once, with ``wq``, ``wk``, ``wv`` column-cut and ``wo`` row-cut.

A leaf whose width does not divide the axis (``sanitize_specs`` drops
its ``model`` entry, as the reference's lowering replicates it:
``whole_leaves``) is held whole by every rank, with the same math as
the unsharded model: a block computes that leaf's product on the layout
it needs and hands its output on in the layout its next op expects.
Attention's ``wq``/``wo`` and ``wk``/``wv`` (and MLA's projections)
whole project the rank's rows of q, or every row, beside cut ones, and a
whole o-projection takes the rank's rows of the attention output (its
share of every row where the sequence does not divide the axis) into
the residual's layout (``layers._tp_o_proj``); a whole MLP runs on the
residual's layout with no collective; whole experts run on every rank,
each combining its share of the tokens; a whole vocab is embedded and
projected on the residual's rows and the logits formed whole.

Every family is cut (``model_axis_sharded``). The leaves that the axis
leaves whole but whose gradient a rank computes from its share
(``partial_grad_leaf``) are summed over the group after the backward.
"""
from __future__ import annotations

import contextlib
import copy
import functools
from collections import Counter

import torch

from repro_torch.launch import mesh as _mesh

# leaf-name -> rule
_COLUMN = {"wq", "wk", "wv", "w_gate", "w_up", "lm_head", "w_uk", "w_uv",
           "w_qa", "w_qb", "w_kr", "in_proj", "conv_w", "b_q", "b_k", "b_v",
           "b_in"}
_ROW = {"wo", "w_down", "out_proj"}
_EMBED = {"embed", "pos_embed"}
_REPLICATED_SUFFIX = {"scale", "bias", "a_log", "d_skip", "dt_bias", "b_o",
                      "b_down", "router", "w_dkv", "norm"}


def spec_for_leaf(path: str, ndim: int, scanned: bool) -> tuple:
    """The spec of a parameter leaf. ``scanned`` leaves carry a leading
    layer dim (always unsharded)."""
    name = path.split("/")[-1].lower()
    body = _body_spec(path, name, ndim - (1 if scanned else 0))
    if scanned:
        return (None,) + body
    return body


def _body_spec(path: str, name: str, ndim: int) -> tuple:
    if "experts" in path and ndim == 3:
        # (E, d_in, d_out): expert-parallel over 'model'
        return ("model", None, None)
    if name in _EMBED:
        # (vocab, d): vocab-parallel; the (tied) LM head stays
        # column-parallel.
        return ("model", None)
    if name in _ROW:
        return ("model",) + (None,) * (ndim - 1)
    if name in _COLUMN:
        if ndim == 1:                    # column bias
            return ("model",)
        return (None,) * (ndim - 1) + ("model",)
    return (None,) * ndim                # norms, scalars: replicated


def param_specs(params, scanned_prefixes=("layers", "enc_layers",
                                          "dec_layers")) -> dict:
    """The full spec tree of a param tree (nested dicts of tensors)."""
    out = {}
    for path, leaf in _leaf_paths(params, ""):
        scanned = any(path.startswith(p + "/") or f"/{p}/" in path
                      for p in scanned_prefixes)
        _set(out, path.split("/"), spec_for_leaf(path, leaf.ndim, scanned))
    return out


def _leaf_paths(tree, prefix: str):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaf_paths(tree[k], f"{prefix}/{k}" if prefix
                                   else str(k))
    else:
        yield prefix, tree


def _set(d: dict, keys, val):
    for k in keys[:-1]:
        d = d.setdefault(k, {})
    d[keys[-1]] = val


def _map(fn, tree, specs):
    if isinstance(tree, dict):
        return {k: _map(fn, tree[k], specs[k]) for k in tree}
    return fn(tree, specs)


def model_dims(spec: tuple) -> list:
    """The dimensions a spec cuts over ``model``."""
    return [i for i, e in enumerate(spec) if e == "model"]


def model_specs(tree, tp: int) -> dict:
    """Each leaf's spec from ``param_specs`` after ``sanitize_specs`` over
    a ``model`` axis of ``tp``: the dims a rank's cut takes ``1 / tp``
    of (a non-divisible dim stays whole, as the reference's does)."""
    from repro_torch.configs.base import MeshConfig
    from repro_torch.launch.specs import sanitize_specs
    return sanitize_specs(param_specs(tree), tree,
                          MeshConfig((tp,), ("model",)))


def cut_shape(shape, spec: tuple, tp: int) -> tuple:
    """The shape of a rank's cut of a leaf of ``shape``."""
    out = list(shape)
    for d in model_dims(spec):
        out[d] //= tp
    return tuple(out)


def cut_views(tree, specs, rank: int, tp: int) -> dict:
    """Rank ``rank`` of ``tp``'s cut of each whole leaf of ``tree`` along
    the dims its spec cuts over ``model``, as views (no copy)."""
    def cut(x, spec):
        for d in model_dims(spec):
            n = x.shape[d] // tp
            x = x.narrow(d, rank * n, n)
        return x
    return _map(cut, tree, specs)


def shard_tree(tree, specs, rank: int, tp: int) -> dict:
    """``cut_views``' cut as new tensors (a leaf its spec leaves whole is
    copied whole)."""
    return _map(lambda x, _: x.clone(),
                cut_views(tree, specs, rank, tp), specs)


def gather_tree(cuts, specs, tp: int) -> dict:
    """Whole leaves from the ``tp`` ranks' cuts (a list of trees in rank
    order), concatenated along the dims their specs cut."""
    def join(spec, parts):
        dims = model_dims(spec)
        if not dims:
            return parts[0]
        return torch.cat(parts, dim=dims[0])

    def walk(spec, parts):
        if isinstance(spec, dict):
            return {k: walk(spec[k], [p[k] for p in parts]) for k in spec}
        return join(spec, parts)
    return walk(specs, list(cuts))


def attention_seq_mode(hq: int, hkv: int, tp: int) -> bool:
    """True when attention runs sequence-parallel: the heads do not both
    divide the ``model`` axis (the reference's rule)."""
    return tp > 1 and not (hq % tp == 0 and hkv % tp == 0)


# The reference's lowering knob (``repro/models/sharding.py``): with it off
# (``--no-qkv-shard``, the paper-faithful baseline) no layout pins q, k
# and v, and where the heads do not divide the axis XLA cuts the QK and
# AV contraction, the head dim, all-reducing the whole score tensor.
_QKV_SHARD = True


def set_qkv_sharding(on: bool) -> None:
    global _QKV_SHARD
    _QKV_SHARD = on


def qkv_sharding_enabled() -> bool:
    return _QKV_SHARD


@contextlib.contextmanager
def qkv_sharding(on: bool):
    """``set_qkv_sharding(on)`` inside the ``with`` block; the setting
    found on entry is restored on exit, also when the block raises."""
    before = _QKV_SHARD
    set_qkv_sharding(on)
    try:
        yield
    finally:
        set_qkv_sharding(before)


def attention_mode(hq: int, hkv: int, sq: int, d: int, dv: int,
                   tp: int) -> str:
    """How a rank of a ``model`` axis of ``tp`` attends with ``hq`` q
    and ``hkv`` kv heads of q/k dim ``d`` and v dim ``dv`` over ``sq``
    query rows: "heads" where the heads divide the axis; otherwise, with
    ``qkv_sharding`` off, "hd" (every head, the head dims cut over the
    ranks, the scores summed) where ``d`` and ``dv`` divide it; else
    "rows" (the rank's rows of q, every head) where ``sq`` divides it,
    or "replicated" (every row and head)."""
    if not attention_seq_mode(hq, hkv, tp):
        return "heads"
    if not _QKV_SHARD and d % tp == 0 and dv % tp == 0:
        return "hd"
    return "rows" if sq % tp == 0 else "replicated"


# ---------------------------------------------------------------------------
# Tensor parallelism: explicit collectives over the model group
# ---------------------------------------------------------------------------

class TensorParallel:
    """This rank's place on a ``model`` axis: its ``group`` (a process
    group or a ``launch.mesh.PlanGroup``), ``size`` and ``rank``, and
    whether the residual stream is cut by sequence
    (``sequence_parallel``). ``issued`` counts the collectives sent, by
    the reference's op names."""

    def __init__(self, group, sequence_parallel: bool = True):
        self.group = group
        self.size = _mesh.group_size(group)
        self.rank = _mesh.group_rank(group)
        self.sequence_parallel = sequence_parallel
        self.issued: Counter = Counter()

    #: whether this forward's residual is cut by sequence (``for_seq``)
    seq_cut = False

    def for_seq(self, seq: int) -> "TensorParallel":
        """This context for a forward over ``seq`` tokens: the residual
        is cut by sequence under ``sequence_parallel`` when ``seq``
        divides the axis (a decode step's one token does not), as the
        reference's ``shard`` drops a spec that does not divide."""
        out = copy.copy(self)
        out.seq_cut = self.sequence_parallel and seq % self.size == 0
        return out

    # -- the differentiable collectives (Megatron's f, g and SP pairs) --
    def copy(self, x):
        """Identity forward; the gradient summed over the group."""
        return _Copy.apply(x, self)

    def reduce(self, x):
        """Summed over the group; the gradient passed through."""
        return _Reduce.apply(x, self)

    def gather(self, x, dim: int):
        """All-gathered along ``dim``; the gradient reduce-scattered."""
        return _Gather.apply(x, self, dim)

    def scatter(self, x, dim: int):
        """Reduce-scattered along ``dim``; the gradient all-gathered."""
        return _Scatter.apply(x, self, dim)

    def all_to_all(self, x, split_dim: int, cat_dim: int):
        """``split_dim`` cut over the ranks, ``cat_dim`` joined; the
        gradient goes back the other way."""
        return _AllToAll.apply(x, self, split_dim, cat_dim)

    # -- the plain ones --
    def all_reduce(self, x, op: str = "sum"):
        self.issued["all-reduce"] += 1
        return _mesh.all_reduce(x, self.group, op)

    def all_gather(self, x, dim: int):
        self.issued["all-gather"] += 1
        return _mesh.all_gather(x, self.group, dim)

    def reduce_scatter(self, x, dim: int):
        self.issued["reduce-scatter"] += 1
        return _mesh.reduce_scatter(x, self.group, dim)

    def all_to_all_plain(self, x, split_dim: int, cat_dim: int):
        self.issued["all-to-all"] += 1
        return _mesh.all_to_all(x, self.group, split_dim, cat_dim)

    def once(self, x):
        """A value every rank computes alike from whole inputs: identity
        forward, the gradient divided by the group's size, so that the
        sums over the group that a rank's share of the backward meets
        (of a whole leaf's gradient, or of the gathered input's) count
        it once."""
        return _Once.apply(x, self)

    def join(self, x, dim: int):
        """All-gathered along ``dim`` into a tensor every rank then uses
        alike (its gradient whole on every rank); the gradient is this
        rank's cut of it, with no collective."""
        return _Join.apply(x, self, dim)

    def cut(self, x, dim: int):
        """This rank's cut of ``x`` along ``dim`` (a view)."""
        n = x.shape[dim] // self.size
        return x.narrow(dim, self.rank * n, n)

    def divides(self, width: int) -> bool:
        """Whether the axis divides ``width``: a leaf of that width is
        cut, else whole (``sanitize_specs``' rule)."""
        return width % self.size == 0

    def share(self, rows: int) -> tuple:
        """This rank's share ``(lo, hi)`` of ``rows`` that need not divide
        the axis: rank r's ``[r rows / n, (r + 1) rows / n)``, the cut
        where they divide."""
        return (self.rank * rows // self.size,
                (self.rank + 1) * rows // self.size)


def active(tp) -> bool:
    """Whether ``tp`` (a ``TensorParallel`` or None) cuts anything."""
    return tp is not None and tp.size > 1


class _Copy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp):
        ctx.tp = tp
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.tp.all_reduce(g.contiguous().clone()), None


class _Once(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp):
        ctx.n = tp.size
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g / ctx.n, None


class _Reduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp):
        return tp.all_reduce(x.contiguous().clone())

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp, dim):
        ctx.tp, ctx.dim = tp, dim
        return tp.all_gather(x.contiguous(), dim)

    @staticmethod
    def backward(ctx, g):
        return ctx.tp.reduce_scatter(g.contiguous(), ctx.dim), None, None


class _Join(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp, dim):
        ctx.tp, ctx.dim = tp, dim
        return tp.all_gather(x.contiguous(), dim)

    @staticmethod
    def backward(ctx, g):
        return ctx.tp.cut(g, ctx.dim).contiguous(), None, None


class _Scatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp, dim):
        ctx.tp, ctx.dim = tp, dim
        return tp.reduce_scatter(x.contiguous(), dim)

    @staticmethod
    def backward(ctx, g):
        return ctx.tp.all_gather(g.contiguous(), ctx.dim), None, None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp, split_dim, cat_dim):
        ctx.tp, ctx.dims = tp, (split_dim, cat_dim)
        return tp.all_to_all_plain(x.contiguous(), split_dim, cat_dim)

    @staticmethod
    def backward(ctx, g):
        split_dim, cat_dim = ctx.dims
        return (ctx.tp.all_to_all_plain(g.contiguous(), cat_dim, split_dim),
                None, None, None)


#: leaves that ``param_specs`` replicates but whose gradient a rank
#: computes from its share, whatever the residual's layout: the q/k norm
#: scales (applied to a rank's heads or rows), the MoE router (the
#: combine's gates of the rank's experts or tokens only; the aux term,
#: the same on every rank, goes through ``TensorParallel.once``), MLA's
#: down-projection and latent norm (their output feeds the rank's heads
#: or rows only) and the Mamba-2 mixer's ``a_log``, ``d_skip``,
#: ``dt_bias`` and gate norm scale (they enter a rank's heads, or every
#: head with only the rank's columns or rows of the output used)
_PARTIAL_ALWAYS = ("q_norm_scale", "k_norm_scale", "router", "w_dkv",
                   "kv_norm_scale", "a_log", "d_skip", "dt_bias",
                   "gate_norm_scale")

#: norm scales applied to the residual stream's layout: a rank's rows
#: under sequence parallelism, the whole replicated residual otherwise
_RESIDUAL_NORMS = ("pre_norm_scale", "post_norm_scale", "final_norm_scale",
                   "cross_norm_scale", "attn_out_norm_scale",
                   "ssm_out_norm_scale")


def _on_residual(path: str) -> bool:
    """Whether a leaf that the axis leaves whole runs on the residual's
    layout, as a norm does: the vocab (``embed``, ``lm_head``) and a
    dense MLP's projections (not an MoE layer's shared experts)."""
    return (path.split("/")[-1] in ("embed", "lm_head")
            or "/mlp/" in f"/{path}")


def partial_grad_leaf(path: str, sp: bool, spec: tuple) -> bool:
    """Whether the gradient of a leaf that the ``model`` axis leaves whole
    is computed on a shard, and so summed over the group. ``spec`` is the
    leaf's ``param_specs`` spec, before ``sanitize_specs``: a leaf it
    puts on ``model`` whose width does not divide the axis is summed
    always, each rank computing it on its rows or columns (attention's
    and MLA's projections, the experts, the SSM mixer's), but the leaves
    on the residual's layout (``_on_residual``), summed when it is cut by
    sequence (``sp``: for an ``enc_layers/`` leaf the encoder's residual,
    else the decoder's) and computed whole on every rank otherwise. A
    leaf it replicates: ``_PARTIAL_ALWAYS`` always, the residual's norms
    (``_RESIDUAL_NORMS``) when it is cut by sequence."""
    if model_dims(spec):
        return sp if _on_residual(path) else True
    name = path.split("/")[-1]
    if name in _PARTIAL_ALWAYS:
        return True
    return sp and name in _RESIDUAL_NORMS


def model_axis_sharded(cfg) -> bool:
    """Whether the port shards ``cfg`` over the ``model`` axis: every
    family it runs (dense, VLM, MoE, SSM, hybrid heads, enc-dec), as the
    reference's rules cut every family alike."""
    from repro_torch.models.transformer import FAMILIES
    return cfg.family in FAMILIES


@functools.lru_cache(maxsize=None)
def check_model_axis(cfg, tp: int) -> tuple:
    """Raise unless ``cfg``'s family is cut over the ``model`` axis
    (``model_axis_sharded``); else ``whole_leaves(cfg, tp)``. A leaf
    that does not divide ``tp`` is held whole by every rank, as the
    reference's ``sanitize_specs`` leaves it; heads need not divide
    ``tp`` either: attention, MLA's too, then runs by rows
    (``attention_mode``)."""
    if not model_axis_sharded(cfg):
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.family} family is not ported")
    return whole_leaves(cfg, tp)


@functools.lru_cache(maxsize=None)
def whole_leaves(cfg, tp: int) -> tuple:
    """The paths of the leaves that ``param_specs`` puts on ``model`` but
    that a ``model`` axis of ``tp`` leaves whole (no dim it cuts
    divides), in leaf order."""
    whole, kept = whole_specs(cfg, tp)
    return tuple(p for (p, a), (_, b) in zip(
        _leaf_paths(param_specs(whole), ""), _leaf_paths(kept, ""))
        if model_dims(a) and not model_dims(b))


def tensor_parallel(cfg, mesh, sequence_parallel: bool = True):
    """The ``TensorParallel`` of this rank of ``mesh`` for ``cfg``: over
    the mesh's ``model`` group when the axis is over 1, else None."""
    if mesh is None or _mesh.model_size(mesh) <= 1 \
            or not model_axis_sharded(cfg):
        return None
    return TensorParallel(_mesh.model_group(mesh), sequence_parallel)


@functools.lru_cache(maxsize=None)
def whole_specs(cfg, tp: int):
    """(the whole parameters on ``meta``, their ``model_specs``) of
    ``cfg`` over a ``model`` axis of ``tp``, built once."""
    whole = _whole_meta(cfg)
    return whole, model_specs(whole, tp)


@functools.lru_cache(maxsize=None)
def _whole_meta(cfg):
    from repro_torch.models.transformer import init_params
    return init_params(cfg, 0, torch.float32, "meta")


def params_are_whole(params, cfg, tp: int) -> bool:
    """True for whole parameters of ``cfg``, False for one rank's cut
    over a ``model`` axis of ``tp``; raises for anything else."""
    whole, specs = whole_specs(cfg, tp)
    got = [tuple(p.shape) for _, p in _leaf_paths(params, "")]
    if got == [tuple(w.shape) for _, w in _leaf_paths(whole, "")]:
        return True
    if got == [cut_shape(w.shape, sp, tp) for (_, w), (_, sp) in zip(
            _leaf_paths(whole, ""), _leaf_paths(specs, ""))]:
        return False
    raise ValueError(f"{cfg.name}: parameters are neither whole nor one "
                     f"rank's cut over a model axis of {tp}")


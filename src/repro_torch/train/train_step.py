"""Training step: loss -> grads -> (bucketed) sync -> AdamW/ZeRO-1 update.

The port of ``repro/train/train_step.py``. Three gradient-synchronization
paths, mirroring the paper's doorbell modes (§VI-C):

* ``make_train_step`` — the plain step (``launch/train.py``'s): one
  backward over the batch (or its microbatches), global-norm clip, AdamW.
  Given a mesh, every rank (one process each, SPMD over a
  ``torch.distributed`` group) takes its slice of the global batch along
  the data-parallel axes (``pod``, ``data``) and each gradient leaf is
  one ``all_reduce`` ("single-request", as XLA inserts one per tensor on
  the reference's pjit path). With ``tcfg.zero1`` each rank updates only
  its ZeRO-1 cut of the parameters and of ``m`` and ``v``, then the
  parameters are all-gathered (``train.optimizer.zero1_*``).
* ``make_bucketed_train_step(sync="psum")`` — "batch-requests": the
  gradients are coalesced into fixed-byte buckets by the doorbell
  planner, and each bucket is ONE ``all_reduce`` over the data-parallel
  group (``bucketed_sync``) — n_params collectives become n_buckets.
  Optionally (``compress_grads``) a bucket is summed in f32 within a pod
  and int8-quantized with error feedback across the ``pod`` axis (K1 and
  K2 on the rank's device) — the Streaming Compute block in its training
  role.
* ``make_bucketed_train_step(sync="rdma")`` — RecoNIC's engine-synced
  step: each data-parallel peer's gradients (a loop over the peer-split
  batch, where the reference ``vmap``s) are bucketed the same way and
  each bucket is a ring all-reduce of scheduled RDMA verbs on the shared
  engine (``repro_torch.train.collectives``): chunk READs through the
  pow2 descriptor buckets, DRR-fair with serving traffic, retransmitted
  byte-identically on a lossy fabric. The gradient words stay on the
  pool's device.

Bucket planning bills every leaf at its dtype's itemsize. Attention runs
K6 and the SSD scan K7 in every forward; their backward recomputes the
plain versions (``kernels.flash_attention._FlashAttention``,
``kernels.ssd_scan._SSDScan``). Each mesh step counts the collectives
its last call issued in ``step.collectives`` (the port's stand-in for
the reference's HLO all-reduce count). The model axis is replicated.
Given a ``launch.mesh.PlanMesh`` (the dry-run's) the mesh steps run as
its rank 0 and record their collectives there instead of sending them.
"""
from __future__ import annotations

from collections import Counter
from typing import Optional

import torch
import torch.distributed as dist

from repro_torch._tree import tree_leaves, tree_map, tree_unflatten
from repro_torch.configs.base import ModelConfig, TrainConfig
from repro_torch.core.rdma.doorbell import plan_buckets
from repro_torch.core.rdma.engine import RDMAEngine
from repro_torch.core.streaming.compress import compressed_all_reduce_group
from repro_torch.launch.mesh import (PlanGroup, axis_group, dp_axes,
                                     dp_group, dp_rank, dp_size)
from repro_torch.models.sharding import param_specs
from repro_torch.models.transformer import loss_fn
from repro_torch.train.collectives import RDMACollective
from repro_torch.train.optimizer import (AdamState, adamw_update,
                                         clip_by_global_norm, zero1_gather,
                                         zero1_shard, zero1_specs)


def _microbatch_grads(params, cfg: ModelConfig, batch: dict,
                      tcfg: TrainConfig):
    """(loss, grads) of the batch, accumulated over ``tcfg.microbatches``
    equal splits as the reference's ``lax.scan`` does (sum from zero,
    then times 1/n). Grads are f32 tensors in the params' layout; a
    param the loss does not reach gets zeros, as ``jax.grad`` gives."""
    n = tcfg.microbatches

    def value_and_grad(b):
        leaves = [p.detach().requires_grad_() for p in tree_leaves(params)]
        loss = loss_fn(tree_unflatten(params, leaves), cfg, b,
                       remat=tcfg.remat)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                    materialize_grads=True)
        return loss.detach(), list(grads)

    if n <= 1:
        loss, grads = value_and_grad(batch)
        return loss, tree_unflatten(params, grads)

    m = batch["tokens"].shape[0] // n

    loss_sum = torch.zeros((), dtype=torch.float32,
                           device=tree_leaves(params)[0].device)
    g_sum = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
             for p in tree_leaves(params)]
    for i in range(n):
        loss, grads = value_and_grad(_batch_rows(batch, i * m,
                                                 (i + 1) * m))
        loss_sum = loss_sum + loss
        g_sum = [a + g for a, g in zip(g_sum, grads)]
    inv = 1.0 / n
    return loss_sum * inv, tree_unflatten(params, [g * inv for g in g_sum])


def _batch_rows(batch: dict, start: int, stop: int) -> dict:
    """Rows ``start:stop`` of the batch: along dim 1 of the M-RoPE ids
    (3, B, S), dim 0 of every other leaf."""
    return {k: v[:, start:stop] if k == "mrope_positions" else v[start:stop]
            for k, v in batch.items()}


def _local_batch(batch: dict, index: int, size: int) -> dict:
    """Data-parallel rank ``index``'s rows of the global batch."""
    rows = batch["tokens"].shape[0]
    if rows % size:
        raise ValueError(f"batch of {rows} does not split over {size} "
                         f"data-parallel ranks")
    m = rows // size
    return _batch_rows(batch, index * m, (index + 1) * m)


def _all_reduce(t: torch.Tensor, group, issued: Counter) -> torch.Tensor:
    """Sum ``t`` over ``group`` in place (gloo takes CUDA tensors here);
    on a ``PlanGroup`` (the dry-run's) record it instead."""
    if isinstance(group, PlanGroup):
        group.record("all-reduce", t)
    else:
        dist.all_reduce(t, group=group)
    issued["all_reduce"] += 1
    return t


def _mean_loss(loss: torch.Tensor, group, size: int, issued: Counter
               ) -> torch.Tensor:
    return _all_reduce(loss.reshape(1).clone(), group, issued)[0] / size


# ---------------------------------------------------------------------------
# Path 1: the plain step ("single-request" over a mesh)
# ---------------------------------------------------------------------------

def make_train_step(cfg: ModelConfig, tcfg: TrainConfig, mesh=None):
    """Returns step(params, opt_state, batch) -> (loss, params, opt).

    ``batch`` holds ``tokens`` and ``labels`` tensors on the params'
    device. With a ``mesh`` (this process one rank of it) ``batch`` is
    the global batch, every rank's ``loss`` and ``params`` are the
    global step's, and under ``tcfg.zero1`` ``opt_state``'s ``m`` and
    ``v`` are this rank's ZeRO-1 cuts, in and out (cut whole state once
    with ``train.optimizer.zero1_init``; whole state raises).
    With ``step.keep_grads = True`` the step keeps its unclipped (synced)
    gradients in ``step.last_grads``, and ``step.grad_norm`` is their
    global norm (introspection hooks)."""
    if mesh is not None:
        axes, size = dp_axes(mesh), dp_size(mesh)
        group, index = dp_group(mesh), dp_rank(mesh)
    zero1 = mesh is not None and tcfg.zero1

    def step(params, opt_state: AdamState, batch):
        issued = Counter()
        if zero1:
            ospecs = zero1_specs(params, param_specs(params), axes, size)
            shapes = zero1_shard(tree_map(lambda p: p.to("meta"), params),
                                 ospecs, axes, index, size)
            if [a.shape for a in tree_leaves(opt_state.m)] != [
                    p.shape for p in tree_leaves(shapes)]:
                raise ValueError(
                    "the ZeRO-1 step takes this rank's cut of m and v; "
                    "cut whole state once with "
                    "train.optimizer.zero1_init(opt, mesh)")
        if mesh is None:
            loss, grads = _microbatch_grads(params, cfg, batch, tcfg)
        else:
            loss, grads = _microbatch_grads(
                params, cfg, _local_batch(batch, index, size), tcfg)
            grads = tree_map(
                lambda g: _all_reduce(g, group, issued).div_(size), grads)
            loss = _mean_loss(loss, group, size, issued)
        step.collectives = sum(issued.values())
        step.last_grads = grads if step.keep_grads else None
        grads, step.grad_norm = clip_by_global_norm(grads, tcfg.grad_clip)
        if not zero1:
            new_params, new_opt = adamw_update(grads, opt_state, params,
                                               tcfg)
            return loss, new_params, new_opt

        def cut(tree):
            return zero1_shard(tree, ospecs, axes, index, size)
        new_cut, new_opt = adamw_update(cut(grads), opt_state, cut(params),
                                        tcfg)
        return loss, zero1_gather(new_cut, ospecs, axes, group), new_opt

    step.keep_grads = False
    step.last_grads = None
    step.collectives = 0
    step.grad_norm = None
    return step


# ---------------------------------------------------------------------------
# Path 2: bucketed sync (collectives over a mesh, or RDMA verbs)
# ---------------------------------------------------------------------------

def _bucketize(grads, bucket_bytes: int):
    """Plan buckets over the flattened grad leaves (backward order).

    Byte accounting derives from each leaf's dtype (``itemsize``) — a
    bf16 leaf bills 2 bytes/element and an int8 residual 1, so buckets
    fill to the intended wire budget."""
    leaves = tree_leaves(grads)
    sizes = [l.numel() * l.element_size() for l in leaves]
    return leaves, plan_buckets(sizes, bucket_bytes)


def bucketed_sync(grads, axes: tuple, bucket_bytes: int,
                  compress: bool = False, residuals=None, *, mesh,
                  issued: Optional[Counter] = None):
    """Bucketed all-reduce over the ``axes`` of ``mesh`` (this rank's
    group along them).

    Each bucket: concat leaves -> ONE ``all_reduce`` -> split. With
    ``compress`` a bucket is summed in f32 within a pod (the axes other
    than ``pod``), then int8 with error feedback across ``pod``
    (``compressed_all_reduce_group``'s mean estimate times the number of
    pods, a sum like the uncompressed path's) — and ``residuals`` is then
    REQUIRED: a missing error-feedback state raises instead of silently
    falling back to the uncompressed f32 sum (init with
    ``streaming.compress.init_error_state``). Returns (synced_grads,
    new_residuals); without ``compress`` the residuals pass through.
    ``issued`` counts the collectives."""
    if compress and residuals is None:
        raise ValueError(
            "bucketed_sync(compress=True) requires an error-feedback "
            "residuals pytree (repro_torch.core.streaming.compress."
            "init_error_state) — refusing to silently ship uncompressed "
            "fp32 gradients")
    issued = Counter() if issued is None else issued
    leaves, buckets = _bucketize(grads, bucket_bytes)
    out = [None] * len(leaves)
    res_leaves = tree_leaves(residuals) if compress else None
    new_res = [None] * len(leaves)

    def split(flat, ids, dst):
        offset = 0
        for i in ids:
            n = leaves[i].numel()
            dst[i] = flat[offset:offset + n].reshape(leaves[i].shape)
            offset += n

    for b in buckets:
        flat = torch.cat(
            [leaves[i].reshape(-1).to(torch.float32) for i in b.leaf_ids])
        if compress:
            intra = tuple(a for a in axes if a != "pod")
            if intra:
                _all_reduce(flat, axis_group(mesh, intra), issued)
            res_flat = torch.cat(
                [res_leaves[i].reshape(-1) for i in b.leaf_ids])
            if "pod" in axes:
                pods = axis_group(mesh, ("pod",))
                flat, res_flat = compressed_all_reduce_group(
                    flat, res_flat, pods)
                issued["all_reduce"] += 2
                # the pods' sum, where the reference keeps the mean and
                # so divides the mean gradient by the pod count twice
                flat.mul_(dist.get_world_size(pods))
            split(res_flat, b.leaf_ids, new_res)
        else:
            _all_reduce(flat, axis_group(mesh, axes), issued)
        split(flat, b.leaf_ids, out)
    out = [o.to(l.dtype) for o, l in zip(out, leaves)]
    return (tree_unflatten(grads, out),
            tree_unflatten(grads, new_res) if compress else residuals)


def _make_psum_step(cfg: ModelConfig, tcfg: TrainConfig, mesh):
    """The reference's ``shard_map`` ``local_step`` as one rank of the
    mesh: its slice of the global batch, the mean gradient by
    ``bucketed_sync`` over the data-parallel axes, the loss by one more
    ``all_reduce``, then clip and AdamW on every rank alike."""
    if mesh is None:
        raise ValueError("sync='psum' needs a mesh")
    axes, size = dp_axes(mesh), dp_size(mesh)
    group, index = dp_group(mesh), dp_rank(mesh)
    bucket_bytes = int(tcfg.grad_bucket_mb * (1 << 20)) or (16 << 20)

    def step(params, opt_state, batch, residuals=None):
        issued = Counter()
        loss, grads = _microbatch_grads(
            params, cfg, _local_batch(batch, index, size), tcfg)
        grads = tree_map(lambda g: g.div_(size), grads)
        grads, residuals = bucketed_sync(
            grads, axes, bucket_bytes, compress=tcfg.compress_grads,
            residuals=residuals, mesh=mesh, issued=issued)
        loss = _mean_loss(loss, group, size, issued)
        step.collectives = sum(issued.values())
        step.last_grads = grads if step.keep_grads else None
        grads, step.grad_norm = clip_by_global_norm(grads, tcfg.grad_clip)
        new_params, new_opt = adamw_update(grads, opt_state, params, tcfg)
        return loss, new_params, new_opt, residuals

    step.keep_grads = False
    step.last_grads = None
    step.collectives = 0
    step.grad_norm = None
    return step


def make_bucketed_train_step(cfg: ModelConfig, tcfg: TrainConfig, mesh,
                             sync: str = "psum", engine=None,
                             n_peers: Optional[int] = None):
    """Returns step(params, opt, batch, residuals=None) -> (loss, params,
    opt, residuals), the reference's signature.

    ``sync="psum"``: this process is one rank of ``mesh``; ``batch`` is
    the global batch, each bucket one ``all_reduce`` over the
    data-parallel axes (``compress_grads``: int8 across ``pod``, with
    the error-feedback ``residuals`` threaded through).
    ``sync="rdma"`` sums each bucket's per-peer shards by
    ``RDMACollective`` on ``engine`` (one is created at the first step
    otherwise, on the params' device, with a pool that fits two
    in-flight buckets — an ``ICITransport`` when the process group holds
    ``n_peers`` ranks); ``n_peers`` is the data-parallel degree (the
    mesh's when not given) and must divide the batch.

    Introspection hooks: ``step.collective(max_bucket_words, device)``
    returns the rdma step's collective (building it on first use); with
    ``step.keep_grads = True`` the step keeps the synced mean gradients
    (before the clip) in ``step.last_grads``; the psum step counts the
    collectives of its last call in ``step.collectives`` and keeps its
    synced gradients' global norm in ``step.grad_norm``."""
    if sync not in ("psum", "rdma"):
        raise ValueError(f"sync must be psum|rdma, got {sync!r}")
    if sync == "psum":
        return _make_psum_step(cfg, tcfg, mesh)
    if tcfg.compress_grads:
        raise ValueError(
            "compress_grads is the psum path's cross-pod compression; "
            "sync='rdma' moves f32 pool words — combine is not supported")
    if n_peers is None:
        if mesh is None:
            raise ValueError("sync='rdma' needs n_peers or a mesh")
        n_peers = dp_size(mesh)
    n = int(n_peers)
    bucket_bytes = int(tcfg.grad_bucket_mb * (1 << 20)) or (16 << 20)
    state = {"coll": None}

    def _collective(max_bucket_words, device=None):
        coll = state["coll"]
        if coll is None:
            eng = engine
            depth = 2
            if eng is None:
                # per-peer arena: (data + scratch) per in-flight bucket,
                # in slots reserved at the largest bucket's size
                need = 2 * max_bucket_words * depth + 1024
                size = 1 << max(12, (need - 1).bit_length())
                eng = RDMAEngine(n_peers=max(n, 2), pool_size=size,
                                 scheduler="drr", device=device)
            coll = state["coll"] = RDMACollective(
                eng, n, algorithm="ring", pipeline_depth=depth)
            if engine is None and max_bucket_words:
                coll.reserve(max_bucket_words)
        return coll

    def step(params, opt_state, batch, residuals=None):
        rows = batch["tokens"].shape[0]
        if rows % n:
            raise ValueError(f"batch of {rows} does not split over {n} "
                             f"peers")
        m = rows // n
        losses, peer_leaves = [], []
        for p in range(n):
            loss_p, grads_p = _microbatch_grads(
                params, cfg, _batch_rows(batch, p * m, (p + 1) * m), tcfg)
            losses.append(loss_p)
            leaves, buckets = _bucketize(grads_p, bucket_bytes)
            peer_leaves.append(leaves)
        del grads_p, leaves
        shapes = [l.shape for l in peer_leaves[0]]
        # arena words per bucket = element count padded to n chunks
        # (billing bytes are dtype-derived; the wire moves f32 words)
        coll = _collective(max(
            -(-sum(peer_leaves[0][i].numel() for i in b.leaf_ids) // n) * n
            for b in buckets), device=peer_leaves[0][0].device)
        # a one-leaf bucket is a view of the leaf: no copy before the pool
        bucket_shards = [
            [torch.cat([peer_leaves[p][i].reshape(-1) for i in b.leaf_ids])
             if len(b.leaf_ids) > 1
             else peer_leaves[p][b.leaf_ids[0]].reshape(-1)
             for p in range(n)]
            for b in buckets]
        del peer_leaves
        reduced = coll.all_reduce_buckets(bucket_shards)
        del bucket_shards
        out = [None] * len(shapes)
        for b, red in zip(buckets, reduced):
            flat = red[0] / n                         # sum -> mean
            offset = 0
            for i in b.leaf_ids:
                sz = shapes[i].numel()
                out[i] = flat[offset:offset + sz].reshape(shapes[i])
                offset += sz
        del reduced
        grads = tree_unflatten(params, out)
        step.last_grads = grads if step.keep_grads else None
        loss = torch.mean(torch.stack(losses))
        grads, _ = clip_by_global_norm(grads, tcfg.grad_clip)
        new_params, new_opt = adamw_update(grads, opt_state, params, tcfg)
        return loss, new_params, new_opt, residuals

    step.collective = _collective      # test/bench introspection hook
    step.keep_grads = False
    step.last_grads = None
    return step

"""Training step: loss -> grads -> (bucketed) sync -> AdamW update.

The port of ``repro/train/train_step.py`` on one card, in two forms:

* ``make_train_step`` — the plain step (``launch/train.py``'s): one
  backward over the batch (or its microbatches), global-norm clip, AdamW.
* ``make_bucketed_train_step(sync="rdma")`` — RecoNIC's engine-synced
  step: each data-parallel peer's gradients (a loop over the peer-split
  batch, where the reference ``vmap``s) are coalesced into fixed-byte
  buckets by the doorbell planner, and each bucket is a ring all-reduce
  of scheduled RDMA verbs on the shared engine
  (``repro_torch.train.collectives``): chunk READs through the pow2
  descriptor buckets, DRR-fair with serving traffic, retransmitted
  byte-identically on a lossy fabric. The gradient words stay on the
  pool's device.

Bucket planning bills every leaf at its dtype's itemsize. Attention runs
K6 and the SSD scan K7 in every forward; their backward recomputes the
plain versions (``kernels.flash_attention._FlashAttention``,
``kernels.ssd_scan._SSDScan``).

The reference's mesh paths — ``sync="psum"``, ``bucketed_sync``,
``compress_grads`` and ZeRO-1 over a mesh — need several cards; they
raise ``NotImplementedError`` until the multi-card port
(``torch.distributed`` across cards).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch._tree import tree_leaves, tree_unflatten
from repro_torch.configs.base import ModelConfig, TrainConfig
from repro_torch.core.rdma.doorbell import plan_buckets
from repro_torch.core.rdma.engine import RDMAEngine
from repro_torch.models.transformer import loss_fn
from repro_torch.train.collectives import RDMACollective
from repro_torch.train.optimizer import (AdamState, adamw_update,
                                         clip_by_global_norm)

_MULTI_CARD = ("needs a multi-device mesh; it waits for the multi-card "
               "port (torch.distributed across cards)")


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

    def split(x, i):
        m = x.shape[0] // n
        return x[i * m:(i + 1) * m]

    loss_sum = torch.zeros((), dtype=torch.float32,
                           device=tree_leaves(params)[0].device)
    g_sum = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
             for p in tree_leaves(params)]
    for i in range(n):
        loss, grads = value_and_grad({k: split(v, i)
                                      for k, v in batch.items()})
        loss_sum = loss_sum + loss
        g_sum = [a + g for a, g in zip(g_sum, grads)]
    inv = 1.0 / n
    return loss_sum * inv, tree_unflatten(params, [g * inv for g in g_sum])


# ---------------------------------------------------------------------------
# Path 1: the plain step
# ---------------------------------------------------------------------------

def make_train_step(cfg: ModelConfig, tcfg: TrainConfig, mesh=None):
    """Returns step(params, opt_state, batch) -> (loss, params, opt).

    ``batch`` holds ``tokens`` and ``labels`` tensors on the params'
    device. With ``step.keep_grads = True`` the step keeps its unclipped
    gradients in ``step.last_grads`` (an introspection hook)."""
    if mesh is not None:
        raise NotImplementedError(f"make_train_step(mesh=...) {_MULTI_CARD}")

    def step(params, opt_state: AdamState, batch):
        loss, grads = _microbatch_grads(params, cfg, batch, tcfg)
        step.last_grads = grads if step.keep_grads else None
        grads, _ = clip_by_global_norm(grads, tcfg.grad_clip)
        new_params, new_opt = adamw_update(grads, opt_state, params, tcfg)
        return loss, new_params, new_opt

    step.keep_grads = False
    step.last_grads = None
    return step


# ---------------------------------------------------------------------------
# Path 2: bucketed sync as scheduled RDMA verbs
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
                  compress: bool = False, residuals=None):
    """The reference's ``psum`` of each bucket over mesh axes."""
    raise NotImplementedError(f"bucketed_sync {_MULTI_CARD}")


def make_bucketed_train_step(cfg: ModelConfig, tcfg: TrainConfig, mesh,
                             sync: str = "psum", engine=None,
                             n_peers: Optional[int] = None):
    """Returns step(params, opt, batch, residuals=None) -> (loss, params,
    opt, residuals), the reference's signature. ``sync="rdma"`` sums
    each bucket's per-peer shards by ``RDMACollective`` on ``engine`` (one
    is created at the first step otherwise, on the params' device, with
    a pool that fits two in-flight buckets); ``n_peers`` is the data-
    parallel degree and must divide the batch. ``sync="psum"`` needs a
    mesh and raises.

    Introspection hooks: ``step.collective(max_bucket_words, device)``
    returns the collective (building it on first use); with
    ``step.keep_grads = True`` the step keeps the synced mean gradients
    (before the clip) in ``step.last_grads``."""
    if sync not in ("psum", "rdma"):
        raise ValueError(f"sync must be psum|rdma, got {sync!r}")
    if sync == "psum":
        raise NotImplementedError(f"sync='psum' {_MULTI_CARD}")
    if tcfg.compress_grads:
        raise ValueError(
            "compress_grads is the psum path's cross-pod compression; "
            "sync='rdma' moves f32 pool words — combine is not supported")
    if n_peers is None:
        if mesh is None:
            raise ValueError("sync='rdma' needs n_peers or a mesh")
        raise NotImplementedError(f"n_peers from a mesh {_MULTI_CARD}")
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
        rows = next(iter(batch.values())).shape[0]
        if rows % n:
            raise ValueError(f"batch of {rows} does not split over {n} "
                             f"peers")
        m = rows // n
        losses, peer_leaves = [], []
        for p in range(n):
            loss_p, grads_p = _microbatch_grads(
                params, cfg, {k: v[p * m:(p + 1) * m]
                              for k, v in batch.items()}, tcfg)
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

"""Pipeline parallelism: a microbatch pipeline over a ``stage`` mesh axis.

The port of ``repro/train/pipeline_parallel.py``, one process per stage
(SPMD over a ``torch.distributed`` group). The GPipe schedule runs
T = M + S - 1 ticks for M microbatches over S stages (the classic
bubble). Each tick every stage applies its layer block to its current
microbatch, then the activations rotate one stage forward: a
``batch_isend_irecv`` to ``(stage + 1) % S`` and from ``(stage - 1) %
S``, the reference's ``ppermute`` — stage-to-stage activation transfer is
exactly an RDMA WRITE-with-immediate to the next peer (PIPELINE_ACT
traffic class). Stage 0 feeds fresh microbatches; stage S-1 emits
outputs, which reach every stage by the reference's ``all_to_all`` then
``all_gather``.

gloo sends and receives host tensors only (a CUDA tensor given to its
``send`` aborts the process), so on a gloo group the rotation stages a
device activation through host memory; its ``all_to_all`` and
``all_gather`` take device tensors.
"""
from __future__ import annotations

from typing import Callable

import torch
import torch.distributed as dist

from repro_torch._tree import tree_map
from repro_torch.launch.mesh import axis_size


def pipeline_forward(layer_fn: Callable, mesh, stage_axis: str,
                     n_microbatches: int):
    """Build a pipelined forward over ``stage_axis`` of ``mesh``.

    layer_fn(stage_params, x) -> y : one stage's computation.
    Returns run(stage_params, x_microbatches) -> y_microbatches, where
    every leaf of ``stage_params`` has a leading stage dim (this rank
    takes its own slice) and x_microbatches, the same on every rank, has
    leading dim n_microbatches. ``run.sends`` counts the activation
    sends of this rank (one per tick when there are several stages)."""
    n_stages = axis_size(mesh, stage_axis)
    assert n_microbatches >= 1
    ticks = n_microbatches + n_stages - 1
    group = mesh.get_group(stage_axis)
    stage = mesh.get_local_rank(stage_axis)
    ranks = [dist.get_global_rank(group, s) for s in range(n_stages)]
    staged = dist.get_backend(group) == "gloo"

    def rotate(y: torch.Tensor) -> torch.Tensor:
        """y to the next stage, the previous stage's y back."""
        send = y.cpu() if staged else y.contiguous()
        recv = torch.empty_like(send)
        ops = [dist.P2POp(dist.isend, send, ranks[(stage + 1) % n_stages],
                          group),
               dist.P2POp(dist.irecv, recv, ranks[(stage - 1) % n_stages],
                          group)]
        for work in dist.batch_isend_irecv(ops):
            work.wait()
        run.sends += 1
        return recv.to(y.device)

    def run(stage_params, xs: torch.Tensor) -> torch.Tensor:
        params = tree_map(lambda p: p[stage], stage_params)
        mb_shape = xs.shape[1:]
        state = xs.new_zeros(mb_shape)
        outputs = xs.new_zeros((n_microbatches,) + mb_shape)
        for t in range(ticks):
            # stage 0 ingests microbatch t (if any remain)
            fresh = (xs[t] if t < n_microbatches
                     else xs.new_zeros(mb_shape))
            y = layer_fn(params, fresh if stage == 0 else state)
            # each stage records its finished microbatch (index t-(S-1));
            # the last stage's are the outputs
            out_idx = t - (n_stages - 1)
            if 0 <= out_idx < n_microbatches:
                outputs[out_idx] = y
            # rotate activations one stage forward (RDMA WRITE+IMM analog)
            state = rotate(y) if n_stages > 1 else y
        if n_stages == 1:
            return outputs
        # Route the last stage's outputs to all stages: each stage keeps
        # the last stage's shard of the microbatch stack (all_to_all),
        # then the shards are tiled back together (all_gather).
        pad = (-n_microbatches) % n_stages
        padded = (torch.cat([outputs, outputs.new_zeros((pad,) + mb_shape)])
                  if pad else outputs)
        mp = padded.shape[0] // n_stages
        routed = torch.empty_like(padded)
        dist.all_to_all_single(routed, padded, group=group)
        mine = routed.reshape((n_stages, mp) + mb_shape)[n_stages - 1]
        shards = [torch.empty_like(mine) for _ in range(n_stages)]
        dist.all_gather(shards, mine.contiguous(), group=group)
        return torch.cat(shards)[:n_microbatches]

    run.sends = 0
    return run


def stage_params_spec(params_one_stage):
    """Spec helper: stack per-stage params along a leading 'stage' dim."""
    return tree_map(lambda _: ("stage",), params_one_stage)


def bubble_fraction(n_stages: int, n_microbatches: int) -> float:
    """Pipeline bubble overhead of the GPipe schedule."""
    return (n_stages - 1) / (n_microbatches + n_stages - 1)

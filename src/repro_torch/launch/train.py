"""End-to-end training entry point (the RecoNIC 'host application').

The port of ``repro/launch/train.py``: config -> params and AdamW state
on the card -> data pipeline -> train loop with the gradient buckets
planned by the doorbell coalescer, async checkpointing and
heartbeat/straggler monitoring. Attention runs K6 in every forward (and
again in each remat recompute). Runs on the GPU unless ``--device cpu``.

Usage::

  PYTHONPATH=src python -m repro_torch.launch.train --arch tiny \\
      --steps 12 --batch 4 --seq 32 --lr 3e-3 --device cpu
  PYTHONPATH=src python -m repro_torch.launch.train --arch tinyllama-1.1b \\
      --steps 3 --batch 4 --seq 512 --data-cycle 1

Buckets are planned at ``TrainConfig.grad_bucket_mb`` (16 MiB when 0);
the reference's cost-model choice of the bucket size and its predicted
sync time wait for a measured cost profile of the card.
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from repro_torch._device import resolve_device, synchronize
from repro_torch._tree import tree_leaves
from repro_torch.checkpoint.checkpoint import CheckpointManager
from repro_torch.configs.base import TrainConfig
from repro_torch.configs.registry import get_config
from repro_torch.core.rdma.doorbell import plan_buckets
from repro_torch.core.streaming.classifier import (TrafficClass,
                                                   TrafficRouter,
                                                   TransferDesc)
from repro_torch.data.pipeline import DataConfig, SyntheticPipeline
from repro_torch.models.transformer import init_params
from repro_torch.runtime.fault_tolerance import (ElasticController,
                                                 HeartbeatMonitor)
from repro_torch.train.optimizer import init_adam
from repro_torch.train.train_step import make_train_step


def run(arch: str, steps: int, batch: int, seq: int, ckpt_dir: str = "",
        resume: bool = False, log_every: int = 10, lr: float = 3e-4,
        microbatches: int = 1, seed: int = 0,
        ckpt_every: int = 50, data_cycle: int = 0, device=None) -> dict:
    """``data_cycle`` > 0 cycles through that many fixed batches
    (memorization demo — loss provably decreases in a few hundred steps);
    0 streams fresh batches. ``device`` ``None`` means the GPU."""
    dev = resolve_device(device)
    cfg = get_config(arch)
    tcfg = TrainConfig(learning_rate=lr, warmup_steps=max(steps // 20, 5),
                       total_steps=steps, microbatches=microbatches,
                       remat=True, zero1=False, sequence_parallel=False,
                       seed=seed)

    params = init_params(cfg, seed, device=dev)
    opt = init_adam(params)
    pipe = SyntheticPipeline(DataConfig(
        seed=seed, vocab_size=cfg.vocab_size, batch=batch, seq_len=seq))

    start_step = 0
    cm = CheckpointManager(ckpt_dir) if ckpt_dir else None
    if cm and resume and cm.latest_step() is not None:
        (params, opt), start_step = cm.restore((params, opt))
        print(f"resumed from step {start_step}")

    step_fn = make_train_step(cfg, tcfg)

    # RecoNIC telemetry: classify the traffic this job generates per step
    router = TrafficRouter(device=dev)
    leaf_bytes = [x.numel() * x.element_size() for x in tree_leaves(params)]
    bucket_bytes = int(tcfg.grad_bucket_mb * (1 << 20)) or (16 << 20)
    buckets = plan_buckets(leaf_bytes, bucket_bytes)
    print(f"grad sync plan: {len(leaf_bytes)} tensors -> {len(buckets)} "
          f"buckets (doorbell batching)")

    monitor = HeartbeatMonitor(n_hosts=1, timeout=3600.0)
    controller = ElasticController(monitor, model_parallel=1)
    losses, times = [], []
    t_start = time.time()
    for step in range(start_step, steps):
        b = pipe.batch_at(step % data_cycle if data_cycle else step)
        batch_dev = {k: torch.from_numpy(v).to(dev) for k, v in b.items()}
        synchronize(dev)
        t0 = time.time()
        loss, params, opt = step_fn(params, opt, batch_dev)
        synchronize(dev)
        dt = time.time() - t0
        monitor.beat(0, dt)
        controller.step(step, {0: dt})
        router.route([TransferDesc(TrafficClass.BULK_GRAD,
                                   sum(leaf_bytes)),
                      TransferDesc(TrafficClass.HOST_IO,
                                   batch_dev["tokens"].numel() * 4)])
        losses.append(float(loss))
        times.append(dt)
        if step % log_every == 0 or step == steps - 1:
            print(f"step {step:5d}  loss {losses[-1]:.4f}  "
                  f"{dt*1e3:7.1f} ms/step")
        if cm and step and step % ckpt_every == 0:
            cm.save(step, (params, opt), blocking=False)
    if cm:
        cm.save(steps, (params, opt), blocking=True)

    return {"arch": arch, "steps": steps,
            "first_loss": losses[0], "last_loss": losses[-1],
            "mean_step_s": float(np.mean(times[1:])) if len(times) > 1
            else times[0],
            "total_s": time.time() - t_start,
            "buckets": len(buckets),
            "traffic": {tc.value: dict(c) for tc, c in
                        router.counters.items() if c["count"]}}



def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="train-100m")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--data-cycle", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU)")
    ap.add_argument("--out", default="")
    args = ap.parse_args()
    res = run(args.arch, args.steps, args.batch, args.seq, args.ckpt_dir,
              args.resume, lr=args.lr, microbatches=args.microbatches,
              data_cycle=args.data_cycle, device=args.device)
    print(json.dumps(res, indent=1))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(res, f, indent=1)
    if not res["last_loss"] < res["first_loss"]:
        raise SystemExit("training must reduce loss")


if __name__ == "__main__":
    main()

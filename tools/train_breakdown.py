"""Where one plain train step of the port spends its time on the GPU.

    python3 tools/train_breakdown.py [--arch tinyllama-1.1b] [--batch 4]
                                     [--seq 512] [--steps 5] [--tree PATH]

Builds the kernels of the tree at ``--tree`` (default: this checkout; two
trees are compared in one call on the same card by one process each),
makes random f32 weights (seed 0) and one ``SyntheticPipeline`` batch
(phase 18's shape by default), runs two warm-up steps of the plain train
step (``make_train_step``, remat on), then times ``--steps`` whole steps,
each synchronised, with the host time spent inside K6's launches
(``flash_attention._launch``: the kernels' launches, the TF32 route's
scratch allocation and tensor maps) and their count, and traces one whole
step: its device time, K6's kernels' part of it and their records. Then
it times the stages of one step
the way the step runs them, each synchronised: the forward with the loss
(``loss_fn``, remat), the backward (``torch.autograd.grad``: the remat
recompute, K6's backward as its plain version, the GEMMs' backward), the
global-norm clip and the AdamW update. The backward is also traced with
``torch.profiler`` and its device time grouped by kernel family (GEMMs,
K6, copies, the rest), with the top kernels by device time. Prints the
card's name and power limit first. Needs a CUDA device.
"""
import argparse
import os
import re
import subprocess
import sys
import time

import torch
from torch.autograd import DeviceType

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def family(name: str) -> str:
    low = name.lower()
    if "flash_attention" in low:        # every route's kernels
        return "K6"
    if "gemm" in low or "cutlass" in low or "cublas" in low:
        return "GEMM"
    if "memcpy" in low or "memset" in low:
        return "copy"
    return "other"


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="tinyllama-1.1b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=512)
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--tree", default=HERE)
    args = ap.parse_args()
    sys.path.insert(0, os.path.join(os.path.abspath(args.tree), "src"))
    if not torch.cuda.is_available():
        print("train_breakdown: no CUDA device is available", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip())
    from repro_torch._tree import tree_leaves, tree_unflatten
    from repro_torch.configs.base import TrainConfig
    from repro_torch.configs.registry import get_config
    from repro_torch.data.pipeline import DataConfig, SyntheticPipeline
    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import init_params, loss_fn
    from repro_torch.train import init_adam, make_train_step
    from repro_torch.train.optimizer import adamw_update, clip_by_global_norm

    torch.backends.cuda.matmul.allow_tf32 = False
    _build.build()
    dev = torch.device("cuda")
    cfg = get_config(args.arch)
    tcfg = TrainConfig(learning_rate=3e-4, warmup_steps=1, total_steps=10,
                       remat=True, zero1=False, sequence_parallel=False)
    params = init_params(cfg, 0, device=dev)
    opt = init_adam(params)
    batch = {k: torch.from_numpy(v).to(dev) for k, v in SyntheticPipeline(
        DataConfig(seed=0, vocab_size=cfg.vocab_size, batch=args.batch,
                   seq_len=args.seq)).batch_at(0).items()}
    step = make_train_step(cfg, tcfg)
    for _ in range(2):
        _, params, opt = step(params, opt, batch)
    torch.cuda.synchronize()
    print(f"tree {os.path.abspath(args.tree)}", flush=True)

    # host time inside K6's launches, summed over a step
    launch, k6_host = fa._launch, [0.0, 0]

    def timed_launch(*a):
        t0 = time.perf_counter()
        launch(*a)
        k6_host[0] += time.perf_counter() - t0
        k6_host[1] += 1

    fa._launch = timed_launch
    for i in range(args.steps):
        k6_host[:] = [0.0, 0]
        routes = dict(getattr(fa.flash_attention, "route_launches", {}))
        torch.cuda.synchronize()
        t = time.perf_counter()
        _, params, opt = step(params, opt, batch)
        torch.cuda.synchronize()
        whole_ms = (time.perf_counter() - t) * 1e3
        print(f"[train step wall] step={i} wall_ms={whole_ms} "
              f"k6_launch_host_ms={k6_host[0] * 1e3} k6_calls={k6_host[1]} "
              + " ".join(f"{r}={n - routes[r]}" for r, n in
                         getattr(fa.flash_attention, "route_launches",
                                 {}).items()), flush=True)
    fa._launch = launch
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        _, params, opt = step(params, opt, batch)
        torch.cuda.synchronize()
    rows = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.count]
    k6 = [e for e in rows if family(e.key) == "K6"]
    print(f"[train step trace] device_ms="
          f"{sum(e.self_device_time_total for e in rows) / 1e3} "
          f"k6_device_ms={sum(e.self_device_time_total for e in k6) / 1e3} "
          f"k6_records={sum(e.count for e in k6)} "
          + " ".join(f"{re.search(r'flash_attention\w*', e.key).group(0)}"
                     f"_ms={e.self_device_time_total / 1e3}"
                     for e in k6), flush=True)

    def stage(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) * 1e3

    leaves = [p.detach().requires_grad_() for p in tree_leaves(params)]
    loss, fwd_ms = stage(lambda: loss_fn(tree_unflatten(params, leaves),
                                         cfg, batch, remat=True))

    def backward():
        return torch.autograd.grad(loss, leaves)

    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        grads, bwd_ms = stage(backward)
    grads = tree_unflatten(params, list(grads))
    (clipped, _), clip_ms = stage(lambda: clip_by_global_norm(
        grads, tcfg.grad_clip))
    _, adam_ms = stage(lambda: adamw_update(clipped, opt, params, tcfg))
    print(f"[train step] arch={cfg.name} batch={args.batch} seq={args.seq} "
          f"step_ms={whole_ms} forward_ms={fwd_ms} backward_ms={bwd_ms} "
          f"clip_ms={clip_ms} adamw_ms={adam_ms} "
          f"stages_sum_ms={fwd_ms + bwd_ms + clip_ms + adam_ms}")
    rows = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.count]
    total = sum(e.self_device_time_total for e in rows) / 1e3
    groups = {}
    for e in rows:
        g = family(e.key)
        groups[g] = groups.get(g, 0.0) + e.self_device_time_total / 1e3
    print(f"[backward trace] device_ms={total} wall_ms={bwd_ms} "
          + " ".join(f"{k}_ms={v}" for k, v in sorted(groups.items())))
    for e in sorted(rows, key=lambda e: -e.self_device_time_total)[:12]:
        print(f"[backward kernel] ms={e.self_device_time_total / 1e3} "
              f"count={e.count} family={family(e.key)} name={e.key[:90]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Warm prefill and decode times of one served model on the GPU, or of one
device's share of a reference cell.

    python3 tools/serve_timing.py [--arch deepseek-v2-lite-16b]
                                  [--requests 8] [--prompt-len 512]
                                  [--gen-len 32] [--reps 3] [--tree PATH]
    python3 tools/serve_timing.py --cell decode_32k
                                  [--arch seamless-m4t-large-v2]
                                  [--reps 5] [--tree PATH]

Builds the kernels of the tree at ``--tree`` (default: this checkout; two
trees are compared in one call on the same card by one process each, in
the order parent, change, change, parent). Prints the card's name and
power limit first. Needs a CUDA device.

Served: makes random f32 weights (seed 0) and random prompts, as
``launch/serve.py`` does, and runs one untimed prefill and decode to warm
up. Then, ``--reps`` times, it prefills the batch into fresh caches and
decodes ``--gen-len - 1`` greedy steps, each synchronised, and prints the
prefill ms and the decode ms a step of every rep and their medians, with
the peak memory.

``--cell SHAPE``: one device's share of the cell on the single-pod mesh in
bf16, as ``chip_smoke.py`` phase 28 runs it (``launch.dryrun.build_cell``
from seed 0; a decode cell steps at its slot over caches of seeded
values). After one untimed run it times ``--reps`` runs, each
synchronised, and prints one JSON line: every wall, their median, one
traced run's device ms and each hand kernel's device ms in it
(``chip_smoke.traced_device_us``) and K6's launches per route in a run.
"""
import argparse
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--cell", metavar="SHAPE")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=512)
    ap.add_argument("--gen-len", type=int, default=32)
    ap.add_argument("--reps", type=int)
    ap.add_argument("--tree", default=HERE)
    args = ap.parse_args()
    sys.path.insert(0, os.path.join(os.path.abspath(args.tree), "src"))
    if not torch.cuda.is_available():
        print("serve_timing: no CUDA device is available", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip())
    if args.cell:
        return cell(args.arch or "seamless-m4t-large-v2", args.cell,
                    args.reps or 5, os.path.abspath(args.tree))
    args.arch = args.arch or "deepseek-v2-lite-16b"
    args.reps = args.reps or 3
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels import _build
    from repro_torch.models.transformer import init_caches, init_params
    from repro_torch.serve.serve_step import decode_step, prefill_step

    _build.build()
    dev = torch.device("cuda")
    cfg = get_config(args.arch)
    params = init_params(cfg, 0, device=dev)
    rng = np.random.default_rng(0)
    prompts = torch.from_numpy(rng.integers(
        0, cfg.vocab_size, size=(args.requests, args.prompt_len))).to(dev)
    max_seq = args.prompt_len + args.gen_len + 8

    def run(steps):
        caches = init_caches(cfg, args.requests, max_seq, torch.float32,
                             device=dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, caches = prefill_step(params, cfg, {"tokens": prompts},
                                      caches)
        torch.cuda.synchronize()
        prefill = time.perf_counter() - t0
        tok = torch.argmax(logits[:, -1], dim=-1)[:, None]
        t0 = time.perf_counter()
        for i in range(steps):
            logits, caches = decode_step(params, cfg, tok, caches,
                                         args.prompt_len + i)
            tok = torch.argmax(logits[:, -1], dim=-1)[:, None]
        torch.cuda.synchronize()
        decode = (time.perf_counter() - t0) / max(steps, 1)
        assert torch.isfinite(logits).all()
        return prefill * 1e3, decode * 1e3

    run(2)
    torch.cuda.reset_peak_memory_stats()
    walls = [run(args.gen_len - 1) for _ in range(args.reps)]
    print(f"tree {os.path.abspath(args.tree)} arch {args.arch}")
    print("prefill ms " + " ".join(f"{p:.3f}" for p, _ in walls)
          + f" median {statistics.median(p for p, _ in walls):.3f}")
    print("decode ms a step " + " ".join(f"{d:.3f}" for _, d in walls)
          + f" median {statistics.median(d for _, d in walls):.3f}")
    print(f"peak GB {torch.cuda.max_memory_allocated() / 1e9:.3f}",
          flush=True)
    return 0


def cell(arch, shape, reps, tree):
    """``--cell``: walls and traced device time of one device's share of
    the cell ``arch`` x ``shape``; one JSON line."""
    sys.path.insert(1, HERE)
    from chip_smoke import _train_config, traced_device_us

    from repro_torch.configs.base import SHAPES, SINGLE_POD_MESH
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.launch.dryrun import build_cell

    _build.build()
    dev = torch.device("cuda")
    fn, _, _ = build_cell(get_config(arch), SHAPES[shape], SINGLE_POD_MESH,
                          _train_config(param_dtype="bfloat16"), device=dev,
                          seed=0)
    fn()
    torch.cuda.synchronize()
    walls = []
    for _ in range(reps):
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t) * 1e3)
    routes = dict(flash_attention.route_launches)
    kernel_ms = {}
    _, dev_us = traced_device_us(fn, per_kernel=kernel_ms)
    per_run = {r: n - routes[r]
               for r, n in flash_attention.route_launches.items()}
    print(json.dumps({"tree": tree, "arch": arch, "shape": shape,
                      "wall_ms": walls,
                      "wall_ms_median": statistics.median(walls),
                      "device_ms": dev_us / 1e3,
                      "kernel_device_ms": kernel_ms,
                      "k6_launches_a_run": per_run}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""K6's split_kv route at phase 2's decode shapes over a range of split plans.

    python3 tools/splitkv_plans.py [tiles a split ...]

For seamless's cut cross-attention decode (``chip_smoke.K6_SERVED``'s
rows of 64 rows or fewer) and ``chip_smoke.K6_DECODE``, in bf16, and
its f32 decode at 16 heads over 128 frames (``K6_PHASE2``'s), runs
``flash_attention`` with ``split_kv_plan`` replaced by each plan of the
given tiles a split (default 1 to 128 in steps that double and
half-double, up to the call's tiles), and prints one JSON line a plan:
the splits, the blocks (B x Hkv x 64-row tiles x splits), the traced
device ms a call (``chip_smoke._traced_ms``: the split pass and the
merge each, as ``passes``) and the plan ``split_kv_plan`` itself
chooses at the wave the card holds (``splitkv_wave``), marked. Prints
the card's name and power limit first. Needs one CUDA card
and nvcc; the kernels are built into this checkout's
``src/repro_torch/kernels/build/``.
"""
import argparse
import json
import os
import subprocess
import sys

import torch

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(HERE, "src"))
sys.path.insert(1, HERE)

from chip_smoke import (K6_DECODE, K6_PHASE2, K6_SERVED,  # noqa: E402
                        _traced_ms)

from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402

PER = (1, 2, 3, 4, 6, 8, 12, 16, 24, 32, 48, 64, 96, 128)


def main():
    if not torch.cuda.is_available():
        print("splitkv_plans: no CUDA device is available", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip())
    ap = argparse.ArgumentParser()
    ap.add_argument("tiles", type=int, nargs="*")
    args = ap.parse_args()
    per_list = tuple(args.tiles) or PER
    _build.build()
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    shapes = [(*row, 0, torch.bfloat16) for row in K6_SERVED
              if row[2] <= 64]
    shapes += [(*row, torch.bfloat16) for row in K6_DECODE]
    shapes += [(row[0], *row[2:], 0, torch.float32) for row in K6_PHASE2
               if row[1] == "float32" and row[3] <= 64
               and (row[7], row[8]) in fa.SM90_HEAD_DIMS]
    chosen_plan = fa.split_kv_plan
    for (what, b, sq, skv, hq, hkv, d, dv, causal, window, off,
         dtype) in shapes:
        q, k, v = (torch.randn(s, generator=gen, device=dev).to(dtype)
                   for s in ((b, sq, hq, d), (b, skv, hkv, d),
                             (b, skv, hkv, dv)))
        call = (b, hq, hkv, sq, skv, causal, window, off)
        wave = fa.splitkv_wave(q.dtype, d, dv,
                               -(-min(hq // hkv * sq, 64) // 16))
        chosen = chosen_plan(*call, wave=wave)
        lo = max(0, off - window + 1) // 64 * 64 if window else 0
        hi = min(skv, off + sq) if causal else skv
        tiles = -(-(hi - lo) // 64)
        m_tiles = -(-(hq // hkv * sq) // 64)
        plans = sorted({(-(-tiles // p), p * 64) for p in per_list
                        if p <= tiles} | {chosen})
        for splits, per in plans:
            fa.split_kv_plan = lambda *a, plan=(splits, per), **k: plan
            try:
                ms, _, passes = _traced_ms(
                    lambda: fa.flash_attention(q, k, v, causal=causal,
                                               window=window, q_offset=off),
                    10, fa.flash_attention)
            finally:
                fa.split_kv_plan = chosen_plan
            print(json.dumps({"shape": what, "dtype": str(dtype)[6:],
                              "wave": wave, "tiles": tiles,
                              "splits": splits, "tiles_a_split": per // 64,
                              "blocks": b * hkv * m_tiles * splits,
                              "ms": ms, "passes": passes,
                              "chosen": (splits, per) == chosen}),
                  flush=True)
        del q, k, v
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""K6's blockwise backward in bf16 against the plain backward, in bf16 steps.

At the shapes of ``tests/test_torch_cuda.py``'s
``test_cuda_flash_attention_blockwise_backward_matches_plain`` (2 x 4096,
causal: tinyllama-1.1b's 32/4 heads of 64, hymba-1.5b's 25/5 with window
1024, MLA's 16 heads of 192/128), from three seeds, K6's forward with the
blockwise backward (``models.layers._attention_blockwise``, chunks of
1024 keys) and autograd through ``flash_attention_plain``, both on bf16
inputs, give the gradients for q, k and v of ``sum(out * w)``. For each
gradient it prints the largest |difference| over one bf16 step of the
plain gradient's largest |value| (``err_over_step``), and the plain bf16
gradient's and the blockwise one's largest |difference| from the plain
f32 gradient of the same inputs over that step (``plain_drift_over_step``,
``blockwise_drift_over_step``): the test holds ``err`` to one step.

    python3 tools/blockwise_bf16_steps.py

Needs one CUDA card and nvcc; the kernels are built into
``src/repro_torch/kernels/build/`` (ignored by git).
"""
from __future__ import annotations

import functools
import json
import math
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

from repro_torch.kernels.flash_attention import (  # noqa: E402
    flash_attention, flash_attention_plain)
from repro_torch.models.layers import _attention_blockwise  # noqa: E402

SHAPES = ((32, 4, 64, 64, 0), (25, 5, 64, 64, 1024), (16, 16, 192, 128, 0))


def main():
    dev = torch.device("cuda")
    backward = functools.partial(_attention_blockwise, q_offset=0,
                                 kv_len=None, chunk=1024)
    worst = 0.0
    for seed in range(3):
        rng = np.random.default_rng(seed)
        for hq, hkv, d, dv, window in SHAPES:
            def draw(*shape):
                return torch.from_numpy(rng.standard_normal(shape).astype(
                    np.float32)).to(dev)
            q32, k32, v32 = (draw(2, 4096, hq, d), draw(2, 4096, hkv, d),
                             draw(2, 4096, hkv, dv))
            w = draw(2, 4096, hq, dv).bfloat16().float()
            q, k, v = (t.bfloat16().requires_grad_()
                       for t in (q32, k32, v32))
            out = flash_attention(q, k, v, causal=True, window=window,
                                  backward=backward)
            got = torch.autograd.grad((out.float() * w).sum(), (q, k, v))
            ref = flash_attention_plain(q, k, v, causal=True, window=window)
            want = torch.autograd.grad((ref.float() * w).sum(), (q, k, v))
            wide = [t.detach().float().requires_grad_() for t in (q, k, v)]
            ref32 = flash_attention_plain(*wide, causal=True, window=window)
            want32 = torch.autograd.grad((ref32 * w).sum(), wide)
            row = {"seed": seed, "heads": f"{hq}/{hkv}", "d": f"{d}/{dv}",
                   "window": window}
            for name, g, e, e32 in zip("qkv", got, want, want32):
                step = 2.0 ** (math.floor(math.log2(
                    float(e.float().abs().max()))) - 7)
                err = float((g.float() - e.float()).abs().max()) / step
                row[f"d{name}"] = {
                    "err_over_step": err,
                    "plain_drift_over_step":
                        float((e.float() - e32).abs().max()) / step,
                    "blockwise_drift_over_step":
                        float((g.float() - e32).abs().max()) / step}
                worst = max(worst, err)
            print(f"[blockwise bf16] {json.dumps(row)}", flush=True)
            del out, got, ref, want, ref32, want32, wide
            torch.cuda.empty_cache()
    print(f"[blockwise bf16 worst] err_over_step={worst}")


if __name__ == "__main__":
    main()

"""Serving entry point: batched prefill + greedy decode of one request batch.

The serving-side host application: a batch of requests is prefilled
into the model's caches, then every sequence advances one token per
decode step. Prefill runs attention through K6 (dense, hybrid, MoE and
VLM models; MLA's at head dims 192/128) and the SSD scan through K7 (SSM
and hybrid models); decode is plain PyTorch over the caches. Runs on the
GPU unless ``--device cpu``.

As the reference's launcher, it feeds tokens alone: qwen2-vl then turns
by RoPE over positions (no image, no M-RoPE ids), and an enc-dec model
(seamless-m4t), whose encoder needs the frontend stub's frames, raises
``KeyError: 'enc_embeds'``. Those inputs are laid out by
``serve.inputs.model_inputs`` and go through ``prefill_step`` and
``decode_step(extra=)``, as ``chip_smoke.py`` phases 21 and 22 serve
them.

Usage::

  PYTHONPATH=src python -m repro_torch.launch.serve --arch tiny --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve --arch tinyllama-1.1b \\
      --requests 8 --prompt-len 512 --gen-len 32
  PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2-370m \\
      --requests 8 --prompt-len 512 --gen-len 32
  PYTHONPATH=src python -m repro_torch.launch.serve \\
      --arch deepseek-v2-lite-16b --requests 8 --prompt-len 512 --gen-len 32

SSM and hybrid models need a prompt length that is a multiple of
``min(chunk_size, prompt_len)``, as in the reference.
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from repro_torch._device import resolve_device, synchronize
from repro_torch.configs.registry import get_config
from repro_torch.models.transformer import init_caches, init_params
from repro_torch.serve.serve_step import decode_step, prefill_step



def run(arch: str, n_requests: int = 8, prompt_len: int = 32,
        gen_len: int = 16, max_seq: int = 128, seed: int = 0,
        device=None) -> dict:
    """Serve ``n_requests`` random prompts of ``prompt_len`` tokens for
    ``gen_len`` greedy tokens each, in f32, on ``device`` (``None`` -> the
    GPU). Returns the timings, the output shape and a finiteness check."""
    dev = resolve_device(device)
    cfg = get_config(arch)
    params = init_params(cfg, seed, device=dev)
    rng = np.random.default_rng(seed)

    batch = n_requests
    prompts = torch.from_numpy(rng.integers(
        0, cfg.vocab_size, size=(batch, prompt_len))).to(dev)

    caches = init_caches(cfg, batch, max_seq, torch.float32, device=dev)
    synchronize(dev)
    t0 = time.perf_counter()
    logits, caches = prefill_step(params, cfg, {"tokens": prompts}, caches)
    synchronize(dev)
    prefill_s = time.perf_counter() - t0

    tok = torch.argmax(logits[:, -1], dim=-1)[:, None]
    generated = [tok]
    t0 = time.perf_counter()
    for i in range(gen_len - 1):
        logits, caches = decode_step(params, cfg, tok, caches,
                                     prompt_len + i)
        tok = torch.argmax(logits[:, -1], dim=-1)[:, None]
        generated.append(tok)
    synchronize(dev)
    decode_s = time.perf_counter() - t0
    out = torch.cat(generated, dim=1)

    toks_per_s = batch * (gen_len - 1) / decode_s if decode_s > 0 else 0.0
    return {"arch": arch, "requests": batch, "device": str(dev),
            "prefill_s": prefill_s, "decode_s": decode_s,
            "decode_tokens_per_s": toks_per_s,
            "output_shape": list(out.shape),
            "no_nans": bool(torch.isfinite(logits).all())}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="tiny")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen-len", type=int, default=16)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU)")
    ap.add_argument("--out", default="")
    args = ap.parse_args()
    res = run(args.arch, args.requests, args.prompt_len, args.gen_len,
              max_seq=args.prompt_len + args.gen_len + 8,
              device=args.device)
    print(json.dumps(res, indent=1))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(res, f, indent=1)
    if not res["no_nans"]:
        raise SystemExit("non-finite logits")


if __name__ == "__main__":
    main()

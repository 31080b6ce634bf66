"""Where K7's ``chunk_scan`` pass spends its time: the pass timed with parts
of its work compiled out.

Each variant is ``src/repro_torch/kernels/csrc/ssd_scan.cu`` with one or
more pieces of ``ssd_scan_chunk_scan`` taken out by a text substitution,
built on its own for ``sm_90a`` with the port's nvcc flags (one nvcc per
variant, all started together) and loaded with ctypes beside the others:

* ``full``: the kernel as it stands;
* ``noexp``: w formed without ``expf`` (the masked ``rel`` in its place);
* ``nomma``: w.x's tensor-core products taken out (w is still formed and
  x still split, in shared memory);
* ``nointer``: C_i . S_prev taken out (neither the state nor C is loaded);
* ``nowork``: all three out: what is left is loading the tiles, forming w
  element by element and storing y.

A variant other than ``full`` computes nothing meaningful; its error
against the plain version is printed only to show that the part was
really gone. Each is timed at mamba2-370m's prefill shape (8 x 512, 32
heads of 64, d_state 128, chunk 256, seeded) in f32 and with a bf16 x, and
at hymba-1.5b's (50 heads, d_state 16): the whole call between CUDA
events, and each pass from a torch.profiler trace. Needs one CUDA card and
nvcc. Run from the repo root: ``python3 tools/k7_ablation.py``; the builds
land in ``src/repro_torch/kernels/build/k7_ablation/`` (ignored by git).
"""
from __future__ import annotations

import ctypes
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.ssd_scan import ssd_scan_plain, work_floats  # noqa: E402

SOURCE = _build.CSRC / "ssd_scan.cu"
OUT = _build.BUILD_DIR / "k7_ablation"

# (pattern, replacement) in ssd_scan_chunk_scan's text, each found once
NOEXP = (r"expf\(rel\)", "rel")
NOMMA = (r"mma3<true, !kExact>\(acc\[n\],[^;]*;", "")
NOINTER = (r"const bool inter_on = seeded \|\| bc % nc > 0;",
           "const bool inter_on = false;")
VARIANTS = {"full": (), "noexp": (NOEXP,), "nomma": (NOMMA,),
            "nointer": (NOINTER,), "nowork": (NOEXP, NOMMA, NOINTER)}

# (label, nh, d_state, x dtype)
SHAPES = (("mamba2 f32", 32, 128, torch.float32),
          ("mamba2 bf16 x", 32, 128, torch.bfloat16),
          ("hymba f32", 50, 16, torch.float32))
B, S, HD, CHUNK = 8, 512, 64, 256


def variant_source(subs) -> str:
    text = SOURCE.read_text()
    head, sep, kernel = text.partition("    ssd_scan_chunk_scan(")
    if not sep:
        raise RuntimeError("ssd_scan_chunk_scan not found in ssd_scan.cu")
    for pattern, repl in subs:
        kernel, n = re.subn(pattern, repl, kernel, count=1, flags=re.S)
        if n != 1:
            raise RuntimeError(f"{pattern!r} not found in chunk_scan")
    return head + sep + kernel


def build_all() -> dict:
    """Build every variant, in parallel; return name -> loaded library."""
    OUT.mkdir(parents=True, exist_ok=True)
    nvcc = _build._nvcc()
    procs = []
    for name, subs in VARIANTS.items():
        src = OUT / f"ssd_scan_{name}.cu"
        src.write_text(variant_source(subs))
        lib = OUT / f"libk7_{name}.so"
        cmd = [nvcc, *_build.NVCC_FLAGS, "-I", str(_build.CSRC), "-shared",
               str(src), "-o", str(lib)]
        procs.append((name, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    _build._run(procs)
    libs = {}
    for name in VARIANTS:
        lib = ctypes.CDLL(str(OUT / f"libk7_{name}.so"))
        lib.reconic_ssd_scan.argtypes = _build.SIGNATURES["reconic_ssd_scan"]
        lib.reconic_ssd_scan.restype = ctypes.c_int
        libs[name] = lib
    return libs


def inputs(nh, n, dtype, dev):
    rng = np.random.default_rng(0)
    f = np.float32

    def normal(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(f)).to(dev)

    x = normal(B, S, nh, HD).to(dtype)
    dt = torch.from_numpy(rng.uniform(0.1, 0.9, (B, S, nh)).astype(f)).to(dev)
    a = torch.from_numpy(-np.linspace(1.0, 16.0, nh).astype(f)).to(dev)
    return x, dt, a, normal(B, S, 1, n), normal(B, S, 1, n), normal(
        B, nh, HD, n)


def caller(lib, x, dt, a, bm, cm, init):
    """A zero-argument call of the variant, and its output y."""
    nh, n = x.shape[2], bm.shape[3]
    y = torch.empty_like(x)
    final = torch.empty((B, nh, HD, n), dtype=torch.float32, device=x.device)
    ws = torch.empty(work_floats(B, S, nh, HD, n, CHUNK),
                     dtype=torch.float32, device=x.device)
    args = (x.data_ptr(), dt.data_ptr(), a.data_ptr(), bm.data_ptr(),
            cm.data_ptr(), init.data_ptr(), y.data_ptr(), final.data_ptr(),
            ws.data_ptr(), ws.numel(), B, nh, S, HD, n, CHUNK,
            int(x.dtype == torch.bfloat16), _build.stream_ptr(x.device))

    def call():
        code = lib.reconic_ssd_scan(*args)
        if code:
            raise RuntimeError(f"reconic_ssd_scan: CUDA error {code}")
    return call, y


def event_ms(call, iters=20):
    call()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in "se")
    start.record()
    for _ in range(iters):
        call()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def pass_ms(call, iters=20):
    """Traced device ms per call of each ssd_scan_* pass."""
    call()
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            call()
            torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        m = re.search(r"\bssd_scan_(\w+?)\b(?=<|\()", e.key)
        if m and e.count:
            out[m.group(1)] = (out.get(m.group(1), 0.0)
                               + e.self_device_time_total / iters / 1e3)
    return out


def main():
    if not torch.cuda.is_available():
        print("k7_ablation: no CUDA device is available", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip(), flush=True)
    libs = build_all()
    for label, nh, n, dtype in SHAPES:
        x, dt, a, bm, cm, init = inputs(nh, n, dtype, dev)
        want, _ = ssd_scan_plain(x, dt, a, bm, cm, CHUNK, init)
        for name, lib in libs.items():
            call, y = caller(lib, x, dt, a, bm, cm, init)
            ms = event_ms(call)
            passes = pass_ms(call)
            err = (y.float() - want.float()).abs().max().item()
            print(f"{name:8s} {label:14s} call_ms={ms:.4f} "
                  + " ".join(f"{k}={v:.4f}" for k, v in sorted(
                      passes.items()))
                  + f" max_abs_err={err:.3g}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Where K6's wgmma kernel spends its time: the kernel timed with parts of
its work taken out or its layout changed.

Each variant is ``src/repro_torch/kernels/csrc/flash_attention_sm90.cu``
changed by a text substitution, built on its own for ``sm_90a`` with the
port's nvcc flags (one nvcc per variant, all started together) and loaded
with ctypes beside the others:

* ``full``: the kernel as it stands;
* ``nopingpong``: the two consumer warpgroups issue their wgmmas
  without taking turns;
* ``alwaysrescale``: O rescaled by every tile's alpha, also where every
  row's is 1;
* ``nosoftmax``: the online softmax of every tile after the first taken
  out (S goes to PV as it is): the products, the pipeline and P's split;
* ``singlep``: one PV product per k step (P_hi only), as a single bf16 P
  would cost;
* ``onestage``, ``stages3``, ``stages4``: one, three or four K and V
  stages in place of two (one: no load overlaps a product);
* ``d64bn64``, ``d64bn80``, ``d64bn128``: 64, 80 or 128 keys a stage at
  head dim 64 in place of 96;
* ``maxnreg``: ``__maxnreg__(168)`` in place of the launch bounds, with
  ``setmaxnreg`` giving the producer warpgroup 24 registers a thread and
  the consumers 240 (FlashAttention-3's split); ``maxnreg_bn128``: the
  same with 128 keys a stage at every head dim, which needs the
  consumers' 240. ptxas's report says whether the consumers got them.

``nosoftmax`` and ``singlep`` compute nothing meaningful; their error
against the plain version is printed only to show that the part was
really gone. Each is timed between CUDA events at the ``K6_SERVED`` shapes
of ``chip_smoke.py`` that go to the wgmma route, three calls after a warm-up,
beside the mma.sync kernel's time on the same inputs, and each variant's
``-Xptxas -v`` lines are printed, with the count of its ``HGMMA``
(wgmma), ``UTMALDG`` (TMA load) and ``STL`` (spill store) instructions
in the SASS that ``cuobjdump`` shows. Needs one CUDA card and nvcc. Run from
the repo root: ``python3 tools/k6_ablation.py [variants...] [shape
names...]`` (all of either by default); the
builds land in ``src/repro_torch/kernels/build/k6_ablation/`` (ignored by
git).
"""
from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

from chip_smoke import K6_SERVED  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402

SOURCE = _build.CSRC / "flash_attention_sm90.cu"
OUT = _build.BUILD_DIR / "k6_ablation"
ENTRY = "reconic_flash_attention_sm90"

# (text, replacement) in the source, each found at least once
NOSOFTMAX = ("        softmax(k_begin + j * BN);\n", "")
SINGLEP = ("    wgmma_rs<DV>(o, pl[kk], db);\n", "")
CASES = ("RECONIC_SM90_CASE(64, 64, 96, 2)",
         "RECONIC_SM90_CASE(128, 128, 64, 2)",
         "RECONIC_SM90_CASE(192, 128, 64, 2)")
STAGES = {n: tuple((c, c.replace(", 2)", f", {n})")) for c in CASES)
          for n in (1, 3, 4)}
D64_BN = {n: (CASES[0], f"RECONIC_SM90_CASE(64, 64, {n}, 2)")
          for n in (64, 80, 128)}
NOPINGPONG = ("constexpr bool kPingpong = true;",
              "constexpr bool kPingpong = false;")
ALWAYSRESCALE = ("        if (__any_sync(0xffffffffu, alpha[0] != 1.f || "
                 "alpha[1] != 1.f)) {", "        {")
MAXNREG = (("__launch_bounds__(kThreads, 1)", "__maxnreg__(168)"),
           ("    // ---- producer: one thread keeps the loads in flight\n",
            "    // ---- producer: one thread keeps the loads in flight\n"
            "    asm volatile(\"setmaxnreg.dec.sync.aligned.u32 24;\\n\");\n"),
           ("    // ---- consumers: 64 q rows each\n",
            "    // ---- consumers: 64 q rows each\n"
            "    asm volatile(\"setmaxnreg.inc.sync.aligned.u32 240;\\n\");\n"))
BN128 = tuple((c, c.replace(", 64, 2)", ", 128, 2)")
                .replace(", 96, 2)", ", 128, 2)")) for c in CASES)
VARIANTS = {"full": (), "nopingpong": (NOPINGPONG,),
            "alwaysrescale": (ALWAYSRESCALE,),
            "nosoftmax": (NOSOFTMAX,), "singlep": (SINGLEP,),
            "onestage": STAGES[1], "stages3": STAGES[3],
            "stages4": STAGES[4], "d64bn64": (D64_BN[64],),
            "d64bn80": (D64_BN[80],), "d64bn128": (D64_BN[128],),
            "maxnreg": MAXNREG, "maxnreg_bn128": (*MAXNREG, *BN128)}


def variant_source(subs) -> str:
    text = SOURCE.read_text()
    for old, new in subs:
        if old not in text:
            raise RuntimeError(f"{old!r} not found in {SOURCE.name}")
        text = text.replace(old, new)
    return text


def build_all(names) -> dict:
    """Build the named variants in parallel; return name -> (library,
    ptxas lines)."""
    OUT.mkdir(parents=True, exist_ok=True)
    nvcc = _build._nvcc()
    procs = []
    for name in names:
        src = OUT / f"flash_attention_sm90_{name}.cu"
        src.write_text(variant_source(VARIANTS[name]))
        cmd = [nvcc, *_build.NVCC_FLAGS, "-I", str(_build.CSRC), "-shared",
               str(src), "-o", str(OUT / f"libk6_{name}.so")]
        procs.append((name, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    log = _build._run(procs)
    out = {}
    for name in names:
        lib = ctypes.CDLL(str(OUT / f"libk6_{name}.so"))
        fn = getattr(lib, ENTRY)
        fn.argtypes = _build.SIGNATURES[ENTRY]
        fn.restype = ctypes.c_int
        part = log.split(f"== {name}\n")[1].split("\n== ")[0]
        out[name] = (fn, [ln.strip() for ln in part.splitlines()
                          if "registers" in ln or "spill" in ln
                          or "C75" in ln])
    return out


def event_ms(call, iters=3):
    call()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in "se")
    start.record()
    for _ in range(iters):
        call()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def main(argv):
    if not torch.cuda.is_available():
        print("k6_ablation: no CUDA device is available", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip(), flush=True)
    _build.build()
    names = [a for a in argv[1:] if a in VARIANTS] or list(VARIANTS)
    argv = [a for a in argv if a not in VARIANTS]
    built = build_all(names)
    cuobjdump = Path(_build._nvcc()).with_name("cuobjdump")
    for name, (_, lines) in built.items():
        for ln in lines:
            print(f"[ptxas {name}] {ln[-160:]}", flush=True)
        sass = subprocess.run(
            [str(cuobjdump), "--dump-sass", str(OUT / f"libk6_{name}.so")],
            capture_output=True, text=True).stdout
        print(f"[sass {name}] " + " ".join(
            f"{op}={sass.count(op)}" for op in ("HGMMA", "UTMALDG", "STL")),
            flush=True)
    shapes = [row for row in K6_SERVED
              if fa.flash_attention_route(torch.bfloat16, row[6], row[7],
                                          row[2]) == "wgmma"
              and (not argv[1:] or row[0] in argv[1:])]
    gen = torch.Generator(device=dev)
    gen.manual_seed(24)
    for what, b, sq, skv, hq, hkv, d, dv, causal, window in shapes:
        q, k, v = (torch.randn(shape, generator=gen, device=dev).bfloat16()
                   for shape in ((b, sq, hq, d), (b, skv, hkv, d),
                                 (b, skv, hkv, dv)))
        out = q.new_empty((b, sq, hq, dv))
        r0 = max(sq - 512, 0)
        want = fa.flash_attention_plain(q[:, r0:], k, v, causal=causal,
                                        window=window, q_offset=r0).float()
        scale = float(d ** -0.5)
        stream = _build.stream_ptr(dev)
        args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b,
                hq, hkv, sq, skv, d, dv, int(causal), int(window), scale,
                stream)
        line = {"mma_sync": event_ms(lambda: fa._launch(
            "mma_sync", q, k, v, out, causal, window, scale))}
        for name, (fn, _) in built.items():
            def call(fn=fn):
                code = fn(*args)
                if code:
                    raise RuntimeError(f"{name}: CUDA error {code}")
            try:
                line[name] = event_ms(call)
            except RuntimeError as e:
                print(f"[k6 ablation] {name}: {e}", flush=True)
                continue
            err = ((out[:, r0:].float() - want).abs()
                   / (2e-4 + 2.0 ** -7 * want.abs())).max().item()
            line[name + "_err_over_limit"] = err
        print(f"[k6 ablation] {what} " + " ".join(
            f"{key}={val:.4f}" for key, val in line.items()), flush=True)
        del q, k, v, out, want
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))

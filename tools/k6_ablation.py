"""Where K6's wgmma kernels spend their time: each kernel timed with parts
of its work taken out or its layout changed.

Each variant is ``src/repro_torch/kernels/csrc/flash_attention_sm90.cu``
(bf16) or, for the variants named ``tf32_*``,
``flash_attention_sm90_tf32.cu`` (f32, 3xTF32), changed by a text
substitution, built on its own for ``sm_90a`` with the port's nvcc flags
(one nvcc per variant, all started together) and loaded with ctypes
beside the others. The bf16 kernel's variants:

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

The TF32 kernel's:

* ``tf32_full``: the kernel as it stands;
* ``tf32_nosoftmax``: the online softmax of every tile after the first
  taken out;
* ``tf32_onestage``: one K and one V stage;
* ``tf32_prepass``: the pre-pass alone (K's hi and lo, V transposed),
  and ``tf32_noprepass``: the attention kernel alone, on scratch the
  pre-pass never wrote;
* ``tf32_1x``: one TF32 product in QK^T and in PV (hi by hi), as a
  single TF32 ``wgmma`` would cost: timing only, it misses the f32
  contract;
* ``tf32_headsfirst``, ``tf32_tilesfirst``: the blocks ordered heads
  first (each head's q tiles a grid of heads apart, as the bf16 kernel
  orders them) or a head's q tiles side by side, at every GQA group (the
  kernel takes the first under GQA, the second without);
* ``tf32_rnahi``: K's hi part rounded (``cvt.rna``) by the pre-pass
  into scratch of its own, K's lo part the rest rounded, in place of K
  itself as the hi part (which the tensor cores read by dropping its
  low 13 bits): the error shows that they truncate, the time what
  writing K_hi cost;
* ``tf32_klo_onchip``: K's lo part made on chip, by the consumer
  warpgroup from each K stage that TMA brought in (then
  ``fence.proxy.async``), in place of the pre-pass's;
* ``tf32_visible``: QK^T's shared-memory addresses left visible to the
  compiler, which then keeps the descriptors of every k step in
  registers from one tile to the next;
* ``tf32_qsplit1``: the split of Q * scale in a loop not unrolled;
* ``tf32_d64bn64``: head dim 64 with 64-key stages (one block an SM);
  ``tf32_d128bn64``: head dim 128 with 64-key stages, one each of K and
  V.

``nosoftmax``, ``singlep``, ``tf32_*softmax``, ``tf32_*prepass`` and
``tf32_1x`` compute nothing meaningful; their error against the plain
version is printed only to show that the part was really gone. Each bf16
variant is timed between CUDA events at the ``K6_SERVED`` shapes of
``chip_smoke.py`` that go to the wgmma route, each TF32 variant at the f32
``K6_PHASE2`` shapes over 64 rows at the wgmma head dims, three calls
after a warm-up, beside the mma.sync kernel's time on the same inputs,
and each variant's ``-Xptxas -v`` lines are printed, with the count of
its ``HGMMA`` (wgmma), ``UTMALDG`` (TMA load) and ``STL`` (spill store)
instructions in the SASS that ``cuobjdump`` shows. Needs one CUDA card
and nvcc. Run from the repo root: ``python3 tools/k6_ablation.py
[variants...] [shape names...]`` (all of either by default); the builds
land in ``src/repro_torch/kernels/build/k6_ablation/`` (ignored by git).
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

from chip_smoke import K6_PHASE2, K6_SERVED  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402

SOURCE = _build.CSRC / "flash_attention_sm90.cu"
SOURCE_TF32 = _build.CSRC / "flash_attention_sm90_tf32.cu"
OUT = _build.BUILD_DIR / "k6_ablation"
ENTRY = "reconic_flash_attention_sm90"
ENTRY_TF32 = "reconic_flash_attention_sm90_tf32"

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
TF32_CASES = ("RECONIC_TF32_CASE(64, 64, 32, 2, 2)",
              "RECONIC_TF32_CASE(128, 128, 32, 2, 2)",
              "RECONIC_TF32_CASE(192, 128, 32, 2, 1)")
TF32_QK = ("    wgmma_ss<BN>(s, desc_k_major(ql + qo), bh, kk > 0);\n"
           "    wgmma_ss<BN>(s, ah, desc_k_major(kl + ko), 1);\n"
           "    wgmma_ss<BN>(s, ah, bh, 1);\n",
           "    wgmma_ss<BN>(s, ah, bh, kk > 0);\n")
TF32_PV = ("    wgmma_rs<DV>(pv, pl[kk], bh, kk > 0);\n"
           "    wgmma_rs<DV>(pv, ph[kk], desc_k_major(vl + vo), 1);\n"
           "    wgmma_rs<DV>(pv, ph[kk], bh, 1);\n",
           "    wgmma_rs<DV>(pv, ph[kk], bh, kk > 0);\n")
TF32_ORDER = ("group > 1 ? blockIdx.x / n_bh : blockIdx.x % n_qt",
              "group > 1 ? blockIdx.x % n_bh : blockIdx.x / n_qt")
TF32_HEADS_FIRST = ((TF32_ORDER[0], "blockIdx.x / n_bh"),
                    (TF32_ORDER[1], "blockIdx.x % n_bh"))
TF32_TILES_FIRST = ((TF32_ORDER[0], "blockIdx.x % n_qt"),
                    (TF32_ORDER[1], "blockIdx.x / n_qt"))
TF32_VISIBLE = ((
    '  asm volatile("" : "+r"(qh), "+r"(ql), "+r"(kh), "+r"(kl));\n', ""),)
# K's hi part rounded by the pre-pass into scratch past V's (which the tool
# allocates), as the route's first version made it
TF32_RNA_HI = (
    ("                               float* __restrict__ klo,\n",
     "                               float* __restrict__ klo,\n"
     "                               float* __restrict__ khi,\n"),
    ("    float4 lo, rest;\n"
     "    split4(make_float4(x.x - trunc_tf32(x.x), x.y - trunc_tf32(x.y),\n"
     "                       x.z - trunc_tf32(x.z), x.w - trunc_tf32(x.w)),\n"
     "           lo, rest);\n",
     "    float4 lo, rest;\n"
     "    split4(x, rest, lo);\n"
     "    *reinterpret_cast<float4*>(khi + off) = rest;\n"),
    ("  float* vtl = vth + sc.vt_words;\n",
     "  float* vtl = vth + sc.vt_words;\n"
     "  float* khi = vtl + sc.vt_words;\n"),
    ("            k, v, klo, vth, vtl, hkv, skv, skv8);",
     "            k, v, klo, khi, vth, vtl, hkv, skv, skv8);"),
    ("make_map(&tkh, k, {DQK", "make_map(&tkh, khi, {DQK"))
# K's lo part made on chip: the pre-pass skips K, TMA brings K alone into
# each stage, and the consumer warpgroup writes its lo part beside it
TF32_KLO_ON_CHIP = (
    ("    if (k0 + j >= skv) break;\n", "    break;\n"),
    ("// ---- the pre-pass: K's and V^T's hi and lo",
     "// K's lo part of a stage, written by the consumer warpgroup for wgmma\n"
     "__device__ __forceinline__ void split_k(unsigned char* hi, int bytes) {\n"
     "  float4* h = reinterpret_cast<float4*>(hi);\n"
     "  float4* l = reinterpret_cast<float4*>(hi + bytes);\n"
     "  for (int i = threadIdx.x; i < bytes / 16; i += 128) {\n"
     "    const float4 x = h[i];\n"
     "    float4 lo, rest;\n"
     "    split4(make_float4(x.x - trunc_tf32(x.x), x.y - trunc_tf32(x.y),\n"
     "                       x.z - trunc_tf32(x.z), x.w - trunc_tf32(x.w)),\n"
     "           lo, rest);\n"
     "    l[i] = lo;\n"
     "  }\n"
     "  asm volatile(\"fence.proxy.async.shared::cta;\\n\" ::: \"memory\");\n"
     "  asm volatile(\"bar.sync 1, 128;\\n\" ::: \"memory\");\n"
     "}\n\n"
     "// ---- the pre-pass: K's and V^T's hi and lo"),
    ("      mbar_expect_tx(k_full + 8 * st, 2 * C::kKHalf);",
     "      mbar_expect_tx(k_full + 8 * st, C::kKHalf);"),
    ("        tma_load(hi + C::kKHalf + off, mkl, k_full + 8 * st, a * 32,"
     " hk,\n                 k_begin + j * BN, b);\n", ""),
    ("    mbar_wait(k_full, 0);\n",
     "    mbar_wait(k_full, 0);\n"
     "    split_k(sbase + (k_hi(0) - base), C::kKHalf);\n"),
    ("      mbar_wait(k_full + 8 * st, (j / SK) & 1);\n",
     "      mbar_wait(k_full + 8 * st, (j / SK) & 1);\n"
     "      split_k(sbase + (k_hi(st) - base), C::kKHalf);\n"))
TF32_VARIANTS = {
    "tf32_full": (),
    "tf32_nosoftmax": (("      softmax(k_begin + j * BN);\n", ""),),
    "tf32_onestage": tuple(
        (c, c.replace(", 2, 2)", ", 1, 1)").replace(", 2, 1)", ", 1, 1)"))
        for c in TF32_CASES),
    "tf32_prepass": (("  kern<<<", "  if (0) kern<<<"),),
    "tf32_noprepass": (("    flash_attention_tf32_split<DQK, DV>\n",
                        "    if (0) flash_attention_tf32_split<DQK, DV>\n"),),
    "tf32_1x": (TF32_QK, TF32_PV),
    "tf32_headsfirst": TF32_HEADS_FIRST,
    "tf32_tilesfirst": TF32_TILES_FIRST,
    "tf32_visible": TF32_VISIBLE,
    "tf32_rnahi": TF32_RNA_HI,
    "tf32_klo_onchip": TF32_KLO_ON_CHIP,
    "tf32_qsplit1": (("#pragma unroll 4\n    for (int i = threadIdx.x;",
                      "#pragma unroll 1\n    for (int i = threadIdx.x;"),),
    "tf32_d64bn64": ((TF32_CASES[0], "RECONIC_TF32_CASE(64, 64, 64, 2, 2)"),),
    "tf32_d128bn64": ((TF32_CASES[1],
                       "RECONIC_TF32_CASE(128, 128, 64, 1, 1)"),),
}
VARIANTS = {"full": (), "nopingpong": (NOPINGPONG,),
            "alwaysrescale": (ALWAYSRESCALE,),
            "nosoftmax": (NOSOFTMAX,), "singlep": (SINGLEP,),
            "onestage": STAGES[1], "stages3": STAGES[3],
            "stages4": STAGES[4], "d64bn64": (D64_BN[64],),
            "d64bn80": (D64_BN[80],), "d64bn128": (D64_BN[128],),
            "maxnreg": MAXNREG, "maxnreg_bn128": (*MAXNREG, *BN128),
            **TF32_VARIANTS}


def is_tf32(name: str) -> bool:
    return name.startswith("tf32_")


def variant_source(name) -> str:
    source = SOURCE_TF32 if is_tf32(name) else SOURCE
    text = source.read_text()
    for old, new in VARIANTS[name]:
        if old not in text:
            raise RuntimeError(f"{old!r} not found in {source.name}")
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
        src.write_text(variant_source(name))
        cmd = [nvcc, *_build.NVCC_FLAGS, "-I", str(_build.CSRC), "-shared",
               str(src), "-o", str(OUT / f"libk6_{name}.so")]
        procs.append((name, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    log = _build._run(procs)
    out = {}
    for name in names:
        lib = ctypes.CDLL(str(OUT / f"libk6_{name}.so"))
        entry = ENTRY_TF32 if is_tf32(name) else ENTRY
        fn = getattr(lib, entry)
        fn.argtypes = _build.SIGNATURES[entry]
        fn.restype = ctypes.c_int
        part = log.split(f"== {name}\n")[1].split("\n== ")[0]
        out[name] = (fn, [ln.strip() for ln in part.splitlines()
                          if "registers" in ln or "spill" in ln
                          or "C75" in ln or "entry function" in ln])
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
    shapes = [(torch.bfloat16, row) for row in K6_SERVED
              if fa.flash_attention_route(torch.bfloat16, row[6], row[7],
                                          row[2]) == "wgmma"
              and not all(map(is_tf32, names))]
    shapes += [(torch.float32, (what, *rest))
               for what, dname, *rest in K6_PHASE2
               if dname == "float32" and rest[1] > 64
               and (rest[5], rest[6]) in fa.SM90_HEAD_DIMS
               and any(map(is_tf32, names))]
    shapes = [(dtype, row) for dtype, row in shapes
              if not argv[1:] or row[0] in argv[1:]]
    gen = torch.Generator(device=dev)
    gen.manual_seed(24)
    for dtype, (what, b, sq, skv, hq, hkv, d, dv, causal, window) in shapes:
        tf32 = dtype == torch.float32
        q, k, v = (torch.randn(shape, generator=gen, device=dev).to(dtype)
                   for shape in ((b, sq, hq, d), (b, skv, hkv, d),
                                 (b, skv, hkv, dv)))
        out = q.new_empty((b, sq, hq, dv))
        r0 = max(sq - 512, 0)
        want = fa.flash_attention_plain(q[:, r0:], k, v, causal=causal,
                                        window=window, q_offset=r0).float()
        scale = float(d ** -0.5)
        stream = _build.stream_ptr(dev)
        ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr())
        dims = (b, hq, hkv, sq, skv, d, dv, int(causal), int(window), 0,
                scale, stream)
        # room past the route's scratch for tf32_rnahi's K_hi
        scratch = torch.empty(fa.tf32_scratch_words(b, skv, hkv, d, dv)
                              + b * skv * hkv * d,
                              device=dev) if tf32 else None
        args = ((*ptrs, scratch.data_ptr(), scratch.numel(), *dims) if tf32
                else (*ptrs, *dims))
        # f32: the reference's 2e-4; bf16 also one bf16 step of the result
        rel = 0.0 if tf32 else 2.0 ** -7
        line = {"mma_sync": event_ms(lambda: fa._launch(
            "mma_sync", q, k, v, out, causal, window, scale))}
        for name, (fn, _) in built.items():
            if is_tf32(name) != tf32:
                continue

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
                   / (2e-4 + rel * want.abs())).max().item()
            line[name + "_err_over_limit"] = err
        print(f"[k6 ablation] {what} {str(dtype)[6:]} " + " ".join(
            f"{key}={val:.4f}" for key, val in line.items()), flush=True)
        del q, k, v, out, want, scratch
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))

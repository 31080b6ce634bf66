"""K6's error against float64 as the key count grows, and its times.

For one sequence at tinyllama-1.1b's heads (32 q heads over 4 kv heads of
64, causal) and 512, 4096 and 32768 keys, the last 64 query rows of K6
(``flash_attention``) and of its plain f32 version are held against the
same attention computed in float64, in f32 and on bf16 inputs: the largest
|error| over the largest |value| of the float64 output (bf16 takes the
wgmma route where the tree has one, f32 on the TF32 wgmma route where it
has that). Then K6 in f32 is timed at the f32 shapes of this checkout's
``chip_smoke.py`` phase 2 (``K6_PHASE2``) and at 32768 keys, and K6 in
bf16 at its ``K6_SERVED`` shapes, these beside
``scaled_dot_product_attention`` on its flash or efficient backend (K and
V repeated to the q heads, a window as a boolean mask), each with the
route the call took: ``ms`` between CUDA events around back-to-back calls
and ``device_ms`` the K6 kernels' own time per call, traced (CUPTI) with
each call run alone. Where the tree has the TF32 wgmma route, f32 calls of
65 to 128 query rows (seamless's encoder and the served head dims) are
launched on it and on mma.sync directly and timed both ways, the numbers
``flash_attention_route`` sends those calls to mma.sync by.

The tree whose kernels are built and run is the one given as the first
argument (default: this checkout), so that two trees can be compared in
one call on the same card, each in a process of its own:

    python3 tools/k6_drift.py                 # this checkout
    python3 tools/k6_drift.py path/to/other   # another checkout

Needs one CUDA card and nvcc; the kernels are built into the tree's
``src/repro_torch/kernels/build/`` (ignored by git).
"""
from __future__ import annotations

import os
import sys

import torch

HERE = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
ROOT = os.path.abspath(sys.argv[1] if len(sys.argv) > 1 else HERE)
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(1, HERE)

from chip_smoke import K6_PHASE2, K6_SERVED, _traced_ms  # noqa: E402

from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.flash_attention import (  # noqa: E402
    flash_attention, flash_attention_plain)

# phase 2's f32 shapes, then one sequence of 32768 at tinyllama's heads:
# (B, Sq, Skv, Hq, Hkv, d, dv, causal, window)
F32_SHAPES = (*(tuple(row[2:]) for row in K6_PHASE2 if row[1] == "float32"),
              (1, 32768, 32768, 32, 4, 64, 64, True, 0))
# f32 calls of 65 to 128 rows, timed on both f32 routes: seamless's encoder
# (128 frames) at 128 and 65 rows, and the served head dims at 128 rows
SHORT_F32_SHAPES = ((8, 128, 128, 16, 16, 64, 64, False, 0),
                    (8, 65, 65, 16, 16, 64, 64, False, 0),
                    (8, 128, 128, 32, 4, 64, 64, True, 0),
                    (8, 128, 128, 28, 4, 128, 128, True, 0),
                    (8, 128, 128, 16, 16, 192, 128, True, 0))


def exact(q, k, v, r0):
    """Causal attention of q's rows (at offset ``r0``) in float64."""
    b, sq, hq, d = q.shape
    hkv = k.shape[2]
    qg = q.double().reshape(b, sq, hkv, hq // hkv, d) * d ** -0.5
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg, k.double())
    seen = (r0 + torch.arange(sq, device=q.device)[:, None]
            >= torch.arange(k.shape[1], device=q.device)[None])
    s = torch.where(seen, s, torch.full_like(s, -1e300))
    out = torch.einsum("bhgqk,bkhd->bqhgd", torch.softmax(s, -1), v.double())
    return out.reshape(b, sq, hq, -1)


def event_ms(fn, iters):
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    t0.record()
    for _ in range(iters):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / iters


def reset_routes():
    for r in getattr(flash_attention, "route_launches", {}):
        flash_attention.route_launches[r] = 0


def route_of(fn):
    """The route the calls of ``fn`` since ``reset_routes`` took
    ("mma_sync" on a tree that has no other)."""
    routes = getattr(fn, "route_launches", None)
    if routes is None:
        return "mma_sync"
    return max(routes, key=routes.get)


def served_bf16(dev, gen):
    """K6 and SDPA in bf16 at each ``K6_SERVED`` shape, 3 calls each."""
    from torch.nn.attention import SDPBackend, sdpa_kernel
    sdpa = torch.nn.functional.scaled_dot_product_attention
    for what, b, sq, skv, hq, hkv, d, dv, causal, window in K6_SERVED:
        q = torch.randn((b, sq, hq, d), generator=gen, device=dev).bfloat16()
        k = torch.randn((b, skv, hkv, d), generator=gen,
                        device=dev).bfloat16()
        v = torch.randn((b, skv, hkv, dv), generator=gen,
                        device=dev).bfloat16()
        reset_routes()

        def call():
            return flash_attention(q, k, v, causal=causal, window=window)

        ms = event_ms(call, 10)
        route = route_of(flash_attention)
        device = _traced_ms(call, 3, flash_attention)[0]
        qt = q.transpose(1, 2).contiguous()
        kt, vt = (t.repeat_interleave(hq // hkv, dim=2).transpose(1, 2)
                  .contiguous() for t in (k, v))
        mask = None
        if window:
            i = torch.arange(skv, device=dev)
            mask = (i[:, None] >= i[None, :]) & (i[:, None] - i[None, :]
                                                 < window)

        def library():
            with sdpa_kernel([SDPBackend.FLASH_ATTENTION,
                              SDPBackend.EFFICIENT_ATTENTION]):
                if mask is not None:
                    return sdpa(qt, kt, vt, attn_mask=mask)
                return sdpa(qt, kt, vt, is_causal=causal)

        sdpa_ms = event_ms(library, 3)
        print(f"[k6 bf16 time] what={what!r} route={route} ms={ms} "
              f"device_ms={device} sdpa_ms={sdpa_ms}", flush=True)
        del q, k, v, qt, kt, vt, mask
        torch.cuda.empty_cache()


def main():
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    _build.build(force=True)
    _build.library()
    print("tree", ROOT, flush=True)
    gen = torch.Generator(device=dev)
    gen.manual_seed(5)
    for dtype in (torch.float32, torch.bfloat16):
        for s in (512, 4096, 32768):
            q, k, v = (torch.randn((1, s, h, 64), generator=gen, device=dev)
                       .to(dtype) for h in (32, 4, 4))
            r0 = s - 64
            want = exact(q[:, r0:], k, v, r0)
            scale = want.abs().max().item()
            reset_routes()
            got = flash_attention(q, k, v, causal=True)[:, r0:]
            plain = flash_attention_plain(q[:, r0:], k, v, causal=True,
                                          q_offset=r0)
            print(f"[k6 drift] dtype={str(dtype)[6:]} keys={s} "
                  f"route={route_of(flash_attention)} "
                  f"k6_rel={(got.double() - want).abs().max().item() / scale} "
                  f"plain_rel="
                  f"{(plain.double() - want).abs().max().item() / scale}",
                  flush=True)
    for b, sq, skv, hq, hkv, d, dv, causal, window in F32_SHAPES:
        q = torch.randn((b, sq, hq, d), generator=gen, device=dev)
        k = torch.randn((b, skv, hkv, d), generator=gen, device=dev)
        v = torch.randn((b, skv, hkv, dv), generator=gen, device=dev)
        reset_routes()

        def call():
            return flash_attention(q, k, v, causal=causal, window=window)

        iters = 20 if sq < 32768 else 3
        ms = event_ms(call, iters)
        route = route_of(flash_attention)
        device = _traced_ms(call, iters, flash_attention)[0]
        print(f"[k6 f32 time] shape={b}x{sq}/{skv}x{hq}/{hkv}x{d}/{dv} "
              f"causal={causal} window={window} route={route} ms={ms} "
              f"device_ms={device}", flush=True)
    served_bf16(dev, gen)
    short_f32_routes(dev, gen)


def short_f32_routes(dev, gen):
    """Both f32 routes at ``SHORT_F32_SHAPES``, launched directly, 20 calls
    each way; nothing on a tree without the TF32 wgmma route."""
    from repro_torch.kernels import flash_attention as fa
    if "wgmma_tf32" not in getattr(fa, "ROUTES", ()):
        return
    for b, sq, skv, hq, hkv, d, dv, causal, window in SHORT_F32_SHAPES:
        q = torch.randn((b, sq, hq, d), generator=gen, device=dev)
        k = torch.randn((b, skv, hkv, d), generator=gen, device=dev)
        v = torch.randn((b, skv, hkv, dv), generator=gen, device=dev)
        out = q.new_empty((b, sq, hq, dv))
        want = flash_attention_plain(q, k, v, causal=causal, window=window)
        line = []
        for route in ("mma_sync", "wgmma_tf32"):
            def call(route=route):
                fa._launch(route, q, k, v, out, causal, window, d ** -0.5)

            call()
            err = (out - want).abs().max().item()
            line.append(f"{route}_ms={event_ms(call, 20)} "
                        f"{route}_device_ms="
                        f"{_traced_ms(call, 20, flash_attention)[0]} "
                        f"{route}_err={err}")
        route = fa.flash_attention_route(q.dtype, d, dv, sq)
        print(f"[k6 f32 short] shape={b}x{sq}/{skv}x{hq}/{hkv}x{d}/{dv} "
              f"causal={causal} route={route} " + " ".join(line), flush=True)


if __name__ == "__main__":
    main()

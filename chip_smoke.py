"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``src/repro_torch/kernels/csrc`` and
runs, on the card:

  1. the card's name and power limit (``nvidia-smi``);
  2. each kernel against its plain PyTorch version at the shapes the main
     path gives it — bit-exact for quantize, dequantize and parse, within
     ``1e-5 * k / 128`` for the f32 matmul (no TF32) — with its time, the
     plain version's time, its bound and, for the matmul, the time of
     ``torch.matmul`` (the yardstick; the port never calls it);
  3-6. the RecoNIC main path with every launch counter at 0 first: the
     Fig 6 networked matmul (2048^3 and the ``lc_offload_mm`` shape
     512x16x512) through ``RDMAEngine`` + ``LookasideBlock`` +
     ``register_default_kernels`` on a 2 x 2^26-word pool, a
     ``PARSER_WORKLOAD`` over 4096 packets, 1024 slots quantized by
     32-slot ``STREAM_QUANT_WORKLOAD`` messages and decompressed, and the
     ``read_batch_16k`` / ``dma_64mib`` READs;
  7. each kernel's launch count on that path, which must be > 0.

Any mismatch raises, so the exit code is not 0. The second-to-last line
is the kernels' JSON record, the last ``{"ok": true, "device": ...}``.
Without a CUDA device it exits with an error before printing a result.
"""
import json
import os
import re
import subprocess
import sys
import time

import numpy as np
import torch

# H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s, f32 FLOP/s outside
# the tensor cores. A card below its 700 W limit runs slower than this.
PEAK_BYTES_S = 3.35e12
PEAK_F32_FLOPS = 67e12

POOL = 1 << 26
DATA_PEER, LC_PEER = 1, 0
SEED = 0


def cuda_ms(fn, iters=20, warmup=3):
    """Mean time per call of ``fn`` over ``iters`` back-to-back calls,
    between CUDA events: device time, or the host's launch rate where
    that is slower."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, iters=20):
    """GPU time per call of ``fn``: the smaller of two readings.

    * The summed device time of the kernels and copies it launches,
      traced by torch.profiler (CUPTI), each call run alone: leaves out
      the host's launch overhead, but overstates calls whose kernels
      overlap (cuBLAS's f32 GEMM traced about twice its event time on an
      H100).
    * ``cuda_ms``: events around back-to-back calls, exact for device-
      bound calls, the host's launch rate for small ones.
    """
    return min(_traced_ms(fn, iters), cuda_ms(fn, iters))


def _traced_ms(fn, iters):
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(iters):
            fn()
            torch.cuda.synchronize()
    total_us = sum(e.self_device_time_total for e in prof.key_averages())
    check(total_us > 0, "the profiler traced no device time")
    return total_us / iters / 1e3


def bound(nbytes, flops=0.0):
    """(bound_ms, bound_by): the larger of bytes over HBM rate and f32
    operations over the f32 peak."""
    t_bytes = nbytes / PEAK_BYTES_S * 1e3
    t_ops = flops / PEAK_F32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def check(ok, what):
    if not ok:
        raise AssertionError(what)


def phase(name, **nums):
    print(f"[{name}] " + " ".join(f"{k}={v}" for k, v in nums.items()),
          flush=True)


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(
        __file__)), "src"))
    from repro_torch.core.lookaside import ControlMsg, LookasideBlock
    from repro_torch.core.rdma import Opcode, Placement, RDMAEngine, WQE
    from repro_torch.core.rdma.transport import (_exec_descriptors_local,
                                                 pack_descriptors)
    from repro_torch.kernels import _build, ops
    from repro_torch.kernels import lc_offload as lco
    from repro_torch.kernels.packet_parser import (parse_packets,
                                                   parse_packets_plain)
    from repro_torch.kernels.quantize_stream import (
        dequantize_stream, dequantize_stream_plain, quantize_stream,
        quantize_stream_plain)
    from repro_torch.kernels.systolic_mm import systolic_mm, systolic_mm_plain

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    rng = np.random.default_rng(SEED)

    # ---- 1. the card -----------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    phase("env", torch=torch.__version__, cuda=torch.version.cuda,
          device=json.dumps(torch.cuda.get_device_name(0)))

    t0 = time.perf_counter()
    built = _build.build(force=True)
    _build.library()
    phase("build", seconds=f"{time.perf_counter() - t0:.2f}",
          nvcc_seconds=f"{built.seconds:.2f}")
    for line in built.log.splitlines():       # ptxas per-kernel report
        if ("entry function" in line or "registers" in line
                or re.search(r"[1-9][0-9]* bytes spill", line)):
            print("  " + line.strip())

    # ---- 2. each kernel against its plain version ------------------------
    rec = {}
    csrc = "src/repro_torch/kernels/csrc/"

    def measure(name, src, replaces, shape, err, fn, plain, nbytes,
                flops=0.0, library=None):
        """Time kernel, plain version and library call; print and record
        (the last shape measured per kernel is the one recorded)."""
        b = bound(nbytes, flops)
        r = {"name": name, "route": "cuda", "source": csrc + src,
             "replaces": replaces, "shape": shape, "max_abs_err": err,
             "ms": device_ms(fn), "plain_ms": device_ms(plain),
             "bound_ms": b[0], "bound_by": b[1],
             "library_ms": device_ms(library) if library else None,
             "call_ms": cuda_ms(fn), "plain_call_ms": cuda_ms(plain)}
        phase("kernel " + name, **{k: v for k, v in r.items()
                                   if k not in ("name", "route", "source",
                                                "replaces")})
        rec[name] = r

    for m, k, n in ((512, 16, 512), (2048, 2048, 2048)):
        x = torch.from_numpy(rng.standard_normal((m, k), np.float32)).to(dev)
        y = torch.from_numpy(rng.standard_normal((k, n), np.float32)).to(dev)
        got, want = systolic_mm(x, y), systolic_mm_plain(x, y)
        tol = 1e-5 * k / 128
        err = (got - want).abs()
        check(bool((err <= tol + tol * want.abs()).all()),
              f"systolic_mm {m}x{k}x{n}: max err {err.max().item()} "
              f"over tolerance {tol}")
        measure("systolic_mm", "systolic_mm.cu",
                "src/repro/kernels/systolic_mm.py:50", f"{m}x{k}x{n}",
                err.max().item(), lambda: systolic_mm(x, y),
                lambda: systolic_mm_plain(x, y),
                4 * (m * k + k * n + m * n), 2.0 * m * k * n,
                library=lambda: torch.matmul(x, y))

    pkts_np = rng.integers(0, 256, size=(4096, 64)).astype(np.uint8)
    pkts_np[::2, 12:14] = [0x08, 0x00]
    pkts_np[::2, 23] = 17
    pkts_np[::2, 36:38] = [18, 183]
    pkts_np[::2, 42] = rng.integers(0, 20, size=2048)
    pk = torch.from_numpy(pkts_np).to(dev)
    check(torch.equal(parse_packets(pk), parse_packets_plain(pk)),
          "parse_packets differs from its plain version")
    measure("parse_packets", "packet_parser.cu",
            "src/repro/kernels/packet_parser.py:92", "4096x64", 0.0,
            lambda: parse_packets(pk), lambda: parse_packets_plain(pk),
            4096 * (64 + 16))

    for n, chunk in ((32, 64), (1024, 64), (4096, 1024)):
        x = torch.from_numpy((rng.standard_normal((n, chunk)) * rng.uniform(
            0.01, 100, (n, 1))).astype(np.float32)).to(dev)
        x[n // 2] = 0.0
        q, s = quantize_stream(x, chunk=chunk)
        pq, ps = quantize_stream_plain(x)
        check(torch.equal(q, pq) and torch.equal(s, ps),
              f"quantize_stream {n}x{chunk} is not bit-exact")
        measure("quantize_stream", "quantize_stream.cu",
                "src/repro/kernels/quantize_stream.py:51", f"{n}x{chunk}",
                0.0, lambda: quantize_stream(x, chunk=chunk),
                lambda: quantize_stream_plain(x),
                n * chunk * (4 + 1) + 4 * n, 4.0 * n * chunk)
        check(torch.equal(dequantize_stream(q, s),
                          dequantize_stream_plain(q, s)),
              f"dequantize_stream {n}x{chunk} is not bit-exact")
        check(torch.equal(dequantize_stream(q, s, out_dtype=torch.bfloat16),
                          dequantize_stream_plain(q, s, torch.bfloat16)),
              f"dequantize_stream bf16 {n}x{chunk} is not bit-exact")
        measure("dequantize_stream", "quantize_stream.cu",
                "src/repro/kernels/quantize_stream.py:70", f"{n}x{chunk}",
                0.0, lambda: dequantize_stream(q, s),
                lambda: dequantize_stream_plain(q, s),
                n * chunk * (1 + 4) + 4 * n, 1.0 * n * chunk)
    del x, y, q, s, pq, ps

    # ---- 3-6. the main path ----------------------------------------------
    counted = (systolic_mm, parse_packets, quantize_stream,
               dequantize_stream)
    for fn in counted:
        fn.launches = 0

    eng = RDMAEngine(n_peers=2, pool_size=POOL)
    check(eng.pool.device.type == "cuda", "pool is not on the card")
    mm_blk = LookasideBlock(eng, peer=LC_PEER, scratch_base=POOL // 2)
    lco.register_default_kernels(mm_blk)
    # the stream handlers ride a block of their own, pipelined 4 deep
    # (the streaming_rx case) over another scratch region, write-backs
    # left armed so they share flushes with the next fetches
    st_blk = LookasideBlock(eng, peer=LC_PEER, scratch_base=POOL // 4,
                            scratch_size=POOL // 4, pipeline_depth=4,
                            eager_writeback=False)
    lco.register_default_kernels(st_blk)
    data_mr = eng.register_mr(DATA_PEER, 0, POOL)

    # 3. Fig 6 networked matmul
    for tag, (m, k, n) in enumerate(((2048, 2048, 2048), (512, 16, 512))):
        A = rng.standard_normal((m, k), np.float32)
        B = rng.standard_normal((k, n), np.float32)
        a, b_, out = 0, m * k, m * k + k * n
        eng.write_buffer(DATA_PEER, a, A.ravel())
        eng.write_buffer(DATA_PEER, b_, B.ravel())
        torch.cuda.synchronize()
        t = time.perf_counter()
        check(mm_blk.dispatch(ControlMsg(
            lco.MM_WORKLOAD, (DATA_PEER, data_mr.rkey, a, b_, out, m, k, n),
            tag=tag)) is None, "MM dispatch refused")
        st = mm_blk.poll(lco.MM_WORKLOAD)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t) * 1e3
        check(st is not None and st.ok and st.result_addr == out,
              f"MM status {st}")
        C = eng.read_device(DATA_PEER, out, m * n).reshape(m, n)
        A64 = torch.from_numpy(A).to(dev, torch.float64)
        B64 = torch.from_numpy(B).to(dev, torch.float64)
        ref = A64 @ B64
        # fp32 dot-product error bound: k * 2^-24 * (|A| @ |B|)
        lim = k * 2.0 ** -24 * (A64.abs() @ B64.abs())
        err = (C.double() - ref).abs()
        check(bool(torch.isfinite(C).all()) and bool((err <= lim).all()),
              f"networked matmul {m}x{k}x{n}: err {err.max().item()}")
        phase("fig6 networked_matmul", shape=f"{m}x{k}x{n}",
              wall_ms=wall, max_abs_err_vs_f64=err.max().item(),
              status_ok=st.ok)
        del C, A64, B64, ref, lim, err

    # 4. PARSER_WORKLOAD over 4096 packets
    n_pkts = 4096
    p_addr, m_addr = 0, n_pkts * 64
    eng.write_buffer(DATA_PEER, p_addr, pkts_np.astype(np.float32).ravel())
    torch.cuda.synchronize()
    t = time.perf_counter()
    mm_blk.dispatch(ControlMsg(lco.PARSER_WORKLOAD, (
        DATA_PEER, data_mr.rkey, p_addr, n_pkts, m_addr), tag=7))
    st = mm_blk.poll(lco.PARSER_WORKLOAD)
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t) * 1e3
    check(st is not None and st.ok, f"parser status {st}")
    meta = eng.read_buffer(DATA_PEER, m_addr, n_pkts * 4).reshape(n_pkts, 4)
    want = parse_packets_plain(torch.from_numpy(pkts_np)).numpy()
    check(np.array_equal(meta, want.astype(np.float32)),
          "PARSER_WORKLOAD meta rows are not byte-exact")
    phase("parser_workload", packets=n_pkts, wall_ms=wall,
          rdma_pkts=int(want[:, 0].sum()))

    # 5. 1024 slots as 32-slot STREAM_QUANT_WORKLOAD messages
    n_slots, burst = 1024, 32
    s_base, q_base = 1 << 20, 1 << 21
    payload = (rng.standard_normal((n_slots, 64)) * rng.uniform(
        0.01, 100, (n_slots, 1))).astype(np.float32)
    payload[::97] = 0.0
    eng.write_buffer(DATA_PEER, s_base, payload.ravel())
    torch.cuda.synchronize()
    t = time.perf_counter()
    for i in range(n_slots // burst):
        spans = ((s_base + i * burst * 64, burst),)
        check(st_blk.dispatch(ControlMsg(lco.STREAM_QUANT_WORKLOAD, (
            DATA_PEER, data_mr.rkey, s_base, DATA_PEER, data_mr.rkey,
            q_base, spans), tag=i), service=False) is None,
            "stream dispatch refused")
    st_blk.service(lco.STREAM_QUANT_WORKLOAD)
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t) * 1e3
    done = []
    while (msg := st_blk.poll(lco.STREAM_QUANT_WORKLOAD)) is not None:
        done.append(msg)
    check(len(done) == n_slots // burst and all(m.ok for m in done),
          "stream quantize statuses")
    rows = eng.read_device(DATA_PEER, q_base, n_slots * lco.QUANT_ROW
                           ).reshape(n_slots, lco.QUANT_ROW)
    pq, ps = quantize_stream_plain(torch.from_numpy(payload))
    check(torch.equal(rows[:, :64].cpu(), pq.to(torch.float32))
          and torch.equal(rows[:, 64:].cpu(), ps),
          "STREAM_QUANT rows are not bit-exact")
    q = rows[:, :64].to(torch.int8).contiguous()
    s = rows[:, 64:].contiguous()
    back = ops.decompress(q, s, (n_slots, 64))
    half = (back.cpu() - torch.from_numpy(payload)).abs() - s.cpu() * 0.5
    check(bool((half <= 1e-7).all()), "decompress beyond half a step")
    lp = eng.stats["lc_pipeline"]
    phase("stream_quant", slots=n_slots, burst=burst, wall_ms=wall,
          overlapped_flushes=lp["overlapped_flushes"],
          in_flight_peak=lp["in_flight_peak"])

    # 6. read_batch_16k and dma_64mib through the engine
    src = torch.from_numpy(rng.standard_normal(1 << 24, np.float32))
    eng.write_buffer(DATA_PEER, 0, src)
    qp = eng.create_qp(LC_PEER, DATA_PEER, placement=Placement.HOST_MEM)
    eng.create_qp(DATA_PEER, LC_PEER, placement=Placement.HOST_MEM)
    pool = eng.pool
    reps = 5

    def doorbell(wqes):
        """Post ``wqes`` as (local, remote, length) READs, ring one
        doorbell; return the synchronised wall seconds and the CQEs."""
        for i, (loc, rem, ln) in enumerate(wqes):
            eng.post_send(qp, WQE(Opcode.READ, qp.qp_num, i,
                                  local_addr=loc, remote_addr=rem,
                                  length=ln, rkey=data_mr.rkey))
        torch.cuda.synchronize()
        t = time.perf_counter()
        eng.ring_sq_doorbell(qp)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        cq = eng.poll_cq(qp, 1 << 10)
        check(len(cq) == len(wqes) and all(
            c.status.value == "success" for c in cq), "READ completions")
        return wall

    def report(name, wqes, walls):
        nbytes = 4 * sum(ln for _, _, ln in wqes)
        desc, chunk = pack_descriptors(
            [("xfer", DATA_PEER, LC_PEER, rem, loc, ln)
             for loc, rem, ln in wqes], POOL)
        wall = sorted(walls)[len(walls) // 2]

        def execute():      # the descriptor executor alone, same table
            _exec_descriptors_local(pool, desc, chunk)

        phase(name, wqes=len(wqes), bytes=nbytes, reps=len(walls),
              wall_ms_median=wall * 1e3,
              wall_ms_each=[round(w * 1e3, 4) for w in walls],
              gbps_median=nbytes * 8 / wall / 1e9,
              executor_call_ms=cuda_ms(execute, iters=5, warmup=1),
              executor_device_ms=device_ms(execute, iters=5))

    # read_batch_16k: 50 READs of 16 KiB, strided so none coalesce
    words, batch, gap = 4096, 50, 8192
    wqes = [((1 << 25) + i * gap, i * gap, words) for i in range(batch)]
    walls = [doorbell(wqes) for _ in range(reps)]
    for loc, rem, ln in wqes:
        check(torch.equal(pool[LC_PEER, loc:loc + ln],
                          pool[DATA_PEER, rem:rem + ln]),
              f"read_batch bytes at {loc}")
    report("read_batch_16k", wqes, walls)

    # dma_64mib: one READ of 16 Mi words
    n = 1 << 24
    wqes = [(1 << 25, 0, n)]
    walls = [doorbell(wqes) for _ in range(reps)]
    check(torch.equal(pool[LC_PEER, 1 << 25:(1 << 25) + n], src.to(dev)),
          "dma_64mib bytes")
    report("dma_64mib", wqes, walls)

    # ---- 7. launches on the main path --------------------------------------
    torch.cuda.synchronize()
    counts = {fn.__name__: fn.launches for fn in counted}
    phase("kernels", **counts)
    for name, c in counts.items():
        check(c > 0, f"{name} never launched on the main path")
        rec[name]["launches"] = c
    phase("engine", flushes=eng.stats["flushes"], wqes=eng.stats["wqes"],
          qdma_writes=eng.stats["transport"]["qdma_writes"],
          lc_wqes=eng.stats["lc_wqes"])

    print(json.dumps({"kernels": list(rec.values())}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

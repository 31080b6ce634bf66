"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``src/repro_torch/kernels/csrc``
(printing each kernel's registers, shared memory and spills as ptxas
reports them) and runs, on the card:

  1. the card's name and power limit (``nvidia-smi``);
  2. each kernel against its plain PyTorch version at the shapes the main
     path gives it — bit-exact for quantize, dequantize, parse and the
     field classifier (K3 at 65536 and 4096 packets, K4 at 1024, 4096
     and 65536), within
     ``1e-5 * k / 128`` for the f32 matmul (K5 on the CUDA cores, no
     TF32; at 512x16x512 and 2048^3), within 2e-4 (plus one bf16 step
     in bf16) for K6 attention on the tensor cores (3xTF32 in f32, bf16
     with P split in two halves) at the tinyllama prefill shape (256 x
     512 x 64, causal, GQA 8, f32; also with window 32, in bf16, at d =
     128, at hymba's 25 q over 5 kv heads with window 1024, at
     deepseek-v2-lite's MLA prefill, 16 heads with q and k 192 wide and
     v 128, at seamless-m4t's encoder (128 x 128, not causal), its
     cross-attention in prefill (512 x 128) and in decode (1 x 128), 16
     heads of 64, and at qwen2-vl's prefill, 28 q over 4 kv heads of
     128) — with
     its time, the plain version's time, its bound (the function's own
     work, by the formula its wrapper charges to the operation counter
     (``*_cost`` beside each kernel), at its dtype's peak; for K6 and K7
     also the bound of the products their routes run) and, for the
     matmul and attention, the
     time of
     ``torch.matmul`` and of ``scaled_dot_product_attention``
     (yardsticks the port never calls), each time read per traced name
     (``ms``), as the trace's plain sum (``ms_summed``) and between CUDA
     events (``call_ms``);
     K7 ``ssd_scan`` within 2e-5 in f32 (6e-2 in bf16) of its plain
     version, outputs and final state, at hymba's prefill shape (8 x 512,
     50 heads, d_state 16), in bf16, and at mamba2's (8 x 512, 32 heads
     of 64, d_state 128, chunk 256, f32) from a zero and a given state,
     with each of its five passes' traced time on a line of its own,
     and K7 in f32 at mamba2's shape within 2e-5 (relative to 1 +
     |value|) of its plain version run in float64, from three seeds,
     with the plain f32 version's distance from it beside;
  3-6. the RecoNIC main path with every launch counter at 0 first: the
     Fig 6 networked matmul (2048^3 and the ``lc_offload_mm`` shape
     512x16x512) through ``RDMAEngine`` + ``LookasideBlock`` +
     ``register_default_kernels`` on a 2 x 2^26-word pool, a
     ``PARSER_WORKLOAD`` over 4096 packets, 1024 slots quantized by
     32-slot ``STREAM_QUANT_WORKLOAD`` messages and decompressed, and the
     ``read_batch_16k`` / ``dma_64mib`` READs;
  23. the knob sweep: a live engine on the card with the reference
     bench's geometry (2 peers, 4096 words, seed 7, eight host READs),
     two ``AutoTuner(passes=2, rows=128)`` sweeps (``apply=False``) that
     must give the same chosen point and surface, equal to a sweep of a
     CPU engine of the same geometry, the choice then installed with
     ``apply_tuning``; the chosen point, trials, improvement, the sweeps'
     walls and each trial's wall on the card;
  24. the executor's cost profile (``cost_model.ExecutorCost``) measured
     on the card: the median host wall of a synchronised one-descriptor
     ``execute_batch`` (``dispatch_s``) and of a 16-word ``host_write``
     (``staging_dispatch_s``) over 64 calls each, and a fresh bucket's
     first call less a warm call (``compile_s``, median of eight
     buckets), printed beside the committed profile (no timing checked);
  25. the paper model beside the card: ``predict_from_stats`` over the
     datapath engine's stats after 3-6 and over ``read_batch_16k``'s own
     counts, under the committed profile and this run's, beside the
     phases' measured walls; ``simulate_rdma`` at ``read_batch_16k``
     (the paper's ~89 Gb/s) beside the port's rate; ``run_testcase`` over
     every ``tests/testcases/*.json``, each anchor checked;
  7-10. the streaming dispatch plane on the same engine: ``streaming_rx``
     (16384 packets through ``TrafficRouter.ingest_packets`` into a
     1024-slot ring drained by ``LCKernel.stream()``),
     ``dispatch_mixed_3class`` (16384 packets, shares 0.5/0.3/0.2, over a
     3-row ``MatchTable``), ``chain_parse_dequant_2stage`` (4096 framed
     slots through a parse→dequantize ``Chain``) and ``grad_egress`` (a
     4 MiB gradient bucket through ``GradEgressChain``), each checked
     byte for byte against the plain versions (K4's field matrices as
     the routers received them too), run once for its wall time and once
     under the profiler for its device time, with the host cost of
     ``RXRing.push`` timed on its own and that of the egress chain's
     per-row read-backs timed inside ``GradEgressChain.compress``;
  11-13. the serving path: tinyllama-1.1b at full width in f32 with
     random weights, 8 requests x 512-token prompts and 32 greedy tokens:
     prefill + 32 teacher-forced decode steps against one forward over
     all 544 tokens (K6 launched 22 times per prefill and per forward,
     none in decode), prefill and decode times with their traced device
     share, the KV handoff of the caches over one-sided READs on an
     engine of its own in 65,536-word pages (byte-exact, and greedy
     tokens through the remote pool equal to local ones), a compressed
     pool whose fetched pages equal the plain dequant(quant(page)) byte
     for byte, and the ``kv_serve`` ledger (every page fetched, none
     failed);
  14-15. SSM serving: mamba2-370m at full width and depth (48 layers),
     f32, random weights, the same traffic: prefill + 32 teacher-forced
     decode steps against one forward over 768 tokens (the scan takes
     whole 256-token chunks; causality makes positions 512-543 the ones
     to compare), K7 launched 48 times per prefill and per forward, none
     in decode, within 1e-4 of the logits' scale, and the prefill against
     a forward over the prompt alone (each serving invariant also reports
     how far the two forwards differ, from their GEMMs' row counts);
     prefill and decode times with their traced device share; the state
     handoff of the 8 sequences' SSM caches (1577 pages) over one-sided
     READs on an engine of 2 x 2^27 words, byte-exact in each of three
     timed fetches and one traced for its device time, greedy tokens
     through the remote pool equal to local ones, the ``kv_serve`` ledger
     clean;
  16. hybrid heads: hymba-1.5b at full width and depth (32 layers), the
     same invariant at 768 tokens with K6 and K7 each launched 32 times
     per prefill and per forward and none in decode;
  20. MoE + MLA serving: deepseek-v2-lite-16b at full width and depth (27
     layers, 15.7B parameters in f32), the same traffic. The invariant at
     capacity_factor 8 over 544 tokens with every MoE layer's top-6 sets
     recorded on both routes: no assignment dropped, a routing flip first
     in its sequence a near-tie (margin under 1e-4 on both routes), every
     sequence without a flip within 1e-4 of the logits' scale, and at
     least one such; K6 (at 192/128) launched 27 times per prefill and
     per forward, none in decode. Then at the config's capacity factor:
     prefill and decode times with their traced device share, the MLA
     cache handoff (1048 pages on 2 x 2^27 words, byte-exact, greedy
     tokens equal) beside a per-head K/V cache's words, free memory
     before the weights and the peak allocated;
  21. encoder-decoder serving: seamless-m4t-large-v2 at full width and
     depth (24 encoder and 24 decoder layers, f32, random weights), the
     speech frontend a stub: 128 N(0, 1) frame embeddings a request. The
     invariant over 544 tokens with the frames on every step, K6 launched
     72 times per prefill and forward (encoder, decoder self and cross)
     and 48 per decode step (the encoder and the cross-attention run from
     no cache on every step, as in the reference); prefill and decode
     times with their traced device share, and the encoder's wall and
     device time alone (what each decode step re-runs); the ``{"self"}``
     cache handoff (3313 pages on 2 x 2^28 words, byte-exact, greedy
     tokens through the remote pool equal local ones, the frames given
     to every step) and the ``kv_serve`` ledger clean; free memory and
     the peak allocated;
  22. vision-language serving: qwen2-vl-7b at full width and depth (28
     layers, 7.6B parameters in f32), the vision tower a stub: 128 patch
     embeddings over the first positions, M-RoPE ids of one 8 x 16 frame
     and then text from 16, each decode step given its ids. The invariant
     over 544 tokens with K6 (28 q over 4 kv heads of 128) launched 28
     times per prefill and forward, none in decode; prefill and decode
     times with their traced device share; free memory before the
     weights and the peak allocated;
  18. training, the plain step: tinyllama-1.1b at full width and depth,
     f32, random weights, one repeated ``SyntheticPipeline`` batch of 4 x
     512 tokens, 3 steps of ``make_train_step`` with remat: ms per step,
     tokens/s, losses (finite, step 3's below step 1's), peak memory and
     K6 launches per step (44: a forward and a remat recompute per layer;
     K6's backward recomputes its plain version); step 1's state saved
     async beside step 2, restored onto the card and held bit-equal;
  19. training, the engine-synced step: the same weights and batch
     through ``make_bucketed_train_step(sync="rdma", n_peers=2)``, its
     16 MiB gradient buckets ring-all-reduced as RDMA READs on a shared
     engine with an ``EngineHeartbeatBridge``: the first loss within 1e-5
     of the plain step's, the synced mean gradients within 1e-5 of the
     global gradient norm of the plain step's, no transport or QDMA
     compile and some overlapped flushes in step 2, no peer failed; its
     buckets, rounds, flushes, wire bytes, collective ms, step ms, peak
     memory and K6 launches (88 per step);
  26. the multi-process path: two gloo ranks sharing the card
     (``run_peers``; the parent's memory freed first, the wire gloo
     through host memory): (a) ``read_batch_16k`` on a 2-peer engine over
     the ranks (``ICITransport``, one pool row a rank), its pool byte-equal
     to a LocalTransport run of the same traffic on the card; (b) the
     Lookaside block over the twin, ``lc_offload_mm`` 512x16x512 and a
     4096-packet ``PARSER_WORKLOAD``, byte-equal to the single-process run
     (K5 and K3 launched in every rank); (c) tinyllama-1.1b at full width
     and depth, f32, remat, phase 18's batch of 4 x 512 split over a
     ("data",) = (2,) mesh: two ``sync="psum"`` steps with 16 MiB buckets
     (their losses within 1e-5 of phase 18's first two, step 1's synced
     gradients' global norm within GRAD_SYNC_TOL of phase 18's,
     ``buckets + 1`` collectives a step) and one ZeRO-1
     ``make_train_step(mesh)`` step (its loss and the loss of the weights
     it leaves within 1e-5 of phase 18's third and of the loss after its
     third step, each rank holding half the moments), with ms per step
     and each rank's peak memory; (d) one ``compress_grads`` step on a
     ("pod", "data") = (2, 1) mesh (K1 and K2 in every rank, bit-exact
     against their plain versions on the largest bucket; the synced
     gradient norm within the compression's own error of phase 18's
     norm), its loss and residual norm; (e) the reference test's
     pipeline over 2 stages, within 1e-5 of the sequential stack;
  27. the dry-run against the card: three steps the smoke runs above
     (tinyllama-1.1b's prefill of 8 x 512 and train step of 4 x 512 with
     remat, mamba2-370m's prefill of 8 x 512; f32) traced on ``meta`` by
     ``launch.dryrun.build_cell`` under ``roofline.count.OpCounter`` and
     run on the card under the same counter from SEED: (a) FLOPs, bytes
     and each kernel's charges equal; (b) the predicted peak live bytes
     within DRYRUN_MEM_TOL of the card's peak allocated over the run
     (less what lay beside the inputs); (c) the roofline's compute and
     memory terms on the H100 profile and the bound beside the step's
     wall, timed once more without the counter (printed, not checked);
     (d) ``python -m repro_torch.launch.dryrun --all`` over the single
     and the multi-pod mesh on ``meta``, one process a mesh run
     together: ok, skipped and failed counts and the wall, 0 failed;
  17. each kernel's launch count on the twelve paths (3-6, 7-10, 11-13,
     14-15, 16, 20, 21, 22, 18, 19, 26, the last summed over its ranks,
     and 27, two runs a cell on the card), each path run with the
     counters at 0 and read right after: every kernel a path runs must
     have launched on it, and each of the seven > 0.

Any mismatch raises, so the exit code is not 0. The second-to-last line
is the kernels' JSON record, the last ``{"ok": true, "device": ...}``.
Without a CUDA device it exits with an error before printing a result.
"""
import hashlib
import json
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
from torch.autograd import DeviceType

# H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s, f32 FLOP/s outside
# the tensor cores. A card below its 700 W limit runs slower than this.
PEAK_BYTES_S = 3.35e12
PEAK_F32_FLOPS = 67e12
PEAK_BF16_FLOPS = 989e12       # dense, tensor cores
PEAK_TF32_FLOPS = 495e12       # dense, tensor cores
PEAK_FP64_TC_FLOPS = 67e12     # FP64 on the tensor cores

POOL = 1 << 26
# the 8 sequences' mamba2-370m caches: 48 x (8*32*64*128 + 8*3*2304) words,
# 1577 pages of 65,536 words, more than POOL
SSM_POOL = 1 << 27
# seamless-m4t-large-v2's decoder caches for the 8 sequences: 24 x 2 x 8 x
# 552 x 16 x 64 words, 3313 pages of 65,536 words, more than SSM_POOL
ENCDEC_POOL = 1 << 28
# timed fetches of each uncompressed cache handoff
N_FETCH = 3
DATA_PEER, LC_PEER = 1, 0
SEED = 0
# the rdma step's synced mean gradients against the plain step's: max
# |difference| over the global gradient norm (the two sum the batch in
# another order, and the embedding's backward adds with atomics)
GRAD_SYNC_TOL = 1e-5
# a routing flip between two f32 routes (other summation orders) is a
# near-tie: its 6th and 7th experts' probabilities within this
FLIP_MARGIN = 1e-4
# the knob sweep's live engine: the reference bench's geometry and seed
# (benchmarks/bench_autotune.py)
TUNER_POOL = 1 << 12
TUNER_SEED = 7
# phase 26: gloo ranks sharing the card, the twin's pool words per peer
MP_RANKS = 2
MP_POOL = 1 << 21
MP_TIMEOUT_S = 900
# traces of a kernel's timed calls before the profiler's empty-handed
# traces fail the smoke (_traced_ms)
TRACE_TRIES = 4
# phase 27: the dry-run's predicted peak live bytes against the card's
# peak, relative (the tolerance PERF.md predicted)
DRYRUN_MEM_TOL = 0.05
# read_batch_16k (phases 6 and 26): words a READ, READs a doorbell, stride
READ16K = (4096, 50, 8192)


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


def device_ms(fn, iters=20, wrapper=None):
    """GPU time per call of ``fn`` as (ms, summed_ms, passes): the first
    two each the smaller of two readings, ``passes`` the traced ms per
    call of each ``__global__`` function of ``wrapper``'s kernel.

    * The device time of the kernels and copies it launches, traced by
      torch.profiler (CUPTI), each call run alone (``_traced_ms``, read
      per name and summed): leaves out the host's launch overhead, but
      overstates calls whose kernels overlap.
    * ``cuda_ms``: events around back-to-back calls, exact for device-
      bound calls, the host's launch rate for small ones.
    """
    per_name, summed, passes = _traced_ms(fn, iters, wrapper)
    events = cuda_ms(fn, iters)
    return min(per_name, events), min(summed, events), passes


def _trace(fn):
    """Run ``fn`` once under torch.profiler (CUPTI); return (its result,
    the trace's device rows, one per kernel or copy name). Only the
    device rows count: the profiler also files each kernel under the
    aten op that launched it, so summing every row would count an aten
    op's kernels twice (the CUDA kernels here launch through ctypes,
    outside any aten op, and appear once either way)."""
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        out = fn()
        torch.cuda.synchronize()
    return out, [e for e in prof.key_averages()
                 if e.device_type == DeviceType.CUDA]


def traced_device_us(fn, tries=1):
    """``_trace``, failing on a trace that holds no device time. CUPTI now
    and then hands back an empty trace of work that is copies alone (seen
    on 64 MiB executor copies and on a cache fetch), so a pure call, run
    only for its device time, may be traced up to ``tries`` times."""
    for _ in range(tries):
        out, rows = _trace(fn)
        total_us = sum(e.self_device_time_total for e in rows)
        if total_us > 0:
            return out, total_us
    raise AssertionError(f"the profiler traced no device time in {tries} "
                         f"traces")


# the __global__ functions one call of each counted wrapper launches, once
# each: K7 runs five passes per call, each named ssd_scan_<pass>
KERNEL_SYMBOL = {"systolic_mm": ("systolic_mm_kernel",),
                 "flash_attention": ("flash_attention_kernel",),
                 "parse_packets": ("parse_packets_kernel",),
                 "parse_packet_fields": ("parse_packet_fields_kernel",),
                 "quantize_stream": ("quantize_kernel",),
                 "dequantize_stream": ("dequantize_kernel",),
                 "ssd_scan": ("ssd_scan_cum", "ssd_scan_cb",
                              "ssd_scan_chunk_state", "ssd_scan_state_pass",
                              "ssd_scan_chunk_scan")}


def _traced_ms(fn, iters, wrapper=None):
    """Device ms per call from one trace of ``iters`` calls, each run
    alone, read two ways, with the wrapper's own functions apart:
    (per_name, summed, passes).

    * per_name: for each kernel or copy name, its mean traced duration
      times the times one call runs it. For each ``__global__`` function
      of ``wrapper`` (a counted wrapper of the port; one call runs each
      of its functions once) that is the wrapper's launch count over the
      traced calls; for any other name, its record count over ``iters``
      rounded up, which holds while CUPTI drops fewer than 1/n of the
      records of a name that runs n times a call. ``passes`` holds the
      wrapper's functions' shares, keyed by the symbol that matched
      (their sum is the wrapper's part of per_name). A trace that holds
      no record of one of them (CUPTI dropped them all: seen twice in a
      row on K1 at 4096x1024) is taken again, up to TRACE_TRIES traces,
      and then raises.
    * summed: every record's duration, summed, over ``iters``. CUPTI can
      drop some of a trace's records, and then this reads low: a trace of
      20 K5 launches at 2048^3 once summed to 0.245 ms a call, under the
      0.256 ms that the f32 peak allows, where CUDA events read 0.43.
    """
    fn()
    names = set(KERNEL_SYMBOL[wrapper.__name__]) if wrapper else set()
    sym = (re.compile(r"\b(" + "|".join(sorted(names)) + r")\b")
           if names else None)

    def run():
        for _ in range(iters):
            fn()
            torch.cuda.synchronize()

    for _ in range(TRACE_TRIES):
        n0 = wrapper.launches if wrapper is not None else 0
        _, rows = _trace(run)
        rows = [e for e in rows if e.count]
        if not any(e.self_device_time_total > 0 for e in rows):
            continue
        summed = sum(e.self_device_time_total for e in rows) / iters
        own = [bool(sym and sym.search(e.key)) for e in rows]
        if names - {sym.search(e.key).group(0)
                    for e, o in zip(rows, own) if o}:
            continue            # every record of one of its kernels dropped
        per_name = sum(e.self_device_time_total / e.count
                       * math.ceil(e.count / iters)
                       for e, o in zip(rows, own) if not o)
        passes = {}
        if sym:
            per_call = (wrapper.launches - n0) / iters
            for e, o in zip(rows, own):
                if o:
                    name = sym.search(e.key).group(0)
                    passes[name] = (passes.get(name, 0.0)
                                    + e.self_device_time_total / e.count
                                    * per_call / 1e3)
            per_name += sum(passes.values()) * 1e3
        return per_name / 1e3, summed / 1e3, passes
    raise AssertionError(f"in {TRACE_TRIES} traces the profiler traced no "
                         f"device time, or no record of one of "
                         f"{sorted(names)}")


def bound(nbytes, flops=0.0, peak_flops=PEAK_F32_FLOPS):
    """(bound_ms, bound_by): the larger of bytes over HBM rate and
    operations over the peak rate for the inputs' type (f32 by default)."""
    t_bytes = nbytes / PEAK_BYTES_S * 1e3
    t_ops = flops / peak_flops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def roce_mix(rng, n, rdma_share=0.5):
    """``n`` 64-byte headers of random bytes; a ``rdma_share`` of them
    (every other one at 0.5) crafted as IPv4/UDP/4791 RoCEv2 with BTH
    opcodes 0..19, the rest IPv4/UDP on random ports."""
    pkts = rng.integers(0, 256, size=(n, 64)).astype(np.uint8)
    pkts[:, 12:14] = [0x08, 0x00]
    pkts[:, 23] = 17
    roce = np.zeros(n, bool)
    if rdma_share:
        roce[::int(round(1 / rdma_share))] = True
    pkts[roce, 36:38] = [18, 183]
    pkts[roce, 42] = rng.integers(0, 20, size=int(roce.sum()))
    return pkts


def check(ok, what):
    if not ok:
        raise AssertionError(what)


def phase(name, **nums):
    print(f"[{name}] " + " ".join(f"{k}={v}" for k, v in nums.items()),
          flush=True)


def train_phases(cfg, dev, k6, zero_counts, read_counts, ckpt_dir,
                 batch=4, seq=512, steps=3):
    """Phases 18-19: ``cfg`` trained in f32 from random weights (SEED) on
    one repeated ``SyntheticPipeline`` batch (``data_cycle`` 1).

    18. ``steps`` plain steps (``make_train_step``, remat on): the loss
        finite and falling, K6 launched twice per attention layer per step
        (forward and remat recompute); step 1's (params, AdamState) saved
        async, restored onto the card after step 2 and held bit-equal.
    19. two steps of ``make_bucketed_train_step(sync="rdma", n_peers=2,
        grad_bucket_mb=16)`` from the same weights: the first loss within
        1e-5 relative of the plain step's first, the synced mean gradients
        within GRAD_SYNC_TOL of the global gradient norm of the plain
        step's (max |difference| over the norm), no transport or QDMA
        compile in step 2, overlapped flushes, and an
        ``EngineHeartbeatBridge`` on the engine that fails no peer.

    Returns the plain steps' losses followed by the loss of the weights
    the last step left (one forward), and the global norm of step 1's
    gradients.
    """
    from repro_torch._tree import tree_leaves
    from repro_torch.checkpoint.checkpoint import CheckpointManager
    from repro_torch.models import init_params
    from repro_torch.runtime.fault_tolerance import (EngineHeartbeatBridge,
                                                     HeartbeatMonitor)
    from repro_torch.train import (init_adam, make_bucketed_train_step,
                                   make_train_step)
    from repro_torch.train.optimizer import global_norm

    tokens = batch * seq
    tcfg = _train_config(total_steps=steps + 1)
    params0 = init_params(cfg, SEED, device=dev)
    data = _train_data(cfg, dev, batch, seq)
    n_attn = cfg.num_layers if cfg.family != "ssm" else 0

    def run(step_fn, *args):
        """(outputs, seconds, K6 launches) of one synchronised step."""
        torch.cuda.synchronize()
        n0, t = k6.launches, time.perf_counter()
        out = step_fn(*args)
        torch.cuda.synchronize()
        return out, time.perf_counter() - t, k6.launches - n0

    # 18. the plain step
    step = make_train_step(cfg, tcfg)
    step.keep_grads = True
    zero_counts()
    torch.cuda.reset_peak_memory_stats()
    params, opt = params0, init_adam(params0)
    cm = CheckpointManager(ckpt_dir, keep=1)
    losses, secs, k6s = [], [], []
    saved = None
    for i in range(steps):
        (loss, params, opt), dt, n6 = run(step, params, opt, data)
        losses.append(float(loss))
        secs.append(dt)
        k6s.append(n6)
        if i == 0:
            plain_grads, step.keep_grads = step.last_grads, False
            step.last_grads = None
            saved = (params, opt)
            t_save = time.perf_counter()
            cm.save(1, saved, blocking=False)
            save_call_s = time.perf_counter() - t_save
        elif i == 1:
            # the save ran beside step 2; restore onto the card
            t_wait = time.perf_counter()
            cm.wait()
            wait_s = time.perf_counter() - t_wait
            (rp, ro), rstep_no = cm.restore(saved, target_device=dev)
            check(rstep_no == 1, f"restored step {rstep_no}")
            pairs = list(zip(tree_leaves(rp) + [ro.step] + tree_leaves(ro.m)
                             + tree_leaves(ro.v),
                             tree_leaves(saved[0]) + [saved[1].step]
                             + tree_leaves(saved[1].m)
                             + tree_leaves(saved[1].v)))
            check(all(a.device == b.device and a.dtype == b.dtype
                      and torch.equal(a, b) for a, b in pairs),
                  "the restored checkpoint is not bit-equal to the saved "
                  "state")
            n_leaves = len(pairs)
            del rp, ro, pairs, saved
    peak_plain = torch.cuda.max_memory_allocated()
    after = forward_loss(params, cfg, data)
    read_counts("train plain", (k6,) if n_attn else ())
    check(all(np.isfinite(losses)), f"plain step losses {losses}")
    check(losses[-1] < losses[0], f"the loss did not fall: {losses}")
    check(all(n == 2 * n_attn for n in k6s),
          f"K6 launches per step {k6s}, want {2 * n_attn}")
    ms = [s * 1e3 for s in secs]
    phase("train plain", arch=cfg.name, batch=batch, seq=seq, steps=steps,
          losses=json.dumps(losses), loss_after=after,
          step_ms=json.dumps(ms),
          ms_per_step=float(np.mean(ms[1:])),
          tokens_per_s=tokens / float(np.mean(secs[1:])),
          peak_mem_gb=peak_plain / 1e9, k6_per_step=json.dumps(k6s))
    phase("train checkpoint", leaves=n_leaves,
          gb=sum(t.numel() * t.element_size() for t in tree_leaves(params0))
          * 3 / 1e9, save_call_s=save_call_s, wait_after_step2_s=wait_s,
          bit_equal=True)
    del params, opt, loss

    # 19. the engine-synced step, the batch split over two peers
    rstep = make_bucketed_train_step(cfg, tcfg, None, sync="rdma",
                                     n_peers=2)
    rstep.keep_grads = True
    zero_counts()
    torch.cuda.reset_peak_memory_stats()
    (loss1, p1, o1, _), dt1, n6_1 = run(rstep, params0, init_adam(params0),
                                        data)
    coll = rstep.collective(0)
    eng = coll.engine
    check(eng.pool.device.type == dev.type, "the collective's pool is not "
          "on the card")
    bridge = EngineHeartbeatBridge(eng, HeartbeatMonitor(eng.n_peers,
                                                         timeout=600.0))
    rel = abs(float(loss1) - losses[0]) / abs(losses[0])
    check(rel <= 1e-5, f"rdma loss {float(loss1)} vs plain {losses[0]}")
    norm = float(global_norm(plain_grads))
    diff = max(float((a - b).abs().max()) for a, b in zip(
        tree_leaves(rstep.last_grads), tree_leaves(plain_grads)))
    rstep.keep_grads, rstep.last_grads = False, None
    del plain_grads
    check(diff <= GRAD_SYNC_TOL * norm,
          f"synced grads {diff} from the plain step's, norm {norm}")
    led0 = dict(eng.stats["collectives"])
    tr = eng.stats["transport"]
    c0, q0 = tr["compiles"], tr["qdma_compiles"]
    # time step 2's collective inside the step
    coll_s = []
    all_reduce = coll.all_reduce_buckets

    def timed_all_reduce(*a, **kw):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = all_reduce(*a, **kw)
        torch.cuda.synchronize()
        coll_s.append(time.perf_counter() - t)
        return out

    coll.all_reduce_buckets = timed_all_reduce
    (loss2, p2, o2, _), dt2, n6_2 = run(rstep, p1, o1, data)
    coll.all_reduce_buckets = all_reduce
    peak_rdma = torch.cuda.max_memory_allocated()
    read_counts("train rdma", (k6,) if n_attn else ())
    led = eng.stats["collectives"]
    per_step = {k: led[k] - led0[k] for k in led}
    check(np.isfinite(float(loss2)), f"rdma step 2 loss {float(loss2)}")
    check(tr["compiles"] == c0 and tr["qdma_compiles"] == q0,
          f"step 2 compiled: {tr['compiles'] - c0} descriptor, "
          f"{tr['qdma_compiles'] - q0} QDMA")
    check(per_step["overlapped_flushes"] > 0, f"no overlapped flush {led}")
    dead = bridge.check()
    check(dead == [] and bridge.monitor.alive_hosts() == list(
        range(eng.n_peers)), f"the heartbeat bridge failed peers {dead}")
    check(n6_1 == n6_2 == 2 * 2 * n_attn,
          f"K6 launches per rdma step {n6_1}, {n6_2}, want {4 * n_attn}")
    phase("train rdma", arch=cfg.name, peers=2, batch=batch, seq=seq,
          losses=json.dumps([float(loss1), float(loss2)]),
          loss_rel_to_plain=rel, grad_max_abs_diff=diff, grad_norm=norm,
          grad_diff_over_norm=diff / norm, tolerance=GRAD_SYNC_TOL,
          step_ms=json.dumps([dt1 * 1e3, dt2 * 1e3]),
          tokens_per_s=tokens / dt2, collective_ms=coll_s[0] * 1e3,
          pool_words=eng.pool_size, peak_mem_gb=peak_rdma / 1e9,
          k6_per_step=json.dumps([n6_1, n6_2]))
    phase("train rdma ledger", **per_step,
          compiles=tr["compiles"], qdma_compiles=tr["qdma_compiles"],
          heartbeat_dead=len(dead))
    return losses + [after], norm


def moe_phases(dev, timed, during, counted, trace_share, handoff, ledger,
               traffic):
    """Phase 20: deepseek-v2-lite-16b (27 layers, d_model 2048, MLA with
    q.k over 192 dims and v over 128, 64 routed experts top-6 plus 2
    shared, layer 0 dense) at full width and depth in f32, random weights
    from SEED, served through ``models`` and ``serve`` as ``launch/serve.py``
    serves it; ``traffic`` is (requests, prompt, greedy tokens, max_seq).

    * The invariant, with drops off (capacity_factor 8): prefill + decode
      teacher-forced against one forward over all prompt + decode tokens,
      with every MoE layer's routing recorded (``route`` wrapped; no
      assignment may be dropped). The two routes sum in other orders, so a
      near-tie between a token's 6th and 7th expert may flip: a flip in
      the lowest layer where its sequence has any must have a margin (6th
      prob - 7th prob) under ``FLIP_MARGIN`` on both routes; later flips
      follow from it. Sequences with no flip hold their logits within 1e-4
      of the logits' scale; at least one must. K6 launches once per layer
      in the prefill and the forward, none in decode.
    * Serving at the config's capacity factor: prefill and decode times,
      their traced device share, and the MLA cache handoff over the
      engine (byte-exact, greedy tokens equal), beside the words a
      per-head K/V cache of the same tokens would move.
    * Free memory before the weights, and the peak allocated across the
      phase. Everything is freed after."""
    import dataclasses

    from repro_torch._tree import tree_leaves
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.models import forward, init_caches, init_params
    from repro_torch.models import moe as moe_mod
    from repro_torch.serve import decode_step, prefill_step

    n_req, p_len, g_len, max_seq = traffic
    cfg = get_config("deepseek-v2-lite-16b")
    inv_cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=8.0))
    n_moe = cfg.num_layers - cfg.moe.first_dense_layers
    k = cfg.moe.top_k
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    free0, total = torch.cuda.mem_get_info()
    torch.cuda.reset_peak_memory_stats()
    params, init_s = timed(lambda: init_params(cfg, SEED))
    n_params = sum(t.numel() for t in tree_leaves(params))
    phase("moe init", arch=cfg.name, layers=cfg.num_layers,
          params=n_params, param_gb=n_params * 4 / 1e9,
          free_gb_before=free0 / 1e9, total_gb=total / 1e9,
          seconds=init_s)

    # ---- the invariant, with routing recorded
    inner = moe_mod.route
    calls = []

    def recording(router_w, x2d, c):
        out = inner(router_w, x2d, c)
        with torch.no_grad():
            top = torch.topk(torch.softmax(x2d.float() @ router_w, -1),
                             k + 1, dim=-1).values
            load = torch.bincount(out[0].reshape(-1),
                                  minlength=c.moe.num_experts).max()
        calls.append((torch.sort(out[0], dim=-1).values,
                      top[:, k - 1] - top[:, k], load,
                      moe_mod._capacity(x2d.shape[0], c)))
        return out

    toks = torch.from_numpy(np.random.default_rng(SEED + 6).integers(
        0, cfg.vocab_size, (n_req, p_len + g_len))).to(dev)
    prompt = toks[:, :p_len]
    moe_mod.route = recording
    try:
        full, full_s, n_full = during(
            lambda: forward(params, inv_cfg, {"tokens": toks})[0])
        full_routes, calls[:] = list(calls), []
        full = full[:, p_len - 1:].clone()     # frees the other 1.7 GB
        caches = init_caches(inv_cfg, n_req, max_seq, torch.float32)
        (lg, caches), pre_s, n_pre = during(lambda: prefill_step(
            params, inv_cfg, {"tokens": prompt}, caches))
        step_routes, calls[:] = [list(calls)], []
        errs = [(lg[:, 0] - full[:, 0]).abs().amax(-1)]

        def decode_all():
            c = caches
            for i in range(p_len, p_len + g_len):
                out, c = decode_step(params, inv_cfg, toks[:, i:i + 1], c, i)
                errs.append((out[:, 0] - full[:, i - p_len + 1]).abs()
                            .amax(-1))
                step_routes.append(list(calls))
                calls[:] = []
            return c

        caches, dec_s, n_dec = during(decode_all)
    finally:
        moe_mod.route = inner
    want = {f.__name__: cfg.num_layers if f is flash_attention else 0
            for f in counted}
    check(n_full == n_pre == want,
          f"{cfg.name}: launches per forward {n_full}, per prefill {n_pre}, "
          f"want {want}")
    check(not any(n_dec.values()), f"{cfg.name}: decode launched {n_dec}")
    check(len(full_routes) == n_moe and all(len(r) == n_moe
                                            for r in step_routes),
          f"{cfg.name}: routed {len(full_routes)} / "
          f"{[len(r) for r in step_routes]} times, want {n_moe}")
    # no assignment dropped on either route
    check(all(int(load) <= cap for _, _, load, cap in
              full_routes + [c for r in step_routes for c in r]),
          f"{cfg.name}: an expert took more than its capacity at "
          "capacity_factor 8")
    # each layer's sets and margins as (B, S, k) / (B, S): the prefill's
    # 512 positions, then one per decode step
    n_tok = p_len + g_len
    f_sets = torch.stack([r[0] for r in full_routes]).view(
        n_moe, n_req, n_tok, k)
    f_marg = torch.stack([r[1] for r in full_routes]).view(
        n_moe, n_req, n_tok)
    s_sets = torch.cat([torch.stack([r[0] for r in rs]).view(
        n_moe, n_req, -1, k) for rs in step_routes], dim=2)
    s_marg = torch.cat([torch.stack([r[1] for r in rs]).view(
        n_moe, n_req, -1) for rs in step_routes], dim=2)
    flip = (f_sets != s_sets).any(-1)                  # (L, B, S)
    seq_flips = flip.any(-1)                           # (L, B)
    first = torch.where(seq_flips.any(0), seq_flips.float().argmax(0),
                        torch.full((n_req,), n_moe, device=dev))
    at_first = flip & (torch.arange(n_moe, device=dev)[:, None, None]
                       == first[None, :, None])
    first_margin = torch.maximum(f_marg, s_marg)[at_first]
    worst_first = (first_margin.max().item() if first_margin.numel()
                   else 0.0)
    check(worst_first < FLIP_MARGIN,
          f"{cfg.name}: a first routing flip has margin {worst_first}, "
          f"not a near-tie (< {FLIP_MARGIN})")
    held = ~seq_flips.any(0)                           # (B,)
    scale = full.abs().max().item()
    tol_s = 1e-4 * scale
    err = torch.stack(errs, dim=1)                     # (B, 1 + g_len)
    held_err = err[held].max().item() if bool(held.any()) else float("nan")
    check(bool(held.any()), f"{cfg.name}: every sequence had a routing "
          "flip, so no sequence's logits were held")
    check(np.isfinite(held_err) and held_err <= tol_s,
          f"{cfg.name} prefill/decode vs full forward: max err {held_err} "
          f"over {tol_s} (logit scale {scale})")
    phase("serve invariant", arch=cfg.name, requests=n_req, prompt=p_len,
          decode_steps=g_len, forward_tokens=n_tok, capacity_factor=8.0,
          decisions=flip.numel(), flipped=int(flip.sum()),
          first_flips=int(at_first.sum()),
          worst_first_flip_margin=worst_first, margin_bound=FLIP_MARGIN,
          sequences_held=int(held.sum()), max_abs_err=held_err,
          tolerance=tol_s, logit_scale=scale,
          min_margin=torch.minimum(f_marg, s_marg).min().item(),
          per_prefill=json.dumps({k_: v for k_, v in n_pre.items() if v}),
          forward_ms=full_s * 1e3, prefill_ms=pre_s * 1e3,
          decode_ms_per_step=dec_s * 1e3 / g_len)
    del full, lg, caches, errs, full_routes, step_routes, f_sets, s_sets

    # ---- serving at the config's capacity factor
    caches = init_caches(cfg, n_req, max_seq, torch.float32)
    (lg, caches), pre_s, n_pre = during(
        lambda: prefill_step(params, cfg, {"tokens": prompt}, caches))
    check(n_pre["flash_attention"] == cfg.num_layers,
          f"{cfg.name}: launches per prefill {n_pre}")
    check(bool(torch.isfinite(lg).all()), f"{cfg.name}: non-finite logits")

    def decode_all():
        c = caches
        for i in range(p_len, p_len + g_len):
            _, c = decode_step(params, cfg, toks[:, i:i + 1], c, i)
        return c

    _, dec_s, n_dec = during(decode_all)
    check(not any(n_dec.values()), f"{cfg.name}: decode launched {n_dec}")
    phase("serve prefill", arch=cfg.name, ms=pre_s * 1e3,
          tokens_per_s=n_req * p_len / pre_s,
          capacity_factor=cfg.moe.capacity_factor)
    phase("serve decode", arch=cfg.name, ms_per_step=dec_s * 1e3 / g_len,
          tokens_per_s=n_req * g_len / dec_s)
    trace_share(cfg, params, prompt, caches)

    s_eng, n_pages, n_fetches = handoff(cfg, params, prompt, caches,
                                        SSM_POOL)
    ledger(s_eng, n_pages, n_fetches)
    m = cfg.mla
    kv_words = (cfg.num_layers * n_req * max_seq * cfg.num_heads
                * (m.qk_head_dim + m.v_head_dim))
    mla_words = sum(t.numel() for t in tree_leaves(caches))
    phase("serve handoff mla", arch=cfg.name, cache_words=mla_words,
          per_head_kv_words=kv_words, per_head_kv_gb=kv_words * 4 / 1e9,
          ratio=kv_words / mla_words)
    torch.cuda.synchronize()
    phase("moe memory", arch=cfg.name,
          peak_gb=torch.cuda.max_memory_allocated() / 1e9,
          free_gb_before=free0 / 1e9)
    del params, caches, s_eng, lg
    torch.cuda.empty_cache()


def _median(xs):
    xs = sorted(xs)
    return xs[len(xs) // 2]


def _tuner_live(device, seed=TUNER_SEED, pool=TUNER_POOL):
    """A live engine with the reference bench's traffic profile
    (``benchmarks/bench_autotune.py``): eight host READs of 8..47 words
    on one QP, one doorbell; its learned buckets seed the trials."""
    from repro_torch.core.rdma import Opcode, RDMAEngine, WQE
    eng = RDMAEngine(n_peers=2, pool_size=pool, device=device)
    mr = eng.register_mr(1, 0, pool // 4)
    qp = eng.create_qp(0, 1)
    rng = np.random.default_rng(seed)
    for i in range(8):
        ln = int(rng.integers(8, 48))
        eng.post_send(qp, WQE(Opcode.READ, qp.qp_num, wr_id=i,
                              local_addr=int(rng.integers(0, pool // 4 - ln)),
                              remote_addr=int(rng.integers(0, pool // 4 - ln)),
                              length=ln, rkey=mr.rkey))
    eng.ring_sq_doorbell(qp)
    return eng


def autotune_phase(dev):
    """Phase 23: the knob sweep on the card's engine. Two
    ``AutoTuner(passes=2, rows=128)`` sweeps of a live engine on ``dev``
    (``apply=False``) must give the same chosen point and surface, and
    the same as a sweep of a CPU engine of the same geometry; the first
    choice is then installed with ``apply_tuning``. Scores are functions
    of the trials' flush and WQE counts, so the card must choose as the
    CPU does; the trials' walls are the card's own."""
    from repro_torch._device import synchronize
    from repro_torch.core.rdma import AutoTuner

    def surface(t):
        return [(r.tuning.key(), r.flushes, r.wqes, r.score)
                for r in t.surface]

    eng = _tuner_live(dev)
    check(eng.pool.device.type == dev.type, "tuner engine off the device")
    tuners, picks, walls = [], [], []
    for _ in range(2):
        synchronize(dev)
        t = time.perf_counter()
        tuner = AutoTuner(eng, seed=TUNER_SEED, passes=2, rows=128)
        picks.append(tuner.sweep(apply=False))
        synchronize(dev)
        walls.append(time.perf_counter() - t)
        tuners.append(tuner)
    at = tuners[0].result
    eng.stats["autotune"] = at
    eng.apply_tuning(picks[0])
    t = time.perf_counter()
    cpu = AutoTuner(_tuner_live("cpu"), seed=TUNER_SEED, passes=2, rows=128)
    cpu_pick = cpu.sweep(apply=False)
    cpu_wall = time.perf_counter() - t
    check(picks[1] == picks[0] and surface(tuners[1]) == surface(tuners[0]),
          "two sweeps on the card disagree")
    check(cpu_pick == picks[0] and surface(cpu) == surface(tuners[0]),
          f"the card chose {picks[0]}, the CPU {cpu_pick}")
    check(eng.tuning == picks[0], "apply_tuning did not install the choice")
    check(all(r.wall_s > 0 for r in tuners[0].surface), "trial walls")
    phase("autotune", device=dev.type, seed=TUNER_SEED,
          chosen=json.dumps({k: v for k, v in picks[0].as_dict().items()
                             if k != "rx_depth"}),
          trials=at["trials"], improvement=at["improvement"],
          score=at["score"], default_score=at["default_score"],
          sweep_s=[round(w, 4) for w in walls], cpu_sweep_s=cpu_wall,
          same_as_cpu=True)
    phase("autotune trials", device=dev.type,
          wall_ms=[round(r.wall_s * 1e3, 3) for r in tuners[0].surface],
          flushes=[r.flushes for r in tuners[0].surface],
          wqes=[r.wqes for r in tuners[0].surface])


def executor_cost_phase(dev, calls=64):
    """Phase 24: the port's executor cost profile on ``dev``, host walls
    of synchronised calls on an engine of its own: ``dispatch_s`` the
    median of ``calls`` one-descriptor ``execute_batch`` calls (16 words,
    a warm bucket), ``staging_dispatch_s`` the median of ``calls`` 16-word
    ``host_write`` calls, ``compile_s`` the median over eight fresh
    (slots, chunk) buckets of a bucket's first call less the median of
    nine warm calls of it. Printed beside the committed profile; no
    timing is checked (host walls move up to 2x between runs). Returns
    the measured ``ExecutorCost``."""
    from repro_torch._device import synchronize
    from repro_torch.core.rdma import RDMAEngine
    from repro_torch.core.rdma.cost_model import EXECUTOR_COST, ExecutorCost

    tr = RDMAEngine(n_peers=2, pool_size=1 << 20, device=dev).transport

    def wall(fn):
        synchronize(dev)
        t = time.perf_counter()
        fn()
        synchronize(dev)
        return time.perf_counter() - t

    def desc(length):
        return [("xfer", 1, 0, 0, 1 << 19, length)]

    one = desc(16)
    data = np.arange(16, dtype=np.float32)
    for _ in range(5):                     # the 16-word buckets, warm
        tr.execute_batch(one)
        tr.host_write(0, 4096, data)
    dispatch = _median([wall(lambda: tr.execute_batch(one))
                        for _ in range(calls)])
    staging = _median([wall(lambda: tr.host_write(0, 4096, data))
                       for _ in range(calls)])
    extra = []
    for length in (32, 64, 128, 256, 512, 1024, 2048, 4096):
        p = desc(length)
        misses = tr.stats["cache_misses"]
        first = wall(lambda: tr.execute_batch(p))
        check(tr.stats["cache_misses"] == misses + 1,
              f"bucket of {length} words was not fresh")
        extra.append(first - _median([wall(lambda: tr.execute_batch(p))
                                      for _ in range(9)]))
    measured = ExecutorCost(compile_s=_median(extra), dispatch_s=dispatch,
                            staging_dispatch_s=staging)
    phase("executor cost", device=dev.type, calls=calls,
          dispatch_us=measured.dispatch_s * 1e6,
          staging_dispatch_us=measured.staging_dispatch_s * 1e6,
          compile_us=measured.compile_s * 1e6,
          compile_us_each=[round(x * 1e6, 2) for x in extra],
          committed_dispatch_us=EXECUTOR_COST.dispatch_s * 1e6,
          committed_staging_dispatch_us=EXECUTOR_COST.staging_dispatch_s
          * 1e6,
          committed_compile_us=EXECUTOR_COST.compile_s * 1e6)
    return measured


def paper_model_phase(stats, walls, read16k, measured, testcase_dir):
    """Phase 25: the paper's hardware beside the port on the card.
    ``predict_from_stats`` over the datapath engine's stats after phases
    3-6 (``stats``) and over ``read_batch_16k``'s own counts
    (``read16k``), each under the committed executor profile and the one
    measured in this run, beside the measured walls; ``simulate_rdma`` at
    ``read_batch_16k`` (the paper's ~89 Gb/s) beside the port's rate; and
    ``run_testcase`` over every JSON testcase, each anchor checked."""
    import glob

    from repro_torch.core.rdma.simulator import (predict_from_stats,
                                                 run_testcase,
                                                 simulate_rdma)

    def model(st, name, wall_s, **extra):
        p = predict_from_stats(st, payload=16384, op="read")
        q = predict_from_stats(st, payload=16384, op="read",
                               executor=measured)
        check(p["hw_predicted_s"] > 0 and p["wqes_per_doorbell"] > 0,
              f"paper model of {name}: no executed work")
        phase("paper model " + name,
              dispatches=st.get("dispatches", st.get("doorbells")),
              wqes=st.get("transport", st)["wqes"],
              wqes_per_doorbell=p["wqes_per_doorbell"],
              hw_predicted_s=p["hw_predicted_s"],
              executor_predicted_s=p["executor_predicted_s"],
              executor_predicted_s_this_run=q["executor_predicted_s"],
              measured_wall_s=wall_s,
              measured_over_executor_predicted=(
                  wall_s / p["executor_predicted_s"]
                  if p["executor_predicted_s"] else None),
              **extra)

    model(stats, "datapath", sum(walls.values()),
          walls_ms=json.dumps({k: round(v * 1e3, 3)
                               for k, v in walls.items()}))
    sim = simulate_rdma("read", 16384, 50)
    model(read16k["stats"], "read_batch_16k", read16k["wall_s"],
          reps=read16k["reps"], paper_gbps=sim.throughput_bps / 1e9,
          paper_us_per_doorbell=sim.total_time * 1e6,
          measured_gbps_median=read16k["gbps_median"],
          measured_us_per_doorbell_median=read16k["wall_median_s"] * 1e6)
    cases = sorted(glob.glob(os.path.join(testcase_dir, "*.json")))
    check(len(cases) >= 8, f"{len(cases)} testcases in {testcase_dir}")
    n_checks = 0
    for path in cases:
        out = run_testcase(path)
        check(out["pass"], f"{os.path.basename(path)}: {out['checks']}")
        n_checks += len(out["checks"])
    phase("paper model testcases", cases=len(cases), anchors=n_checks,
          passed=True)


# ---- 26. the multi-process path --------------------------------------------

def _digest(arr) -> str:
    return hashlib.sha256(np.ascontiguousarray(arr).tobytes()).hexdigest()


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def read16k_wqes(base):
    """``read_batch_16k``'s (local, remote, length) READs: 50 of 16 KiB,
    strided so none coalesce, landing from ``base``."""
    words, batch, gap = READ16K
    return [(base + i * gap, i * gap, words) for i in range(batch)]


def read_doorbell(eng, qp, rkey, wqes, dev):
    """Post ``wqes`` as (local, remote, length) READs on ``qp``, ring one
    doorbell; returns the synchronised wall in seconds (every completion
    checked)."""
    from repro_torch.core.rdma import Opcode, WQE
    for i, (loc, rem, ln) in enumerate(wqes):
        eng.post_send(qp, WQE(Opcode.READ, qp.qp_num, i, local_addr=loc,
                              remote_addr=rem, length=ln, rkey=rkey))
    _sync(dev)
    t = time.perf_counter()
    eng.ring_sq_doorbell(qp)
    _sync(dev)
    wall = time.perf_counter() - t
    cq = eng.poll_cq(qp, 1 << 10)
    check(len(cq) == len(wqes) and all(c.status.value == "success"
                                       for c in cq), "READ completions")
    return wall


def read16k_traffic(eng, dev):
    """``read_batch_16k`` on ``eng``: 5 doorbells of its READs from
    DATA_PEER into LC_PEER over a host_mem QP, as phase 6 runs it;
    returns each doorbell's synchronised wall in seconds and a digest of
    the whole pool."""
    from repro_torch.core.rdma import Placement
    base = MP_POOL // 2
    mr = eng.register_mr(DATA_PEER, 0, MP_POOL)
    eng.write_buffer(DATA_PEER, 0, np.random.default_rng(
        SEED + 20).standard_normal(base, np.float32))
    qp = eng.create_qp(LC_PEER, DATA_PEER, placement=Placement.HOST_MEM)
    eng.create_qp(DATA_PEER, LC_PEER, placement=Placement.HOST_MEM)
    wqes = read16k_wqes(base)
    walls = [read_doorbell(eng, qp, mr.rkey, wqes, dev) for _ in range(5)]
    return walls, _digest(eng.transport.gather_pool())


def lookaside_traffic(eng):
    """``lc_offload_mm`` 512x16x512 and a 4096-packet PARSER_WORKLOAD
    through a LookasideBlock on LC_PEER; digests of the product, of the
    meta rows and of the whole pool."""
    from repro_torch.core.lookaside import ControlMsg, LookasideBlock
    from repro_torch.kernels import lc_offload as lco
    rng = np.random.default_rng(SEED + 21)
    blk = LookasideBlock(eng, peer=LC_PEER, scratch_base=MP_POOL // 2)
    lco.register_default_kernels(blk)
    mr = eng.register_mr(DATA_PEER, 0, MP_POOL // 2)
    m, k, n = 512, 16, 512
    A = rng.standard_normal((m, k), np.float32)
    B = rng.standard_normal((k, n), np.float32)
    a, b, out = 0, m * k, m * k + k * n
    eng.write_buffer(DATA_PEER, a, A.ravel())
    eng.write_buffer(DATA_PEER, b, B.ravel())
    check(blk.dispatch(ControlMsg(lco.MM_WORKLOAD, (
        DATA_PEER, mr.rkey, a, b, out, m, k, n))) is None,
        "MM dispatch refused")
    st = blk.poll(lco.MM_WORKLOAD)
    check(st is not None and st.ok, f"MM status {st}")
    C = eng.read_buffer(DATA_PEER, out, m * n)
    n_pkts = 4096
    p_addr = out + m * n
    m_addr = p_addr + n_pkts * 64
    pkts = roce_mix(rng, n_pkts)
    eng.write_buffer(DATA_PEER, p_addr, pkts.astype(np.float32).ravel())
    check(blk.dispatch(ControlMsg(lco.PARSER_WORKLOAD, (
        DATA_PEER, mr.rkey, p_addr, n_pkts, m_addr))) is None,
        "parser dispatch refused")
    st = blk.poll(lco.PARSER_WORKLOAD)
    check(st is not None and st.ok, f"parser status {st}")
    meta = eng.read_buffer(DATA_PEER, m_addr, n_pkts * 4)
    return {"mm": _digest(C), "parser": _digest(meta),
            "pool": _digest(eng.transport.gather_pool())}


def pipeline_case(seed=0, stages=MP_RANKS, micro=8, d=16):
    """The reference test's pipeline geometry (8 microbatches of 4 x 16,
    seed 0), ``stages`` stages of ``tanh(x @ w + b)``."""
    rng = np.random.default_rng(seed)
    ws = (rng.normal(size=(stages, d, d)) * 0.5).astype(np.float32)
    bs = (rng.normal(size=(stages, d)) * 0.1).astype(np.float32)
    xs = rng.normal(size=(micro, 4, d)).astype(np.float32)
    return ws, bs, xs


def _rank_setup(rank, device):
    """A phase-26 rank's device (``rank_device(rank, device)``) and the
    counted kernel wrappers, their launches set to 0."""
    from repro_torch._device import rank_device
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.packet_parser import (parse_packet_fields,
                                                   parse_packets)
    from repro_torch.kernels.quantize_stream import (dequantize_stream,
                                                     quantize_stream)
    from repro_torch.kernels.ssd_scan import ssd_scan
    from repro_torch.kernels.systolic_mm import systolic_mm
    torch.backends.cuda.matmul.allow_tf32 = False
    counted = (systolic_mm, parse_packets, parse_packet_fields,
               quantize_stream, dequantize_stream, flash_attention,
               ssd_scan)
    for fn in counted:
        fn.launches = 0
    return rank_device(rank, device), counted


def _launches(dev, counted):
    _sync(dev)
    return {fn.__name__: fn.launches for fn in counted}


def _peak_reset(dev):
    if dev.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)


def _peak_gb(dev):
    return (torch.cuda.max_memory_allocated(dev) / 1e9
            if dev.type == "cuda" else None)


def _mp_datapath_rank(rank, device):
    """26 (a), (b), (e) in one rank: read_batch_16k on a 2-peer engine
    over the ranks (an ICITransport), the Lookaside block over the
    twin, the pipeline over a ("stage",) mesh."""
    import torch.distributed as dist
    from repro_torch.core.rdma import RDMAEngine
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.train.pipeline_parallel import pipeline_forward
    dev, counted = _rank_setup(rank, device)
    out = {"device": str(dev), "world": dist.get_world_size()}
    eng = RDMAEngine(n_peers=2, pool_size=MP_POOL, device=dev)
    out["transport"] = type(eng.transport).__name__
    out["walls"], out["pool"] = read16k_traffic(eng, dev)
    out["stats"] = {k: eng.transport.stats[k] for k in (
        "dispatches", "wqes", "compiles", "coalesced_wqes")}
    out["lookaside"] = lookaside_traffic(
        RDMAEngine(n_peers=2, pool_size=MP_POOL, device=dev))
    ws, bs, xs = pipeline_case()
    run = pipeline_forward(lambda p, x: torch.tanh(x @ p["w"] + p["b"]),
                           make_mesh((MP_RANKS,), ("stage",)), "stage",
                           n_microbatches=xs.shape[0])
    got = run({"w": torch.from_numpy(ws).to(dev),
               "b": torch.from_numpy(bs).to(dev)},
              torch.from_numpy(xs).to(dev))
    out["pipeline"] = {"got": got.cpu().numpy(), "sends": run.sends}
    out["launches"] = _launches(dev, counted)
    return out


def _train_data(cfg, dev, batch, seq):
    """Phase 18's batch: ``SyntheticPipeline`` from SEED, on ``dev``."""
    from repro_torch.data.pipeline import DataConfig, SyntheticPipeline
    return {k: torch.from_numpy(v).to(dev) for k, v in SyntheticPipeline(
        DataConfig(seed=SEED, vocab_size=cfg.vocab_size, batch=batch,
                   seq_len=seq)).batch_at(0).items()}


def forward_loss(params, cfg, data):
    """The loss of ``params`` on ``data``: one forward, no gradients."""
    from repro_torch.models.transformer import loss_fn
    with torch.no_grad():
        return float(loss_fn(params, cfg, data))


def _train_config(**kw):
    """Phase 18's training settings (remat, 16 MiB buckets; the cosine
    reaches 0 at step 4, after phase 18's three)."""
    from repro_torch.configs.base import TrainConfig
    return TrainConfig(**{**dict(
        learning_rate=3e-4, warmup_steps=1, total_steps=4, remat=True,
        zero1=False, sequence_parallel=False, grad_bucket_mb=16), **kw})


def _near(got, want, what, rtol=1e-5):
    check(abs(got - want) <= rtol * abs(want), f"{what} {got} vs {want}")


def _mp_train_rank(rank, device, cfg, plain, seq, batch):
    """26 (c) in one rank: ``cfg`` from SEED on phase 18's global batch
    split over a ("data",) mesh: two ``sync="psum"`` steps, then one
    ZeRO-1 ``make_train_step(mesh)`` step and one forward. ``plain`` is
    phase 18's (losses, step 1's gradient norm): the psum steps' losses
    and the ZeRO-1 step's, then the forward's, within 1e-5 of phase 18's
    four, step 1's synced norm within GRAD_SYNC_TOL, ``buckets + 1``
    collectives a step, each rank holding half the moments' words."""
    from repro_torch._tree import tree_leaves
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import init_params
    from repro_torch.train import (init_adam, make_bucketed_train_step,
                                   zero1_init)
    from repro_torch.train.train_step import _bucketize, make_train_step
    plain_losses, plain_norm = plain
    dev, counted = _rank_setup(rank, device)
    tcfg = _train_config()
    data = _train_data(cfg, dev, batch, seq)
    mesh = make_mesh((MP_RANKS,), ("data",))
    params = init_params(cfg, SEED, device=dev)
    n_buckets = len(_bucketize(params, 16 << 20)[1])
    step = make_bucketed_train_step(cfg, tcfg, mesh)
    opt = init_adam(params)
    _peak_reset(dev)
    c = {"step_s": [], "losses": [], "grad_norms": [], "collectives": []}
    for _ in range(2):
        _sync(dev)
        t = time.perf_counter()
        loss, params, opt, _ = step(params, opt, data, None)
        _sync(dev)
        c["step_s"].append(time.perf_counter() - t)
        c["losses"].append(float(loss))
        c["grad_norms"].append(float(step.grad_norm))
        c["collectives"].append(step.collectives)
    c["peak_gb"] = _peak_gb(dev)
    c["buckets"] = n_buckets
    for i in range(2):
        _near(c["losses"][i], plain_losses[i], f"psum step {i + 1} loss")
    _near(c["grad_norms"][0], plain_norm, "psum step 1 gradient norm",
          GRAD_SYNC_TOL)
    check(c["collectives"] == [n_buckets + 1] * 2,
          f"collectives {c['collectives']}, buckets {n_buckets}")
    del step
    zstep = make_train_step(cfg, _train_config(zero1=True), mesh)
    opt = zero1_init(opt, mesh)
    _peak_reset(dev)
    _sync(dev)
    t = time.perf_counter()
    loss, params, opt = zstep(params, opt, data)
    _sync(dev)
    z = c["zero1"] = {
        "step_s": time.perf_counter() - t, "loss": float(loss),
        "collectives": zstep.collectives, "peak_gb": _peak_gb(dev),
        "m_words": sum(x.numel() for x in tree_leaves(opt.m)),
        "param_words": sum(x.numel() for x in tree_leaves(params)),
        "loss_after": forward_loss(params, cfg, data)}
    _near(z["loss"], plain_losses[2], "ZeRO-1 step loss")
    _near(z["loss_after"], plain_losses[3], "loss after the ZeRO-1 step")
    check(z["m_words"] * MP_RANKS == z["param_words"],
          f"ZeRO-1 m holds {z['m_words']} of {z['param_words']} words")
    c["launches"] = _launches(dev, counted)
    return c


def _mp_compressed_rank(rank, device, cfg, plain_norm, seq, batch,
                        microbatches):
    """26 (d) in one rank: one ``compress_grads`` step of ``cfg`` from
    SEED on a ("pod", "data") = (2, 1) mesh, residuals from zero.

    Each bucket's compressed sync is checked on its way in: on the
    largest bucket, K1 and K2 bit-exact against their plain versions
    (those launches are put back: they are not the path's); on every
    bucket, the plain formula's error, this rank's codes at the pods'
    mean scale less its target, summed over the pods. Its norm over the
    buckets is how far the synced gradients lie from the pods' true sum,
    so the step's synced gradient norm must lie within it (and
    GRAD_SYNC_TOL for the summation order) of phase 18's ``plain_norm``.
    """
    import torch.distributed as dist
    import repro_torch.train.train_step as ts
    from repro_torch.core.streaming.compress import init_error_state
    from repro_torch.kernels.quantize_stream import (
        dequantize_stream, dequantize_stream_plain, quantize_stream,
        quantize_stream_plain)
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import init_params
    from repro_torch.train import init_adam, make_bucketed_train_step
    from repro_torch.train.optimizer import global_norm
    dev, counted = _rank_setup(rank, device)
    data = _train_data(cfg, dev, batch, seq)
    step = make_bucketed_train_step(
        cfg, _train_config(compress_grads=True, microbatches=microbatches),
        make_mesh((MP_RANKS, 1), ("pod", "data")))
    params = init_params(cfg, SEED, device=dev)
    leaves, buckets = ts._bucketize(params, 16 << 20)
    largest = max(sum(leaves[i].numel() for i in b.leaf_ids)
                  for b in buckets)
    del leaves
    seen = {"err_sq": 0.0, "kernels_checked": 0, "largest_rows": 0}
    synced = ts.compressed_all_reduce_group

    def checked(flat, residual, group, chunk=1024):
        x = flat.to(torch.float32) + residual
        pad = (-x.numel()) % chunk
        if pad:
            x = torch.cat([x, x.new_zeros(pad)])
        x = x.reshape(-1, chunk)
        q, s = quantize_stream_plain(x)
        if flat.numel() == largest and not seen["kernels_checked"]:
            k1, k2 = quantize_stream.launches, dequantize_stream.launches
            qk, sk = quantize_stream(x)
            check(torch.equal(qk, q) and torch.equal(sk, s),
                  f"K1 differs from its plain version at {tuple(x.shape)}")
            del qk, sk
            check(torch.equal(dequantize_stream(q, s),
                              dequantize_stream_plain(q, s)),
                  f"K2 differs from its plain version at {tuple(q.shape)}")
            quantize_stream.launches, dequantize_stream.launches = k1, k2
            seen["kernels_checked"] += 1
            seen["largest_rows"] = x.shape[0]
        live = q.ne(0).any(dim=1, keepdim=True)
        scales = torch.cat([torch.where(live, s, 0.0), live.to(s.dtype)], 1)
        dist.all_reduce(scales, group=group)
        s_mean = scales[:, :1] / scales[:, 1:].clamp_min(1)
        err = q.to(torch.float32).mul_(s_mean).sub_(x)
        del x, q
        dist.all_reduce(err, group=group)
        seen["err_sq"] += float(torch.linalg.vector_norm(err)) ** 2
        del err
        return synced(flat, residual, group, chunk=chunk)

    ts.compressed_all_reduce_group = checked
    _peak_reset(dev)
    _sync(dev)
    t = time.perf_counter()
    # no name holds the zero residuals or the fresh AdamW state, so the
    # step frees the old residuals once the buckets are synced: two
    # ranks' f32 state, AdamW's new copy and the residuals fill the card
    try:
        loss, params, _, res = step(params, init_adam(params), data,
                                    init_error_state(params))
        _sync(dev)
    finally:
        ts.compressed_all_reduce_group = synced
    err = math.sqrt(seen["err_sq"])
    d = {"step_s": time.perf_counter() - t, "loss": float(loss),
         "grad_norm": float(step.grad_norm), "error_norm": err,
         "residual_norm": float(global_norm(res)),
         "collectives": step.collectives, "peak_gb": _peak_gb(dev),
         "microbatches": microbatches, "k1": quantize_stream.launches,
         "k2": dequantize_stream.launches, "largest_rows":
         seen["largest_rows"], "buckets": len(buckets)}
    check(seen["kernels_checked"] == 1, "the largest bucket never synced")
    check(math.isfinite(d["loss"]) and d["residual_norm"] > 0,
          f"compressed step {d}")
    check(abs(d["grad_norm"] - plain_norm)
          <= err + GRAD_SYNC_TOL * plain_norm,
          f"compressed synced norm {d['grad_norm']} vs plain {plain_norm}, "
          f"error {err}")
    check(dev.type != "cuda" or d["k1"] == d["k2"] == len(buckets),
          f"K1/K2 launches {d}")
    d["launches"] = _launches(dev, counted)
    return d


def multi_process_phase(dev, cfg, plain, seq=512, batch=4, microbatches=1):
    """Phase 26 from the parent: the single-process references on
    ``dev`` (read_batch_16k and the Lookaside traffic on a LocalTransport
    engine, the pipeline's sequential stack), then three spawns of
    MP_RANKS gloo ranks on ``dev``'s kind (two on the one card) through
    ``run_peers`` — (a, b, e), (c), (d) — each rank's results held
    against the references and each other. ``plain`` is phase 18's
    (losses, step 1's gradient norm); ``microbatches`` splits (d)'s rank
    batch. Returns the launches summed over every rank."""
    from repro_torch.core.rdma import RDMAEngine
    from repro_torch.launch.mesh import run_peers

    ref_walls, ref_pool = read16k_traffic(
        RDMAEngine(n_peers=2, pool_size=MP_POOL, device=dev), dev)
    la_ref = lookaside_traffic(RDMAEngine(n_peers=2, pool_size=MP_POOL,
                                          device=dev))
    ws, bs, xs = pipeline_case()
    seq_ref = torch.from_numpy(xs).to(dev)
    for s in range(MP_RANKS):
        seq_ref = torch.tanh(seq_ref @ torch.from_numpy(ws[s]).to(dev)
                             + torch.from_numpy(bs[s]).to(dev))
    seq_ref = seq_ref.cpu().numpy()
    cuda = dev.type == "cuda"
    kind, rank_dev = ("cuda", None) if cuda else ("cpu", "cpu")
    # two ranks' f32 training state fill the card: let each rank's
    # allocator grow its segments rather than fragment (set before the
    # ranks start their CUDA contexts)
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF",
                          "expandable_segments:True")

    def spawn(fn, *args):
        _sync(dev)
        if cuda:
            torch.cuda.empty_cache()
        free = torch.cuda.mem_get_info()[0] / 1e9 if cuda else None
        t = time.perf_counter()
        got = run_peers(fn, MP_RANKS, device=kind, timeout_s=MP_TIMEOUT_S,
                        args=(rank_dev,) + args)
        return got, time.perf_counter() - t, free

    got, wall, free = spawn(_mp_datapath_rank)
    r0 = got[0]
    for r in got:
        check(r["transport"] == "ICITransport", f"the twin runs on "
              f"{r['transport']}")
        check(r["pool"] == ref_pool, "the twin's pool after read_batch_16k "
              "differs from LocalTransport's")
        check(r["lookaside"] == la_ref, "the Lookaside results over the "
              "twin differ from the single-process run")
        err = float(np.abs(r["pipeline"]["got"] - seq_ref).max())
        check(err < 1e-5, f"pipeline {err} from the sequential stack")
        check(r["pipeline"]["sends"] == xs.shape[0] + MP_RANKS - 1,
              f"pipeline sends {r['pipeline']['sends']}")
    phase("multi-process", ranks=MP_RANKS, device=r0["device"],
          world=r0["world"], spawn_and_run_s=wall, free_gb_before=free,
          wire="gloo through host")
    phase("multi-process twin read_batch_16k", wire="gloo through host",
          twin_ms=json.dumps([round(w * 1e3, 4) for w in r0["walls"]]),
          twin_ms_median=_median(r0["walls"]) * 1e3,
          local_ms=json.dumps([round(w * 1e3, 4) for w in ref_walls]),
          local_ms_median=_median(ref_walls) * 1e3,
          byte_equal=True, **r0["stats"])
    phase("multi-process lookaside", shape="512x16x512", packets=4096,
          byte_equal=True)
    phase("multi-process pipeline", stages=MP_RANKS, microbatches=8,
          max_abs_err=max(float(np.abs(r["pipeline"]["got"] - seq_ref)
                                .max()) for r in got),
          sends=r0["pipeline"]["sends"])
    ranks = list(got)

    plain_losses, plain_norm = plain
    got, wall, free = spawn(_mp_train_rank, cfg, plain, seq, batch)
    c = got[0]
    check(all(r["losses"] == c["losses"] for r in got),
          "the ranks' psum losses differ")
    phase("multi-process train psum", arch=cfg.name, ranks=MP_RANKS,
          batch=f"{batch}x{seq}", wire="gloo through host",
          losses=json.dumps(c["losses"]),
          plain_losses=json.dumps(plain_losses[:2]),
          loss_rel=json.dumps([abs(a - b) / abs(b) for a, b in zip(
              c["losses"], plain_losses)]),
          grad_norm=c["grad_norms"][0], plain_grad_norm=plain_norm,
          norm_rel=abs(c["grad_norms"][0] - plain_norm) / plain_norm,
          buckets=c["buckets"], collectives=json.dumps(c["collectives"]),
          step_ms=json.dumps([t * 1e3 for t in c["step_s"]]),
          peak_gb_each=json.dumps([r["peak_gb"] for r in got]),
          free_gb_before=free, spawn_and_run_s=wall)
    z = c["zero1"]
    phase("multi-process train zero1", loss=z["loss"],
          plain_loss=plain_losses[2], loss_after=z["loss_after"],
          plain_loss_after=plain_losses[3],
          step_ms=z["step_s"] * 1e3, collectives=z["collectives"],
          m_words=z["m_words"], param_words=z["param_words"],
          peak_gb_each=json.dumps([r["zero1"]["peak_gb"] for r in got]))
    ranks += got

    got, wall, free = spawn(_mp_compressed_rank, cfg, plain_norm, seq,
                            batch, microbatches)
    d = got[0]
    check(all(r["loss"] == d["loss"] and r["grad_norm"] == d["grad_norm"]
              for r in got), "the ranks' compressed steps differ")
    phase("multi-process train compressed", mesh="pod 2 x data 1",
          loss=d["loss"], grad_norm=d["grad_norm"],
          plain_grad_norm=plain_norm,
          norm_rel=abs(d["grad_norm"] - plain_norm) / plain_norm,
          error_norm=d["error_norm"], error_rel=d["error_norm"] / plain_norm,
          buckets=d["buckets"], k1_k2_checked_rows=d["largest_rows"],
          residual_norm=d["residual_norm"],
          step_ms=d["step_s"] * 1e3, collectives=d["collectives"],
          microbatches=d["microbatches"], k1=d["k1"], k2=d["k2"],
          peak_gb_each=json.dumps([r["peak_gb"] for r in got]),
          free_gb_before=free, spawn_and_run_s=wall)
    ranks += got
    return {name: sum(r["launches"][name] for r in ranks)
            for name in r0["launches"]}


# ---- 27. the dry-run against the card -----------------------------------

def _wall_ms(fn):
    """ms of ``fn()`` between two synchronisations; its result is dropped
    (a train step's is a second copy of the state)."""
    torch.cuda.synchronize()
    t = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t) * 1e3


def dryrun_cells():
    """Phase 27's cells, each a step the smoke runs elsewhere: (arch,
    shape) with tinyllama-1.1b's prefill of 8 x 512 (phase 11) and plain
    train step of 4 x 512 (phase 18), and mamba2-370m's prefill of 8 x
    512 (phase 14); f32, one device."""
    from repro_torch.configs.base import ShapeConfig
    return (("tinyllama-1.1b", ShapeConfig("prefill_8x512", 512, 8,
                                           "prefill")),
            ("tinyllama-1.1b", ShapeConfig("train_4x512", 512, 4, "train")),
            ("mamba2-370m", ShapeConfig("prefill_8x512", 512, 8,
                                        "prefill")))


def dryrun_sweep(meshes=("single", "multi"), timeout_s=900):
    """``launch.dryrun --all`` on ``meta`` over ``meshes``, one process a
    mesh, all started together: (ok, skipped, failed, wall seconds)."""
    env = {**os.environ, "PYTHONPATH": os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "src")}
    out_dir = tempfile.mkdtemp(prefix="chip_smoke_dryrun_")
    procs = []
    t = time.perf_counter()
    try:
        for mesh in meshes:
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "repro_torch.launch.dryrun", "--all",
                 "--mesh", mesh, "--out", os.path.join(out_dir, mesh)],
                env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True))
        logs = [p.communicate(timeout=timeout_s)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        shutil.rmtree(out_dir, ignore_errors=True)
    wall = time.perf_counter() - t
    counts = [0, 0, 0]
    for mesh, p, log in zip(meshes, procs, logs):
        m = re.search(r"done: (\d+) ok, (\d+) skipped, (\d+) failed", log)
        check(m is not None, f"dry-run --mesh {mesh} printed no summary "
                             f"(exit {p.returncode}):\n{log[-3000:]}")
        counts = [c + int(x) for c, x in zip(counts, m.groups())]
        for line in log.splitlines():
            if line.startswith("FAIL"):
                print("  " + line)
    return (*counts, wall)


def dryrun_phase(dev, mem_tol=None):
    """27. Each of ``dryrun_cells`` traced by ``roofline.count.OpCounter``
    on ``meta`` (``launch.dryrun.build_cell``, as the dry-run traces it)
    and then run on the card under the same counter, from SEED: (a) the
    FLOPs, bytes and each kernel's charges equal; (b) the predicted peak
    live bytes within ``mem_tol`` (relative) of the card's peak
    allocated over the run, less what was allocated beside the inputs;
    (c) the roofline's compute, memory and bound beside the step's wall,
    one more run without the counter (printed only). Then (d) the
    dry-run's sweep, ``--all`` over the single and multi-pod meshes on
    ``meta``, with 0 failed. Returns the kernels charged on the card."""
    from repro_torch.configs.base import MeshConfig
    from repro_torch.configs.registry import get_config
    from repro_torch.launch.dryrun import build_cell, trace
    from repro_torch.roofline.analysis import analyze

    mem_tol = DRYRUN_MEM_TOL if mem_tol is None else mem_tol
    mesh = MeshConfig((1,), ("data",))
    tcfg = _train_config(param_dtype="float32")
    charged = {}
    for arch, shape in dryrun_cells():
        cfg = get_config(arch)
        fn, inputs, plan = build_cell(cfg, shape, mesh, tcfg)
        meta = trace(fn, inputs)
        del fn, inputs
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        fn, inputs, plan = build_cell(cfg, shape, mesh, tcfg, device=dev,
                                      seed=SEED)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        card = trace(fn, inputs)
        torch.cuda.synchronize()
        # the peak less what lay on the card beside the inputs
        peak = (torch.cuda.max_memory_allocated()
                - (base - card["input_bytes"]))
        for key in ("flops", "bytes", "kernels"):
            check(meta[key] == card[key],
                  f"dry-run {arch} {shape.name}: {key} on meta "
                  f"{meta[key]}, on the card {card[key]}")
        pred = meta["peak_bytes"]
        mem_err = (pred - peak) / peak
        check(abs(mem_err) <= mem_tol,
              f"dry-run {arch} {shape.name}: predicted peak {pred} bytes, "
              f"the card {peak} ({mem_err:+.4f}, over {mem_tol})")
        for name, k in card["kernels"].items():
            charged[name] = charged.get(name, 0) + k["calls"]
        wall_ms = _wall_ms(fn)
        del fn, inputs
        roof = analyze(arch, shape.name, "1:data", 1, meta, plan.collectives,
                       cfg, shape, "float32")
        bound_ms = max(roof.compute_s, roof.memory_s) * 1e3
        phase("dryrun cell", arch=arch, shape=shape.name, kind=shape.kind,
              flops=meta["flops"], bytes=meta["bytes"],
              kernels=json.dumps(meta["kernels"], sort_keys=True),
              equal_on_meta_and_card=True,
              predicted_peak_gb=pred / 1e9, card_peak_gb=peak / 1e9,
              card_max_allocated_gb=torch.cuda.max_memory_allocated() / 1e9,
              peak_err=mem_err, peak_tol=mem_tol,
              compute_ms=roof.compute_s * 1e3, memory_ms=roof.memory_s * 1e3,
              bound_ms=bound_ms, dominant=roof.dominant, wall_ms=wall_ms,
              bound_over_wall=bound_ms / wall_ms, hardware=json.dumps(
                  roof.hardware))
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
    n_ok, n_skip, n_fail, wall = dryrun_sweep()
    phase("dryrun sweep", meshes="single,multi", processes=2, ok=n_ok,
          skipped=n_skip, failed=n_fail, wall_s=wall)
    check(n_fail == 0, f"the dry-run sweep failed {n_fail} cells")
    return charged


def main():
    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(
        __file__)), "src"))
    from repro_torch.core.lookaside import ControlMsg, LookasideBlock
    from repro_torch.core.rdma import Placement, RDMAEngine
    from repro_torch.core.streaming import (Chain, Drop, GradEgressChain,
                                            Handler, MatchTable, RXRing,
                                            Stream, StreamDispatcher,
                                            TrafficRouter)
    from repro_torch.core.rdma.transport import (_exec_descriptors_local,
                                                 pack_descriptors)
    from repro_torch.kernels import _build, ops
    from repro_torch.kernels import lc_offload as lco
    from repro_torch.kernels.packet_parser import (
        parse_cost, parse_packet_fields, parse_packet_fields_plain,
        parse_packets, parse_packets_plain)
    from repro_torch.kernels.quantize_stream import (
        dequantize_stream, dequantize_stream_cost, dequantize_stream_plain,
        quantize_stream, quantize_stream_cost, quantize_stream_plain)
    from repro_torch.kernels.systolic_mm import (systolic_mm,
                                                 systolic_mm_cost,
                                                 systolic_mm_plain)
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_cost,
                                                     flash_attention_plain)
    from repro_torch.kernels.ssd_scan import (ssd_scan, ssd_scan_cost,
                                              ssd_scan_plain)
    from repro_torch._tree import tree_leaves

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

    wrappers = {f.__name__: f for f in (
        systolic_mm, parse_packets, parse_packet_fields, quantize_stream,
        dequantize_stream, flash_attention, ssd_scan)}

    def measure(name, src, replaces, shape, err, fn, plain, cost,
                library=None, peak_flops=PEAK_F32_FLOPS, **extra):
        """Time kernel, plain version and library call; print and record
        (the last shape measured per kernel is the one recorded). ``cost``
        is the kernel's (flops, bytes), by the formula its wrapper charges
        to ``roofline.count.OpCounter``."""
        flops, nbytes = cost
        b = bound(nbytes, flops, peak_flops)
        ms, ms_summed, passes = device_ms(fn, wrapper=wrappers[name])
        plain_ms, plain_ms_summed, _ = device_ms(plain)
        lib_ms, lib_ms_summed, _ = (device_ms(library) if library
                                    else (None, None, None))
        r = {"name": name, "route": "cuda", "source": csrc + src,
             "replaces": replaces, "shape": shape, "max_abs_err": err,
             "ms": ms, "plain_ms": plain_ms,
             "bound_ms": b[0], "bound_by": b[1], "library_ms": lib_ms,
             "call_ms": cuda_ms(fn), "plain_call_ms": cuda_ms(plain),
             "ms_summed": ms_summed, "plain_ms_summed": plain_ms_summed,
             "library_ms_summed": lib_ms_summed, **extra}
        if len(passes) > 1:
            # each pass's traced ms per call, on a line of its own
            r["passes_ms_sum"] = sum(passes.values())
            phase("kernel " + name + " passes", shape=shape,
                  **{k: v for k, v in sorted(passes.items())})
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
                lambda: systolic_mm_plain(x, y), systolic_mm_cost(x, y),
                library=lambda: torch.matmul(x, y))

    pkts_np = rng.integers(0, 256, size=(4096, 64)).astype(np.uint8)
    pkts_np[::2, 12:14] = [0x08, 0x00]
    pkts_np[::2, 23] = 17
    pkts_np[::2, 36:38] = [18, 183]
    pkts_np[::2, 42] = rng.integers(0, 20, size=2048)
    # K3 at 65536 packets (where it has real work, as K4 below), from a
    # generator of its own so the later phases keep their inputs; then at
    # 4096, recorded last
    big = torch.from_numpy(roce_mix(np.random.default_rng(SEED + 5),
                                    65536)).to(dev)
    for n, pk in ((65536, big), (4096, torch.from_numpy(pkts_np).to(dev))):
        check(torch.equal(parse_packets(pk), parse_packets_plain(pk)),
              f"parse_packets {n}x64 differs from its plain version")
        measure("parse_packets", "packet_parser.cu",
                "src/repro/kernels/packet_parser.py:92", f"{n}x64", 0.0,
                lambda: parse_packets(pk), lambda: parse_packets_plain(pk),
                parse_cost(pk, 4))
    del big

    # K4 at 4096, at a large batch and, recorded last, at the 1024-packet
    # bursts the streaming phases ingest; K4 and the streaming path draw
    # from a generator of their own, so the datapath phases get the same
    # inputs as when they ran alone
    srng = np.random.default_rng(SEED + 1)
    for n in (4096, 65536, 1024):
        pf_np = roce_mix(srng, n)
        pf = torch.from_numpy(pf_np).to(dev)
        got, want = parse_packet_fields(pf), parse_packet_fields_plain(pf)
        check(got.shape == (n, 8) and torch.equal(got, want),
              f"parse_packet_fields {n}x64 differs from its plain version")
        measure("parse_packet_fields", "packet_parser.cu",
                "src/repro/kernels/packet_parser.py:110", f"{n}x64", 0.0,
                lambda: parse_packet_fields(pf),
                lambda: parse_packet_fields_plain(pf), parse_cost(pf, 8))

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
                lambda: quantize_stream_plain(x), quantize_stream_cost(x))
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
                dequantize_stream_cost(q, s))
    del x, y, q, s, pq, ps

    # K6 at the tinyllama prefill shape (8 sequences x 32 q heads over 4 kv
    # heads, S = 512, d = 64, causal, f32; recorded last), with window 32,
    # in bf16, at hymba's prefill shape (25 q heads over 5 kv heads, a GQA
    # group of 5, window 1024), at d = 128 and at deepseek-v2-lite's MLA
    # prefill shape (16 heads, q and k 192 wide, v 128: the largest
    # shared-memory case), at seamless-m4t-large-v2's attentions (16 heads
    # of 64, not causal: its encoder over 128 frames, its cross-attention
    # in prefill, 512 decoder rows over the 128 frames, and in a decode
    # step, 1 row) and at qwen2-vl-7b's prefill (28 q heads over 4 kv heads
    # of 128, a GQA group of 7, causal); SDPA on the same inputs is the
    # yardstick (the port never calls it). The bound is the function's own
    # work (2 (d + dv) flops per visible q-k pair) at the peak of its
    # dtype; route_bound_ms counts the products the kernel's route runs: in
    # bf16 two PV products (P split in a high and a low bf16 half) at the
    # bf16 peak, in f32 three TF32 products each (3xTF32) at the TF32 peak.
    sdpa = torch.nn.functional.scaled_dot_product_attention
    ab = 8
    for window, dtype, ahq, ahkv, ad, adv, asq, askv, causal in (
            (32, torch.float32, 32, 4, 64, 64, 512, 512, True),
            (0, torch.bfloat16, 32, 4, 64, 64, 512, 512, True),
            (1024, torch.float32, 25, 5, 64, 64, 512, 512, True),
            (0, torch.float32, 32, 4, 128, 128, 512, 512, True),
            (0, torch.float32, 16, 16, 192, 128, 512, 512, True),
            (0, torch.float32, 16, 16, 64, 64, 128, 128, False),
            (0, torch.float32, 16, 16, 64, 64, 512, 128, False),
            (0, torch.float32, 16, 16, 64, 64, 1, 128, False),
            (0, torch.float32, 28, 4, 128, 128, 512, 512, True),
            (0, torch.float32, 32, 4, 64, 64, 512, 512, True)):
        qa = torch.from_numpy(rng.standard_normal(
            (ab, asq, ahq, ad), np.float32)).to(dev, dtype)
        ka, va = (torch.from_numpy(rng.standard_normal(
            (ab, askv, ahkv, w), np.float32)).to(dev, dtype)
            for w in (ad, adv))
        got = flash_attention(qa, ka, va, causal=causal, window=window)
        want = flash_attention_plain(qa, ka, va, causal=causal,
                                     window=window)
        err = (got.float() - want.float()).abs()
        # f32: the reference's 2e-4 (sums in another order); bf16 outputs
        # may also sit one bf16 step (2^-7 relative) apart
        rel = 2.0 ** -7 if dtype == torch.bfloat16 else 0.0
        check(bool((err <= 2e-4 + rel * want.float().abs()).all()),
              f"flash_attention {asq}x{askv} d={ad}/{adv} gqa "
              f"{ahq // ahkv} window={window} {dtype}: max err "
              f"{err.max().item()}")
        qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (qa, ka, va))
        if window:
            pos_ = torch.arange(asq, device=dev)
            wmask = (pos_[:, None] >= pos_[None, :]) & (
                pos_[:, None] - pos_[None, :] < window)

            def library():
                return sdpa(qt, kt, vt, attn_mask=wmask, enable_gqa=True)
        else:
            def library():
                return sdpa(qt, kt, vt, is_causal=causal, enable_gqa=True)
        cost = flash_attention_cost(qa, ka, va, causal=causal,
                                    window=window)
        nbytes, flops = cost[1], float(cost[0])
        if dtype == torch.bfloat16:
            peak, route = PEAK_BF16_FLOPS, "bf16 tensor cores, P split"
            route_flops, route_peak = 1.5 * flops, PEAK_BF16_FLOPS
        else:
            peak, route = PEAK_F32_FLOPS, "3xTF32 tensor cores"
            route_flops, route_peak = 3.0 * flops, PEAK_TF32_FLOPS
        rb = bound(nbytes, route_flops, route_peak)
        measure("flash_attention", "flash_attention.cu",
                "src/repro/kernels/flash_attention.py:102",
                f"{ab * ahq}x{asq}{f'/{askv}' if askv != asq else ''}"
                f"x{ad}{f'/{adv}' if adv != ad else ''} "
                f"gqa{ahq // ahkv} {'causal' if causal else 'noncausal'}"
                f"{f' window{window}' if window else ''} "
                f"{str(dtype).split('.')[-1]}",
                err.max().item(),
                lambda: flash_attention(qa, ka, va, causal=causal,
                                        window=window),
                lambda: flash_attention_plain(qa, ka, va, causal=causal,
                                              window=window),
                cost, library=library, peak_flops=peak,
                route_work=route, route_flops=route_flops,
                route_bound_ms=rb[0], route_bound_by=rb[1])
    del qa, ka, va, qt, kt, vt, got, want, err

    # K7 at hymba's prefill shape (8 x 512, 50 heads of 64, d_state 16), in
    # bf16 at mamba2's, then at mamba2-370m's prefill shape (8 x 512, 32
    # heads of 64, d_state 128, chunk 256, f32) from a zero and from a
    # given state (recorded last). Model-like inputs: a = -linspace(1, 16,
    # nh) as the model initialises it, dt in (0.1, 0.9). No one PyTorch
    # call computes the scan, so there is no library time.
    krng = np.random.default_rng(SEED + 3)
    sb, ss, shd, schunk = 8, 512, 64, 256
    for snh, sn, dtype, seeded in ((50, 16, torch.float32, True),
                                   (32, 128, torch.bfloat16, True),
                                   (32, 128, torch.float32, False),
                                   (32, 128, torch.float32, True)):
        def normal(*shape):
            return torch.from_numpy(krng.standard_normal(
                shape, np.float32)).to(dev)

        sx = normal(sb, ss, snh, shd).to(dtype)
        sdt = torch.from_numpy(krng.uniform(0.1, 0.9, (sb, ss, snh)).astype(
            np.float32)).to(dev)
        sa = torch.from_numpy(-np.linspace(1.0, 16.0, snh).astype(
            np.float32)).to(dev)
        sbm, scm = normal(sb, ss, 1, sn), normal(sb, ss, 1, sn)
        sinit = normal(sb, snh, shd, sn) if seeded else None
        args = (sx, sdt, sa, sbm, scm)
        y7, f7 = ssd_scan(*args, chunk=schunk, init_state=sinit,
                          return_final_state=True)
        py7, pf7 = ssd_scan_plain(*args, schunk, sinit)
        tol = 6e-2 if dtype == torch.bfloat16 else 2e-5
        errs7 = [(g.float() - w.float()).abs() for g, w in ((y7, py7),
                                                          (f7, pf7))]
        check(all(bool((e <= tol + tol * w.float().abs()).all())
                  for e, w in zip(errs7, (py7, pf7))),
              f"ssd_scan nh {snh} n {sn} {dtype} seeded={seeded}: max err "
              f"y {errs7[0].max().item()}, final {errs7[1].max().item()}")
        # the function's work: C.B^T over each chunk's lower triangle
        # once per (sequence, chunk); per head w.x over that triangle, the
        # state increment and C_i . S_prev. The route bound counts the
        # products the kernel's route runs: w.x, the state increment and
        # C_i . S_prev as 3xTF32, three TF32 products each (two for those
        # with a bf16 x as an operand: x is exact in TF32) at the TF32
        # peak, and C.B^T once on the FP64 tensor cores at theirs
        tri = schunk * (schunk + 1) // 2
        nc7 = sb * (ss // schunk)
        f_cb = 2.0 * nc7 * tri * sn
        f_wx = 2.0 * nc7 * snh * tri * shd
        f_state = f_cs = 2.0 * nc7 * snh * schunk * sn * shd
        kx = 2 if dtype == torch.bfloat16 else 3
        route_flops = 3 * f_cs + kx * (f_wx + f_state)
        cost = ssd_scan_cost(*args, schunk, sinit)
        nbytes = cost[1]
        route_ops_ms = (route_flops / PEAK_TF32_FLOPS
                        + f_cb / PEAK_FP64_TC_FLOPS) * 1e3
        bytes_ms = nbytes / PEAK_BYTES_S * 1e3
        rb = ((route_ops_ms, "operations") if route_ops_ms >= bytes_ms
              else (bytes_ms, "bytes"))
        measure("ssd_scan", "ssd_scan.cu",
                "src/repro/kernels/ssd_scan.py:79",
                f"{sb}x{ss} nh{snh} hd{shd} n{sn} chunk{schunk} "
                f"{str(dtype).split('.')[-1]} "
                f"{'seeded' if seeded else 'zero state'}",
                max(e.max().item() for e in errs7),
                lambda: ssd_scan(*args, chunk=schunk, init_state=sinit,
                                 return_final_state=True),
                lambda: ssd_scan_plain(*args, schunk, sinit), cost,
                peak_flops=(PEAK_BF16_FLOPS if dtype == torch.bfloat16
                            else PEAK_F32_FLOPS),
                route_work=("3xTF32 tensor cores"
                            + (", bf16 x" if kx == 2 else "")
                            + "; C.B^T on the FP64 tensor cores"),
                route_flops=route_flops, route_fp64_flops=f_cb,
                route_bound_ms=rb[0], route_bound_by=rb[1])
    del sx, sdt, sa, sbm, scm, sinit, args, y7, f7, py7, pf7, errs7

    # K7 and its plain f32 version against the float64 oracle (the plain
    # version in float64 on the f32 in-order cumsum) at mamba2's shape,
    # seeded, from three seeds: K7 within the 2e-5 relative to 1 + |value|
    # that tests/test_torch_ssd_numerics.py sets, both errors printed
    def rel_err(got, want):
        got, want = got.double(), want.double()
        return ((got - want).abs() / (1.0 + want.abs())).max().item()

    for i in range(3):
        orng = np.random.default_rng(SEED + 10 + i)

        def normal(*shape):
            return torch.from_numpy(orng.standard_normal(
                shape, np.float32)).to(dev)

        snh, sn = 32, 128
        args = (normal(sb, ss, snh, shd),
                torch.from_numpy(orng.uniform(0.1, 0.9, (sb, ss, snh))
                                 .astype(np.float32)).to(dev),
                torch.from_numpy(-np.linspace(1.0, 16.0, snh)
                                 .astype(np.float32)).to(dev),
                normal(sb, ss, 1, sn), normal(sb, ss, 1, sn))
        sinit = normal(sb, snh, shd, sn)
        got = ssd_scan(*args, chunk=schunk, init_state=sinit,
                       return_final_state=True)
        plain = ssd_scan_plain(*args, schunk, sinit)
        oracle = ssd_scan_plain(*args, schunk, sinit, dtype=torch.float64)
        k7_err = max(rel_err(g, w) for g, w in zip(got, oracle))
        plain_err = max(rel_err(g, w) for g, w in zip(plain, oracle))
        phase("kernel ssd_scan oracle", seed=SEED + 10 + i,
              k7_err=k7_err, plain_f32_err=plain_err, bound=2e-5)
        check(k7_err <= 2e-5, f"ssd_scan: {k7_err} from the float64 oracle")
    del args, sinit, got, plain, oracle

    # ---- 3-6. the main path ----------------------------------------------
    # each path runs with every launch counter at 0 and is read right
    # after; the kernel phase above does not count
    counted = (systolic_mm, parse_packets, parse_packet_fields,
               quantize_stream, dequantize_stream, flash_attention,
               ssd_scan)
    launches = {}

    def zero_counts():
        torch.cuda.synchronize()
        for fn in counted:
            fn.launches = 0

    def read_counts(path, needed):
        torch.cuda.synchronize()
        launches[path] = {fn.__name__: fn.launches for fn in counted}
        phase("launches " + path, **launches[path])
        for fn in needed:
            check(fn.launches > 0,
                  f"{fn.__name__} never launched on the {path} path")

    zero_counts()

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
    dp_walls = {}       # each datapath phase's synchronised wall, seconds

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
        dp_walls[f"fig6 {m}x{k}x{n}"] = wall / 1e3
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
    dp_walls["parser_workload"] = wall / 1e3
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
    dp_walls["stream_quant"] = wall / 1e3
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
        return read_doorbell(eng, qp, data_mr.rkey, wqes, dev)

    def report(name, wqes, walls):
        nbytes = 4 * sum(ln for _, _, ln in wqes)
        desc, chunk = pack_descriptors(
            [("xfer", DATA_PEER, LC_PEER, rem, loc, ln)
             for loc, rem, ln in wqes], POOL)
        wall = _median(walls)

        def execute():      # the descriptor executor alone, same table
            _exec_descriptors_local(pool, desc, chunk)

        phase(name, wqes=len(wqes), bytes=nbytes, reps=len(walls),
              wall_ms_median=wall * 1e3,
              wall_ms_each=[round(w * 1e3, 4) for w in walls],
              gbps_median=nbytes * 8 / wall / 1e9,
              executor_call_ms=cuda_ms(execute, iters=5, warmup=1),
              executor_device_ms=device_ms(execute, iters=5)[0])

    # read_batch_16k: 50 READs of 16 KiB, strided so none coalesce
    words, batch, _ = READ16K
    wqes = read16k_wqes(1 << 25)
    counters = ("dispatches", "wqes", "compiles", "coalesced_wqes",
                "qdma_writes", "qdma_compiles")
    before = {c: eng.transport.stats[c] for c in counters}
    walls = [doorbell(wqes) for _ in range(reps)]
    read16k = {"stats": {c: eng.transport.stats[c] - before[c]
                         for c in counters},
               "reps": reps, "wall_s": sum(walls),
               "wall_median_s": _median(walls),
               "gbps_median": 4 * words * batch * 8 / _median(walls) / 1e9}
    dp_walls["read_batch_16k"] = sum(walls)
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
    dp_walls["dma_64mib"] = sum(walls)

    read_counts("datapath", (systolic_mm, parse_packets, quantize_stream,
                             dequantize_stream))

    # ---- 23-25. the engine's models: knob sweep, executor cost, paper ----
    autotune_phase(dev)
    measured_cost = executor_cost_phase(dev)
    paper_model_phase(eng.stats, dp_walls, read16k, measured_cost,
                      os.path.join(os.path.dirname(os.path.abspath(
                          __file__)), "tests", "testcases"))

    # ---- 7-10. the streaming dispatch plane --------------------------------
    # LC peer: rings below 2^20, block scratch in [2^20, 2^23); data peer:
    # the output rings from 2^25 (phases 3-6 used lower addresses)
    out0 = 1 << 25
    sc_blk = LookasideBlock(eng, peer=LC_PEER, scratch_base=1 << 22,
                            scratch_size=1 << 22, pipeline_depth=4,
                            eager_writeback=False)
    lco.register_default_kernels(sc_blk)

    split = {}          # a phase's wall split into its parts, in ms

    def run_phase(name, fn, units, unit):
        """Drive ``fn(check)`` once for its wall time (``fn`` returns the
        seconds of its driven sections; checks run between them, off the
        clock) and once more under the profiler for its device time."""
        split.clear()
        wall = fn(True) * 1e3
        parts = dict(split)
        _, dev_us = traced_device_us(lambda: fn(False))
        phase(name, **{unit + "s": units}, wall_ms=wall,
              **{"host_ms_per_" + unit: wall / units}, **parts,
              device_ms=dev_us / 1e3, device_share=dev_us / 1e3 / wall,
              dispatch=json.dumps(eng.stats["dispatch"], sort_keys=True))

    def add_split(key, sec):
        split[key] = split.get(key, 0.0) + sec * 1e3

    def sentinel(peer, addr, words):
        """Fill an output region with -1 (no parsed or quantized row is
        all -1), so a slot the path never wrote fails the byte check."""
        eng.write_buffer(peer, addr, np.full(words, -1, np.float32))

    def field_taps(table):
        """Keep the field matrix each ingest burst hands ``table``: K4's
        output as the router used it, checked byte for byte below."""
        seen = []
        inner = table.classify_ex

        def classify_ex(fields):
            seen[:] = [np.array(fields)]
            return inner(fields)

        table.classify_ex = classify_ex
        return seen

    def check_fields(seen, hdrs, what):
        want = parse_packet_fields_plain(torch.from_numpy(hdrs)).numpy()
        check(len(seen) == 1 and np.array_equal(seen[0], want),
              f"{what}: the router's field matrix is not byte-exact")

    def timed(fn):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t

    zero_counts()

    # 7. streaming_rx: every packet streamed, parsed by K3 on the ring
    depth, burst, n_rx = 1024, 32, 16384
    rx_ring = RXRing(eng, peer=LC_PEER, base=0, depth=depth)
    rx_mr = eng.register_mr(DATA_PEER, out0, depth * 4)
    rx_k = sc_blk.attach_ring(lco.STREAM_PARSER_WORKLOAD, rx_ring,
                              DATA_PEER, rx_mr.rkey, out0, burst=burst)
    rx_router = TrafficRouter(rx_ring, table=MatchTable(default=Stream()))
    check(rx_router.device.type == "cuda", "router parses off the card")
    rx_fields = field_taps(rx_router.table)
    rx_hdrs = roce_mix(srng, n_rx)

    def streaming_rx(checking):
        total = 0.0
        for b in range(0, n_rx, depth):
            hdrs = rx_hdrs[b:b + depth]
            if checking:
                sentinel(DATA_PEER, out0, depth * 4)
            # ingest (K4 + match + one slot write per packet), then drain
            counts, sec_in = timed(lambda: rx_router.ingest_packets(hdrs))
            n, sec_out = timed(rx_k.stream)
            total += sec_in + sec_out
            add_split("ingest_ms", sec_in)
            add_split("drain_ms", sec_out)
            check(counts["streamed"] == depth == n,
                  f"streaming_rx burst {b}: {counts}, consumed {n}")
            if checking:
                check_fields(rx_fields, hdrs, f"streaming_rx burst {b}")
                meta = eng.read_buffer(DATA_PEER, out0, depth * 4)
                want = parse_packets_plain(torch.from_numpy(hdrs))
                check(np.array_equal(meta.reshape(depth, 4),
                                     want.numpy().astype(np.float32)),
                      f"streaming_rx meta rows of burst {b} not byte-exact")
        return total

    run_phase("streaming_rx", streaming_rx, n_rx, "packet")

    # the host cost of RXRing.push alone (one slot write per packet, a
    # host-to-device copy), over one ring's worth of headers
    hdrs = rx_hdrs[:depth]
    _, sec = timed(lambda: [check(rx_ring.push(h), "ring refused a push")
                            for h in hdrs])
    check(rx_k.stream() == depth, "ring_push drain")
    phase("ring_push", packets=depth, host_ms=sec * 1e3,
          host_ms_per_packet=sec * 1e3 / depth)

    # 8. dispatch_mixed_3class: parser / quantizer / Drop() by udp_dport;
    # the parser's class is RoCEv2 (port 4791, BTH opcodes 0..19), so its
    # meta rows carry is_rdma, opcode, dest_qp and class
    ports = np.array([4791, 9100, 9200])
    d_ring = RXRing(eng, peer=LC_PEER, base=1 << 16, depth=depth)
    meta_base, quant_base = out0 + (1 << 16), out0 + (1 << 17)
    meta_mr = eng.register_mr(DATA_PEER, meta_base, depth * 4)
    quant_mr = eng.register_mr(DATA_PEER, quant_base, depth * lco.QUANT_ROW)
    table = (MatchTable(default=Drop())
             .add(Handler(lco.STREAM_PARSER_WORKLOAD), udp_dport=4791)
             .add(Handler(lco.STREAM_QUANT_WORKLOAD), udp_dport=9100)
             .add(Drop(), udp_dport=9200))
    disp = StreamDispatcher(sc_blk, d_ring, table, burst=burst)
    disp.register_handler(lco.STREAM_PARSER_WORKLOAD, DATA_PEER,
                          meta_mr.rkey, meta_base)
    disp.register_handler(lco.STREAM_QUANT_WORKLOAD, DATA_PEER,
                          quant_mr.rkey, quant_base)
    d_router = TrafficRouter(d_ring, table=table)
    d_fields = field_taps(table)
    n_d = 16384
    d_cls = srng.choice(3, size=n_d, p=[0.5, 0.3, 0.2])
    d_hdrs = roce_mix(srng, n_d, rdma_share=0.0)
    d_hdrs[:, 36] = ports[d_cls] >> 8
    d_hdrs[:, 37] = ports[d_cls] & 0xFF
    d_hdrs[d_cls == 0, 42] = srng.integers(0, 20,
                                           size=int((d_cls == 0).sum()))

    def dispatch_mixed(checking):
        total = 0.0
        for b in range(0, n_d, depth):
            hdrs, cls = d_hdrs[b:b + depth], d_cls[b:b + depth]
            seq0 = d_ring._tail
            if checking:
                sentinel(DATA_PEER, meta_base, depth * 4)
                sentinel(DATA_PEER, quant_base, depth * lco.QUANT_ROW)
            (counts, n), sec = timed(lambda: (
                d_router.ingest_packets(hdrs), disp.service()))
            total += sec
            streamed = int((cls < 2).sum())
            check(counts["streamed"] == n == streamed
                  and counts["dropped"] == int((cls == 2).sum()),
                  f"dispatch burst {b}: {counts}, consumed {n}")
            if not checking:
                continue
            check_fields(d_fields, hdrs, f"dispatch burst {b}")
            check(np.array_equal(d_fields[0][:, 0], (cls == 0).astype(
                np.int32)), f"dispatch burst {b}: the parser class is not "
                  "exactly the RoCEv2 packets")
            slots = (seq0 + np.arange(streamed)) % depth
            kept = cls[cls < 2]
            meta = eng.read_buffer(DATA_PEER, meta_base, depth * 4
                                   ).reshape(depth, 4)
            quant = eng.read_buffer(DATA_PEER, quant_base,
                                    depth * lco.QUANT_ROW
                                    ).reshape(depth, lco.QUANT_ROW)
            ph, qh = hdrs[cls == 0], hdrs[cls == 1]
            want_m = parse_packets_plain(torch.from_numpy(ph)).numpy()
            wq, ws = quantize_stream_plain(torch.from_numpy(
                qh.astype(np.float32)))
            want_q = torch.cat([wq.float(), ws], 1).numpy()
            check(np.array_equal(meta[slots[kept == 0]],
                                 want_m.astype(np.float32))
                  and np.array_equal(quant[slots[kept == 1]], want_q),
                  f"dispatch rows of burst {b} not byte-exact")
        return total

    cl = eng.stats["dispatch"]["classes"]
    pre = sum(c["pkts"] for c in cl.values())
    run_phase("dispatch_mixed_3class", dispatch_mixed, n_d, "packet")
    routed = sum(c["pkts"] for c in cl.values()) - pre
    n_drop = d_router.class_counters[Drop()]
    check(routed + n_drop == 2 * n_d == d_router.pkt_counters["streamed"]
          + d_router.pkt_counters["dropped"]
          and d_ring.stats["consumed"] == routed,
          f"dispatch per-class counts do not add up: {cl}, drops {n_drop}")

    # 9. chain_parse_dequant_2stage: framed slots (129) -> 69 -> 64 words
    ch_blk = LookasideBlock(eng, peer=LC_PEER, scratch_base=1 << 21,
                            scratch_size=1 << 21, pipeline_depth=4,
                            eager_writeback=False)
    lco.register_chain_kernels(ch_blk)
    c_ring = RXRing(eng, peer=LC_PEER, base=1 << 17, depth=depth,
                    slot_bytes=lco.FRAME_ROW)
    chain = Chain((lco.CHAIN_PARSE_WORKLOAD, lco.CHAIN_DEQUANT_WORKLOAD),
                  name="ingress")
    c_disp = StreamDispatcher(ch_blk, c_ring, MatchTable(default=chain),
                              burst=burst)
    s1 = out0 + (1 << 18)
    s2 = s1 + depth * lco.PARSED_ROW
    c_mr = eng.register_mr(DATA_PEER, s1,
                           depth * (lco.PARSED_ROW + lco.HDR_BYTES))
    c_disp.register_chain(chain, DATA_PEER, c_mr.rkey, [s1, s2])
    n_c = 4096
    c_x = torch.from_numpy((srng.standard_normal((n_c, 64)) * srng.uniform(
        0.01, 100, (n_c, 1))).astype(np.float32))
    c_q, c_s = quantize_stream_plain(c_x)
    c_hdrs = roce_mix(srng, n_c)
    frames = np.concatenate([c_hdrs.astype(np.float32),
                             c_q.float().numpy(), c_s.numpy()], axis=1)
    want_parsed = np.concatenate(
        [parse_packets_plain(torch.from_numpy(c_hdrs)).numpy().astype(
            np.float32), frames[:, 64:]], axis=1)
    want_deq = dequantize_stream_plain(c_q, c_s).numpy()

    def chain_phase(checking):
        total = 0.0
        for b in range(0, n_c, depth):
            def window():
                for f in frames[b:b + depth]:
                    check(c_ring.push(f), "frame ring refused a slot")
                c_disp.service()
            _, sec = timed(window)
            total += sec
            if checking:
                p1 = eng.read_buffer(DATA_PEER, s1, depth * lco.PARSED_ROW)
                p2 = eng.read_buffer(DATA_PEER, s2, depth * lco.HDR_BYTES)
                check(np.array_equal(p1.reshape(depth, -1),
                                     want_parsed[b:b + depth])
                      and np.array_equal(p2.reshape(depth, -1),
                                         want_deq[b:b + depth]),
                      f"chain rows of window {b} not byte-exact")
        return total

    run_phase("chain_parse_dequant_2stage", chain_phase, n_c, "slot")
    led = eng.stats["dispatch"]["chains"]["ingress"]
    check(led["completed_pkts"] == 2 * n_c
          and led["dataflow_msgs"] == led["bursts"],
          f"chain ledger {led}")

    # 10. grad_egress: a 4 MiB bucket (2^20 f32 words, 16384 rows of 64)
    egress = GradEgressChain(eng, data_peer=DATA_PEER, ring_base=1 << 19,
                             out_base=out0 + (1 << 19), lc_peer=LC_PEER,
                             depth=256, burst=burst, scratch_base=1 << 20,
                             scratch_size=1 << 20, pipeline_depth=4)
    g_flat = srng.standard_normal(1 << 20).astype(np.float32)
    g_res = (srng.standard_normal(1 << 20) * 1e-3).astype(np.float32)
    g_target = torch.from_numpy(g_flat + g_res).reshape(-1, 64)
    g_q, g_s = quantize_stream_plain(g_target)
    g_back = dequantize_stream_plain(g_q, g_s).reshape(-1).numpy()

    def grad_egress(checking):
        # time compress()'s own per-row read-backs (its only read_buffer
        # calls) as a split of the phase's wall
        inner = eng.read_buffer

        def read_buffer(*args, **kw):
            t = time.perf_counter()
            out = inner(*args, **kw)
            add_split("readback_ms", time.perf_counter() - t)
            return out

        eng.read_buffer = read_buffer
        (q, s_, csum, resid), sec = timed(
            lambda: egress.compress(g_flat, g_res))
        del eng.read_buffer
        if checking:
            check(GradEgressChain.verify_checksums(q, s_, csum),
                  "grad_egress checksums do not verify")
            check(np.array_equal(q, g_q.numpy())
                  and np.array_equal(s_, g_s.numpy()),
                  "grad_egress q/s not byte-exact against ops.compress")
            check(np.array_equal(resid, g_target.reshape(-1).numpy()
                                 - g_back),
                  "grad_egress residual is not the wire error")
        return sec

    run_phase("grad_egress", grad_egress, 1 << 14, "row")

    read_counts("streaming", (parse_packet_fields, parse_packets,
                              quantize_stream, dequantize_stream))

    # ---- 11-16. serving ----------------------------------------------------
    # three models at full width and depth, random weights from SEED, in
    # f32: 8 requests x 512-token prompts, 32 greedy tokens, max_seq 552;
    # each cache handoff on an engine of its own, in 65,536-word pages
    from repro_torch.configs.registry import get_config
    from repro_torch.models import forward, init_caches, init_params
    from repro_torch.models.transformer import encode
    from repro_torch.serve import (PagedKVPool, RemoteKVClient,
                                   decode_step, greedy_generate,
                                   greedy_with_inputs, model_inputs,
                                   prefill_step, step_inputs)
    from repro_torch.serve.kv_cache import flatten_cache_leaves

    n_req, p_len, g_len = 8, 512, 32
    max_seq, page = p_len + g_len + 8, 1 << 16

    def during(fn):
        """Run ``fn`` synchronised; return (its result, the seconds it
        took, each counted kernel's launches during it)."""
        torch.cuda.synchronize()
        n0 = {f.__name__: f.launches for f in counted}
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t, {
            f.__name__: f.launches - n0[f.__name__] for f in counted}

    def invariant(arch, per_layer, n_tokens, seed, per_step=None):
        """Prefill 512 + 32 teacher-forced decode steps against one forward
        over ``n_tokens`` tokens without caches, held within 1e-4 of the
        logits' scale (the forward's largest |logit|): f32 on both routes,
        which differ only in summation order (cuBLAS picks other kernels
        for 8 rows than for thousands, K6 or the scan's chunks against
        plain decode), and the difference grows through the layers. The
        inputs beside the tokens (an enc-dec model's frames, a VLM's image
        and M-RoPE ids) come from ``model_inputs``, each step given its
        share. ``per_layer``: the kernels a prefill and a forward launch
        once per layer, and decode none; or ``per_step``, each counted
        kernel's launches (per prefill and forward, per decode step).
        Returns (cfg, params, prompt, caches after decode, the inputs)."""
        cfg = get_config(arch)
        params = init_params(cfg, SEED)
        toks = torch.from_numpy(np.random.default_rng(seed).integers(
            0, cfg.vocab_size, (n_req, n_tokens))).to(dev)
        inp = model_inputs(cfg, n_req, p_len, n_tokens, seed=seed + 100)
        prompt = toks[:, :p_len]
        full, full_s, n_full = during(lambda: forward(
            params, cfg, {"tokens": toks,
                          **step_inputs(inp, 0, n_tokens)})[0])
        scale = full.abs().max().item()
        # a forward over the prompt alone runs the prefill's shapes; against
        # the longer forward it shows what the GEMMs' row count alone moves
        pre_batch = {"tokens": prompt, **step_inputs(inp, 0, p_len)}
        same = forward(params, cfg, pre_batch)[0]
        rows_err = (same - full[:, :p_len]).abs().max().item()
        same = same[:, -1]
        full = full[:, p_len - 1:p_len + g_len]
        caches = init_caches(cfg, n_req, max_seq, torch.float32)
        (lg, caches), pre_s, n_pre = during(
            lambda: prefill_step(params, cfg, pre_batch, caches))
        want, want_dec = per_step or (
            {f.__name__: cfg.num_layers if f in per_layer else 0
             for f in counted}, {f.__name__: 0 for f in counted})
        check(n_full == n_pre == want,
              f"{arch}: launches per forward {n_full}, per prefill "
              f"{n_pre}, want {want}")
        same_err = (lg[:, 0] - same).abs().max().item()
        errs = [(lg[:, 0] - full[:, 0]).abs().max().item()]

        def decode_all():
            c = caches
            for i in range(p_len, p_len + g_len):
                out, c = decode_step(params, cfg, toks[:, i:i + 1], c, i,
                                     extra=step_inputs(inp, i, i + 1))
                errs.append((out[:, 0] - full[:, i - p_len + 1]).abs()
                            .max().item())
            return c

        caches, dec_s, n_dec = during(decode_all)
        check(n_dec == {k: g_len * v for k, v in want_dec.items()},
              f"{arch}: decode launched {n_dec}, want {want_dec} a step")
        tol_s = 1e-4 * scale
        check(all(np.isfinite(errs)) and max(errs) <= tol_s,
              f"{arch} prefill/decode vs full forward: max err {max(errs)} "
              f"over {tol_s} (logit scale {scale})")
        check(np.isfinite(same_err) and same_err <= tol_s,
              f"{arch} prefill vs a forward over the prompt: max err "
              f"{same_err} over {tol_s}")
        phase("serve invariant", arch=cfg.name, requests=n_req,
              prompt=p_len, decode_steps=g_len, forward_tokens=n_tokens,
              max_abs_err=max(errs), tolerance=tol_s, logit_scale=scale,
              err_last_prompt=errs[0], worst_step=int(np.argmax(errs)),
              err_prefill_vs_prompt_forward=same_err,
              err_prompt_forward_vs_forward=rows_err,
              per_prefill=json.dumps({k: v for k, v in n_pre.items() if v}),
              per_decode_step=json.dumps({k: v // g_len for k, v in
                                          n_dec.items() if v}))
        phase("serve prefill", arch=cfg.name, ms=pre_s * 1e3,
              tokens_per_s=n_req * p_len / pre_s, forward_ms=full_s * 1e3)
        phase("serve decode", arch=cfg.name, ms_per_step=dec_s * 1e3 / g_len,
              tokens_per_s=n_req * g_len / dec_s)
        return cfg, params, prompt, caches, inp

    def trace_share(cfg, params, prompt, caches, inp=None):
        """Traced device share of one more prefill and of 8 decode steps,
        each given its share of the inputs ``inp`` beside the tokens."""
        spare = init_caches(cfg, n_req, max_seq, torch.float32)
        inp = inp or {}

        def prefill_again():
            return prefill_step(params, cfg, {"tokens": prompt,
                                              **step_inputs(inp, 0, p_len)},
                                spare)

        _, dev_us = traced_device_us(prefill_again)
        _, wall = timed(prefill_again)
        phase("serve prefill trace", arch=cfg.name, wall_ms=wall * 1e3,
              device_ms=dev_us / 1e3,
              device_share=dev_us / 1e3 / (wall * 1e3))

        def decode8():
            c = caches
            for i in range(p_len, p_len + 8):
                _, c = decode_step(params, cfg, prompt[:, :1], c, i,
                                   extra=step_inputs(inp, i, i + 1))
            return c

        _, dev_us = traced_device_us(decode8)
        _, wall = timed(decode8)
        phase("serve decode trace", arch=cfg.name, steps=8,
              wall_ms=wall * 1e3, device_ms=dev_us / 1e3,
              device_share=dev_us / 1e3 / (wall * 1e3))

    def handoff(cfg, params, prompt, caches, pool_size, inp=None):
        """The cache handoff over the RDMA engine, uncompressed, on an
        engine of its own: publish and fetch the caches byte for byte
        (every leaf, dtypes included), then greedy tokens through the
        remote pool equal those with local caches (``greedy_with_inputs``
        the inputs ``inp`` where the model takes any). Returns (the engine,
        its pool's pages, the fetches made)."""
        eng_ = RDMAEngine(n_peers=2, pool_size=pool_size)
        n_pages = -(-flatten_cache_leaves(caches).numel() // page)
        check(n_pages * page <= pool_size,
              f"{n_pages} pages exceed the {pool_size}-word pool")
        kv_pool = PagedKVPool(eng_, 0, page_elems=page, max_pages=n_pages)
        client = RemoteKVClient(eng_, 1, kv_pool)
        tenant = client.register_tenant("decode", weight=2)
        n_pub, pub_s = timed(lambda: client.publish_caches(1, caches))
        check(n_pub == n_pages, f"{cfg.name}: published {n_pub} pages")
        # three timed fetches, each checked, with the caching allocator's
        # cudaMalloc calls and retries during them; then one more under the
        # profiler for its device time
        fetch_ms, mallocs, retries = [], [], []
        for _ in range(N_FETCH):
            mem0 = torch.cuda.memory_stats()
            fetched, fetch_s = timed(
                lambda: client.fetch_caches(1, caches, tenant))
            mem1 = torch.cuda.memory_stats()
            check(all(g.dtype == w.dtype and torch.equal(g, w)
                      for g, w in zip(tree_leaves(fetched),
                                      tree_leaves(caches))),
                  f"{cfg.name}: the uncompressed handoff is not byte-exact")
            del fetched
            fetch_ms.append(fetch_s * 1e3)
            mallocs.append(mem1["num_device_alloc"]
                           - mem0["num_device_alloc"])
            retries.append(mem1["num_alloc_retries"]
                           - mem0["num_alloc_retries"])
        traces = []

        def fetch_traced():
            traces.append(1)
            return client.fetch_caches(1, caches, tenant)

        try:
            _, fetch_dev_us = traced_device_us(fetch_traced, tries=6)
            fetch_dev_ms, fetch_dev_src = fetch_dev_us / 1e3, "traced"
        except AssertionError:
            # CUPTI handed back only empty traces of this copy-only call:
            # its device time is not measured
            fetch_dev_ms, fetch_dev_src = None, "untraced"
        kv_pool.evict(1)
        if inp:
            local, gen_s = timed(lambda: greedy_with_inputs(
                params, cfg, prompt, inp, g_len, max_seq))
            remote, rgen_s = timed(lambda: greedy_with_inputs(
                params, cfg, prompt, inp, g_len, max_seq, kv_client=client,
                kv_tenant=tenant))
        else:
            local, gen_s = timed(lambda: greedy_generate(
                params, cfg, prompt, g_len, max_seq))
            remote, rgen_s = timed(lambda: greedy_generate(
                params, cfg, prompt, g_len, max_seq, kv_client=client,
                kv_seq_id=0, kv_tenant=tenant))
        check(torch.equal(local, remote),
              "greedy tokens through the remote pool differ from local")
        check(kv_pool.allocated == 0, "the handoff left pages in the pool")
        phase("serve handoff", arch=cfg.name, pages=n_pages,
              page_words=page, mib=n_pages * page * 4 / 2 ** 20,
              publish_ms=pub_s * 1e3, fetch_ms=json.dumps(fetch_ms),
              fetch_device_ms=fetch_dev_ms,
              fetch_device_source=fetch_dev_src, fetch_traces=len(traces),
              fetch_cuda_mallocs=json.dumps(mallocs),
              fetch_alloc_retries=json.dumps(retries),
              wire_words=eng_.stats["kv_serve"]["posted_words"],
              greedy_local_ms=gen_s * 1e3, greedy_remote_ms=rgen_s * 1e3,
              tokens_equal=True)
        return eng_, n_pages, N_FETCH + len(traces) + 1

    def ledger(eng_, pages, fetches):
        """Every page of ``fetches`` fetches fetched, none failed."""
        led = eng_.stats["kv_serve"]
        check(led["pages_fetched"] == fetches * pages
              and led["pages_failed"] == 0 and led["failed"] == 0
              and led["completed"] == fetches, f"kv_serve ledger {led}")
        phase("serve ledger", **led)

    # 11. tinyllama-1.1b (dense GQA, K6): the invariant over all 544
    # tokens, then times and device share
    zero_counts()
    cfg, params, prompt, caches, _ = invariant(
        "tinyllama-1.1b", (flash_attention,), p_len + g_len, SEED + 2)
    trace_share(cfg, params, prompt, caches)

    # 12. the KV handoff
    s_eng, n_pages, n_fetches = handoff(cfg, params, prompt, caches, POOL)

    # 13. a compressed pool: K1 packs each page on publish, K2 unpacks the
    # fetch; the fetched words equal the plain dequant(quant(page))
    c_pool = PagedKVPool(s_eng, 0, page_elems=page, max_pages=n_pages,
                         compressed=True)
    c_client = RemoteKVClient(s_eng, 1, c_pool)
    c_tenant = c_client.register_tenant("bulk")
    words0 = s_eng.stats["kv_serve"]["posted_words"]
    _, cpub_s = timed(lambda: c_client.publish_caches(2, caches))
    data, cfetch_s = timed(lambda: c_client.complete(
        c_client.fetch_sequence(c_tenant, 2)))
    flat = flatten_cache_leaves(caches)
    padded = torch.zeros(n_pages * page, device=dev)
    padded[:flat.numel()] = flat
    pq, ps = quantize_stream_plain(padded.reshape(-1, 64))
    want = dequantize_stream_plain(pq, ps).reshape(n_pages, page)
    check(torch.equal(data, want),
          "compressed KV pages are not byte-exact against the plain "
          "dequant(quant(page))")
    c_words = s_eng.stats["kv_serve"]["posted_words"] - words0
    c_pool.evict(2)
    del data, want, pq, ps, padded, flat
    phase("serve handoff compressed", pages=n_pages,
          publish_ms=cpub_s * 1e3, fetch_ms=cfetch_s * 1e3,
          wire_words=c_words, wire_ratio=n_pages * page / c_words)
    ledger(s_eng, n_pages, n_fetches + 1)
    read_counts("serve", (flash_attention, quantize_stream,
                          dequantize_stream))
    del params, caches, s_eng, c_pool, c_client

    # 14. mamba2-370m (SSM, K7): the scan takes whole 256-token chunks, so
    # the forward runs 768 tokens (544 % 256 != 0); causality makes its
    # positions 511-543 the ones to compare
    zero_counts()
    cfg, params, prompt, caches, _ = invariant("mamba2-370m", (ssd_scan,),
                                               768, SEED + 4)
    trace_share(cfg, params, prompt, caches)

    # 15. the state handoff of the SSM caches, on a larger pool
    s_eng, n_pages, n_fetches = handoff(cfg, params, prompt, caches,
                                        SSM_POOL)
    ledger(s_eng, n_pages, n_fetches)
    read_counts("ssm", (ssd_scan,))
    del params, caches, s_eng

    # 16. hymba-1.5b: attention (K6, window 1024, global at layers 0, 16
    # and 31) and SSM heads (K7) on the same input in every layer
    zero_counts()
    cfg, params, prompt, caches, _ = invariant(
        "hymba-1.5b", (ssd_scan, flash_attention), 768, SEED + 4)
    read_counts("hybrid", (ssd_scan, flash_attention))
    del params, caches

    # 20. MoE + MLA: deepseek-v2-lite-16b at full width and depth
    zero_counts()
    moe_phases(dev, timed, during, counted, trace_share, handoff, ledger,
               (n_req, p_len, g_len, max_seq))
    read_counts("moe", (flash_attention,))

    def memory_before():
        """Free device memory, with the caching allocator emptied and the
        peak counter reset."""
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        return torch.cuda.mem_get_info()[0]

    def memory_phase(name, cfg, free0):
        torch.cuda.synchronize()
        phase(name, arch=cfg.name,
              peak_gb=torch.cuda.max_memory_allocated() / 1e9,
              free_gb_before=free0 / 1e9)

    # 21. seamless-m4t-large-v2 (enc-dec, the speech frontend a stub: 128
    # N(0, 1) frames a request): K6 in the encoder (not causal, 128 x 128),
    # in the decoder's self-attention from an empty cache and in the
    # cross-attention (512 x 128 in prefill); a decode step re-runs the
    # encoder and the cross-attention from no cache, as the reference
    # does, so it launches K6 48 times. Then the {"self"} cache handoff.
    zero_counts()
    free0 = memory_before()
    seam = get_config("seamless-m4t-large-v2")
    n_enc, n_dec = seam.encoder_layers, seam.num_layers
    per_step = tuple({f.__name__: n if f is flash_attention else 0
                      for f in counted}
                     for n in (n_enc + 2 * n_dec, n_enc + n_dec))
    cfg, params, prompt, caches, inp = invariant(
        "seamless-m4t-large-v2", (), p_len + g_len, SEED + 7, per_step)
    trace_share(cfg, params, prompt, caches, inp)
    # the encoder alone, as each decode step re-runs it: its share of a
    # step is what caching its output would save
    enc_embeds = inp["enc_embeds"]
    enc_s = [timed(lambda: encode(params, cfg, enc_embeds))[1]
             for _ in range(3)]
    _, enc_us = traced_device_us(lambda: encode(params, cfg, enc_embeds))
    phase("encdec encoder", arch=cfg.name, frames=tuple(enc_embeds.shape),
          ms=json.dumps([t * 1e3 for t in enc_s]), device_ms=enc_us / 1e3)
    s_eng, n_pages, n_fetches = handoff(cfg, params, prompt, caches,
                                        ENCDEC_POOL, inp)
    ledger(s_eng, n_pages, n_fetches)
    memory_phase("encdec memory", cfg, free0)
    read_counts("encdec", (flash_attention,))
    del params, caches, s_eng, inp

    # 22. qwen2-vl-7b (M-RoPE; the vision tower a stub): 128 patch
    # embeddings over the first positions, one frame on an 8 x 16 grid,
    # the text from id 16 on; K6 at 28 q heads over 4 kv heads of 128
    # once per layer in prefill and forward, none in decode. Its caches
    # are laid out as tinyllama's, whose handoff phase 12 holds.
    zero_counts()
    free0 = memory_before()
    cfg, params, prompt, caches, inp = invariant(
        "qwen2-vl-7b", (flash_attention,), p_len + g_len, SEED + 8)
    trace_share(cfg, params, prompt, caches, inp)
    memory_phase("vlm memory", cfg, free0)
    read_counts("vlm", (flash_attention,))
    del params, caches, inp
    torch.cuda.empty_cache()

    # ---- 18-19. training -------------------------------------------------
    # tinyllama-1.1b at full width and depth, f32, batch 4 x 512; the
    # checkpoint goes to a temporary directory, removed after
    ckpt_dir = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    try:
        plain_losses, plain_norm = train_phases(
            get_config("tinyllama-1.1b"), dev, flash_attention, zero_counts,
            read_counts, ckpt_dir)
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)

    # ---- 26. the multi-process path: two gloo ranks on the one card ------
    # every rank counts its own launches from 0 and returns them
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    path = "multi-process"
    launches[path] = multi_process_phase(
        dev, get_config("tinyllama-1.1b"), (plain_losses, plain_norm))
    phase("launches " + path, **launches[path])
    for fn in (systolic_mm, parse_packets, quantize_stream,
               dequantize_stream, flash_attention):
        check(launches[path][fn.__name__] > 0,
              f"{fn.__name__} never launched on the {path} path")

    # ---- 27. the dry-run against the card ---------------------------------
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    zero_counts()
    charged = dryrun_phase(dev)
    read_counts("dryrun", (flash_attention, ssd_scan))
    # each cell ran twice on the card: counted, then timed
    check({k: launches["dryrun"][k] for k in charged}
          == {k: 2 * n for k, n in charged.items()},
          f"dry-run launches {launches['dryrun']}, charged {charged} a run")

    # ---- 17. launches on the main path -------------------------------------
    counts = {fn.__name__: sum(c[fn.__name__] for c in launches.values())
              for fn in counted}
    phase("kernels", **counts)
    for name, c in counts.items():
        check(c > 0, f"{name} never launched on the main path")
        rec[name]["launches"] = c
        rec[name]["launches_by_path"] = {
            path: per[name] for path, per in launches.items()}
    phase("engine", flushes=eng.stats["flushes"], wqes=eng.stats["wqes"],
          qdma_writes=eng.stats["transport"]["qdma_writes"],
          lc_wqes=eng.stats["lc_wqes"])

    phase("total", seconds=time.perf_counter() - t_start)
    print(json.dumps({"kernels": list(rec.values())}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

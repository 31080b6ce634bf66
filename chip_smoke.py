"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``src/repro_torch/kernels/csrc``
(printing each kernel's registers, shared memory and spills as ptxas
reports them, and the TF32 wgmma kernel's ``HGMMA``, ``UTMALDG`` and
``STL`` counts in its SASS, each instantiation needing the first two)
and runs, on the card:

  1. the card's name and power limit (``nvidia-smi``);
  2. each kernel against its plain PyTorch version at the shapes the main
     path gives it — bit-exact for quantize, dequantize, parse and the
     field classifier (K3 at 65536 and 4096 packets, K4 at 1024, 4096
     and 65536), within
     ``1e-5 * k / 128`` for the f32 matmul (K5 on the CUDA cores, no
     TF32; at 512x16x512 and 2048^3), within 2e-4 (plus one bf16 step
     in bf16) for K6 attention on the tensor cores (3xTF32 in f32, on
     ``wgmma`` over more than 64 rows at head dims 64, 128 and 192/128
     and on ``mma.sync`` elsewhere; bf16 with P split in two halves, on
     ``wgmma`` over more than 64 rows at those dims, each row printing
     the route it
     took, TFLOP/s of the function's flops and SDPA's time beside, and
     the TF32 route's pre-pass and attention kernel each on a
     ``[kernel flash_attention passes]`` line) at the tinyllama prefill
     shape (256 x
     512 x 64, causal, GQA 8, f32; also with window 32, in bf16, at d =
     128, at hymba's 25 q over 5 kv heads with window 1024, at
     deepseek-v2-lite's MLA prefill, 16 heads with q and k 192 wide and
     v 128, at seamless-m4t's encoder (128 x 128, not causal), its
     cross-attention in prefill (512 x 128) and in decode (1 x 128), 16
     heads of 64, at qwen2-vl's prefill, 28 q over 4 kv heads of
     128, and at the serve driver's default ``tiny`` prefill, 8 x 32
     rows, 4 q over 2 kv heads of 16, and the same at head dim 32: the
     ``mma_sync`` route's shapes, the d-16 row recorded as its row), and
     in bf16 at each shape phases 28 and 31 give it
     (``K6_SERVED``: 2 x 32768 rows at every attention model's heads,
     MLA's 192/128, seamless's one head a model rank over its 8192
     frames; 16 x 4096 rows at tinyllama's heads and seamless's one head,
     over 1024 frames), held over slices
     of the query rows at their offset (the plain version's scores at
     32768 rows would not fit), and on each of its wgmma and mma_sync
     routes at query
     offsets (``K6_OFFSETS``: 16 x 256 rows of a sequence-parallel rank
     at offsets 37 and 3840 over 4096 keys, 16 q heads over 2 KV heads
     of 128, causal and with a window of 1024, printed, not recorded,
     beside SDPA on the same rows), and in bf16 at the cut shapes of the
     MoE and hybrid families (``K6_CUT``: phi3.5-moe-42b's 32/8 heads of
     128 and hymba-1.5b's 25/5 of 64, windowed and global, as the last
     model rank's rows at their offset, deepseek-v2-lite-16b's one head
     of 192/128 a rank, at ``prefill_32k`` and ``train_4k``; printed,
     not recorded), and in bf16 at decode-shaped calls (``K6_DECODE``:
     seamless's cross decode with 16 heads over 8192 frames, and GQA
     decode steps over a 32768-slot cache, tinyllama's 32/4 x 64,
     qwen3-4b's 32/8 x 128 and hymba's 25/5 x 64 with its window of
     1024, one row a sequence at slot 32767; printed, not recorded, each
     bound over the keys the call reads) — calls of 64 rows or fewer on ``split_kv``, with the
     ``mma_sync`` kernel launched directly and timed beside it at the
     cross-decode shapes (seamless's one head over 8192 frames in bf16,
     16 heads over 128 in f32; printed, not recorded)
     — with
     its time, the plain version's time, its bound (the function's own
     work, by the formula its wrapper charges to the operation counter
     (``*_cost`` beside each kernel), at its dtype's peak, K6 in f32 as
     three TF32 products at the TF32 peak since it runs on the tensor
     cores; for K6 and K7 also the bound of the products their routes
     run) and, for the
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
     and in f32 at each shape phases 28 and 31 give it (``K7_SERVED``: 2
     x 32768 tokens, 128 chunks a sequence, and 16 x 4096, 16 chunks, at
     mamba2's cut of 2 heads a model rank and hymba's 50, which every
     rank scans) as a prefill passes it and with slow
     decays from a seeded state,
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
  18. training, the plain step: tinyllama-1.1b at full width, cut to
     TRAIN_LAYERS (11) layers, f32, random weights, one repeated
     ``SyntheticPipeline`` batch of 4 x 512 tokens, 3 steps of
     ``make_train_step`` with remat: ms per step, tokens/s, losses
     (finite, step 3's below step 1's), peak memory and K6 launches per
     step (22: a forward and a remat recompute per layer;
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
     memory and K6 launches (44 per step);
  26. the multi-process path: two gloo ranks sharing the card
     (``run_peers``; the parent's memory freed first, the wire gloo
     through host memory): (a) ``read_batch_16k`` on a 2-peer engine over
     the ranks (``ICITransport``, one pool row a rank), its pool byte-equal
     to a LocalTransport run of the same traffic on the card; (b) the
     Lookaside block over the twin, ``lc_offload_mm`` 512x16x512 and a
     4096-packet ``PARSER_WORKLOAD``, byte-equal to the single-process run
     (K5 and K3 launched in every rank); (c) phase 18's tinyllama-1.1b
     (full width, TRAIN_LAYERS deep), f32, remat, its batch split over a
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
     and the multi-pod mesh on ``meta``, one process a mesh, started
     with the meta traces of 28 and 31's cells before phase 18, at the
     lowest CPU priority (``CpuWork``), so that phases 18, 19, 26 and 27
     run beside them: ok, skipped and failed counts, 0 failed;
  28. the reference's bf16 cells: one device's share of the single-pod
     mesh (16, 16) of the 22 ``prefill_32k``, ``decode_32k`` and
     ``long_500k`` cells that fit the card (``BF16_CELLS``; every arch's
     share cut over the model axis, each the share of its last model
     rank, which sequence-parallel attention loads most), each traced
     on ``meta`` and run on the card from SEED in bf16 as phase 27 runs
     its cells (``card_cell``: (a) and (b) checked, (c) printed), decode
     cells stepping at their slot over caches of seeded values, with
     (d) a traced run's device share and tokens/s;
  29. bf16 serving against f32 on the same weights: the eight archs of
     28 other than qwen1.5-32b and phi3.5-moe-42b at full width and depth, 2 x 512 prompt tokens and 8 decode
     steps, the bf16 prefill + decode within twice the gap between the
     bf16 and the f32 forward, the f32 prefill + decode within 1e-4 of
     the f32 forward's logits' scale (deepseek pinned to the bf16
     forward's routing, every routing flip a near-tie, no expert over
     its capacity), and tinyllama's bf16 caches through the uncompressed
     handoff with greedy tokens equal;
  30. decode at the cells' length: tinyllama-1.1b and hymba-1.5b (cut
     to 8 of its 32 layers, ``LONG_LAYERS``), one
     sequence of 32768 tokens, the last 8 (hymba: 256, one chunk)
     decoded to slot 32767 after a prefill of the rest, against one
     forward over all of them: bf16 within twice its gap to f32, f32
     within 1e-4 of the logits' scale (deepseek's cut MLA decode, (b),
     and mamba2's cut SSM decode, (c), to slot 32767 run in 32's ranks);
  31. the reference's ``train_4k`` cells the card trains: one device's
     share of the single-pod mesh (16, 16), 16 x 4096 tokens, of
     mamba2-370m, hymba-1.5b, tinyllama-1.1b, qwen2.5-3b, qwen3-4b,
     qwen2-vl-7b, qwen1.5-32b, phi3.5-moe-42b, deepseek-v2-lite-16b and
     seamless-m4t-large-v2 at full width and depth, bf16, from SEED, the
     dry-run's ``TrainConfig`` (remat, ZeRO-1 over the plan's 16 data
     ranks, every arch cut over its 16 model ranks under sequence
     parallelism; an MoE layer routes as data rank 0 of the global
     batch, the other ranks' counts stand-ins), under
     ``set_attention_impl("blockwise", 1024)``: K6's backward recomputes
     the online softmax over chunks of 1024 keys. Each cell through
     ``card_cell`` as 28 runs its cells (the traced run for mamba2,
     tinyllama and seamless), its loss and global gradient norm finite
     and some parameter moved, K6 at two calls an attention layer a step
     (seamless's 72: encoder, self and cross) and K7 at 96 and 64
     (mamba2, hymba), each traced cell's K6 and K7 device ms a step
     printed. (c) tinyllama's and mamba2's shares again under the
     reference's ``--remat-policy dots`` (``remat_policy("dots")``:
     selective checkpointing that keeps the outputs of the products
     without batch dims): meta against the card's peak within
     DRYRUN_MEM_TOL, K6 and K7 calls a step as under ``full``, the loss
     and gradient norm within GRAD_SYNC_TOL of (b)'s, printed beside
     them with both walls, peaks and traced device ms.
     Before them, the blockwise backward against the plain one at a
     depth where both fit: tinyllama cut to 2 layers, 2 x 4096, remat,
     the loss and its gradients under ``"naive"`` and under
     ``"blockwise"`` at 1024 keys: f32 within 1e-5 (loss, relative) and
     2e-5 of each gradient leaf's largest |value|, bf16 within one bf16
     step of it or the naive bf16 leaf's distance from f32's;
  32. the ``model`` axis: a two-layer qwen2.5-3b (its 16 q heads over 2
     KV heads of 128; FFN and vocab narrowed) in f32 on 2 x 400 tokens,
     unsharded in this process (the logits and one plain train step's
     loss, norm and gradients), then four gloo ranks of a (1, 4) data x
     model mesh sharing the card (``tp_phase``): each rank's cut of the
     weights, its forward's vocab-cut logits within 1e-4 of their
     scale, and one ``make_train_step(mesh)`` step under sequence
     parallelism, its loss within 1e-5, norm within GRAD_SYNC_TOL and
     every gradient within 2e-5 of the unsharded run's (a leaf that one
     f32 rounding of the unsharded run's weights moves by over 5e-6, the
     SSM's ``a_log`` and ``dt_bias``, within GRAD_SYNC_TOL of the global
     gradient norm); attention is
     sequence-parallel, so rank r launches K6 (``wgmma_tf32``) at query
     offset 100 r, and no other offset; the same for a two-layer
     deepseek-v2-lite-16b at full width (dense FFN narrowed; MLA
     head-parallel, K6 at offset 0; its MoE layer's 64 experts 16 a
     rank, at the config's capacity factor), a two-layer encoder and
     decoder of seamless-m4t-large-v2 (4 heads a rank, K6 at offset 0,
     100 frames), and on 2 x 512 tokens mamba2-370m's mixer (a
     head-parallel scan, K7 once a layer a forward) and hymba-1.5b's
     hybrid heads (attention by rows at offset 128 r, every rank
     scanning all 50 SSM heads); then phase 30 (b) on the same ranks:
     deepseek's MLA over a narrow dense FFN, each rank's cut weights and
     cut latent cache, a prefill of 32760 tokens and 8 decode steps to
     slot 32767 within 1e-4 of the unsharded forward's logits' scale, K6
     once a layer in the prefill and never in decode; 30 (c): mamba2 at
     full width, two layers, its cut conv and SSM caches, prefills of
     32512 and 248 tokens and 8 decode steps to slot 32767 within 1e-4,
     K7 once a layer a prefill and never in decode; and (b) a (2, 2)
     data x model mesh of the same ranks: deepseek's narrow model at
     capacity factor 1 (assignments dropped), one ``make_train_step``
     step whose MoE layer routes each data rank's rows as a part of the
     global batch, its loss, norm and gradients against the unsharded
     step on the global batch; (d) qwen2.5-3b's narrow model again on
     the (1, 4) ranks with ``sharding.qkv_sharding(False)`` (the
     reference's ``--no-qkv-shard``): every rank scores its 32 columns of
     each head's 128 and the scores are all-reduced, held to the same
     unsharded run with the same tolerances, and no K6 launch;
  34. MLA over a model axis its heads do not divide: one device's
     share of deepseek-v2-lite-16b's ``prefill_32k`` and ``decode_32k``
     on the reference's custom ``8x32:data,model`` mesh (its 16 heads
     over 32 model ranks), bf16, through ``card_cell`` with the traced
     run: the prefill's MLA by rows, the last rank's 1024 rows of each
     sequence against K and V gathered whole, K6 once a layer on
     ``wgmma`` at 192/128 and query offset 31744; the decode step none;
     meta equal to the card;
  33. the serve driver's default (``launch/serve.py``'s ``run`` with
     its default ``tiny``: 8 requests, 32-token prompts, 16 greedy
     tokens, f32): K6 on ``mma_sync`` at head dim 16, once a layer in
     the prefill, and finite outputs of the shape it reports;
  17. each kernel's launch count on the twenty-one paths (3-6, 7-10,
     11-13, 14-15, 16, 20, 21, 22, 33, 18, 19, 26 summed over its
     ranks, 27
     with two runs a cell on the card, 28 with three, 31's cells with
     two or three, 31 (c)'s with three, 34's with three, 29, 30, 31's
     check and 32 summed over its ranks),
     each path run with the counters at 0 and read right after: every
     kernel a path runs must have launched on it, and each of the seven
     > 0, K6 also per route (``flash_attention.wgmma`` and
     ``flash_attention.wgmma_tf32``, the Hopper kernels that bf16 and
     f32 calls over 64 rows at the served head dims take,
     ``flash_attention.split_kv``, which calls of 64 rows or fewer there
     take, seamless's cross-attention in decode above all, and
     ``flash_attention.mma_sync``, head dims 16 and 32: path 33's), each
     > 0; the kernels line records K6's four kernels apart
     (``flash_attention``, ``flash_attention_sm90``,
     ``flash_attention_sm90_tf32`` and ``flash_attention_splitkv``).

Any mismatch raises, so the exit code is not 0. The second-to-last line
is the kernels' JSON record, the last ``{"ok": true, "device": ...}``.
Without a CUDA device it exits with an error before printing a result.
"""
import atexit
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
#: the depth of tinyllama-1.1b in phases 18-19 and 26 (its 22 layers cut
#: to pay for phases 31 (c), 32 (d) and 34: half of 26's gloo traffic is
#: the stack's gradients and state)
TRAIN_LAYERS = 11
MP_POOL = 1 << 21
MP_TIMEOUT_S = 900
# traces of a kernel's timed calls before the profiler's empty-handed
# traces fail the smoke (_traced_ms)
TRACE_TRIES = 4
# phase 27: the dry-run's predicted peak live bytes against the card's
# peak, relative (the tolerance PERF.md predicted)
DRYRUN_MEM_TOL = 0.05
# K6's bf16 shapes in the bf16 cells and the train_4k cells (phase 2 holds
# each): (where, B, Sq, Skv, Hq, Hkv, d, dv, causal, window)
K6_SERVED = (
    ("tinyllama-1.1b", 2, 32768, 32768, 32, 4, 64, 64, True, 0),
    ("qwen2.5-3b", 2, 32768, 32768, 16, 2, 128, 128, True, 0),
    ("qwen3-4b", 2, 32768, 32768, 32, 8, 128, 128, True, 0),
    ("qwen2-vl-7b", 2, 32768, 32768, 28, 4, 128, 128, True, 0),
    ("deepseek-v2-lite-16b mla", 2, 32768, 32768, 16, 16, 192, 128, True,
     0),
    # seamless-m4t-large-v2's cut shares: one head of 64 a rank (16 over
    # 16 model ranks), the encoder over S / 4 frames
    ("seamless encoder head", 2, 8192, 8192, 1, 1, 64, 64, False, 0),
    ("seamless self head", 2, 32768, 32768, 1, 1, 64, 64, True, 0),
    ("seamless cross prefill head", 2, 32768, 8192, 1, 1, 64, 64, False, 0),
    ("seamless decode encoder head", 8, 8192, 8192, 1, 1, 64, 64, False, 0),
    ("seamless cross decode head", 8, 1, 8192, 1, 1, 64, 64, False, 0),
    ("tinyllama-1.1b train_4k", 16, 4096, 4096, 32, 4, 64, 64, True, 0),
    ("seamless train_4k encoder head", 16, 1024, 1024, 1, 1, 64, 64, False,
     0),
    ("seamless train_4k self head", 16, 4096, 4096, 1, 1, 64, 64, True, 0),
    ("seamless train_4k cross head", 16, 4096, 1024, 1, 1, 64, 64, False,
     0),
)
# K6 at phase 2's shapes, f32 but for one bf16 row (the f32 tinyllama row
# recorded last, as wgmma_tf32's; the serve driver's default `tiny` prefill,
# path 33's call and the main path's only mma_sync one, as mma_sync's):
# (where, dtype, B, Sq, Skv, Hq, Hkv, d, dv, causal, window)
K6_PHASE2 = (
    ("tinyllama-1.1b window 32", "float32", 8, 512, 512, 32, 4, 64, 64, True,
     32),
    ("tinyllama-1.1b", "bfloat16", 8, 512, 512, 32, 4, 64, 64, True, 0),
    ("hymba-1.5b", "float32", 8, 512, 512, 25, 5, 64, 64, True, 1024),
    ("d 128", "float32", 8, 512, 512, 32, 4, 128, 128, True, 0),
    ("deepseek-v2-lite-16b mla", "float32", 8, 512, 512, 16, 16, 192, 128,
     True, 0),
    ("seamless encoder", "float32", 8, 128, 128, 16, 16, 64, 64, False, 0),
    ("seamless cross prefill", "float32", 8, 512, 128, 16, 16, 64, 64, False,
     0),
    ("seamless cross decode", "float32", 8, 1, 128, 16, 16, 64, 64, False, 0),
    ("qwen2-vl-7b", "float32", 8, 512, 512, 28, 4, 128, 128, True, 0),
    ("tiny d 32", "float32", 8, 32, 32, 4, 2, 32, 32, True, 0),
    ("tiny serve prefill", "float32", 8, 32, 32, 4, 2, 16, 16, True, 0),
    ("tinyllama-1.1b", "float32", 8, 512, 512, 32, 4, 64, 64, True, 0),
)
# K6 at query offsets (phase 2): 256 rows of a sequence-parallel rank,
# qwen2.5-3b's train_4k share at a model axis of 16 (16 sequences, 16 q
# heads over 2 KV heads of 128) over 4096 keys, causal, on each route, at
# an offset no tile divides and at rank 15's 3840, there also with a
# window: (dtype, route, window, q_offset)
K6_OFFSETS = tuple((dtype, route, window, off)
                   for dtype, route in (("bfloat16", "wgmma"),
                                        ("float32", "wgmma_tf32"),
                                        ("float32", "mma_sync"))
                   for window, off in ((0, 37), (0, 3840), (1024, 3840)))
# K6 at the cut shapes of the MoE and hybrid families (phase 2, bf16 as
# the cells run it), causal: phi3.5-moe-42b's GQA 32/8 x 128 and
# hymba-1.5b's 25/5 x 64 (its window of 1024 and its global layers) in
# sequence mode, the last model rank's rows at their offset (2 x 2048 of
# 32768 at prefill_32k, 16 x 256 of 4096 at train_4k), and
# deepseek-v2-lite-16b's one head a rank of 192/128 at prefill_32k and
# train_4k: (where, B, Sq, Skv, Hq, Hkv, d, dv, q_offset, window)
K6_CUT = (
    ("phi3.5-moe-42b prefill_32k rank 15", 2, 2048, 32768, 32, 8, 128, 128,
     30720, 0),
    ("phi3.5-moe-42b train_4k rank 15", 16, 256, 4096, 32, 8, 128, 128,
     3840, 0),
    ("deepseek-v2-lite-16b prefill_32k head", 2, 32768, 32768, 1, 1, 192,
     128, 0, 0),
    ("deepseek-v2-lite-16b train_4k head", 16, 4096, 4096, 1, 1, 192, 128,
     0, 0),
    # phase 34: every head, the last of 32 model ranks' rows (MLA by rows)
    ("deepseek-v2-lite-16b prefill_32k 8x32 rank 31 rows", 4, 1024, 32768,
     16, 16, 192, 128, 31744, 0),
    ("hymba-1.5b prefill_32k rank 15 windowed", 2, 2048, 32768, 25, 5, 64,
     64, 30720, 1024),
    ("hymba-1.5b prefill_32k rank 15 global", 2, 2048, 32768, 25, 5, 64, 64,
     30720, 0),
    ("hymba-1.5b train_4k rank 15 windowed", 16, 256, 4096, 25, 5, 64, 64,
     3840, 1024),
    ("hymba-1.5b train_4k rank 15 global", 16, 256, 4096, 25, 5, 64, 64,
     3840, 0),
)
# K6 at decode-shaped calls (phase 2, bf16, on split_kv): seamless's cross
# decode replicated, and GQA decode steps over a 32768-slot cache, one row
# a sequence at slot 32767, causal; hymba's window of 1024 reads 1024 keys,
# not 32768. The yardstick for decode attention over the cache, which
# runs plain today: (where, B, Sq, Skv, Hq, Hkv, d, dv, causal, window,
# q_offset)
K6_DECODE = (
    # seamless's cross-attention decode with the model axis replicated: 16
    # heads of 64 over 8192 frames, not causal
    ("seamless cross decode 16 heads", 8, 1, 8192, 16, 16, 64, 64, False, 0,
     0),
    ("tinyllama-1.1b decode", 8, 1, 32768, 32, 4, 64, 64, True, 0, 32767),
    ("qwen3-4b decode", 8, 1, 32768, 32, 8, 128, 128, True, 0, 32767),
    ("hymba-1.5b decode window", 8, 1, 32768, 25, 5, 64, 64, True, 1024,
     32767),
)
# K6's four routes: each route's source and its key in the kernels line
K6_SOURCE = {"mma_sync": "flash_attention.cu",
             "wgmma": "flash_attention_sm90.cu",
             "wgmma_tf32": "flash_attention_sm90_tf32.cu",
             "split_kv": "flash_attention_splitkv.cu"}
K6_KEY = {"mma_sync": "flash_attention", "wgmma": "flash_attention_sm90",
          "wgmma_tf32": "flash_attention_sm90_tf32",
          "split_kv": "flash_attention_splitkv"}
# K7's shapes in the bf16 cells and the train_4k cells, f32 as models/ssm.py
# passes them (phase 2 holds each): (where, B, S, nh, hd, d_state, chunk),
# one group. The cut shares: mamba2-370m's scan head-parallel, 2 of its 32
# heads a model rank; hymba-1.5b's 50 heads do not divide 16 ranks, and
# every rank scans them all
K7_SERVED = (
    ("mamba2-370m 2 heads", 2, 32768, 2, 64, 128, 256),
    ("hymba-1.5b", 2, 32768, 50, 64, 16, 256),
    ("mamba2-370m train_4k 2 heads", 16, 4096, 2, 64, 128, 256),
    ("hymba-1.5b train_4k", 16, 4096, 50, 64, 16, 256),
)
# phases 11-16: requests, prompt tokens, greedy tokens; the caches' slots
SERVE_TRAFFIC = (8, 512, 32)
SERVE_MAX_SEQ = 552
# phase 29: requests, prompt tokens, teacher-forced decode steps
BF16_TRAFFIC = (2, 512, 8)
# the f32 prefill + decode against the f32 forward (phases 11-22, 29 and
# 30): max |difference| over the logits' largest |value|
SERVE_TOL = 1e-4
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


def traced_device_us(fn, tries=1, per_kernel=None):
    """``_trace``, failing on a trace that holds no device time. CUPTI now
    and then hands back an empty trace of work that is copies alone (seen
    on 64 MiB executor copies and on a cache fetch), so a pure call, run
    only for its device time, may be traced up to ``tries`` times. With
    a dict ``per_kernel``, each counted wrapper whose kernels ran is set
    in it to their device ms in the trace (``KERNEL_SYMBOL``)."""
    for _ in range(tries):
        out, rows = _trace(fn)
        total_us = sum(e.self_device_time_total for e in rows)
        if total_us > 0:
            if per_kernel is not None:
                for name, syms in KERNEL_SYMBOL.items():
                    sym = re.compile(r"\b(" + "|".join(syms) + r")\b")
                    us = sum(e.self_device_time_total for e in rows
                             if sym.search(e.key))
                    if us:
                        per_kernel[name] = us / 1e3
            return out, total_us
    raise AssertionError(f"the profiler traced no device time in {tries} "
                         f"traces")


# the __global__ functions one call of each counted wrapper launches, once
# each: K7 runs five passes per call, each named ssd_scan_<pass>; a K6 call
# runs its route's kernels (ROUTE_SYMBOL: the TF32 route a pre-pass, then
# the attention; split_kv the split pass, then the merge of its splits,
# which a call of one split does without: a trace must hold the split pass
# and counts the merge where it appears, SPLIT_KV_MERGE)
SPLIT_KV_MERGE = "flash_attention_splitkv_combine"
ROUTE_SYMBOL = {"flash_attention": {
    "mma_sync": ("flash_attention_kernel",),
    "wgmma": ("flash_attention_sm90_kernel",),
    "wgmma_tf32": ("flash_attention_tf32_split",
                   "flash_attention_sm90_tf32_kernel"),
    "split_kv": ("flash_attention_splitkv_kernel", SPLIT_KV_MERGE)}}
KERNEL_SYMBOL = {"systolic_mm": ("systolic_mm_kernel",),
                 "flash_attention": tuple(
                     sym for syms in ROUTE_SYMBOL["flash_attention"].values()
                     for sym in syms),
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
        r0 = dict(getattr(wrapper, "route_launches", {}))
        _, rows = _trace(run)
        if r0:
            # the kernels of the routes these calls took
            names = {sym for r, n in wrapper.route_launches.items()
                     if n > r0[r]
                     for sym in ROUTE_SYMBOL[wrapper.__name__][r]
                     if sym != SPLIT_KV_MERGE}
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


def counted_run(counted):
    """``during(fn)``: run ``fn`` synchronised and return (its result, the
    seconds it took, each of the ``counted`` wrappers' launches during
    it)."""
    def during(fn):
        torch.cuda.synchronize()
        n0 = {f.__name__: f.launches for f in counted}
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t, {
            f.__name__: f.launches - n0[f.__name__] for f in counted}
    return during


def check(ok, what):
    if not ok:
        raise AssertionError(what)


#: when this process started: every phase line gives its seconds since
_T0 = time.perf_counter()


def phase(name, **nums):
    nums["at_s"] = f"{time.perf_counter() - _T0:.1f}"
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


class RouteLog:
    """``models.moe.route`` wrapped: each call's own top-k sets (sorted),
    the margins between each token's k-th and (k+1)-th expert probability
    and the probabilities are logged, and no expert may take more than
    its capacity (nothing is dropped); with ``pins`` (a list of (T, k)
    expert sets, one a call) the call takes the pinned set instead, its
    gates renormalised from its own probabilities as ``route`` makes
    them, so that two routes can be held on the same routing."""

    def __init__(self, inner, k):
        self.inner, self.k = inner, k
        self.log, self.pins = [], None

    def __call__(self, router_w, x2d, cfg):
        from repro_torch.models.moe import _capacity

        idx, gate, aux = self.inner(router_w, x2d, cfg)
        with torch.no_grad():
            probs = torch.softmax(x2d.float() @ router_w, -1)
            top = torch.topk(probs, self.k + 1, dim=-1).values
        self.log.append((torch.sort(idx, dim=-1).values,
                         top[:, self.k - 1] - top[:, self.k], probs))
        if self.pins is not None:
            idx = self.pins.pop(0)
            g = probs.gather(1, idx)
            gate = g / torch.sum(g, dim=-1, keepdim=True)
        load = int(torch.bincount(idx.reshape(-1),
                                  minlength=cfg.moe.num_experts).max())
        cap = _capacity(x2d.shape[0], cfg)
        check(load <= cap, f"{cfg.name}: an expert took {load} "
                           f"assignments, over its capacity {cap}")
        return idx, gate, aux


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
    routes = RouteLog(moe_mod.route, k)
    toks = torch.from_numpy(np.random.default_rng(SEED + 6).integers(
        0, cfg.vocab_size, (n_req, p_len + g_len))).to(dev)
    prompt = toks[:, :p_len]
    moe_mod.route = routes
    try:
        full, full_s, n_full = during(
            lambda: forward(params, inv_cfg, {"tokens": toks})[0])
        full_routes, routes.log = routes.log, []
        full = full[:, p_len - 1:].clone()     # frees the other 1.7 GB
        caches = init_caches(inv_cfg, n_req, max_seq, torch.float32)
        (lg, caches), pre_s, n_pre = during(lambda: prefill_step(
            params, inv_cfg, {"tokens": prompt}, caches))
        step_routes, routes.log = [routes.log], []
        errs = [(lg[:, 0] - full[:, 0]).abs().amax(-1)]

        def decode_all():
            c = caches
            for i in range(p_len, p_len + g_len):
                out, c = decode_step(params, inv_cfg, toks[:, i:i + 1], c, i)
                errs.append((out[:, 0] - full[:, i - p_len + 1]).abs()
                            .amax(-1))
                step_routes.append(routes.log)
                routes.log = []
            return c

        caches, dec_s, n_dec = during(decode_all)
    finally:
        moe_mod.route = routes.inner
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
    tol_s = SERVE_TOL * scale
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
    zero_launches(counted)
    return rank_device(rank, device), counted


def zero_launches(counted):
    """Set every counted wrapper's launches to 0, and K6's per route."""
    from repro_torch.kernels.flash_attention import reset_launches
    for fn in counted:
        fn.launches = 0
    reset_launches()


def launch_counts(counted):
    """Each counted wrapper's launches by its name, and K6's per route as
    ``flash_attention.<route>``."""
    from repro_torch.kernels.flash_attention import flash_attention
    out = {fn.__name__: fn.launches for fn in counted}
    out.update({f"flash_attention.{r}": n
                for r, n in flash_attention.route_launches.items()})
    return out


def _launches(dev, counted):
    _sync(dev)
    return launch_counts(counted)


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


def k6_served_phase(dev, measure):
    """Phase 2's K6 in bf16 at the shapes the bf16 and train_4k cells
    give it (``K6_SERVED``, phase 28: one device's share of prefill_32k
    and decode_32k; phase 31: of train_4k's forward), each held and timed
    by ``measure`` (main's) over 5 calls. The plain version cannot hold S
    x S scores at 32768 rows (137 GB at 32 heads), so it is held over
    slices of the query rows against
    all keys, at their offset: a 512-row block in the middle and the last
    512 rows; its time is that of the last slice. SDPA is the yardstick
    on flash or memory-efficient attention alone (the math backend would
    materialise the scores), with K and V repeated to the q heads
    beforehand and hymba's window as a boolean mask."""
    from torch.nn.attention import SDPBackend, sdpa_kernel

    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_cost,
                                                     flash_attention_plain,
                                                     flash_attention_route)

    sdpa = torch.nn.functional.scaled_dot_product_attention
    backends = [SDPBackend.FLASH_ATTENTION, SDPBackend.EFFICIENT_ATTENTION]
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 30)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(
            torch.bfloat16)

    for what, b, sq, skv, hq, hkv, d, dv, causal, window in K6_SERVED:
        q, k, v = randn(b, sq, hq, d), randn(b, skv, hkv, d), randn(
            b, skv, hkv, dv)
        got = flash_attention(q, k, v, causal=causal, window=window)
        slices = ([(0, sq)] if sq <= 1024 else
                  [(sq // 2 - 256, sq // 2 + 256), (sq - 512, sq)])
        err = 0.0
        for r0, r1 in slices:
            want = flash_attention_plain(q[:, r0:r1], k, v, causal=causal,
                                         window=window, q_offset=r0)
            e = (got[:, r0:r1].float() - want.float()).abs()
            check(bool((e <= 2e-4 + 2.0 ** -7 * want.float().abs()).all()),
                  f"flash_attention bf16 {what} rows {r0}:{r1}: max err "
                  f"{e.max().item()}")
            err = max(err, e.max().item())
        del got, want, e
        qt = q.transpose(1, 2).contiguous()
        kt, vt = (t.repeat_interleave(hq // hkv, dim=2).transpose(1, 2)
                  .contiguous() for t in (k, v))
        mask = None
        if window:
            i = torch.arange(skv, device=dev)
            mask = (i[:, None] >= i[None, :]) & (i[:, None] - i[None, :]
                                                 < window)

        def library():
            with sdpa_kernel(backends):
                if mask is not None:
                    return sdpa(qt, kt, vt, attn_mask=mask)
                return sdpa(qt, kt, vt, is_causal=causal)

        cost = flash_attention_cost(q, k, v, causal=causal, window=window)
        r0 = slices[-1][0]
        route = flash_attention_route(q.dtype, d, dv, sq)
        if route == "split_kv":
            mma_sync_beside(measure, what, q, k, v, causal, window, cost,
                            library, PEAK_BF16_FLOPS)
        # the wgmma kernel's record in the kernels line is tinyllama's row,
        # split_kv's seamless's cross decode
        measure("flash_attention", K6_SOURCE[route],
                "src/repro/kernels/flash_attention.py:102",
                f"{what} {b}x{sq}{f'/{skv}' if skv != sq else ''}x"
                f"{hq}/{hkv}x{d}{f'/{dv}' if dv != d else ''} "
                f"{'causal' if causal else 'noncausal'}"
                f"{f' window{window}' if window else ''} bfloat16",
                err, lambda: flash_attention(q, k, v, causal=causal,
                                             window=window),
                lambda: flash_attention_plain(
                    q[:, r0:], k, v, causal=causal, window=window,
                    q_offset=r0), cost, library=library,
                peak_flops=PEAK_BF16_FLOPS, iters=5,
                key=K6_KEY[route],
                record=(route, what) in (
                    ("wgmma", "tinyllama-1.1b"),
                    ("split_kv", "seamless cross decode head")),
                plain_rows=f"{r0}:{sq}", k6_route=route,
                route_bound_ms=bound(cost[1], 1.5 * cost[0],
                                     PEAK_BF16_FLOPS)[0])
        del q, k, v, qt, kt, vt, mask
        torch.cuda.empty_cache()


def mma_sync_beside(measure, what, q, k, v, causal, window, cost, library,
                    peak):
    """A split_kv shape on the ``mma_sync`` kernel, the route such calls
    took before split_kv, launched directly (``_launch``): held against
    ``flash_attention_plain`` with phase 2's tolerances, then timed by
    ``measure`` and printed, not recorded."""
    from repro_torch.kernels import flash_attention as fa
    b, sq, hq, d = q.shape
    out = q.new_empty((b, sq, hq, v.shape[-1]))

    def kernel():
        fa._launch("mma_sync", q, k, v, out, causal, window, d ** -0.5)
        return out

    def plain():
        return fa.flash_attention_plain(q, k, v, causal=causal,
                                        window=window)

    before = fa.flash_attention.route_launches["mma_sync"]
    got, want = kernel(), plain()
    check(fa.flash_attention.route_launches["mma_sync"] == before + 1,
          f"K6 {what} did not launch mma_sync")
    err = (got.float() - want.float()).abs()
    rel = 2.0 ** -7 if q.dtype == torch.bfloat16 else 0.0
    check(bool((err <= 2e-4 + rel * want.float().abs()).all()),
          f"flash_attention mma_sync {what}: max err {err.max().item()}")
    measure("flash_attention", K6_SOURCE["mma_sync"],
            "src/repro/kernels/flash_attention.py:102",
            f"{what} {b}x{sq}/{k.shape[1]}x{hq}/{k.shape[2]}x{d} "
            f"{'causal' if causal else 'noncausal'} "
            f"{str(q.dtype).split('.')[-1]} on mma_sync",
            err.max().item(), kernel, plain, cost, library=library,
            peak_flops=peak, key=K6_KEY["mma_sync"], record=False,
            k6_route="mma_sync")


def k6_decode_phase(dev, measure):
    """Phase 2's K6 in bf16 at decode-shaped calls (``K6_DECODE``), on
    split_kv: each held against ``flash_attention_plain(q_offset=)``
    within 2e-4 plus one bf16 step, then timed by ``measure`` over 5
    calls and printed, not recorded. The bound counts the keys the call
    reads (hymba's window: 1024 of 32768), each once per kv head, and q
    and the output once; SDPA on flash or memory-efficient attention
    alone, with K and V repeated to the q heads, the window as a boolean
    mask, is the library time."""
    from torch.nn.attention import SDPBackend, sdpa_kernel

    from repro_torch.kernels import flash_attention as fa

    sdpa = torch.nn.functional.scaled_dot_product_attention
    backends = [SDPBackend.FLASH_ATTENTION, SDPBackend.EFFICIENT_ATTENTION]
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 70)
    for what, b, sq, skv, hq, hkv, d, dv, causal, window, off in K6_DECODE:
        q, k, v = (torch.randn(shape, generator=gen, device=dev).to(
            torch.bfloat16) for shape in ((b, sq, hq, d), (b, skv, hkv, d),
                                          (b, skv, hkv, dv)))
        route = fa.flash_attention_route(q.dtype, d, dv, sq)
        check(route == "split_kv", f"K6 decode row {what} routed to {route}")

        def kernel():
            return fa.flash_attention(q, k, v, causal=causal, window=window,
                                      q_offset=off)

        def plain():
            return fa.flash_attention_plain(q, k, v, causal=causal,
                                            window=window, q_offset=off)

        before = fa.flash_attention.route_launches[route]
        got, want = kernel(), plain()
        check(fa.flash_attention.route_launches[route] == before + 1,
              f"K6 {what} did not launch {route}")
        err = (got.float() - want.float()).abs()
        check(bool((err <= 2e-4 + 2.0 ** -7 * want.float().abs()).all()),
              f"flash_attention split_kv {what}: max err "
              f"{err.max().item()}")
        pos = off + torch.arange(sq, device=dev)[:, None]
        j = torch.arange(skv, device=dev)[None, :]
        seen = torch.ones((sq, skv), dtype=torch.bool, device=dev)
        if causal:
            seen &= pos >= j
        if window:
            seen &= pos - j < window
        keys = int(seen.any(0).sum())
        flops = fa.flash_attention_cost(q, k, v, causal=causal,
                                        window=window, q_offset=off)[0]
        nbytes = q.element_size() * b * (d + dv) * (sq * hq + keys * hkv)
        qt = q.transpose(1, 2).contiguous()
        kt, vt = (t.repeat_interleave(hq // hkv, dim=2).transpose(1, 2)
                  .contiguous() for t in (k, v))
        mask = seen if bool((~seen).any()) else None

        def library():
            with sdpa_kernel(backends):
                return sdpa(qt, kt, vt, attn_mask=mask)

        measure("flash_attention", K6_SOURCE[route],
                "src/repro/kernels/flash_attention.py:102",
                f"{what} {b}x{sq}/{skv}x{hq}/{hkv}x{d} "
                f"{'causal' if causal else 'noncausal'}"
                f"{f' window{window}' if window else ''} q_offset{off} "
                f"bfloat16", err.max().item(), kernel, plain,
                (flops, nbytes), library=library, peak_flops=PEAK_BF16_FLOPS,
                iters=5, key=K6_KEY[route], record=False, k6_route=route,
                keys_read=keys, q_offset=off)
        del q, k, v, got, want, err, qt, kt, vt, mask, seen
        torch.cuda.empty_cache()


def k6_offset_phase(dev, measure):
    """Phase 2's K6 at query offsets (``K6_OFFSETS``): each route's
    output against ``flash_attention_plain(q_offset=)`` within phase 2's
    tolerances (2e-4, and one bf16 step in bf16), then timed by
    ``measure`` (main's) and printed, not recorded. The wgmma routes take
    the call through ``flash_attention``; ``mma_sync``, which the
    routing gives head dims 16 and 32, is launched directly. The
    library time is SDPA on flash or memory-efficient attention alone,
    with K and V repeated to the q heads beforehand, as in
    ``k6_served_phase``: the last rows of the keys (offset Skv - Sq, no
    window) as ``causal_lower_right``, any other offset or a window as a
    boolean mask built beside it."""
    from torch.nn.attention import SDPBackend, sdpa_kernel
    from torch.nn.attention.bias import causal_lower_right

    from repro_torch.kernels import flash_attention as fa

    sdpa = torch.nn.functional.scaled_dot_product_attention
    backends = [SDPBackend.FLASH_ATTENTION, SDPBackend.EFFICIENT_ATTENTION]
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 40)
    b, sq, skv, hq, hkv, d = 16, 256, 4096, 16, 2, 128
    for dname, route, window, off in K6_OFFSETS:
        dtype = getattr(torch, dname)
        q, k, v = (torch.randn(shape, generator=gen, device=dev).to(dtype)
                   for shape in ((b, sq, hq, d), (b, skv, hkv, d),
                                 (b, skv, hkv, d)))
        out = q.new_empty(q.shape)

        def kernel():
            if route == "mma_sync":
                fa._launch(route, q, k, v, out, True, window, d ** -0.5,
                           off)
                return out
            return fa.flash_attention(q, k, v, causal=True, window=window,
                                      q_offset=off)

        def plain():
            return fa.flash_attention_plain(q, k, v, causal=True,
                                            window=window, q_offset=off)

        check(route == "mma_sync" or fa.flash_attention_route(
            dtype, d, d, sq) == route, f"K6 offset row routed off {route}")
        before = fa.flash_attention.route_launches[route]
        got, want = kernel(), plain()
        check(fa.flash_attention.route_launches[route] == before + 1,
              f"K6 at offset {off} did not launch {route}")
        err = (got.float() - want.float()).abs()
        rel = 2.0 ** -7 if dtype == torch.bfloat16 else 0.0
        check(bool((err <= 2e-4 + rel * want.float().abs()).all()),
              f"flash_attention {route} q_offset {off} window {window}: "
              f"max err {err.max().item()}")
        cost = fa.flash_attention_cost(q, k, v, causal=True, window=window,
                                       q_offset=off)
        peak = (PEAK_BF16_FLOPS if dtype == torch.bfloat16
                else PEAK_TF32_FLOPS / 3)
        qt = q.transpose(1, 2).contiguous()
        kt, vt = (t.repeat_interleave(hq // hkv, dim=2).transpose(1, 2)
                  .contiguous() for t in (k, v))
        if window == 0 and off == skv - sq:
            mask = causal_lower_right(sq, skv)
        else:
            i = off + torch.arange(sq, device=dev)[:, None]
            j = torch.arange(skv, device=dev)[None, :]
            mask = (i >= j) & ((i - j < window) if window else True)

        def library():
            with sdpa_kernel(backends):
                return sdpa(qt, kt, vt, attn_mask=mask)
        measure("flash_attention", K6_SOURCE[route],
                "src/repro/kernels/flash_attention.py:102",
                f"train_4k share {b}x{sq}/{skv}x{hq}/{hkv}x{d} causal"
                f"{f' window{window}' if window else ''} q_offset{off} "
                f"{dname}", err.max().item(), kernel, plain, cost,
                library=library, peak_flops=peak, key=K6_KEY[route],
                record=False, k6_route=route, q_offset=off)
        del q, k, v, out, got, want, err, qt, kt, vt, mask
    torch.cuda.empty_cache()


def k6_cut_phase(dev, measure):
    """Phase 2's K6 in bf16 at the cut shapes of the MoE and hybrid
    families (``K6_CUT``),
    each held against ``flash_attention_plain(q_offset=)`` over slices of
    the query rows (all rows up to 512, else a middle and the last 512),
    within 2e-4 plus one bf16 step, then
    timed by ``measure`` over 5 calls and printed, not recorded. The
    library time is SDPA on flash or memory-efficient attention alone
    with K and V repeated to the q heads, causal from the top left at
    offset 0 and ``causal_lower_right`` where the rows are the keys'
    last."""
    from torch.nn.attention import SDPBackend, sdpa_kernel
    from torch.nn.attention.bias import causal_lower_right

    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_cost,
                                                     flash_attention_plain,
                                                     flash_attention_route)

    sdpa = torch.nn.functional.scaled_dot_product_attention
    backends = [SDPBackend.FLASH_ATTENTION, SDPBackend.EFFICIENT_ATTENTION]
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 50)
    for what, b, sq, skv, hq, hkv, d, dv, off, window in K6_CUT:
        check(off + sq == skv, f"K6 cut row {what}: rows end at {off + sq}")
        q, k, v = (torch.randn(shape, generator=gen, device=dev).to(
            torch.bfloat16) for shape in ((b, sq, hq, d), (b, skv, hkv, d),
                                          (b, skv, hkv, dv)))
        got = flash_attention(q, k, v, causal=True, window=window,
                              q_offset=off)
        slices = ([(0, sq)] if sq <= 512 else
                  [(sq // 2 - 256, sq // 2 + 256), (sq - 512, sq)])
        err = 0.0
        for r0, r1 in slices:
            want = flash_attention_plain(q[:, r0:r1], k, v, causal=True,
                                         window=window, q_offset=off + r0)
            e = (got[:, r0:r1].float() - want.float()).abs()
            check(bool((e <= 2e-4 + 2.0 ** -7 * want.float().abs()).all()),
                  f"flash_attention bf16 {what} rows {r0}:{r1}: max err "
                  f"{e.max().item()}")
            err = max(err, e.max().item())
        del got, want, e
        qt = q.transpose(1, 2).contiguous()
        kt, vt = (t.repeat_interleave(hq // hkv, dim=2).transpose(1, 2)
                  .contiguous() for t in (k, v))
        if window:
            i = off + torch.arange(sq, device=dev)[:, None]
            j = torch.arange(skv, device=dev)[None, :]
            mask = (i >= j) & (i - j < window)
        else:
            mask = causal_lower_right(sq, skv) if off else None

        def library():
            with sdpa_kernel(backends):
                if mask is not None:
                    return sdpa(qt, kt, vt, attn_mask=mask)
                return sdpa(qt, kt, vt, is_causal=True)

        r0 = slices[-1][0]
        route = flash_attention_route(q.dtype, d, dv, sq)
        cost = flash_attention_cost(q, k, v, causal=True, window=window,
                                    q_offset=off)
        measure("flash_attention", K6_SOURCE[route],
                "src/repro/kernels/flash_attention.py:102",
                f"{what} {b}x{sq}/{skv}x{hq}/{hkv}x{d}"
                f"{f'/{dv}' if dv != d else ''} causal"
                f"{f' window{window}' if window else ''} q_offset{off} "
                f"bfloat16", err,
                lambda: flash_attention(q, k, v, causal=True, window=window,
                                        q_offset=off),
                lambda: flash_attention_plain(q[:, r0:], k, v, causal=True,
                                              window=window,
                                              q_offset=off + r0),
                cost, library=library, peak_flops=PEAK_BF16_FLOPS, iters=5,
                key=K6_KEY[route], record=False, plain_rows=f"{r0}:{sq}",
                k6_route=route, q_offset=off)
        del q, k, v, qt, kt, vt, mask
        torch.cuda.empty_cache()


def k7_route(b, s, nh, hd, n, chunk, nbytes, bf16_x=False):
    """``measure``'s route fields for K7 at (B, S, nh, hd, d_state,
    chunk), one group: the products the kernel's route runs, w.x, the
    state increment and C_i . S_prev as 3xTF32, three TF32 products each
    (two for those with a bf16 x as an operand: x is exact in TF32) at
    the TF32 peak, and C.B^T once per (sequence, chunk) on the FP64
    tensor cores at theirs; bound by the larger of that and ``nbytes``
    over the memory rate."""
    tri = chunk * (chunk + 1) // 2
    nc = b * (s // chunk)
    f_cb = 2.0 * nc * tri * n
    f_wx = 2.0 * nc * nh * tri * hd
    f_state = f_cs = 2.0 * nc * nh * chunk * n * hd
    kx = 2 if bf16_x else 3
    route_flops = 3 * f_cs + kx * (f_wx + f_state)
    ops_ms = (route_flops / PEAK_TF32_FLOPS
              + f_cb / PEAK_FP64_TC_FLOPS) * 1e3
    bytes_ms = nbytes / PEAK_BYTES_S * 1e3
    return {"route_work": ("3xTF32 tensor cores"
                           + (", bf16 x" if bf16_x else "")
                           + "; C.B^T on the FP64 tensor cores"),
            "route_flops": route_flops, "route_fp64_flops": f_cb,
            "route_bound_ms": max(ops_ms, bytes_ms),
            "route_bound_by": ("operations" if ops_ms >= bytes_ms
                               else "bytes")}


def k7_served_phase(dev, measure):
    """Phase 2's K7 at the shapes the bf16 and train_4k cells give it
    (``K7_SERVED``, phase 28's prefill_32k: 128 chunks a sequence; phase
    31's train_4k: 16), in f32 as
    ``models/ssm.py`` passes it, against its plain version (chunked: its
    largest scratch, the (B, chunks, 256, 256, nh) decays, fits) at phase
    2's f32 tolerance, y and the final state, on two inputs: as a prefill
    from fresh caches passes them (dt in (0.1, 0.9) over a = -linspace(1,
    16, nh) as the model initialises it, a zero state), and with slow
    decays (dt in (0.001, 0.01)) from a seeded state, so that the state
    carried from chunk to chunk still counts several chunks later. The
    first is timed by ``measure`` over 5 calls; no one PyTorch call
    computes the scan, so there is no library time."""
    from repro_torch.kernels.ssd_scan import (ssd_scan, ssd_scan_cost,
                                              ssd_scan_plain)

    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 31)

    def rand(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    for what, b, s, nh, hd, n, chunk in K7_SERVED:
        x, bm, cm = rand(b, s, nh, hd), rand(b, s, 1, n), rand(b, s, 1, n)
        a = -torch.linspace(1.0, 16.0, nh, device=dev)
        errs, served = [], None
        for lo, hi, seeded in ((0.1, 0.9, False), (0.001, 0.01, True)):
            dt = torch.empty((b, s, nh), device=dev).uniform_(
                lo, hi, generator=gen)
            init = (rand(b, nh, hd, n) if seeded
                    else torch.zeros((b, nh, hd, n), device=dev))
            args = (x, dt, a, bm, cm)
            got = ssd_scan(*args, chunk=chunk, init_state=init,
                           return_final_state=True)
            want = ssd_scan_plain(*args, chunk, init)
            for g, w, part in zip(got, want, ("y", "final state")):
                e = (g - w).abs()
                check(bool((e <= 2e-5 + 2e-5 * w.abs()).all()),
                      f"ssd_scan {what} {b}x{s} nh {nh} n {n} "
                      f"{'slow, seeded' if seeded else 'zero state'}: "
                      f"max err {part} {e.max().item()}")
                errs.append(e.max().item())
            del got, want, e
            served = served or (args, init)
        args, init = served
        cost = ssd_scan_cost(*args, chunk, init)
        measure("ssd_scan", "ssd_scan.cu",
                "src/repro/kernels/ssd_scan.py:79",
                f"{what} {b}x{s} nh{nh} hd{hd} n{n} chunk{chunk} float32 "
                f"zero state", max(errs),
                lambda: ssd_scan(*args, chunk=chunk, init_state=init,
                                 return_final_state=True),
                lambda: ssd_scan_plain(*args, chunk, init), cost, iters=5,
                **k7_route(b, s, nh, hd, n, chunk, cost[1]))
        del x, bm, cm, dt, args, init, served
        torch.cuda.empty_cache()


# ---- 27. the dry-run against the card -----------------------------------

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


HERE = os.path.dirname(os.path.abspath(__file__))


def _cpu_env():
    # one thread each: a meta trace computes nothing
    return {**os.environ, "PYTHONPATH": os.path.join(HERE, "src"),
            "OMP_NUM_THREADS": "1"}


def _lowest_priority():
    os.nice(19)


class CpuWork:
    """The smoke's work that needs no card, started beside the card
    phases (each in a process of its own, all together, at the lowest
    CPU priority and one thread each, so that the phases timed on the
    host's clock beside them, 18, 19, 26 and 27, keep the cores they
    had) and read where a phase needs it: the dry-run's ``--all`` sweep
    over ``meshes`` on ``meta`` (27d), and the ``meta`` traces of phase
    28's and 31's cells (``meta_traces``). Every process it started is
    killed, and its directory removed, by ``close`` (registered at
    exit)."""

    def __init__(self, meshes=("single", "multi")):
        self.dir = tempfile.mkdtemp(prefix="chip_smoke_cpu_")
        self.meshes, self.t = meshes, time.perf_counter()
        low = dict(env=_cpu_env(), stdout=subprocess.PIPE,
                   stderr=subprocess.STDOUT, text=True,
                   preexec_fn=_lowest_priority)
        self.sweep = [subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--all",
             "--mesh", mesh, "--out", os.path.join(self.dir, mesh)], **low)
            for mesh in meshes]
        self.meta_path = os.path.join(self.dir, "meta.json")
        self.meta = subprocess.Popen(
            [sys.executable, "-c", "import chip_smoke as c; "
             f"c.meta_traces({self.meta_path!r})"], cwd=HERE, **low)
        atexit.register(self.close)

    def sweep_counts(self, timeout_s=900):
        """The sweep's (ok, skipped, failed, seconds since the start)."""
        logs = [p.communicate(timeout=timeout_s)[0] for p in self.sweep]
        return _sweep_counts(self.meshes, self.sweep, logs,
                             time.perf_counter() - self.t)

    def traces(self, timeout_s=900):
        """{cell key: its ``meta`` trace} (``meta_traces``)."""
        log = self.meta.communicate(timeout=timeout_s)[0]
        check(self.meta.returncode == 0,
              f"the meta traces failed:\n{log[-3000:]}")
        with open(self.meta_path) as f:
            return json.load(f)

    def close(self):
        for p in (*self.sweep, self.meta):
            if p.poll() is None:
                p.kill()
                p.wait()
        shutil.rmtree(self.dir, ignore_errors=True)


def cell_key(arch, shape_name, tcfg, attn="naive", extra=""):
    return f"{arch}|{shape_name}|{tcfg.param_dtype}|{attn}" + (
        f"|{extra}" if extra else "")


def meta_traces(path):
    """Trace each cell of phases 28 (``BF16_CELLS``), 31
    (``TRAIN_4K_ARCHS``, under the blockwise backward, and
    ``DOTS_ARCHS`` under the ``dots`` remat policy too), 34
    (``MLA_ROWS_CELLS`` on MLA_ROWS_MESH) and 35 (``WHOLE_CELLS`` on
    WHOLE_MESH) on ``meta`` as ``card_cell`` does, and write
    {``cell_key``: the trace} to ``path`` as JSON."""
    sys.path.insert(0, os.path.join(HERE, "src"))
    from repro_torch.configs.base import SHAPES, SINGLE_POD_MESH, MeshConfig
    from repro_torch.configs.registry import get_config
    from repro_torch.launch.dryrun import build_cell, trace, train_config
    from repro_torch.models import layers as L
    from repro_torch.models import transformer as T

    single, rows = SINGLE_POD_MESH, MeshConfig(*MLA_ROWS_MESH)
    rows_name = "x".join(map(str, rows.shape)) + ":" + ",".join(rows.axes)
    bf16 = _train_config(param_dtype="bfloat16")
    cells = [(a, s, bf16, "naive", single, "", "full") for a, s in BF16_CELLS]
    cells += [(a, "train_4k", train_config(), "blockwise", single, "",
               "full") for a in TRAIN_4K_ARCHS]
    cells += [(a, "train_4k", train_config(), "blockwise", single, "dots",
               "dots") for a in DOTS_ARCHS]
    cells += [("deepseek-v2-lite-16b", s, bf16, "naive", rows, rows_name,
               "full") for s in MLA_ROWS_CELLS]
    whole = MeshConfig(*WHOLE_MESH)
    whole_name = "x".join(map(str, whole.shape)) + ":" + ",".join(
        whole.axes)
    cells += [(WHOLE_ARCH, s, bf16, "naive", whole, whole_name, "full")
              for s in WHOLE_CELLS]
    out = {}
    for arch, shape_name, tcfg, attn, mesh, extra, policy in cells:
        with L.attention_impl(attn, TRAIN_4K_CHUNK), T.remat_policy(policy):
            fn, inputs, _ = build_cell(get_config(arch), SHAPES[shape_name],
                                       mesh, tcfg)
            out[cell_key(arch, shape_name, tcfg, attn, extra)] = trace(
                fn, inputs)
    with open(path, "w") as f:
        json.dump(out, f)


def _sweep_counts(meshes, procs, logs, wall):
    """(ok, skipped, failed, ``wall``) summed over the sweep's logs, each
    FAIL line printed."""
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


def card_cell(dev, arch, shape, mesh, mesh_name, tcfg, mem_tol, label,
              traced=False, meta=None):
    """One dry-run cell traced by ``roofline.count.OpCounter`` on ``meta``
    (``launch.dryrun.build_cell``, as the dry-run traces it) and then run
    on the card under the same counter, from SEED, in ``tcfg``'s dtype:
    (a) the FLOPs, bytes and each kernel's charges equal; (b) the
    predicted peak live bytes within ``mem_tol`` (relative) of the card's
    peak allocated over the run, less what was allocated beside the
    inputs; (c) one more run without the counter, its logits (a serving
    step's) finite, or a train step's ``train_step_checks``: its wall
    beside the roofline's compute, memory and bound and, for a serving
    step, tokens/s; (d) with ``traced``, a third run under the profiler
    for the card's busy share of that wall and each hand kernel's device
    ms in it. ``meta``: the ``meta`` trace, where it was taken beside
    (``CpuWork``).
    Prints a ``[<label>]`` line; returns (the kernels charged a run, the
    card runs made, the numbers printed)."""
    from repro_torch.configs.registry import get_config
    from repro_torch.launch.dryrun import build_cell, trace
    from repro_torch.launch.specs import local_shape
    from repro_torch.roofline.analysis import analyze

    cfg = get_config(arch)
    if meta is None:
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
    peak = torch.cuda.max_memory_allocated() - (base - card["input_bytes"])
    tag = f"{arch} {shape.name} {tcfg.param_dtype}"
    for key in ("flops", "bytes", "kernels"):
        check(meta[key] == card[key],
              f"cell {tag}: {key} on meta {meta[key]}, on the card "
              f"{card[key]}")
    pred = meta["peak_bytes"]
    mem_err = (pred - peak) / peak
    check(abs(mem_err) <= mem_tol,
          f"cell {tag}: predicted peak {pred} bytes, the card {peak} "
          f"({mem_err:+.4f}, over {mem_tol})")
    card_max = torch.cuda.max_memory_allocated()
    if shape.kind == "train":
        fn.step.keep_grads = True
    torch.cuda.synchronize()
    t = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t) * 1e3
    if shape.kind != "train":
        check(bool(torch.isfinite(out[0]).all()),
              f"cell {tag}: non-finite logits")
        nums = {}
    else:
        nums = train_step_checks(tag, out, inputs[0], fn.step, tcfg)
        fn.step.keep_grads, fn.step.last_grads = False, None
    del out
    runs = 2
    if traced:
        kernel_ms = {}
        _, dev_us = traced_device_us(fn, per_kernel=kernel_ms)
        runs += 1
        nums.update(device_ms=dev_us / 1e3,
                    device_share=dev_us / 1e3 / wall_ms,
                    kernel_device_ms=json.dumps(kernel_ms, sort_keys=True))
    del fn, inputs
    roof = analyze(arch, shape.name, mesh_name, mesh.num_devices, meta,
                   plan.collectives, cfg, shape, tcfg.param_dtype)
    bound_ms = max(roof.compute_s, roof.memory_s) * 1e3
    if shape.kind != "train":
        share = local_shape(shape, mesh)
        nums["tokens_per_s"] = (share.global_batch
                                * (share.seq_len if shape.kind == "prefill"
                                   else 1) / (wall_ms / 1e3))
    nums.update(predicted_peak_gb=pred / 1e9, card_peak_gb=peak / 1e9,
                wall_ms=wall_ms)
    phase(label, arch=arch, shape=shape.name, kind=shape.kind,
          dtype=tcfg.param_dtype, mesh=mesh_name, flops=meta["flops"],
          bytes=meta["bytes"],
          kernels=json.dumps(meta["kernels"], sort_keys=True),
          equal_on_meta_and_card=True,
          card_max_allocated_gb=card_max / 1e9,
          peak_err=mem_err, peak_tol=mem_tol,
          compute_ms=roof.compute_s * 1e3, memory_ms=roof.memory_s * 1e3,
          bound_ms=bound_ms, dominant=roof.dominant,
          bound_over_wall=bound_ms / wall_ms, **nums,
          hardware=json.dumps(roof.hardware))
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return ({name: k["calls"] for name, k in card["kernels"].items()}, runs,
            nums)


def train_step_checks(tag, out, params, step, tcfg):
    """A train cell's first step ``out`` = (loss, params, opt) from
    ``params`` and zero moments, run with ``step.keep_grads``: the loss
    and ``step.grad_norm`` finite, the norm that of ``step.last_grads``
    (the synced gradients before clipping) within 1e-4 (relative, here
    in float64), and the step against a plain AdamW step on those
    gradients, clipped to ``tcfg.grad_clip``: m and v within 1e-6 of
    (1 - beta) g and g^2 (of their largest |value|), and each parameter
    within one step of its dtype (plus 1e-6 of its update) of ``p - lr
    (g / (|g| + eps) + wd p)``, the first step's ``m^ / (sqrt(v^) +
    eps)`` (decay on matrices only), with some parameter moved. Under ZeRO-1 on a plan
    only this rank's cut of a leaf is updated (the first ``m.shape[d]``
    along the dim its moment ``m`` is cut on); the rest stands for what
    the broadcasts would have sent, so only that cut is compared.
    Returns the loss, the norm, the leaves moved and the share of
    elements moved beside the plain step's."""
    from repro_torch._tree import tree_leaves
    from repro_torch.train.optimizer import lr_schedule
    loss, new_params, new_opt = out
    norm = float(step.grad_norm)
    check(math.isfinite(float(loss)), f"cell {tag}: loss {float(loss)}")
    check(math.isfinite(norm), f"cell {tag}: gradient norm {norm}")
    check(int(new_opt.step) == 1, f"cell {tag}: step {int(new_opt.step)}")
    grads = tree_leaves(step.last_grads)
    plain_norm = math.sqrt(sum(float(g.double().square().sum())
                               for g in grads))
    check(abs(norm - plain_norm) <= 1e-4 * plain_norm,
          f"cell {tag}: gradient norm {norm}, plain {plain_norm}")
    # the clip's factor as the step computes it, in f32 on the card
    scale = torch.clamp(tcfg.grad_clip / (step.grad_norm + 1e-9), max=1.0)
    lr = float(lr_schedule(tcfg)(torch.ones((), dtype=torch.int32)))
    b1, b2 = tcfg.beta1, tcfg.beta2
    moved = n_el = n_moved = n_plain_moved = 0
    leaves = tree_leaves(params)
    for p0, p1, m, v, g in zip(leaves, tree_leaves(new_params),
                               tree_leaves(new_opt.m),
                               tree_leaves(new_opt.v), grads):
        if p0.numel() == 0:     # an SSM arch's empty MLP, as the reference's
            continue
        for d, (n, cut) in enumerate(zip(p0.shape, m.shape)):
            if n != cut:
                p0, p1, g = (t.narrow(d, 0, cut) for t in (p0, p1, g))
        g = (g * scale).to(g.dtype).float()
        for got, want, what in ((m, (1 - b1) * g, "m"),
                                (v, (1 - b2) * g.square(), "v")):
            e = float((got - want).abs().max())
            check(e <= 1e-6 * float(want.abs().max()),
                  f"cell {tag}: {what} {e} off the plain step's")
        w = p0.float()
        upd = g / (g.abs() + tcfg.eps)
        if p0.ndim >= 2:
            upd = upd + tcfg.weight_decay * w
        plain = (w - lr * upd).to(p0.dtype)
        # one step of the dtype at the value, and 1e-6 of the update
        # for the step's other f32 rounding of m^ and sqrt(v^)
        e = (p1.float() - plain.float()).abs()
        tol = torch.finfo(p0.dtype).eps * torch.maximum(
            plain.float().abs(), p1.float().abs()) + 1e-6 * lr * upd.abs()
        check(bool((e <= tol).all()),
              f"cell {tag}: a parameter {float(e.max())} off the plain "
              f"AdamW step's")
        moved += not torch.equal(p0, p1)
        n_el += p0.numel()
        n_moved += int((p0 != p1).sum())
        n_plain_moved += int((p0 != plain).sum())
    check(moved > 0, f"cell {tag}: no parameter moved")
    return {"loss": float(loss), "grad_norm": norm, "lr": lr,
            "leaves_moved": f"{moved}/{len(leaves)}",
            "elements_moved": n_moved / n_el,
            "plain_elements_moved": n_plain_moved / n_el}


def dryrun_phase(dev, cpu, mem_tol=None):
    """27. Each of ``dryrun_cells`` in f32 on one device through
    ``card_cell`` (meta against the card, the peak, the wall against the
    roofline); then the dry-run's sweep, ``--all`` over the single and
    multi-pod meshes on ``meta``, with 0 failed (``cpu``'s, the
    ``CpuWork`` started beside the earlier phases). Returns each
    kernel's launches the card runs should have made."""
    from repro_torch.configs.base import MeshConfig

    mem_tol = DRYRUN_MEM_TOL if mem_tol is None else mem_tol
    mesh = MeshConfig((1,), ("data",))
    tcfg = _train_config(param_dtype="float32")
    launched = {}
    for arch, shape in dryrun_cells():
        charged, runs, _ = card_cell(dev, arch, shape, mesh, "1:data",
                                     tcfg, mem_tol, "dryrun cell")
        for name, n in charged.items():
            launched[name] = launched.get(name, 0) + runs * n
    n_ok, n_skip, n_fail, wall = cpu.sweep_counts()
    phase("dryrun sweep", meshes="single,multi", processes=2, ok=n_ok,
          skipped=n_skip, failed=n_fail, wall_s=wall)
    check(n_fail == 0, f"the dry-run sweep failed {n_fail} cells")
    return launched


# ---- 28. the reference's bf16 cells ---------------------------------------

#: one device's share of the single-pod mesh (16, 16) of every serving
#: cell the card holds: the 9 archs whose share fits, at prefill_32k (2
#: sequences of 32768 tokens) and decode_32k (8 sequences, the step at
#: slot 32767), and the SSM and hybrid archs at long_500k (1 sequence,
#: slot 524287). Every arch's share is cut over the model axis as the
#: reference cuts it (qwen1.5-32b's 17.24 and 26.63 GB on meta, 176.90 and
#: 424.81 with the axis replicated; phi3.5-moe-42b's 11.69 and 7.59,
#: 103.84 and 120.33 replicated; seamless-m4t-large-v2's 2.96 and 3.34,
#: 44.30 and 33.87).
BF16_ARCHS = ("tinyllama-1.1b", "qwen2.5-3b", "qwen3-4b", "qwen2-vl-7b",
              "qwen1.5-32b", "mamba2-370m", "hymba-1.5b",
              "deepseek-v2-lite-16b", "seamless-m4t-large-v2",
              "phi3.5-moe-42b")
#: phase 29's archs, each whole on the card in f32 beside bf16: not
#: qwen1.5-32b or phi3.5-moe-42b, whose f32 weights alone are 130 and
#: 168 GB
BF16_SERVE_ARCHS = tuple(a for a in BF16_ARCHS
                         if a not in ("qwen1.5-32b", "phi3.5-moe-42b"))
BF16_CELLS = tuple((a, s) for s in ("prefill_32k", "decode_32k")
                   for a in BF16_ARCHS) + (("mamba2-370m", "long_500k"),
                                           ("hymba-1.5b", "long_500k"))


def bf16_cells_phase(dev, traces=None):
    """28. Each of ``BF16_CELLS`` (arch, shape name in ``SHAPES``) as one
    device's share of the single-pod mesh, in bf16 (the dtype in which
    the reference's dry-run sizes it), through ``card_cell`` with the
    traced run: meta against the card, the peak, the wall against the
    roofline, tokens/s and the device share. Decode cells step at their
    slot over caches of seeded values. ``traces``: the cells' ``meta``
    traces by ``cell_key`` (``CpuWork.traces``). Returns each kernel's
    launches the card runs should have made."""
    from repro_torch.configs.base import SHAPES, SINGLE_POD_MESH

    tcfg = _train_config(param_dtype="bfloat16")
    launched = {}
    t = time.perf_counter()
    for arch, shape_name in BF16_CELLS:
        charged, runs, _ = card_cell(
            dev, arch, SHAPES[shape_name], SINGLE_POD_MESH, "single", tcfg,
            DRYRUN_MEM_TOL, "bf16 cell", traced=True,
            meta=(traces or {}).get(cell_key(arch, shape_name, tcfg)))
        for name, n in charged.items():
            launched[name] = launched.get(name, 0) + runs * n
    phase("bf16 cells", cells=len(BF16_CELLS),
          seconds=time.perf_counter() - t)
    return launched


# ---- 31. the reference's train_4k cells, under the blockwise backward ----

#: the train_4k cells one card trains: one device's share of the
#: single-pod mesh (16 x 4096 tokens), under the blockwise backward at
#: TRAIN_4K_CHUNK, every arch's share cut over the model axis (PERF.md
#: gives each meta peak; seamless-m4t-large-v2's needed 281.00 GB with
#: the axis replicated)
TRAIN_4K_ARCHS = ("mamba2-370m", "hymba-1.5b", "tinyllama-1.1b",
                  "qwen2.5-3b", "qwen3-4b", "qwen2-vl-7b", "qwen1.5-32b",
                  "phi3.5-moe-42b", "deepseek-v2-lite-16b",
                  "seamless-m4t-large-v2")
#: keys a chunk of K6's blockwise backward: the reference's 2048 leaves
#: tinyllama's share at 92.18 GB on meta, over the card's 80 GB
TRAIN_4K_CHUNK = 1024
#: K6 and K7 calls a step: the forward and the remat recompute, each
#: once per attention or SSM layer (seamless's encoder, decoder self- and
#: cross-attention: 72)
TRAIN_4K_LAUNCHES = {"mamba2-370m": {"ssd_scan": 96},
                     "hymba-1.5b": {"flash_attention": 64, "ssd_scan": 64},
                     "tinyllama-1.1b": {"flash_attention": 44},
                     "qwen2.5-3b": {"flash_attention": 72},
                     "qwen3-4b": {"flash_attention": 72},
                     "qwen2-vl-7b": {"flash_attention": 56},
                     "qwen1.5-32b": {"flash_attention": 128},
                     "phi3.5-moe-42b": {"flash_attention": 64},
                     "deepseek-v2-lite-16b": {"flash_attention": 54},
                     "seamless-m4t-large-v2": {"flash_attention": 144}}
#: the cells whose step runs a third time under the profiler, to keep the
#: smoke in its limit: an SSM, a dense and the enc-dec share
TRAIN_4K_TRACED = frozenset({"mamba2-370m", "tinyllama-1.1b",
                             "seamless-m4t-large-v2"})
#: the blockwise backward against the plain one: tinyllama's layers, and
#: the batch and length of the check
BLOCKWISE_CHECK = (2, 2, 4096)


def _leaf_names(tree, prefix=""):
    """The '/'-joined key path of each leaf of a dict pytree, in
    ``tree_leaves``' order (sorted keys)."""
    if isinstance(tree, dict):
        return [n for k in sorted(tree)
                for n in _leaf_names(tree[k], f"{prefix}{k}/")]
    return [prefix[:-1]]


def blockwise_check_phase(dev, layers=BLOCKWISE_CHECK[0],
                          batch=BLOCKWISE_CHECK[1], seq=BLOCKWISE_CHECK[2],
                          chunk=TRAIN_4K_CHUNK):
    """31 (a). tinyllama-1.1b cut to ``layers`` layers, ``batch`` x
    ``seq`` tokens of phase 18's pipeline, remat, one bf16 draw from SEED
    and its values in f32: the loss and its gradients under ``"naive"``
    (K6's backward over whole scores) and under ``"blockwise"`` at
    ``chunk`` keys. f32: the loss within 1e-5 (relative) and each
    gradient leaf within 2e-5 of its largest |value|
    (``tests/test_torch_train.py``'s). bf16: the loss as f32's, each leaf
    within one bf16 step of its largest |value| or, where more, the
    naive bf16 leaf's own distance from the f32 one (the whole step runs
    in bf16, and the scan rounds P to bf16 before PV as the reference
    does: on the H100 the attention and embedding leaves sit up to 1.5
    steps off, inside the naive leaves' 1.8-4.1 steps from f32's, so one
    step alone does not hold at this depth); each leaf's error over one
    bf16 step and the naive bf16 leaf's distance from f32's over it are
    printed by leaf. Prints each
    run's wall (loss and gradients, synchronised; the first also takes
    the warm-up of a cold process)."""
    import dataclasses
    from repro_torch._tree import tree_leaves, tree_map
    from repro_torch.configs.registry import get_config
    from repro_torch.models import init_params
    from repro_torch.models import layers as L
    from repro_torch.models.transformer import loss_fn

    cfg = dataclasses.replace(get_config("tinyllama-1.1b"),
                              num_layers=layers)
    data = _train_data(cfg, dev, batch, seq)
    p16 = init_params(cfg, SEED, torch.bfloat16, dev)
    p32 = tree_map(lambda t: t.float(), p16)
    names = _leaf_names(p16)
    got, ms = {}, {}
    for name, params in (("f32", p32), ("bf16", p16)):
        leaves = [t.requires_grad_() for t in tree_leaves(params)]
        for impl in ("naive", "blockwise"):
            with L.attention_impl(impl, chunk):
                _sync(dev)
                t = time.perf_counter()
                loss = loss_fn(params, cfg, data, remat=True)
                grads = torch.autograd.grad(loss, leaves)
                _sync(dev)
            ms[name, impl] = (time.perf_counter() - t) * 1e3
            got[name, impl] = (float(loss.detach()), grads)
    del p16, p32
    for name in ("f32", "bf16"):
        (l0, g0), (l1, g1) = got[name, "naive"], got[name, "blockwise"]
        check(math.isfinite(l0) and abs(l1 - l0) <= 1e-5 * abs(l0),
              f"blockwise check {name}: loss {l1} against {l0}")
        worst, by_step, drift_by_step = 0.0, {}, {}
        for leaf, a, b, f in zip(names, g1, g0, got["f32", "naive"][1]):
            top = float(b.abs().max())
            tol = 2e-5 * top
            err = float((a.float() - b.float()).abs().max())
            if name == "bf16":
                step = 2.0 ** (math.floor(math.log2(top)) - 7)
                drift = float((b.float() - f).abs().max())
                tol = max(step, drift)
                by_step[leaf] = err / step
                drift_by_step[leaf] = drift / step
            check(math.isfinite(err) and err <= tol,
                  f"blockwise check {name}: {leaf}'s gradient {err} off, "
                  f"over {tol}")
            worst = max(worst, err / tol)
        nums = {}
        if name == "bf16":
            nums = dict(worst_grad_err_over_step=max(by_step.values()),
                        grad_err_over_step=json.dumps(by_step),
                        naive_drift_over_step=json.dumps(drift_by_step))
        phase("train 4k blockwise check", dtype=name, layers=layers,
              batch=batch, seq=seq, chunk=chunk, loss=l0,
              loss_blockwise=l1, worst_grad_err_over_tol=worst,
              leaves=len(g0), naive_ms=ms[name, "naive"],
              blockwise_ms=ms[name, "blockwise"], **nums)
    del got
    torch.cuda.empty_cache()


def train_4k_phase(dev, traces=None):
    """31 (b). Each of ``TRAIN_4K_ARCHS`` at ``train_4k`` as one device's
    share of the single-pod mesh, in bf16 with the dry-run's
    ``TrainConfig``, under ``set_attention_impl("blockwise",
    TRAIN_4K_CHUNK)`` (restored after), through ``card_cell``: meta
    against the card, the peak, the wall against the roofline, the
    device share, and the step's loss, gradient norm and moved
    parameters; each kernel's calls a step as ``TRAIN_4K_LAUNCHES``
    says; ``traces`` as ``bf16_cells_phase`` takes them. Returns each
    kernel's launches the card runs should have made, and each cell's
    numbers (``card_cell``'s) by arch."""
    from repro_torch.configs.base import SHAPES, SINGLE_POD_MESH
    from repro_torch.launch.dryrun import train_config
    from repro_torch.models import layers as L

    tcfg = train_config()
    launched, cells = {}, {}
    t = time.perf_counter()
    with L.attention_impl("blockwise", TRAIN_4K_CHUNK):
        for arch in TRAIN_4K_ARCHS:
            charged, runs, cells[arch] = card_cell(
                dev, arch, SHAPES["train_4k"], SINGLE_POD_MESH, "single",
                tcfg, DRYRUN_MEM_TOL, "train 4k cell",
                traced=arch in TRAIN_4K_TRACED,
                meta=(traces or {}).get(cell_key(arch, "train_4k", tcfg,
                                                 "blockwise")))
            want = {k: TRAIN_4K_LAUNCHES[arch].get(k, 0)
                    for k in ("flash_attention", "ssd_scan")}
            got = {k: charged.get(k, 0) for k in want}
            check(got == want, f"train_4k {arch}: kernel calls a step "
                               f"{got}, want {want}")
            for name, n in charged.items():
                launched[name] = launched.get(name, 0) + runs * n
    phase("train 4k cells", cells=len(TRAIN_4K_ARCHS),
          attn=f"blockwise/{TRAIN_4K_CHUNK}",
          chunk_cut="2048->1024 (tinyllama's share 92.18 GB on meta at "
                    "2048)", seconds=time.perf_counter() - t)
    return launched, cells


#: 31 (c): the train_4k shares run again under the reference's
#: ``--remat-policy dots``: an attention share (K6) and an SSM share (K7)
DOTS_ARCHS = ("tinyllama-1.1b", "mamba2-370m")


def train_4k_dots_phase(dev, full, traces=None):
    """31 (c). Each of ``DOTS_ARCHS``' ``train_4k`` share as 31 (b) runs
    it, under ``remat_policy("dots")`` (restored after): selective
    checkpointing that keeps the outputs of the products without batch
    dims from the forward. Through ``card_cell``: meta against the card
    (its peak within DRYRUN_MEM_TOL, the kept outputs held from the
    forward to the backward), each kernel's calls a step as
    ``TRAIN_4K_LAUNCHES`` says for ``full`` (K6 and K7 are recomputed:
    ctypes launches the policy never sees), and the loss and gradient
    norm within GRAD_SYNC_TOL (relative) of the ``full`` step's in
    ``full`` (31 (b)'s numbers by arch), printed beside them with both
    walls and peaks. Returns each kernel's launches the card runs should
    have made."""
    from repro_torch.configs.base import SHAPES, SINGLE_POD_MESH
    from repro_torch.launch.dryrun import train_config
    from repro_torch.models import layers as L
    from repro_torch.models import transformer as T

    tcfg = train_config()
    launched = {}
    with L.attention_impl("blockwise", TRAIN_4K_CHUNK), \
            T.remat_policy("dots"):
        for arch in DOTS_ARCHS:
            charged, runs, nums = card_cell(
                dev, arch, SHAPES["train_4k"], SINGLE_POD_MESH, "single",
                tcfg, DRYRUN_MEM_TOL, "train 4k dots cell", traced=True,
                meta=(traces or {}).get(cell_key(arch, "train_4k", tcfg,
                                                 "blockwise", "dots")))
            want = {k: TRAIN_4K_LAUNCHES[arch].get(k, 0)
                    for k in ("flash_attention", "ssd_scan")}
            got = {k: charged.get(k, 0) for k in want}
            check(got == want, f"train_4k dots {arch}: kernel calls a "
                               f"step {got}, want {want} (as under full)")
            ref = full[arch]
            for key in ("loss", "grad_norm"):
                _near(nums[key], ref[key], f"train_4k dots {arch} {key}",
                      GRAD_SYNC_TOL)
            phase("train 4k dots", arch=arch, policy="dots",
                  loss=nums["loss"], full_loss=ref["loss"],
                  grad_norm=nums["grad_norm"],
                  full_grad_norm=ref["grad_norm"], wall_ms=nums["wall_ms"],
                  full_wall_ms=ref["wall_ms"],
                  device_ms=nums["device_ms"],
                  full_device_ms=ref.get("device_ms", "not traced"),
                  predicted_peak_gb=nums["predicted_peak_gb"],
                  card_peak_gb=nums["card_peak_gb"],
                  full_card_peak_gb=ref["card_peak_gb"])
            for name, n in charged.items():
                launched[name] = launched.get(name, 0) + runs * n
    return launched


#: the reference's custom mesh whose model axis MLA's heads do not divide
#: (``repro/launch/dryrun.py --mesh 8x32:data,model``): deepseek's 16
#: heads over 32 model ranks run by rows, the last rank's share 1024 of
#: a 32768-token sequence's rows at offset 31744
MLA_ROWS_MESH = ((8, 32), ("data", "model"))
MLA_ROWS_CELLS = ("prefill_32k", "decode_32k")


def mla_rows_phase(dev, traces=None):
    """34. deepseek-v2-lite-16b's ``prefill_32k`` and ``decode_32k`` as
    one device's share of MLA_ROWS_MESH, in bf16, through ``card_cell``
    (meta against the card, the peak, the wall against the roofline):
    MLA by rows, the last model rank's 1024 rows of q (its 96 columns of
    ``wq``, half a head, all-to-all into whole rows) against K and V
    gathered whole; the prefill's K6 calls (one an MLA layer) all on
    ``wgmma`` at 192/128 and offset 31744, the decode's none (it scores
    the cut latent cache where it lies). Returns each kernel's launches
    the card runs should have made."""
    from repro_torch.configs.base import SHAPES, MeshConfig
    from repro_torch.configs.registry import get_config

    cfg = get_config("deepseek-v2-lite-16b")
    mesh = MeshConfig(*MLA_ROWS_MESH)
    name = "x".join(map(str, mesh.shape)) + ":" + ",".join(mesh.axes)
    tcfg = _train_config(param_dtype="bfloat16")
    n = mesh.shape[mesh.axes.index("model")]
    launched = {}
    for shape_name in MLA_ROWS_CELLS:
        shape = SHAPES[shape_name]
        offsets, undo = _k6_logged()
        try:
            charged, runs, nums = card_cell(
                dev, cfg.name, shape, mesh, name, tcfg, DRYRUN_MEM_TOL,
                "mla rows cell", traced=True,
                meta=(traces or {}).get(cell_key(cfg.name, shape_name, tcfg,
                                                 "naive", name)))
        finally:
            undo()
        rows = shape.seq_len // n
        want = ({("wgmma", (n - 1) * rows)} if shape.kind == "prefill"
                else set())
        calls = charged.get("flash_attention", 0)
        check(set(offsets) == want and calls == (
            cfg.num_layers if shape.kind == "prefill" else 0),
              f"mla rows {shape_name}: K6 {calls} calls a run at "
              f"{sorted(set(offsets))}, want {want}")
        phase("mla rows", arch=cfg.name, shape=shape_name, mesh=name,
              attention=("rows" if shape.kind == "prefill" else
                         "every head, the cut latent cache scored where "
                         "it lies"), q_rows=rows, k6_calls=calls,
              k6=json.dumps(sorted(set(offsets))),
              predicted_peak_gb=nums["predicted_peak_gb"],
              card_peak_gb=nums["card_peak_gb"], wall_ms=nums["wall_ms"])
        for key, c in charged.items():
            launched[key] = launched.get(key, 0) + runs * c
    return launched


WHOLE_MESH = ((2, 128), ("data", "model"))
WHOLE_ARCH = "hymba-1.5b"
WHOLE_CELLS = ("prefill_32k", "decode_32k", "long_500k")


def _whole_logged():
    """Every K6 launch logged as (route, q rows, window, query offset),
    and every K7 call's head count: (the K6 log, the K7 log, undo)."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import ssm as ssm_mod
    launch, scan, k6, k7 = fa._launch, ssm_mod.ssd_scan, [], []

    def logged(route, *args):
        k6.append((route, int(args[0].shape[1]), int(args[5]),
                   int(args[7]) if len(args) > 7 else 0))
        return launch(route, *args)

    def scanned(xh, *args, **kw):
        k7.append(int(xh.shape[2]))
        return scan(xh, *args, **kw)

    fa._launch, ssm_mod.ssd_scan = logged, scanned

    def undo():
        fa._launch, ssm_mod.ssd_scan = launch, scan
    return k6, k7, undo


def whole_leaves_phase(dev, traces=None):
    """35. hymba-1.5b as one device's share of WHOLE_MESH in bf16, the one
    registry arch whose share on a power-of-two model axis holds some
    leaves whole beside cut ones: its attention's ``wq``, ``wk``, ``wv``
    and ``wo`` (25 x 64 and 5 x 64 columns) and the SSM's ``in_proj`` and
    ``conv_w`` whole on every rank, the MLP, ``out_proj`` and the vocab
    cut over 128. Each of WHOLE_CELLS is traced on ``meta`` first and
    its predicted peak printed; a cell whose peak fits the card (within
    DRYRUN_MEM_TOL) runs through ``card_cell`` (meta against the card,
    the peak, the wall against the roofline), the rest are printed as
    meta-only records. A prefill: K6 32 calls a run, all on ``wgmma`` at
    the last rank's 256 rows and offset 32512 (every head, by rows, q
    projected through the whole ``wq`` on those rows alone), 29 of them
    windowed at 1024; K7 32 calls, each over all 50 SSM heads. A decode:
    finite logits and neither kernel (the whole cache scored plainly).
    Returns each kernel's launches the card runs should have made."""
    from repro_torch.configs.base import SHAPES, MeshConfig
    from repro_torch.configs.registry import get_config
    from repro_torch.launch.dryrun import build_cell, trace
    from repro_torch.models import sharding
    from repro_torch.models.transformer import layer_windows

    cfg = get_config(WHOLE_ARCH)
    mesh = MeshConfig(*WHOLE_MESH)
    name = "x".join(map(str, mesh.shape)) + ":" + ",".join(mesh.axes)
    tcfg = _train_config(param_dtype="bfloat16")
    n = mesh.shape[mesh.axes.index("model")]
    whole = sharding.whole_leaves(cfg, n)
    check(any(p.endswith("attn/wq") for p in whole)
          and not any(p.endswith("mlp/w_up") for p in whole),
          f"whole leaves {cfg.name} at {n}: {whole}")
    card_bytes = torch.cuda.get_device_properties(dev).total_memory
    launched = {}
    ran = []
    for shape_name in WHOLE_CELLS:
        shape = SHAPES[shape_name]
        meta = (traces or {}).get(cell_key(cfg.name, shape_name, tcfg,
                                           "naive", name))
        if meta is None:
            fn, inputs, _ = build_cell(cfg, shape, mesh, tcfg)
            meta = trace(fn, inputs)
            del fn, inputs
        pred = meta["peak_bytes"]
        fits = pred * (1 + DRYRUN_MEM_TOL) <= card_bytes
        phase("whole leaves meta", arch=cfg.name, shape=shape_name,
              mesh=name, predicted_peak_gb=pred / 1e9,
              card_gb=card_bytes / 1e9, runs_on_the_card=fits,
              whole_leaves=json.dumps(list(whole)), flops=meta["flops"],
              bytes=meta["bytes"],
              kernels=json.dumps(meta["kernels"], sort_keys=True))
        if not fits:
            continue
        k6, k7, undo = _whole_logged()
        try:
            charged, runs, nums = card_cell(
                dev, cfg.name, shape, mesh, name, tcfg, DRYRUN_MEM_TOL,
                "whole leaves cell", traced=True, meta=meta)
        finally:
            undo()
        ran.append(shape_name)
        rows = shape.seq_len // n
        calls = charged.get("flash_attention", 0)
        scans = charged.get("ssd_scan", 0)
        if shape.kind == "prefill":
            windows = [w for _, _, w, _ in k6[:calls]]
            check(set(k6) <= {("wgmma", rows, w, (n - 1) * rows)
                              for w in (0, cfg.sliding_window)}
                  and calls == cfg.num_layers
                  and windows.count(cfg.sliding_window) == sum(
                      1 for w in layer_windows(cfg, cfg.num_layers) if w)
                  and scans == cfg.num_layers
                  and set(k7) == {cfg.ssm.n_heads(cfg.d_model)},
                  f"whole leaves {shape_name}: K6 {calls} calls a run at "
                  f"{sorted(set(k6))}, K7 {scans} over {sorted(set(k7))} "
                  f"heads")
        else:
            check(calls == 0 and scans == 0,
                  f"whole leaves {shape_name}: K6 {calls}, K7 {scans} "
                  f"calls in a decode")
        phase("whole leaves", arch=cfg.name, shape=shape_name, mesh=name,
              attention=("rows, every projection whole"
                         if shape.kind == "prefill" else
                         "every head over the whole cache"),
              q_rows=rows if shape.kind == "prefill" else 1,
              k6_calls=calls, k6=json.dumps(sorted(set(k6))),
              k7_calls=scans, k7_heads=json.dumps(sorted(set(k7))),
              predicted_peak_gb=nums["predicted_peak_gb"],
              card_peak_gb=nums["card_peak_gb"], wall_ms=nums["wall_ms"],
              tokens_per_s=nums["tokens_per_s"])
        for key, c in charged.items():
            launched[key] = launched.get(key, 0) + runs * c
    check("prefill_32k" in ran or "long_500k" in ran,
          f"whole leaves: no hymba cell ran on the card ({ran})")
    return launched


# ---- 32. the model axis: four gloo ranks of a (1, 4) mesh ----------------

TP_RANKS = 4
#: phase 32's models, each at two layers (an enc-dec's encoder too) with
#: its FFN (where it has one) and vocab narrowed: qwen2.5-3b's attention
#: (16 q heads over 2 KV heads of 128, d_model 2048: sequence-parallel at
#: a model axis of 4); deepseek-v2-lite-16b's MLA (16 heads of 192/128
#: over a 512-wide latent: head-parallel) with its dense layer 0 and one
#: MoE layer of 64 experts top-6 and 2 shared (16 experts a rank), at the
#: config's capacity factor; seamless-m4t-large-v2's encoder and decoder
#: (16 heads of 64: 4 a rank, the cross-attention too); mamba2-370m's
#: mixer (32 heads of 64: a head-parallel scan, 8 a rank); hymba-1.5b's
#: hybrid heads (25 q over 5 KV heads of 64 by rows; 50 SSM heads, every
#: rank scanning all, over its whole 6482-column in_proj)
TP_MODEL = dict(num_layers=2, d_ff=2048, vocab_size=4096)
TP_ARCHS = ("qwen2.5-3b", "deepseek-v2-lite-16b", "seamless-m4t-large-v2",
            "mamba2-370m", "hymba-1.5b")
#: sequences and tokens: 100 q rows a rank, at offsets 0, 100, 200, 300;
#: the scanning models take 512 (two chunks of 256), 128 rows a rank
TP_BATCH, TP_SEQ, TP_SCAN_SEQ = 2, 400, 512
#: the (2, 2) data x model MoE step: deepseek's narrow model at capacity
#: factor 1, so that the global batch's routing drops assignments
TP_MOE_CAPACITY = 1.0
#: a rank's gradient leaf against the unsharded run's: max |difference|
#: over the whole leaf's largest |value| (tests/test_torch_train.py's)
TP_GRAD_TOL = 2e-5


def _tp_cfg(arch="qwen2.5-3b", moe=True):
    """Phase 32's narrow ``arch``; deepseek's with ``moe=False`` is its MLA
    over a dense FFN (phase 30's cut decode)."""
    import dataclasses

    from repro_torch.configs.base import MoEConfig
    from repro_torch.configs.registry import get_config
    base = get_config(arch)
    narrow = dict(TP_MODEL, d_ff=TP_MODEL["d_ff"] if base.d_ff else 0)
    if base.enc_dec:
        narrow["encoder_layers"] = TP_MODEL["num_layers"]
    cfg = dataclasses.replace(base, name=f"{arch}-narrow", **narrow)
    if cfg.moe.enabled:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, dense_d_ff=TP_MODEL["d_ff"]))
        if not moe:
            cfg = dataclasses.replace(cfg, name=f"{arch}-mla-narrow",
                                      family="dense", moe=MoEConfig())
    return cfg


def _tp_moe_cfg():
    """The (2, 2) MoE step's model: deepseek's narrow one at
    ``TP_MOE_CAPACITY``."""
    import dataclasses
    cfg = _tp_cfg("deepseek-v2-lite-16b")
    return dataclasses.replace(cfg, name=f"{cfg.name}-cf1",
                               moe=dataclasses.replace(
                                   cfg.moe,
                                   capacity_factor=TP_MOE_CAPACITY))


def _tp_data(cfg, dev):
    """Phase 32's batch of ``cfg``: phase 18's TP_BATCH sequences of
    TP_SEQ tokens (TP_SCAN_SEQ where the model scans), and for an
    enc-dec model N(0, 1) frames from SEED, a quarter as many."""
    seq = TP_SCAN_SEQ if cfg.ssm.enabled else TP_SEQ
    data = _train_data(cfg, dev, TP_BATCH, seq)
    if cfg.enc_dec:
        gen = torch.Generator().manual_seed(SEED + 60)
        data["enc_embeds"] = torch.randn(
            (TP_BATCH, seq // cfg.encoder_seq_ratio, cfg.d_model),
            generator=gen).to(dev)
    return data


def _tp_attention(cfg):
    """How a phase 32 model's attention runs over TP_RANKS: "none" (an
    SSM), "heads" (they divide the axis, or MLA) or "rows"."""
    from repro_torch.models.sharding import attention_seq_mode
    if cfg.family == "ssm":
        return "none"
    if cfg.mla.enabled or not attention_seq_mode(
            cfg.num_heads, cfg.num_kv_heads, TP_RANKS):
        return "heads"
    return "rows"


def _tp_k6_want(cfg, rank):
    """The (route, query offset) set of a rank's K6 launches: none for an
    SSM, offset 0 by heads, else the rank's rows of phase 32's
    sequence."""
    mode = _tp_attention(cfg)
    if mode == "none":
        return set()
    rows = (TP_SCAN_SEQ if cfg.ssm.enabled else TP_SEQ) // TP_RANKS
    return {("wgmma_tf32", rank * rows if mode == "rows" else 0)}


def _k6_logged():
    """Every K6 launch logged as (route, query offset): (the log, undo)."""
    from repro_torch.kernels import flash_attention as fa
    launch, offsets = fa._launch, []

    def logged(route, *args):
        offsets.append((route, int(args[7]) if len(args) > 7 else 0))
        return launch(route, *args)

    fa._launch = logged
    return offsets, lambda: setattr(fa, "_launch", launch)


def _tp_arch_share(arch, rank, n, dev, mesh, ref_path):
    """One rank's share of ``arch``'s narrow model over a (1, ``n``)
    mesh: its f32 weights from SEED, this rank's cut (a leaf the axis
    does not divide whole), phase 18's batch; the forward's logits (its
    vocab cut, or the whole vocab) and one ``make_train_step(mesh)``
    step under sequence parallelism with ``step.keep_grads``, each
    against the unsharded run saved at ``ref_path``: the logits' max
    error over their largest |value|, the loss, the gradient norm and
    each gradient leaf's error (``_tp_grad_errs``); every K6 launch's
    route and query offset, and K7's launches."""
    from repro_torch.kernels.ssd_scan import ssd_scan
    from repro_torch.models import init_params, sharding
    from repro_torch.models.transformer import forward
    from repro_torch.train import init_adam
    from repro_torch.train.train_step import make_train_step
    ref = torch.load(ref_path)
    cfg = _tp_cfg(arch)
    _, specs = sharding.whole_specs(cfg, n)
    cut = sharding.shard_tree(init_params(cfg, SEED, device=dev), specs,
                              rank, n)
    data = _tp_data(cfg, dev)
    offsets, undo = _k6_logged()
    k7_before = ssd_scan.launches
    out = {"whole": list(sharding.whole_leaves(cfg, n))}
    try:
        tp = sharding.tensor_parallel(cfg, mesh, True)
        _sync(dev)
        t = time.perf_counter()
        with torch.no_grad():
            logits, _, _ = forward(cut, cfg, data, tp=tp)
        _sync(dev)
        out["forward_ms"] = (time.perf_counter() - t) * 1e3
        want = ref["logits"]
        if logits.shape[-1] != want.shape[-1]:
            want = tp.cut(want, 2)
        out["logits_err"] = float((logits.cpu() - want).abs().max()
                                  / ref["logits"].abs().max())
        del logits
        step = make_train_step(
            cfg, _train_config(sequence_parallel=True), mesh)
        step.keep_grads = True
        _peak_reset(dev)
        _sync(dev)
        t = time.perf_counter()
        loss, _, _ = step(cut, init_adam(cut), data)
        _sync(dev)
        out["step_ms"] = (time.perf_counter() - t) * 1e3
        out["peak_gb"] = _peak_gb(dev)
        out["loss"], out["grad_norm"] = (float(loss), float(step.grad_norm))
        out["grad_errs"] = _tp_grad_errs(step.last_grads, ref["grads"],
                                         specs, rank, n)
        out["model_collectives"] = dict(step.model_collectives)
        del cut, step, loss
    finally:
        undo()
    out["k6"] = sorted(set(offsets))
    out["k7"] = ssd_scan.launches - k7_before
    return out


def _tp_rank(rank, device, ref_paths):
    """32 in one rank of a (1, TP_RANKS) ("data", "model") mesh: each of
    ``TP_ARCHS``' narrow model's share (``_tp_arch_share``: the logits
    within SERVE_TOL of their largest |value|, the loss within 1e-5
    (relative), the gradient norm within GRAD_SYNC_TOL, each gradient
    leaf within 2e-5 of the whole leaf's largest |value|, checked by
    ``tp_phase``). Then phase 30's cut decode (``_tp_long_decode``)."""
    from repro_torch.launch.mesh import make_mesh
    dev, counted = _rank_setup(rank, device)
    mesh = make_mesh((1, TP_RANKS), ("data", "model"))
    res = {arch: _tp_arch_share(arch, rank, TP_RANKS, dev, mesh,
                                ref_paths[arch]) for arch in TP_ARCHS}
    res["qkv_off"] = _tp_qkv_off(rank, dev, mesh, ref_paths[QKV_OFF_ARCH])
    res["long"] = _tp_long_decode(rank, dev, mesh, ref_paths["long"])
    res["long_ssm"] = _tp_long_ssm_decode(rank, dev, mesh,
                                          ref_paths["long_ssm"])
    res["moe_data"] = _tp_moe_data_step(rank, dev, ref_paths["moe_data"])
    res["launches"] = _launches(dev, counted)
    return res


#: 32 (e): three gloo ranks of a (1, 3) mesh, which divides none of these
#: narrow models' vocab of 4096 nor most of their widths: deepseek's (MLA
#: with ``w_kr``, ``w_uk``, ``w_uv`` and ``wo`` whole beside its cut
#: ``wq``, the dense MLP and the 64 experts whole) and mamba2's
#: (``in_proj`` and ``out_proj`` whole), the vocab whole; their sequences of
#: 400 and 512 do not divide 3 either, so every row runs on every rank
#: and a whole o-projection or ``out_proj`` takes each rank's share of
#: the rows
TP_WHOLE_RANKS = 3
TP_WHOLE_ARCHS = ("deepseek-v2-lite-16b", "mamba2-370m")


def _tp_whole_rank(rank, device, ref_paths):
    """32 (e) in one rank of a (1, TP_WHOLE_RANKS) ("data", "model")
    mesh: each of TP_WHOLE_ARCHS' narrow model's share
    (``_tp_arch_share``) against the same unsharded runs."""
    from repro_torch.launch.mesh import make_mesh
    dev, counted = _rank_setup(rank, device)
    mesh = make_mesh((1, TP_WHOLE_RANKS), ("data", "model"))
    res = {arch: _tp_arch_share(arch, rank, TP_WHOLE_RANKS, dev, mesh,
                                ref_paths[arch]) for arch in TP_WHOLE_ARCHS}
    res["launches"] = _launches(dev, counted)
    return res


def _tp_share_report(label, archs, refs, got, n, k6_want, attention):
    """Phase 32's checks and ``[<label> rank]`` lines of the ranks'
    ``_tp_arch_share`` results ``got`` over a (1, ``n``) mesh, each
    against the unsharded run in ``refs``: the logits, loss, gradient
    norm and gradients within ``_tp_arch_share``'s bounds, K6's
    (route, offset) set ``k6_want(cfg, rank)``, K7 once a layer in the
    forward, the step and its remat recompute of a scanning model;
    ``attention(cfg)`` names the attention mode."""
    for arch in archs:
        ref, cfg = refs[arch], _tp_cfg(arch)
        scans = cfg.ssm.enabled
        for r, res in enumerate(got):
            out = res[arch]
            check(out["logits_err"] <= SERVE_TOL,
                  f"{label} {arch} rank {r}: logits {out['logits_err']} "
                  f"off")
            _near(out["loss"], ref["loss"], f"{label} {arch} rank {r} loss")
            _near(out["grad_norm"], ref["norm"],
                  f"{label} {arch} rank {r} gradient norm", GRAD_SYNC_TOL)
            off = _tp_grad_ok(out["grad_errs"], ref)
            check(not off, f"{label} {arch} rank {r}: gradients off "
                           f"{off} ({out['grad_errs']})")
            worst = max(rel for rel, _ in out["grad_errs"].values())
            held = sorted(p for p, (rel, _) in out["grad_errs"].items()
                          if rel > TP_GRAD_TOL)
            want = k6_want(cfg, r)
            check(set(map(tuple, out["k6"])) == want,
                  f"{label} {arch} rank {r}: K6 launches {out['k6']}, "
                  f"want {want}")
            # the forward, the step's and its remat recompute: one a layer
            k7 = 3 * cfg.num_layers if scans else 0
            check(out["k7"] == k7, f"{label} {arch} rank {r}: K7 "
                                   f"launched {out['k7']}, want {k7}")
            phase(f"{label} rank", rank=r, ranks=n, arch=cfg.name,
                  batch=f"{TP_BATCH}x{TP_SCAN_SEQ if scans else TP_SEQ}",
                  attention=attention(cfg),
                  whole_leaves=json.dumps(out["whole"]),
                  k6=json.dumps(out["k6"]), k7=out["k7"],
                  logits_err=out["logits_err"],
                  loss=out["loss"], plain_loss=ref["loss"],
                  grad_norm=out["grad_norm"], plain_grad_norm=ref["norm"],
                  worst_grad_err=worst,
                  held_to_the_norm=json.dumps({p: [out["grad_errs"][p][1]
                                                   / ref["norm"],
                                                   ref["sensitivity"][p]]
                                               for p in held}),
                  forward_ms=out["forward_ms"],
                  step_ms=out["step_ms"], peak_gb=out["peak_gb"],
                  model_collectives=json.dumps(out["model_collectives"],
                                               sort_keys=True),
                  wire="gloo through host")


def _tp_whole_k6(cfg, rank):
    """32 (e)'s K6 launches: none for an SSM, else every row at offset 0
    (sequences that do not divide TP_WHOLE_RANKS)."""
    return set() if cfg.family == "ssm" else {("wgmma_tf32", 0)}


def _tp_whole_attention(cfg):
    return "none" if cfg.family == "ssm" else "replicated"


#: 32 (d): the narrow model run again with ``qkv_sharding`` off (the
#: reference's ``--no-qkv-shard``): qwen2.5-3b's 2 KV heads do not divide
#: the axis, its head dim of 128 does, so every rank scores its 32 columns
#: of every head and the scores are all-reduced, with no K6
QKV_OFF_ARCH = "qwen2.5-3b"


def _tp_qkv_off(rank, dev, mesh, ref_path):
    """32 (d) in one rank: ``_tp_rank``'s forward and train step of
    QKV_OFF_ARCH's narrow model under ``sharding.qkv_sharding(False)``
    (restored after), its logits, loss, gradient norm and gradient
    errors against the same unsharded run, its collectives, and its K6
    launches logged (none: the softmax needs the sum in the middle)."""
    from repro_torch.models import init_params, sharding
    from repro_torch.models.transformer import forward
    from repro_torch.train import init_adam
    from repro_torch.train.train_step import make_train_step
    ref = torch.load(ref_path)
    cfg = _tp_cfg(QKV_OFF_ARCH)
    _, specs = sharding.whole_specs(cfg, TP_RANKS)
    cut = sharding.shard_tree(init_params(cfg, SEED, device=dev), specs,
                              rank, TP_RANKS)
    data = _tp_data(cfg, dev)
    offsets, undo = _k6_logged()
    out = {}
    try:
        with sharding.qkv_sharding(False):
            tp = sharding.tensor_parallel(cfg, mesh, True)
            _sync(dev)
            t = time.perf_counter()
            with torch.no_grad():
                logits, _, _ = forward(cut, cfg, data, tp=tp)
            _sync(dev)
            out["forward_ms"] = (time.perf_counter() - t) * 1e3
            out["logits_err"] = float(
                (logits.cpu() - tp.cut(ref["logits"], 2)).abs().max()
                / ref["logits"].abs().max())
            del logits
            step = make_train_step(
                cfg, _train_config(sequence_parallel=True), mesh)
            step.keep_grads = True
            _sync(dev)
            t = time.perf_counter()
            loss, _, _ = step(cut, init_adam(cut), data)
            _sync(dev)
            out["step_ms"] = (time.perf_counter() - t) * 1e3
            out["loss"], out["grad_norm"] = (float(loss),
                                             float(step.grad_norm))
            out["grad_errs"] = _tp_grad_errs(step.last_grads, ref["grads"],
                                             specs, rank, TP_RANKS)
            out["model_collectives"] = dict(step.model_collectives)
    finally:
        undo()
    out["k6"] = sorted(set(offsets))
    return out


def _tp_grad_errs(grads, ref_grads, specs, rank, n):
    """Each leaf of a rank's cut gradients against the cut of the whole
    ``ref_grads``: (its max |difference| over the whole leaf's largest
    |value|, the max |difference| itself); an empty leaf (a full-width
    SSM's zero-width FFN) has none, a leaf of zeros its difference."""
    from repro_torch.models import sharding
    out = {}
    for (path, g), (_, w), (_, whole) in zip(
            sharding._leaf_paths(grads, ""),
            sharding._leaf_paths(sharding.shard_tree(
                ref_grads, specs, rank, n), ""),
            sharding._leaf_paths(ref_grads, "")):
        if whole.numel():
            err = float((g.cpu() - w).abs().max())
            out[path] = (err / max(float(whole.abs().max()), 1e-30), err)
    return out


def _tp_grad_ok(errs, ref):
    """The leaves of ``_tp_grad_errs`` off their unsharded twin: each
    must lie within TP_GRAD_TOL of the whole leaf's largest |value|, or,
    for a leaf that one f32 rounding of the weights moves by over a
    quarter of that in the unsharded run (``_tp_reference``'s
    sensitivity; a rank's step rounds the same values in several more
    places, each gather, reduce and the split norm), within
    GRAD_SYNC_TOL of the global gradient norm, the bound the rdma step's
    gradients, summed in another order, are held to (phase 19)."""
    return {path: rel for path, (rel, err) in errs.items()
            if rel > TP_GRAD_TOL and not (
                ref["sensitivity"].get(path, 0.0) > TP_GRAD_TOL / 4
                and err <= GRAD_SYNC_TOL * ref["norm"])}


def _tp_moe_data_step(rank, dev, ref_path):
    """32 (b) in one rank of a (2, 2) ("data", "model") mesh over the same
    ranks: ``_tp_moe_cfg``'s cut over 2 model ranks, one
    ``make_train_step(mesh)`` step on phase 32's global batch (one
    sequence a data rank), its MoE layer routing the rank's rows as a
    part of the global batch, against the unsharded step on the global
    batch saved at ``ref_path``: the loss, the norm and each gradient
    leaf of the rank's cut."""
    from repro_torch.launch.mesh import make_mesh, model_rank
    from repro_torch.models import init_params, sharding
    from repro_torch.train import init_adam
    from repro_torch.train.train_step import make_train_step
    ref = torch.load(ref_path)
    cfg = _tp_moe_cfg()
    mesh = make_mesh((2, 2), ("data", "model"))
    m = model_rank(mesh)
    _, specs = sharding.whole_specs(cfg, 2)
    cut = sharding.shard_tree(init_params(cfg, SEED, device=dev), specs, m,
                              2)
    step = make_train_step(cfg, _train_config(sequence_parallel=True), mesh)
    step.keep_grads = True
    _sync(dev)
    t = time.perf_counter()
    loss, _, _ = step(cut, init_adam(cut), _tp_data(cfg, dev))
    _sync(dev)
    return {"coords": list(mesh.get_coordinate()), "loss": float(loss),
            "grad_norm": float(step.grad_norm),
            "step_ms": (time.perf_counter() - t) * 1e3,
            "grad_errs": _tp_grad_errs(step.last_grads, ref["grads"], specs,
                                       m, 2)}


def _tp_long_ssm_decode(rank, dev, mesh, ref_path):
    """30 (c) in one rank: mamba2-370m at full width, two layers
    (``_tp_cfg``), f32 from SEED, this rank's cut and cut caches (the
    conv cache's channels and the state's head dim); a prefill of the
    saved sequence's first 32512 tokens (127 chunks) and of the next 248
    from the state (one chunk), then 8 teacher-forced decode steps to its
    last slot, each updating the state's cut where it lies, against the
    cut of the unsharded forward's logits saved at ``ref_path``. K7
    launches once a layer in each prefill, none in decode."""
    from repro_torch.kernels.ssd_scan import ssd_scan
    from repro_torch.models import (forward, init_caches, init_params,
                                    sharding)
    from repro_torch.serve import decode_step, prefill_step
    ref = torch.load(ref_path)
    cfg = _tp_cfg("mamba2-370m")
    _, specs = sharding.whole_specs(cfg, TP_RANKS)
    cut = sharding.shard_tree(init_params(cfg, SEED, device=dev), specs,
                              rank, TP_RANKS)
    tp = sharding.tensor_parallel(cfg, mesh, False)
    toks = ref["tokens"].to(dev)
    n = toks.shape[1]
    head = n - 8
    first = head // cfg.ssm.chunk_size * cfg.ssm.chunk_size
    caches = init_caches(cfg, 1, n, torch.float32, dev, tp_size=TP_RANKS)
    k7 = ssd_scan.launches
    with torch.no_grad():
        _sync(dev)
        t = time.perf_counter()
        _, caches = prefill_step(cut, cfg, {"tokens": toks[:, :first]},
                                 caches, tp=tp)
        lg, caches, _ = forward(cut, cfg, {"tokens": toks[:, first:head]},
                                caches=caches, pos=first, tp=tp)
        _sync(dev)
        prefill_ms = (time.perf_counter() - t) * 1e3
        k7_prefill = ssd_scan.launches - k7
        steps = [lg[:, -1]]
        t = time.perf_counter()
        for i in range(head, n):
            lg, caches = decode_step(cut, cfg, toks[:, i:i + 1], caches, i,
                                     tp=tp)
            steps.append(lg[:, 0])
        _sync(dev)
        decode_ms = (time.perf_counter() - t) * 1e3 / (n - head)
    got = torch.stack(steps, dim=1).cpu()
    want = tp.cut(ref["logits"], 2)
    return {"err": float((got - want).abs().max()),
            "scale": float(ref["logits"].abs().max()),
            "cache": {k: list(v.shape) for k, v in caches["scan"].items()},
            "prefills": [first, head - first], "k7_prefill": k7_prefill,
            "k7_decode": ssd_scan.launches - k7 - k7_prefill,
            "prefill_ms": prefill_ms, "decode_ms": decode_ms}


def _tp_long_decode(rank, dev, mesh, ref_path):
    """30 (b) in one rank: deepseek-v2-lite-16b's MLA at full width over a
    dense FFN (``_tp_cfg(moe=False)``: no routing, so prefill and decode
    are the forward's function), f32 from SEED, this rank's cut and cut
    caches (the latent's and the rope key's feature dims); prefill of
    the saved sequence's tokens (LONG_SEQ) but the last 8, then 8
    teacher-forced decode steps to its last slot, each scoring the cut latent cache
    where it lies, against the cut of the unsharded forward's logits
    saved at ``ref_path``. K6 launches once a layer in the prefill, none
    in decode."""
    from repro_torch.models import init_caches, init_params, sharding
    from repro_torch.serve import decode_step, prefill_step
    ref = torch.load(ref_path)
    cfg = _tp_cfg("deepseek-v2-lite-16b", moe=False)
    _, specs = sharding.whole_specs(cfg, TP_RANKS)
    cut = sharding.shard_tree(init_params(cfg, SEED, device=dev), specs,
                              rank, TP_RANKS)
    tp = sharding.tensor_parallel(cfg, mesh, False)
    toks = ref["tokens"].to(dev)
    n = toks.shape[1]
    head = n - 8
    caches = init_caches(cfg, 1, n, torch.float32, dev, tp_size=TP_RANKS)
    offsets, undo = _k6_logged()
    try:
        with torch.no_grad():
            _sync(dev)
            t = time.perf_counter()
            lg, caches = prefill_step(cut, cfg, {"tokens": toks[:, :head]},
                                      caches, tp=tp)
            _sync(dev)
            prefill_ms = (time.perf_counter() - t) * 1e3
            n_prefill = len(offsets)
            steps = [lg[:, 0]]
            t = time.perf_counter()
            for i in range(head, n):
                lg, caches = decode_step(cut, cfg, toks[:, i:i + 1], caches,
                                         i, tp=tp)
                steps.append(lg[:, 0])
            _sync(dev)
            decode_ms = (time.perf_counter() - t) * 1e3 / (n - head)
    finally:
        undo()
    got = torch.stack(steps, dim=1).cpu()
    want = tp.cut(ref["logits"], 2)
    return {"err": float((got - want).abs().max()),
            "scale": float(ref["logits"].abs().max()),
            "cache": {k: list(v.shape) for k, v in caches["scan"].items()},
            "k6_prefill": n_prefill, "k6_decode": len(offsets) - n_prefill,
            "k6": sorted(set(offsets)), "prefill_ms": prefill_ms,
            "decode_ms": decode_ms}


def _tp_reference(cfg, dev):
    """The unsharded run phase 32 holds a narrow model's ranks against:
    f32 weights from SEED, the forward's logits and one plain train step's
    loss, gradients and norm on phase 18's batch. ``sensitivity``: each
    gradient leaf's change, over its largest |value|, when every matrix
    of the weights moves by one f32 rounding (times 1 + 2^-23 N(0, 1),
    seeded): the SSM's per-head ``a_log`` and ``dt_bias`` gradients sum
    the chunked scan's large decays, and move by 1e-5 to 1e-4 of
    themselves (``_tp_grad_ok``)."""
    from repro_torch._tree import tree_map
    from repro_torch.models import init_params, sharding
    from repro_torch.models.transformer import forward
    from repro_torch.train import init_adam
    from repro_torch.train.train_step import make_train_step
    params = init_params(cfg, SEED, device=dev)
    data = _tp_data(cfg, dev)
    with torch.no_grad():
        logits = forward(params, cfg, data)[0].cpu()
    step = make_train_step(cfg, _train_config(sequence_parallel=True))
    step.keep_grads = True

    def grads(p):
        out = step(p, init_adam(p), data)
        return out[0], tree_map(lambda g: g.detach().cpu(), step.last_grads)

    loss, whole = grads(params)
    norm = float(step.grad_norm)
    gen = torch.Generator(device=dev).manual_seed(SEED + 70)
    _, moved = grads(tree_map(lambda t: t * (1 + 2.0 ** -23 * torch.randn(
        t.shape, generator=gen, device=dev)) if t.ndim >= 2 else t, params))
    sensitivity = {path: float((a - b).abs().max()
                               / max(float(b.abs().max()), 1e-30))
                   for (path, a), (_, b) in zip(
                       sharding._leaf_paths(moved, ""),
                       sharding._leaf_paths(whole, "")) if b.numel()}
    return {"logits": logits, "loss": float(loss), "norm": norm,
            "grads": whole, "sensitivity": sensitivity}


def _moe_data_reference(dev):
    """32 (b)'s unsharded run: ``_tp_reference`` of ``_tp_moe_cfg`` (the
    plain step routes the global batch at once), with the assignments
    its MoE layer drops counted, and the loss of the per-shard function
    (each data shard's sequence routed alone, the reference's
    ``shard_map`` step) beside."""
    from repro_torch.models import init_params
    from repro_torch.models import moe as moe_mod
    from repro_torch.models.transformer import loss_fn
    cfg = _tp_moe_cfg()
    real, dropped = moe_mod._dispatch_indices, []

    def counted(*args):
        pos, keep = real(*args)
        dropped.append(int((~keep).sum()))
        return pos, keep

    moe_mod._dispatch_indices = counted
    try:
        ref = _tp_reference(cfg, dev)
    finally:
        moe_mod._dispatch_indices = real
    params = init_params(cfg, SEED, device=dev)
    data = _tp_data(cfg, dev)
    with torch.no_grad():
        shards = [float(loss_fn(params, cfg, {k: v[i:i + 1]
                                              for k, v in data.items()}))
                  for i in range(TP_BATCH)]
    ref["dropped"] = dropped
    ref["per_shard_loss"] = sum(shards) / len(shards)
    return ref


def _long_reference(dev, arch="deepseek-v2-lite-16b"):
    """Phase 30 (b)'s unsharded run (30 (c)'s with ``arch``
    mamba2-370m): the narrow model's forward (deepseek's MLA over a
    dense FFN) over one sequence of LONG_SEQ seeded tokens, the logits at
    the prefill's last position and the 8 decode steps' positions."""
    from repro_torch.models import forward, init_params
    cfg = _tp_cfg(arch, moe=False)
    params = init_params(cfg, SEED, device=dev)
    toks = torch.from_numpy(np.random.default_rng(SEED + 40).integers(
        0, cfg.vocab_size, (1, LONG_SEQ))).to(dev)
    with torch.no_grad():
        logits = forward(params, cfg, {"tokens": toks})[0]
    return {"tokens": toks.cpu(),
            "logits": logits[:, LONG_SEQ - 9:].float().cpu()}


def tp_phase(dev):
    """32. The model axis on the card: each narrow model of ``TP_ARCHS``
    unsharded in this process (``_tp_reference``: ``_train_config(
    sequence_parallel=True)``) and phase 30 (b)'s forward
    (``_long_reference``), saved for the ranks; then TP_RANKS gloo ranks
    of a (1, TP_RANKS) ("data", "model") mesh on the card (``_tp_rank``),
    each holding its share against them. qwen2.5-3b's and hymba's heads
    do not divide the axis, so their attention is sequence-parallel: rank
    r's K6 launches take q rows at offset r x S / TP_RANKS; deepseek's MLA
    and seamless's attention are head-parallel (4 heads a rank, offset
    0), deepseek's MoE layer expert-parallel (16 experts a rank); K7 runs
    on every rank's share of mamba2 and hymba, once a layer a forward.
    The same ranks then run phase 30 (b) and (c), the cut MLA and SSM
    decodes to slot 32767, and (b) a (2, 2) data x model mesh's MoE step
    (``_tp_moe_data_step``) against the unsharded step on the global
    batch, whose routing drops assignments (``_moe_data_reference``).
    Then (e) TP_WHOLE_RANKS gloo ranks (``_tp_whole_rank``) hold
    TP_WHOLE_ARCHS' narrow models, with the leaves a model axis of 3
    does not divide whole, against the same unsharded runs. Returns the
    ranks' launches summed."""
    from repro_torch.launch.mesh import run_peers

    refs = {arch: _tp_reference(_tp_cfg(arch), dev) for arch in TP_ARCHS}
    refs["long"] = _long_reference(dev)
    refs["long_ssm"] = _long_reference(dev, "mamba2-370m")
    refs["moe_data"] = _moe_data_reference(dev)
    cuda = dev.type == "cuda"
    kind, rank_dev = ("cuda", None) if cuda else ("cpu", "cpu")
    tmp = tempfile.mkdtemp(prefix="chip_smoke_tp_")
    try:
        paths = {}
        for name, ref in refs.items():
            paths[name] = os.path.join(tmp, f"{name}.pt")
            torch.save(ref, paths[name])
        _sync(dev)
        if cuda:
            torch.cuda.empty_cache()
        t = time.perf_counter()
        got = run_peers(_tp_rank, TP_RANKS, device=kind,
                        timeout_s=MP_TIMEOUT_S, args=(rank_dev, paths))
        wall = time.perf_counter() - t
        _sync(dev)
        if cuda:
            torch.cuda.empty_cache()
        t = time.perf_counter()
        got3 = run_peers(_tp_whole_rank, TP_WHOLE_RANKS, device=kind,
                         timeout_s=MP_TIMEOUT_S, args=(rank_dev, paths))
        wall3 = time.perf_counter() - t
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    _tp_share_report("model axis", TP_ARCHS, refs, got, TP_RANKS,
                     _tp_k6_want, _tp_attention)
    ref, cfg = refs[QKV_OFF_ARCH], _tp_cfg(QKV_OFF_ARCH)
    for r, res in enumerate(got):
        out = res["qkv_off"]
        check(out["logits_err"] <= SERVE_TOL,
              f"no qkv shard {cfg.name} rank {r}: logits "
              f"{out['logits_err']} off")
        _near(out["loss"], ref["loss"], f"no qkv shard {cfg.name} rank {r} "
                                        f"loss")
        _near(out["grad_norm"], ref["norm"],
              f"no qkv shard {cfg.name} rank {r} gradient norm",
              GRAD_SYNC_TOL)
        off = _tp_grad_ok(out["grad_errs"], ref)
        check(not off, f"no qkv shard {cfg.name} rank {r}: gradients off "
                       f"{off} ({out['grad_errs']})")
        check(not out["k6"], f"no qkv shard {cfg.name} rank {r}: K6 "
                             f"launched at {out['k6']}")
        phase("model axis no qkv shard", rank=r, ranks=TP_RANKS,
              arch=cfg.name, batch=f"{TP_BATCH}x{TP_SEQ}", attention="hd",
              logits_err=out["logits_err"], loss=out["loss"],
              plain_loss=ref["loss"], grad_norm=out["grad_norm"],
              plain_grad_norm=ref["norm"],
              worst_grad_err=max(rel for rel, _ in
                                 out["grad_errs"].values()),
              forward_ms=out["forward_ms"], step_ms=out["step_ms"],
              model_collectives=json.dumps(out["model_collectives"],
                                           sort_keys=True),
              wire="gloo through host")
    cfg = _tp_cfg("deepseek-v2-lite-16b", moe=False)
    m = cfg.mla
    for r, res in enumerate(got):
        out = res["long"]
        tol = SERVE_TOL * out["scale"]
        check(out["err"] <= tol,
              f"cut MLA decode at {LONG_SEQ} rank {r}: max err "
              f"{out['err']} over {tol}")
        check(out["cache"]["c_kv"][-1] == m.kv_lora_rank // TP_RANKS
              and out["cache"]["k_rope"][-1] == m.qk_rope_head_dim
              // TP_RANKS, f"cut MLA decode rank {r}: caches {out['cache']}")
        check(out["k6_prefill"] == cfg.num_layers and out["k6_decode"] == 0
              and set(map(tuple, out["k6"])) == {("wgmma_tf32", 0)},
              f"cut MLA decode rank {r}: K6 {out['k6_prefill']} in prefill, "
              f"{out['k6_decode']} in decode, {out['k6']}")
        phase("long decode cut", rank=r, ranks=TP_RANKS, arch=cfg.name,
              tokens=LONG_SEQ, prefill=LONG_SEQ - 8, decode_steps=8,
              last_slot=LONG_SEQ - 1, max_abs_err=out["err"],
              tolerance=tol, logit_scale=out["scale"],
              cache=json.dumps(out["cache"]),
              prefill_ms=out["prefill_ms"],
              decode_ms_per_step=out["decode_ms"], dtype="float32",
              wire="gloo through host")
    cfg = _tp_cfg("mamba2-370m")
    s_cfg = cfg.ssm
    conv = s_cfg.d_inner(cfg.d_model) + 2 * s_cfg.d_state
    for r, res in enumerate(got):
        out = res["long_ssm"]
        tol = SERVE_TOL * out["scale"]
        check(out["err"] <= tol,
              f"cut SSM decode at {LONG_SEQ} rank {r}: max err "
              f"{out['err']} over {tol}")
        check(out["cache"]["conv"][-1] == conv // TP_RANKS
              and out["cache"]["ssm"][-2] == s_cfg.head_dim // TP_RANKS,
              f"cut SSM decode rank {r}: caches {out['cache']}")
        check(out["k7_prefill"] == 2 * cfg.num_layers
              and out["k7_decode"] == 0,
              f"cut SSM decode rank {r}: K7 {out['k7_prefill']} in the "
              f"prefills, {out['k7_decode']} in decode")
        phase("long decode cut ssm", rank=r, ranks=TP_RANKS, arch=cfg.name,
              tokens=LONG_SEQ, prefills=json.dumps(out["prefills"]),
              decode_steps=8, last_slot=LONG_SEQ - 1,
              max_abs_err=out["err"], tolerance=tol,
              logit_scale=out["scale"], cache=json.dumps(out["cache"]),
              k7_prefill=out["k7_prefill"], prefill_ms=out["prefill_ms"],
              decode_ms_per_step=out["decode_ms"], dtype="float32",
              wire="gloo through host")
    ref, cfg = refs["moe_data"], _tp_moe_cfg()
    check(sum(ref["dropped"]) > 0,
          f"the (2, 2) MoE step's global batch drops nothing: "
          f"{ref['dropped']}")
    for r, res in enumerate(got):
        out = res["moe_data"]
        _near(out["loss"], ref["loss"], f"(2, 2) MoE step rank {r} loss")
        _near(out["grad_norm"], ref["norm"],
              f"(2, 2) MoE step rank {r} gradient norm", GRAD_SYNC_TOL)
        off = _tp_grad_ok(out["grad_errs"], ref)
        check(not off, f"(2, 2) MoE step rank {r}: gradients off {off} "
                       f"({out['grad_errs']})")
        worst = max(rel for rel, _ in out["grad_errs"].values())
        phase("model axis data routing", rank=r,
              coords=json.dumps(out["coords"]), arch=cfg.name,
              mesh="data 2 x model 2", batch=f"{TP_BATCH}x{TP_SEQ}",
              capacity_factor=TP_MOE_CAPACITY,
              dropped_by_call=json.dumps(ref["dropped"]), loss=out["loss"],
              plain_loss=ref["loss"],
              per_shard_loss=ref["per_shard_loss"],
              grad_norm=out["grad_norm"], plain_grad_norm=ref["norm"],
              worst_grad_err=worst, step_ms=out["step_ms"],
              wire="gloo through host")
    phase("model axis", ranks=TP_RANKS, mesh="data 1 x model 4",
          archs=",".join(TP_ARCHS), spawn_and_run_s=wall)
    for arch in TP_WHOLE_ARCHS:
        check("embed" in got3[0][arch]["whole"],
              f"model axis whole {arch}: whole leaves "
              f"{got3[0][arch]['whole']}")
    _tp_share_report("model axis whole", TP_WHOLE_ARCHS, refs, got3,
                     TP_WHOLE_RANKS, _tp_whole_k6, _tp_whole_attention)
    phase("model axis whole", ranks=TP_WHOLE_RANKS, mesh="data 1 x model 3",
          archs=",".join(TP_WHOLE_ARCHS), spawn_and_run_s=wall3)
    return {name: sum(res["launches"][name] for res in got + got3)
            for name in got[0]["launches"]}


# ---- 29. bf16 serving against f32 on the same weights -------------------

def _f32_of_bf16_draw(cfg, dev):
    """``init_params(cfg, SEED, bf16)``'s values in f32: drawn in f32 from
    the same seed (``init_dense`` draws f32 and casts, so the bf16 draw is
    this one rounded) and each leaf the bf16 draw holds in bf16 rounded
    through bf16 in place, 2^26 elements at a time (the router and the
    SSM's f32 leaves stay as drawn). No second copy of the weights is
    made: deepseek's are 63 GB in f32."""
    from repro_torch._tree import tree_leaves
    from repro_torch.models import init_params

    like = tree_leaves(init_params(cfg, SEED, torch.bfloat16,
                                   device="meta"))
    params = init_params(cfg, SEED, torch.float32, device=dev)
    for t, kind in zip(tree_leaves(params), like):
        if kind.dtype == torch.bfloat16:
            for part in t.view(-1).split(1 << 26):
                part.copy_(part.to(torch.bfloat16))
    return params


def _route_flips(fwd, f32, steps, pinned, calls, n_req, n_tok):
    """deepseek's routing under phase 29's pins: ``fwd``, ``f32`` and
    ``steps`` are the ``RouteLog`` logs of the bf16 forward, of the f32
    forward and of the prefill and decode steps (one entry a MoE layer a
    call), ``pinned`` the bf16 forward's (B, S, k) sets a layer and
    ``calls`` each step's token span. Every decision of the steps whose
    own top-k set differs from the pinned one must have a margin, on the
    steps and on the forward, under twice the largest gap between the
    bf16 and the f32 forward's router probabilities. Returns the counts
    for the phase's line."""
    gp = max((a[2] - b[2]).abs().max().item() for a, b in zip(fwd, f32))
    n_moe, k = len(fwd), pinned[0].shape[-1]
    # the steps' decisions, layer by layer, each call's in token order
    by_layer = [c for i in range(n_moe) for c in steps[i::n_moe]]
    flipped = (torch.cat([c[0] for c in by_layer]) != torch.cat([
        torch.sort(p[:, a:b].reshape(-1, k), -1).values
        for p in pinned for a, b in calls])).any(-1)
    margin = torch.maximum(
        torch.cat([c[1] for c in by_layer]),
        torch.cat([m.view(n_req, n_tok)[:, a:b].reshape(-1)
                   for _, m, _ in fwd for a, b in calls]))
    worst = margin[flipped].max().item() if bool(flipped.any()) else 0.0
    check(worst < 2 * gp, f"a routing flip has margin {worst}, not under "
                          f"twice bf16's probability gap {gp}")
    return {"decisions": int(flipped.numel()), "flips": int(flipped.sum()),
            "worst_flip_margin": worst, "margin_bound": 2 * gp}


def bf16_serve_phase(dev, during, kernels, handoff, ledger):
    """29. bf16 serving against the same weights in f32, for each of
    ``BF16_SERVE_ARCHS`` at full width and depth: ``BF16_TRAFFIC`` (requests,
    prompt, decode steps). The weights are drawn in bf16 from SEED and
    copied to f32 after the bf16 runs (``_f32_of_bf16_draw``: a leading
    slice of every leaf checked equal to the bf16 draw's); frames,
    patches and token ids are the same bf16 values on both. ``g``, the
    bf16 forward against the f32 forward at the prefill's last position
    and the decode steps' (a forward over whole chunks where the model
    scans), is what bf16 costs; the bf16 prefill and teacher-forced
    decode on bf16 caches must lie within ``2 g`` of the bf16 forward,
    and the f32 prefill and decode on f32 caches within ``SERVE_TOL`` of
    the logits' scale of the f32 forward (phases 11-22's limit, which a
    stale cache or state would break whatever ``g``). K6 and K7 launch
    once a layer in the prefills and the forwards (seamless's decode
    steps K6 too). deepseek runs at capacity factor 8 (no drops), every
    step and the f32 forward pinned to the bf16 forward's routing, every
    flip of the bf16 steps' own routing a near-tie (``_route_flips``).
    Then tinyllama's bf16 caches take the uncompressed handoff (bf16
    widens exactly into the f32 pool) with greedy tokens equal to local
    ones (``handoff`` and ``ledger`` main's; the caches have main's
    ``SERVE_MAX_SEQ`` slots, as its greedy loop makes them; ``handoff``
    None skips it). ``kernels`` is (flash_attention, ssd_scan)."""
    import dataclasses

    from repro_torch._tree import tree_leaves
    from repro_torch.configs.registry import get_config
    from repro_torch.models import forward, init_caches, init_params
    from repro_torch.models import moe as moe_mod
    from repro_torch.serve import (decode_step, model_inputs, prefill_step,
                                   step_inputs)

    k6, k7 = kernels
    n_req, p_len, g_len = BF16_TRAFFIC
    max_seq = p_len + g_len
    # each step's token span: the prefill's, then one a decode step
    calls = [(0, p_len)] + [(i, i + 1) for i in range(p_len, max_seq)]
    bf16 = torch.bfloat16
    for arch in BF16_SERVE_ARCHS:
        t0 = time.perf_counter()
        cfg = get_config(arch)
        scans = cfg.family == "ssm" or cfg.hybrid_parallel_heads
        if cfg.moe.enabled:
            cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
                cfg.moe, capacity_factor=8.0))
        # a forward over whole chunks where the model scans
        n_tok = (-(-max_seq // cfg.ssm.chunk_size) * cfg.ssm.chunk_size
                 if scans else max_seq)
        attn = 0 if cfg.family == "ssm" else (
            cfg.encoder_layers + 2 * cfg.num_layers if cfg.enc_dec
            else cfg.num_layers)
        want = {k6.__name__: attn, k7.__name__: cfg.num_layers if scans
                else 0}
        want_dec = {k6.__name__: (cfg.encoder_layers + cfg.num_layers
                                  if cfg.enc_dec else 0), k7.__name__: 0}
        toks = torch.from_numpy(np.random.default_rng(SEED + 20).integers(
            0, cfg.vocab_size, (n_req, n_tok))).to(dev)
        # frames and patches as bf16 values, so both dtypes read the same
        inp = {k: v.to(bf16).float() if v.is_floating_point() else v
               for k, v in model_inputs(cfg, n_req, p_len, n_tok,
                                        seed=SEED + 21, device=dev).items()}
        batch = {"tokens": toks, **step_inputs(inp, 0, n_tok)}
        pos = slice(p_len - 1, max_seq)       # the compared positions
        routes = pinned = None

        def pin(start, stop):
            if routes:
                routes.pins = [p[:, start:stop].reshape(-1, p.shape[-1])
                               for p in pinned]

        def serve(params, dtype):
            """Prefill and teacher-forced decode on caches of ``dtype``,
            pinned: (the logits (B, 1 + steps, V) f32, the caches)."""
            caches = init_caches(cfg, n_req, SERVE_MAX_SEQ, dtype)
            pin(0, p_len)
            (lg, caches), _, n_pre = during(lambda: prefill_step(
                params, cfg, {"tokens": toks[:, :p_len],
                              **step_inputs(inp, 0, p_len)}, caches))
            steps = [lg[:, 0].float()]

            def decode_all():
                c = caches
                for i in range(p_len, max_seq):
                    pin(i, i + 1)
                    out, c = decode_step(params, cfg, toks[:, i:i + 1], c,
                                         i, extra=step_inputs(inp, i, i + 1))
                    steps.append(out[:, 0].float())
                return c

            caches, _, n_dec = during(decode_all)
            check(n_pre == {**{f: 0 for f in n_pre}, **want},
                  f"{arch} {dtype}: launches per prefill {n_pre}, want "
                  f"{want}")
            check(n_dec == {**{f: 0 for f in n_dec},
                            **{f: g_len * n for f, n in want_dec.items()}},
                  f"{arch} {dtype}: decode launched {n_dec}, want "
                  f"{want_dec} a step")
            return torch.stack(steps, dim=1), caches, n_pre, n_dec

        if cfg.moe.enabled:
            routes = RouteLog(moe_mod.route, cfg.moe.top_k)
            moe_mod.route = routes
        try:
            params = init_params(cfg, SEED, bf16)
            heads = [t.reshape(-1)[:4096].float().clone()
                     for t in tree_leaves(params)]
            full, _, n_full = during(
                lambda: forward(params, cfg, batch)[0][:, pos].float())
            check(n_full == {**{f: 0 for f in n_full}, **want},
                  f"{arch} bf16: launches per forward {n_full}, want {want}")
            fwd_log = []
            if routes:
                fwd_log, routes.log = routes.log, []
                pinned = [torch.topk(p, cfg.moe.top_k, dim=-1).indices.view(
                    n_req, n_tok, -1) for _, _, p in fwd_log]
            steps, caches, n_pre, n_dec = serve(params, bf16)
            step_log = routes.log if routes else []
            if handoff and arch == "tinyllama-1.1b":
                s_eng, n_pages, n_fetches = handoff(
                    cfg, params, toks[:, :p_len], caches, POOL, dtype=bf16)
                ledger(s_eng, n_pages, n_fetches)
                del s_eng
            del caches, params
            # the same weights in f32
            torch.cuda.empty_cache()
            params = _f32_of_bf16_draw(cfg, dev)
            check(all(torch.equal(t.reshape(-1)[:4096], h)
                      for t, h in zip(tree_leaves(params), heads)),
                  f"{arch}: the f32 weights are not the bf16 draw's values")
            if routes:
                routes.log, routes.pins = [], [
                    p.reshape(-1, p.shape[-1]) for p in pinned]
            full32 = forward(params, cfg, batch)[0][:, pos]
            f32_log = routes.log if routes else []
            steps32, caches, _, _ = serve(params, torch.float32)
        finally:
            if routes:
                moe_mod.route = routes.inner
        del params, caches
        torch.cuda.synchronize()
        gap = (full - full32).abs().max().item()
        err = (steps - full).abs().max().item()
        scale = full32.abs().max().item()
        err32 = (steps32 - full32).abs().max().item()
        nums = (_route_flips(fwd_log, f32_log, step_log, pinned, calls,
                             n_req, n_tok) if routes else {})
        check(np.isfinite(gap) and gap > 0 and np.isfinite(err),
              f"{arch} bf16: gap {gap}, err {err}")
        check(err <= 2 * gap,
              f"{arch} bf16 prefill/decode vs the bf16 forward: max err "
              f"{err} over 2 g = {2 * gap}")
        check(np.isfinite(err32) and err32 <= SERVE_TOL * scale,
              f"{arch} f32 prefill/decode vs the f32 forward: max err "
              f"{err32} over {SERVE_TOL * scale} (logit scale {scale})")
        phase("bf16 invariant", arch=arch, requests=n_req, prompt=p_len,
              decode_steps=g_len, forward_tokens=n_tok, max_abs_err=err,
              bf16_vs_f32_gap=gap, tolerance=2 * gap, logit_scale=scale,
              gap_over_scale=gap / scale, f32_max_abs_err=err32,
              f32_tolerance=SERVE_TOL * scale,
              per_prefill=json.dumps({k: v for k, v in n_pre.items() if v}),
              per_decode_step=json.dumps({k: v // g_len for k, v in
                                          n_dec.items() if v}),
              seconds=time.perf_counter() - t0, **nums)
        del full, full32, steps, steps32, fwd_log, f32_log, step_log, pinned
        torch.cuda.empty_cache()


# ---- 30. decode at the cells' length against a prefill ----------------

#: one attention arch and the hybrid, whose windowed heads mask a cache
#: of the cell's length
LONG_ARCHS = ("tinyllama-1.1b", "hymba-1.5b")
LONG_SEQ = 32768
#: depths cut for phase 30: hymba's host-bound decode steps (its scan
#: takes a chunk of 256 teacher-forced steps, twice) cost ~100 s at its
#: 32 layers; 8 keep its global first and last layers and 6 windowed
#: ones between
LONG_LAYERS = {"hymba-1.5b": 8}


def long_decode_phase(dev, during, kernels):
    """30. Decode at the bf16 cells' length held against the forward, for
    each of ``LONG_ARCHS`` at full width and depth (``LONG_LAYERS``
    where it cuts one), one sequence of
    ``LONG_SEQ`` seeded tokens: prefill all but the last ``tail`` (8, or
    one chunk where the model scans, whose prefill takes whole chunks),
    then ``tail`` teacher-forced decode steps up to slot ``LONG_SEQ`` - 1,
    against one forward over all the tokens at the prefill's last
    position and the steps'. In bf16 within twice ``g``, the bf16 forward
    against the f32 forward there; in f32 (the same weights,
    ``_f32_of_bf16_draw``) within ``SERVE_TOL`` of the f32 forward's
    logits' scale. K6 and K7 launch once a layer in the prefills and the
    forwards, never in decode. ``kernels`` is (flash_attention,
    ssd_scan). The MoE family's cut MLA decode at LONG_SEQ (30 b) runs
    in phase 32's ranks (``_tp_long_decode``): a cut share needs its
    model group's processes."""
    import dataclasses

    from repro_torch.configs.registry import get_config
    from repro_torch.models import forward, init_caches, init_params
    from repro_torch.serve import decode_step, prefill_step

    k6, k7 = kernels
    for arch in LONG_ARCHS:
        t0 = time.perf_counter()
        cfg = get_config(arch)
        if arch in LONG_LAYERS:
            cfg = dataclasses.replace(cfg, num_layers=LONG_LAYERS[arch])
        scans = cfg.hybrid_parallel_heads
        tail = cfg.ssm.chunk_size if scans else 8
        head = LONG_SEQ - tail
        want = {k6.__name__: cfg.num_layers,
                k7.__name__: cfg.num_layers if scans else 0}
        toks = torch.from_numpy(np.random.default_rng(SEED + 40).integers(
            0, cfg.vocab_size, (1, LONG_SEQ))).to(dev)
        out = {}
        for dtype in (torch.bfloat16, torch.float32):
            params = (init_params(cfg, SEED, dtype) if dtype == torch.bfloat16
                      else _f32_of_bf16_draw(cfg, dev))
            full, _, n_full = during(lambda: forward(
                params, cfg, {"tokens": toks})[0][:, head - 1:].float())
            caches = init_caches(cfg, 1, LONG_SEQ, dtype)
            (lg, caches), _, n_pre = during(lambda: prefill_step(
                params, cfg, {"tokens": toks[:, :head]}, caches))
            steps = [lg[:, 0].float()]

            def decode_all():
                c = caches
                for i in range(head, LONG_SEQ):
                    lg_, c = decode_step(params, cfg, toks[:, i:i + 1], c, i)
                    steps.append(lg_[:, 0].float())
                return c

            _, dec_s, n_dec = during(decode_all)
            check(n_full == n_pre == {**{f: 0 for f in n_full}, **want}
                  and not any(n_dec.values()),
                  f"{arch} {dtype} at {LONG_SEQ}: launches per forward "
                  f"{n_full}, per prefill {n_pre}, in decode {n_dec}, "
                  f"want {want}")
            out[dtype] = (full, torch.stack(steps, dim=1),
                          dec_s * 1e3 / tail)
            del params, caches, lg, steps
            torch.cuda.empty_cache()
        (full, steps, dec16), (full32, steps32, dec32) = out.values()
        gap = (full - full32).abs().max().item()
        err = (steps - full).abs().max().item()
        scale = full32.abs().max().item()
        err32 = (steps32 - full32).abs().max().item()
        check(np.isfinite(gap) and gap > 0 and np.isfinite(err)
              and err <= 2 * gap,
              f"{arch} bf16 decode at {LONG_SEQ} vs the forward: max err "
              f"{err} over 2 g = {2 * gap}")
        check(np.isfinite(err32) and err32 <= SERVE_TOL * scale,
              f"{arch} f32 decode at {LONG_SEQ} vs the forward: max err "
              f"{err32} over {SERVE_TOL * scale} (logit scale {scale})")
        phase("long decode", arch=arch, layers=cfg.num_layers,
              tokens=LONG_SEQ, prefill=head,
              decode_steps=tail, last_slot=LONG_SEQ - 1, max_abs_err=err,
              bf16_vs_f32_gap=gap, tolerance=2 * gap, logit_scale=scale,
              f32_max_abs_err=err32, f32_tolerance=SERVE_TOL * scale,
              decode_ms_per_step_bf16=dec16, decode_ms_per_step_f32=dec32,
              seconds=time.perf_counter() - t0)
        del out, full, full32, steps, steps32
        torch.cuda.empty_cache()


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
    from repro_torch.kernels.flash_attention import (SM90_HEAD_DIMS,
                                                     flash_attention,
                                                     flash_attention_cost,
                                                     flash_attention_plain,
                                                     flash_attention_route)
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
    # the TF32 wgmma kernel's SASS, per instantiation (d, dv, keys a stage,
    # K stages, V stages, consumer warpgroups): its wgmmas (HGMMA), TMA
    # loads (UTMALDG) and spill stores (STL)
    sass = subprocess.run(
        [os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump"),
         "--dump-sass", str(built.path)], capture_output=True, text=True,
        check=True, timeout=300).stdout
    n_tf32 = 0
    for fn_sass in sass.split("Function : ")[1:]:
        name = fn_sass.split("\n", 1)[0]
        if "flash_attention_sm90_tf32_kernel" not in name:
            continue
        n_tf32 += 1
        n_op = {op: fn_sass.count(op) for op in ("HGMMA", "UTMALDG", "STL")}
        args = re.search(r"kernelI((?:Li\d+E)+)E", name)
        phase("sass flash_attention_sm90_tf32",
              instance="/".join(re.findall(r"\d+", args.group(1)))
              if args else name, **n_op)
        check(n_op["HGMMA"] > 0 and n_op["UTMALDG"] > 0,
              f"flash_attention_sm90_tf32 {name}: no HGMMA or UTMALDG")
    check(n_tf32 == len(SM90_HEAD_DIMS),
          f"{n_tf32} flash_attention_sm90_tf32 instantiations in the SASS")

    # ---- 2. each kernel against its plain version ------------------------
    rec = {}
    csrc = "src/repro_torch/kernels/csrc/"

    wrappers = {f.__name__: f for f in (
        systolic_mm, parse_packets, parse_packet_fields, quantize_stream,
        dequantize_stream, flash_attention, ssd_scan)}

    def measure(name, src, replaces, shape, err, fn, plain, cost,
                library=None, peak_flops=PEAK_F32_FLOPS, iters=20,
                key=None, record=True, **extra):
        """Time kernel, plain version and library call, ``iters`` calls
        each; print and, with ``record``, record under ``key`` (default
        ``name``; the last shape recorded per key is the one in the
        kernels line). ``cost`` is the kernel's (flops, bytes), by the
        formula its wrapper charges to ``roofline.count.OpCounter``."""
        flops, nbytes = cost
        b = bound(nbytes, flops, peak_flops)
        ms, ms_summed, passes = device_ms(fn, iters, wrapper=wrappers[name])
        plain_ms, plain_ms_summed, _ = device_ms(plain, iters)
        lib_ms, lib_ms_summed, _ = (device_ms(library, iters) if library
                                    else (None, None, None))
        if flops:
            extra["tflops"] = flops / ms / 1e9     # the cost's, at ms
        r = {"name": name, "route": "cuda", "source": csrc + src,
             "replaces": replaces, "shape": shape, "max_abs_err": err,
             "ms": ms, "plain_ms": plain_ms,
             "bound_ms": b[0], "bound_by": b[1], "library_ms": lib_ms,
             "call_ms": cuda_ms(fn, iters),
             "plain_call_ms": cuda_ms(plain, iters),
             "ms_summed": ms_summed, "plain_ms_summed": plain_ms_summed,
             "library_ms_summed": lib_ms_summed, **extra}
        if len(passes) > 1:
            # each pass's traced ms per call, on a line of its own
            r["passes_ms_sum"] = sum(passes.values())
            phase("kernel " + name + " passes", shape=shape,
                  **{k: v for k, v in sorted(passes.items())})
        phase("kernel " + (key or name), **{
            k: v for k, v in r.items()
            if k not in ("name", "route", "source", "replaces")})
        if record:
            rec[key or name] = dict(r, name=key or name)

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

    k6_served_phase(dev, measure)
    k6_decode_phase(dev, measure)
    k6_offset_phase(dev, measure)
    k6_cut_phase(dev, measure)

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
    # work (2 (d + dv) flops per visible q-k pair) at the least cost its
    # dtype's contract allows: bf16 at the bf16 peak; f32, which every
    # route runs as 3xTF32 on the tensor cores, as three TF32 products at
    # the TF32 peak (a third of 495 TFLOP/s: the 67 TFLOP/s of the CUDA
    # cores is no floor there, since one TF32 product alone runs under
    # it). route_bound_ms counts the products the kernel's route runs: in
    # bf16 two PV products (P split in a high and a low bf16 half) at the
    # bf16 peak, in f32 three TF32 products each (3xTF32) at the TF32 peak,
    # the f32 bound itself.
    sdpa = torch.nn.functional.scaled_dot_product_attention
    for (what, dname, ab, asq, askv, ahq, ahkv, ad, adv, causal,
         window) in K6_PHASE2:
        dtype = getattr(torch, dname)
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
        route = flash_attention_route(dtype, ad, adv, asq)
        nbytes, flops = cost[1], float(cost[0])
        if dtype == torch.bfloat16:
            peak, work = PEAK_BF16_FLOPS, "bf16 tensor cores, P split"
            route_flops, route_peak = 1.5 * flops, PEAK_BF16_FLOPS
        else:
            peak, work = PEAK_TF32_FLOPS / 3, "3xTF32 tensor cores"
            route_flops, route_peak = 3.0 * flops, PEAK_TF32_FLOPS
        rb = bound(nbytes, route_flops, route_peak)
        if route == "split_kv":
            # seamless's cross decode on the route it took before split_kv,
            # printed beside it
            mma_sync_beside(measure, what, qa, ka, va, causal, window,
                            cost, library, peak)
        # recorded: the f32 tinyllama row (the TF32 wgmma kernel) and the
        # tiny serve prefill (mma_sync); split_kv's record is the bf16
        # cross decode's
        measure("flash_attention", K6_SOURCE[route],
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
                cost, library=library, peak_flops=peak, key=K6_KEY[route],
                record=(route == "wgmma_tf32"
                        or what == "tiny serve prefill"), k6_route=route,
                route_work=work, route_flops=route_flops,
                route_bound_ms=rb[0], route_bound_by=rb[1])
    del qa, ka, va, qt, kt, vt, got, want, err

    k7_served_phase(dev, measure)

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
        cost = ssd_scan_cost(*args, schunk, sinit)
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
                **k7_route(sb, ss, snh, shd, sn, schunk, cost[1],
                           dtype == torch.bfloat16))
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
        zero_launches(counted)

    def read_counts(path, needed):
        torch.cuda.synchronize()
        launches[path] = launch_counts(counted)
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

    n_req, p_len, g_len = SERVE_TRAFFIC
    max_seq, page = SERVE_MAX_SEQ, 1 << 16

    during = counted_run(counted)

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
        tol_s = SERVE_TOL * scale
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

    def handoff(cfg, params, prompt, caches, pool_size, inp=None,
                dtype=torch.float32):
        """The cache handoff over the RDMA engine, uncompressed, on an
        engine of its own: publish and fetch the caches byte for byte
        (every leaf, dtypes included), then greedy tokens through the
        remote pool equal those with local caches (``greedy_with_inputs``
        the inputs ``inp`` where the model takes any; caches of
        ``dtype``). Returns (the engine,
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
                params, cfg, prompt, inp, g_len, max_seq, dtype))
            remote, rgen_s = timed(lambda: greedy_with_inputs(
                params, cfg, prompt, inp, g_len, max_seq, dtype,
                kv_client=client, kv_tenant=tenant))
        else:
            local, gen_s = timed(lambda: greedy_generate(
                params, cfg, prompt, g_len, max_seq, dtype))
            remote, rgen_s = timed(lambda: greedy_generate(
                params, cfg, prompt, g_len, max_seq, dtype,
                kv_client=client, kv_seq_id=0, kv_tenant=tenant))
        check(torch.equal(local, remote),
              "greedy tokens through the remote pool differ from local")
        check(kv_pool.allocated == 0, "the handoff left pages in the pool")
        phase("serve handoff", arch=cfg.name, dtype=str(dtype)[6:],
              pages=n_pages,
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

    # 33. the serve driver as a user calls it with no arguments: its
    # default `tiny` (4 q over 2 kv heads of 16), whose prefill takes K6's
    # mma_sync route (head dims 16 and 32) once a layer; decode runs none
    from repro_torch.launch.serve import run as serve_run
    zero_counts()
    tiny_cfg = get_config("tiny")
    served = serve_run("tiny", device=dev)
    phase("serve default", **{k: json.dumps(v) if isinstance(v, list) else v
                              for k, v in served.items()})
    check(served["no_nans"] and served["output_shape"] == [8, 16],
          f"the serve driver's default run: {served}")
    read_counts("serve default", (flash_attention,))
    check(launches["serve default"]["flash_attention.mma_sync"]
          == launches["serve default"]["flash_attention"]
          == tiny_cfg.num_layers,
          f"serve default: K6 launches {launches['serve default']}, want "
          f"{tiny_cfg.num_layers} on mma_sync")

    # the dry-run sweep (27) and phases 28 and 31's meta traces need no
    # card: they run on the host's other cores from here on
    cpu = CpuWork()

    # ---- 18-19. training -------------------------------------------------
    # tinyllama-1.1b at full width, TRAIN_LAYERS deep, f32, batch 4 x 512;
    # the checkpoint goes to a temporary directory, removed after
    import dataclasses
    train_cfg = dataclasses.replace(get_config("tinyllama-1.1b"),
                                    num_layers=TRAIN_LAYERS)
    ckpt_dir = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    try:
        plain_losses, plain_norm = train_phases(
            train_cfg, dev, flash_attention, zero_counts, read_counts,
            ckpt_dir)
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)

    # ---- 26. the multi-process path: two gloo ranks on the one card ------
    # every rank counts its own launches from 0 and returns them
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    path = "multi-process"
    launches[path] = multi_process_phase(
        dev, train_cfg, (plain_losses, plain_norm))
    phase("launches " + path, **launches[path])
    for fn in (systolic_mm, parse_packets, quantize_stream,
               dequantize_stream, flash_attention):
        check(launches[path][fn.__name__] > 0,
              f"{fn.__name__} never launched on the {path} path")

    # ---- 27. the dry-run against the card ---------------------------------
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    zero_counts()
    want = dryrun_phase(dev, cpu)
    read_counts("dryrun", (flash_attention, ssd_scan))
    # each cell ran twice on the card: counted, then timed
    check({k: launches["dryrun"][k] for k in want} == want,
          f"dry-run launches {launches['dryrun']}, want {want}")

    # ---- 28. the reference's bf16 cells --------------------------------
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    zero_counts()
    traces = cpu.traces()
    want = bf16_cells_phase(dev, traces)
    read_counts("bf16 cells", (flash_attention, ssd_scan))
    # each cell ran three times on the card: counted, timed, traced
    check({k: launches["bf16 cells"][k] for k in want} == want,
          f"bf16 cell launches {launches['bf16 cells']}, want {want}")

    # ---- 29. bf16 serving against f32 on the same weights -------------
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    zero_counts()
    bf16_serve_phase(dev, during, (flash_attention, ssd_scan), handoff,
                     ledger)
    read_counts("bf16 serve", (flash_attention, ssd_scan))

    # ---- 30. decode at the cells' length against a prefill -----------
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    zero_counts()
    long_decode_phase(dev, during, (flash_attention, ssd_scan))
    read_counts("bf16 long", (flash_attention, ssd_scan))

    # ---- 31. the reference's train_4k cells, under the blockwise backward --
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    zero_counts()
    blockwise_check_phase(dev)
    read_counts("train 4k check", (flash_attention,))
    torch.cuda.empty_cache()
    zero_counts()
    want, train_4k_full = train_4k_phase(dev, traces)
    read_counts("train 4k cells", (flash_attention, ssd_scan))
    # each cell ran two or three times on the card: counted, timed and
    # (TRAIN_4K_TRACED) traced
    check({k: launches["train 4k cells"][k] for k in want} == want,
          f"train_4k launches {launches['train 4k cells']}, want {want}")
    torch.cuda.empty_cache()
    zero_counts()
    want = train_4k_dots_phase(dev, train_4k_full, traces)
    read_counts("train 4k dots", (flash_attention, ssd_scan))
    check({k: launches["train 4k dots"][k] for k in want} == want,
          f"train_4k dots launches {launches['train 4k dots']}, want "
          f"{want}")

    # ---- 34. MLA over a model axis its heads do not divide ---------------
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    zero_counts()
    want = mla_rows_phase(dev, traces)
    read_counts("mla rows", (flash_attention,))
    check({k: launches["mla rows"][k] for k in want} == want,
          f"mla rows launches {launches['mla rows']}, want {want}")

    # ---- 35. leaves that do not divide the model axis, held whole ---------
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    zero_counts()
    want = whole_leaves_phase(dev, traces)
    read_counts("whole leaves", (flash_attention, ssd_scan))
    check({k: launches["whole leaves"][k] for k in want} == want,
          f"whole leaves launches {launches['whole leaves']}, want {want}")

    # ---- 32. the model axis: four gloo ranks of a (1, 4) mesh on the card --
    # every rank counts its own launches from 0 and returns them; ranks 1-3
    # launch K6 at query offsets above 0, and every rank K7 on its share
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    path = "model axis"
    launches[path] = tp_phase(dev)
    phase("launches " + path, **launches[path])
    check(launches[path]["flash_attention.wgmma_tf32"] > 0,
          f"K6 never launched on the {path} path")
    check(launches[path]["ssd_scan"] > 0,
          f"K7 never launched on the {path} path")

    # ---- 17. launches on the main path -------------------------------------
    # K6's four kernels are recorded apart: flash_attention (mma.sync),
    # flash_attention_sm90 (wgmma, bf16), flash_attention_sm90_tf32
    # (wgmma, f32) and flash_attention_splitkv (split_kv), each with its
    # route's launches
    counts = {name: sum(c[name] for c in launches.values())
              for name in launches["datapath"]}
    phase("kernels", **counts)
    for name, c in counts.items():
        check(c > 0, f"{name} never launched on the main path")
    for name, key in (*((fn.__name__, fn.__name__) for fn in counted
                        if fn is not flash_attention),
                      ("flash_attention", "flash_attention.mma_sync"),
                      ("flash_attention_sm90", "flash_attention.wgmma"),
                      ("flash_attention_sm90_tf32",
                       "flash_attention.wgmma_tf32"),
                      ("flash_attention_splitkv", "flash_attention.split_kv")):
        rec[name]["launches"] = counts[key]
        rec[name]["launches_by_path"] = {
            path: per[key] for path, per in launches.items()}
    rec["flash_attention"]["launches_all_routes"] = counts["flash_attention"]
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

"""Discrete-event timing simulator of the RDMA engine (paper §V + §VI).

Reproduces the measurement methodology of the paper's evaluation:

* single-request: ring SQ doorbell and poll CQ doorbell once per WQE
* batch-requests: post n WQEs, ring once, poll completions once (n=50)

The engine pipeline mirrors §VI-C's explanation: the first WQE fetch over
the PCIe slave bridge takes ~170 cycles (680 ns), subsequent WQEs stream
every ~10 cycles (40 ns), so with batching the steady-state inter-WQE
interval is fetch_next + payload serialization (the fetch and the wire
don't overlap in the engine), while single-requests pay doorbell MMIO +
fetch + CQE + software poll per WQE.

This is the analogue of the paper's JSON-testcase simulation framework
(Fig 7): ``run_testcase`` consumes a JSON testcase and checks simulated
metrics against golden anchors — the paper's own measured numbers.
"""
from __future__ import annotations

import json
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.core.rdma.cost_model import (EXECUTOR_COST, ExecutorCost,
                                              LC_OFFLOAD, LCOffload,
                                              PAPER_HW, PaperHW,
                                              STREAMING_RX, StreamingRX,
                                              jain_fairness_index)


@dataclass(frozen=True)
class SimResult:
    op: str
    payload: int          # bytes per WQE
    batch: int            # WQEs per doorbell
    total_time: float     # seconds for the whole batch
    latency_per_op: float # seconds per WQE (avg)
    throughput_bps: float # payload bits/s

    def as_row(self) -> str:
        return (f"{self.op},{self.payload},{self.batch},"
                f"{self.total_time*1e6:.3f}us,"
                f"{self.latency_per_op*1e9:.1f}ns,"
                f"{self.throughput_bps/1e9:.2f}Gb/s")


def _request_overheads(hw: PaperHW, qp_location: str) -> Dict[str, float]:
    """Fixed per-dispatch cost components. QPs in dev_mem skip the PCIe
    slave-bridge WQE fetch (fetched from on-card DDR instead)."""
    if qp_location == "dev_mem":
        fetch_first, fetch_next = 200e-9, 40e-9
    else:
        fetch_first, fetch_next = hw.wqe_fetch_first, hw.wqe_fetch_next
    return dict(
        doorbell=hw.mmio_write,
        fetch_first=fetch_first,
        fetch_next=fetch_next,
        request_wire=64 / hw.line_rate + hw.wire_prop,
        response_start=hw.resp_process,
        completion=hw.host_access_base + hw.mmio_read + hw.sw_poll_overhead,
    )


def simulate_rdma(op: str, payload: int, batch: int,
                  qp_location: str = "host_mem",
                  hw: PaperHW = PAPER_HW) -> SimResult:
    """Simulate one doorbell covering ``batch`` WQEs of ``payload`` bytes.

    op: 'read' or 'write'. Returns timing metrics.
    """
    o = _request_overheads(hw, qp_location)
    ser = payload / hw.line_rate               # serialization per WQE

    # Read-vs-write asymmetry (§VI-C): payload serialization is identical
    # (it IS the `ser` term of the steady-state interval, whichever
    # direction the bytes flow), the *fixed* costs differ.
    if op == "read":
        # READ is a round trip before the first byte arrives: request
        # packet on the wire + the responder engine's dev-mem read.
        startup = (o["doorbell"] + o["fetch_first"] + o["request_wire"]
                   + o["response_start"])
    elif op == "write":
        # WRITE carries the payload with the request — no request/response
        # round trip; only ACK generation (≈ half the responder
        # processing) remains on the critical path.
        startup = (o["doorbell"] + o["fetch_first"]
                   + 0.5 * o["response_start"])
    else:
        raise ValueError(f"op must be read|write, got {op}")

    # steady-state pipeline: WQE fetch (40 ns) and payload serialization
    # don't overlap in the engine, so each extra WQE costs their sum
    interval = ser + o["fetch_next"]
    # the closing hop is propagation only: the final payload's
    # serialization is already accounted in the last `interval` (reads),
    # and a write's closing ACK is a header-only packet
    wire_back = hw.wire_prop

    if batch <= 1:
        total = startup + ser + wire_back + o["completion"]
        lat = total
    else:
        total = startup + batch * interval + wire_back + o["completion"]
        lat = interval  # per-op latency once the pipe is full (paper Fig 10)

    thr = payload * batch * 8.0 / total
    return SimResult(op, payload, batch, total, lat, thr)


def sweep(op: str, payloads: List[int], batch: int,
          qp_location: str = "host_mem", hw: PaperHW = PAPER_HW
          ) -> List[SimResult]:
    return [simulate_rdma(op, p, batch, qp_location, hw) for p in payloads]


def predict_from_stats(stats: Dict, payload: int, op: str = "write",
                       qp_location: str = "host_mem",
                       hw: PaperHW = PAPER_HW,
                       executor: ExecutorCost = EXECUTOR_COST
                       ) -> Dict[str, float]:
    """Thread an *executed* transport/engine stats surface back through the
    cost model, so simulated and executed batching can be compared.

    ``stats`` is ``transport.stats`` (or ``engine.stats`` — both carry
    ``dispatches``/``doorbells``, ``wqes``, ``compiles``): each dispatch
    pays the fixed doorbell startup, each WQE the steady-state interval.
    Returns the paper-hardware prediction alongside the port-executor
    prediction (dispatch + compile overheads from ``executor``, the H100
    profile by default), both in seconds, plus the effective batch factor
    the executor achieved.
    """
    # engine.stats nests the executor counters under "transport" — use
    # those for executed WQEs/compiles (post-coalesce descriptor counts).
    xstats = stats.get("transport", stats)
    dispatches = stats.get("dispatches", stats.get("doorbells", 0))
    wqes = xstats.get("wqes", 0)
    coalesced = xstats.get("coalesced_wqes", 0)
    o = _request_overheads(hw, qp_location)
    ser = payload / hw.line_rate
    startup = o["doorbell"] + o["fetch_first"] + 0.5 * o["response_start"]
    if op == "read":
        startup = (o["doorbell"] + o["fetch_first"] + o["request_wire"]
                   + o["response_start"])
    hw_time = (dispatches * (startup + hw.wire_prop + o["completion"])
               + wqes * (ser + o["fetch_next"]))
    # QDMA staging terms: each host_write pays the staging dispatch, each
    # new chunk bucket a compile (the descriptor-ized path's whole win).
    qdma_writes = xstats.get("qdma_writes", 0)
    qdma_compiles = xstats.get("qdma_compiles", 0)
    exec_time = (xstats.get("compiles", 0) * executor.compile_s
                 + dispatches * executor.dispatch_s
                 + qdma_compiles * executor.compile_s
                 + qdma_writes * executor.staging_dispatch_s)
    out = {
        "hw_predicted_s": hw_time,
        "executor_predicted_s": exec_time,
        "wqes_per_doorbell": wqes / dispatches if dispatches else 0.0,
        "coalesced_wqes": float(coalesced),
        "interleaved_batches": float(xstats.get("interleaved_batches", 0)),
        "qdma_writes": float(qdma_writes),
        "qdma_compiles": float(qdma_compiles),
    }
    # Streaming-compute terms (§IV-D): RX-ring health and the Lookaside
    # invocation pipeline's overlap ledger, when present.
    rx_pushed = xstats.get("rx_ring_pushed", 0)
    rx_refused = (xstats.get("rx_ring_dropped", 0)
                  + xstats.get("rx_ring_backpressure", 0))
    if rx_pushed or rx_refused:
        out["rx_ring_pushed"] = float(rx_pushed)
        out["rx_ring_consumed"] = float(xstats.get("rx_ring_consumed", 0))
        out["rx_ring_refused"] = float(rx_refused)
        out["rx_ring_refusal_rate"] = rx_refused / (rx_pushed + rx_refused)
        out["rx_ring_peak_occupancy"] = float(
            xstats.get("rx_ring_peak_occupancy", 0))
    lp = stats.get("lc_pipeline") or {}
    if lp.get("tail"):
        out["lc_pipeline_depth"] = float(lp.get("depth", 1))
        out["lc_pipeline_in_flight_peak"] = float(
            lp.get("in_flight_peak", 0))
        out["lc_pipeline_overlapped_flushes"] = float(
            lp.get("overlapped_flushes", 0))
        out["lc_pipeline_credit_waits"] = float(lp.get("credit_waits", 0))
    # Match→action dispatch plane: per-class routing ledger (how the
    # handler mix shares service rounds — mixed rounds are the ones
    # whose operand gathers shared a descriptor table across handlers).
    dp = stats.get("dispatch") or {}
    if dp.get("dispatch_rounds"):
        out["dispatch_rounds"] = float(dp["dispatch_rounds"])
        out["dispatch_mixed_rounds"] = float(
            dp.get("dispatch_mixed_rounds", 0))
        out["dispatch_mixed_share"] = (out["dispatch_mixed_rounds"]
                                       / out["dispatch_rounds"])
        out["dispatch_classes"] = float(len(dp.get("classes", {})))
        for name, ledger in dp.get("classes", {}).items():
            out[f"dispatch_pkts_{name}"] = float(ledger.get("pkts", 0))
    # Service-chain terms: per-chain pipeline ledgers — dataflow_msgs are
    # the inter-stage invocations the finalize hooks enqueued mid-pass
    # (each one a fetch that rode a later SHARED flush instead of its own
    # drain), completion the share of claimed packets whose final stage
    # write-back landed.
    chains = dp.get("chains") or {}
    if chains:
        out["dispatch_chains"] = float(len(chains))
        for name, led in chains.items():
            pkts = led.get("pkts", 0)
            out[f"chain_pkts_{name}"] = float(pkts)
            out[f"chain_stages_{name}"] = float(led.get("stages", 0))
            out[f"chain_stage_invocations_{name}"] = float(
                led.get("stage_invocations", 0))
            out[f"chain_dataflow_msgs_{name}"] = float(
                led.get("dataflow_msgs", 0))
            out[f"chain_completion_{name}"] = (
                led.get("completed_pkts", 0) / pkts if pkts else 0.0)
    # Disaggregated KV serving terms (serve.kv_cache): fetch outcome
    # rates and the migration ledger — a rolled-back page is wire time
    # spent without eviction progress.
    kv = stats.get("kv_serve") or {}
    if kv.get("fetches") or kv.get("migrations"):
        fetches = kv.get("fetches", 0)
        out["kv_fetches"] = float(fetches)
        out["kv_pages_fetched"] = float(kv.get("pages_fetched", 0))
        out["kv_fetch_fail_rate"] = (kv.get("failed", 0) / fetches
                                     if fetches else 0.0)
        out["kv_recoveries"] = float(kv.get("recoveries", 0))
        out["kv_pages_migrated"] = float(kv.get("pages_migrated", 0))
        out["kv_pages_rolled_back"] = float(
            kv.get("pages_rolled_back", 0))
        out["kv_fetch_wire_s"] = kv.get("posted_words", 0) * 4 \
            / hw.line_rate
    # Collective terms (train.collectives): gradient-bucket all-reduce
    # wire/reduce time and the overlap ledger — overlapped flushes are
    # doorbell startups amortized across in-flight buckets.
    col = stats.get("collectives") or {}
    if col.get("rounds"):
        out["collective_rounds"] = float(col["rounds"])
        out["collective_buckets"] = float(col.get("buckets", 0))
        out["collective_wire_bytes"] = float(col.get("wire_bytes", 0))
        out["collective_wire_s"] = col.get("wire_bytes", 0) / hw.line_rate
        out["collective_reduce_s"] = (
            col.get("reduce_words", 0) * 4 * 2.0 / hw.pcie_rate)
        fl = col.get("flushes", 0)
        out["collective_flushes"] = float(fl)
        out["collective_overlap_fraction"] = (
            col.get("overlapped_flushes", 0) / fl if fl else 0.0)
        exec_time += out["collective_wire_s"] + out["collective_reduce_s"]
        out["executor_predicted_s"] = exec_time
    # Reliability terms: with the lossy-fabric layer active, every
    # retransmit re-pays the steady-state WQE interval (wasted wire
    # time), RNR backoff idles the engine for modeled µs, and shed
    # packets are load deliberately refused at the MAC. goodput_fraction
    # is the share of executed WQE slots that carried FIRST deliveries.
    rel = stats.get("reliability") or {}
    if rel.get("psn_assigned"):
        retx = rel.get("retransmits", 0)
        delivered = rel.get("acks", 0)
        out["retransmits"] = float(retx)
        out["reliability_naks"] = float(rel.get("naks", 0)
                                        + rel.get("rnr_naks", 0))
        out["reliability_timeouts"] = float(rel.get("timeouts", 0))
        out["goodput_fraction"] = (delivered / (delivered + retx)
                                   if delivered + retx else 1.0)
        out["retx_overhead_s"] = retx * (ser + o["fetch_next"])
        out["rnr_backoff_s"] = rel.get("backoff_us", 0.0) * 1e-6
        out["shed_pkts"] = float(rel.get("shed", 0))
        out["qp_errors"] = float(rel.get("qp_errors", 0))
        exec_time += out["retx_overhead_s"] + out["rnr_backoff_s"]
        out["executor_predicted_s"] = exec_time
    # Fairness term: engine.stats carries the per-QP service ledger.
    qp_service = stats.get("qp_service")
    if qp_service:
        out["service_jain_index"] = jain_fairness_index(qp_service.values())
        # LC-vs-host contention: Lookaside kernels are clients of the SAME
        # engine, so every WQE they burn is a steady-state interval the
        # host traffic waits out. lc_share is the engine fraction spent on
        # compute-block QPs; lc_contention_s the absolute engine time;
        # host_jain_index the fairness among host QPs only (an LC stream
        # must not skew service between host QPs); host_slowdown_from_lc
        # the service-rate dilution the host sees from sharing.
        lc_service = stats.get("lc_service") or {}
        if lc_service:
            lc_wqes = sum(lc_service.values())
            total = sum(qp_service.values())
            host = {q: n for q, n in qp_service.items()
                    if q not in lc_service}
            out["lc_wqes"] = float(lc_wqes)
            out["lc_share"] = lc_wqes / total if total else 0.0
            out["lc_contention_s"] = lc_wqes * (ser + o["fetch_next"])
            if host:
                out["host_jain_index"] = jain_fairness_index(host.values())
                out["host_slowdown_from_lc"] = (
                    total / max(1, total - lc_wqes))
    # Self-tuning terms (rdma.autotune): the online bucket learner's
    # decay/merge/size ledger, and — when a knob sweep ran — the chosen
    # point vs the hand-picked defaults on the modeled flush throughput
    # (improvement >= 1.0 by construction: the default is in the grid).
    if (xstats.get("learned_buckets") or xstats.get("bucket_merges")
            or xstats.get("bucket_decay_events")):
        out["learned_buckets"] = float(xstats.get("learned_buckets", 0))
        out["bucket_merges"] = float(xstats.get("bucket_merges", 0))
        out["bucket_decay_events"] = float(
            xstats.get("bucket_decay_events", 0))
    at = stats.get("autotune") or {}
    if at.get("trials"):
        out["autotune_trials"] = float(at["trials"])
        out["autotune_score"] = float(at.get("score", 0.0))
        out["autotune_default_score"] = float(
            at.get("default_score", 0.0))
        out["autotune_improvement"] = float(at.get("improvement", 1.0))
        chosen = at.get("chosen") or {}
        for knob in ("ring_burst", "pipeline_depth"):
            out[f"autotune_chosen_{knob}"] = float(chosen.get(knob) or 0)
    return out


def doorbell_flush_time(served_wqes: int, payload: int,
                        qp_location: str = "host_mem",
                        hw: PaperHW = PAPER_HW) -> float:
    """Model time (seconds) for ONE budgeted engine flush on the paper's
    write path: fixed doorbell startup + completion poll per dispatch,
    plus the steady-state interval per served WQE. Shared by
    ``simulate_fair_schedule`` and ``autotune.modeled_flush_seconds`` so
    the golden traces and the tuner's score can never disagree on the
    flush model."""
    o = _request_overheads(hw, qp_location)
    interval = payload / hw.line_rate + o["fetch_next"]
    startup = o["doorbell"] + o["fetch_first"] + 0.5 * o["response_start"]
    return startup + served_wqes * interval + hw.wire_prop + o["completion"]


def simulate_fair_schedule(qp_depths: Sequence[int],
                           scheduler: str = "rr",
                           weights: Optional[Sequence[int]] = None,
                           budget: int = 16, payload: int = 4096,
                           qp_location: str = "host_mem",
                           hw: PaperHW = PAPER_HW,
                           promote_after: Optional[int] = None) -> Dict:
    """Discrete-event model of the multi-QP doorbell scheduler.

    ``qp_depths[i]`` WQEs are armed on QP *i*; the engine serves at most
    ``budget`` WQEs per flush, picked by the *real* ``schedule_plan``
    policy (rr / weighted-rr / drr / fifo — the golden traces exercise
    exactly the production scheduler, not a re-implementation; one
    scheduler state dict persists across flushes, so drr deficits/rotor
    and fifo ages behave exactly as in the engine). Each flush is one
    doorbell batch on the paper's write path: fixed startup + completion
    poll, plus the steady-state per-WQE interval for every served WQE.

    Returns per-QP service shares of the first (fully contended) flush,
    per-QP completion times, their spread, Jain's fairness index of the
    first flush, and the flush count — the quantities the fairness golden
    traces pin.
    """
    from repro_torch.core.rdma.doorbell import schedule_plan

    if budget <= 0:
        raise ValueError(f"budget must be positive, got {budget}")
    n = len(qp_depths)
    wmap = ({i: int(w) for i, w in enumerate(weights)} if weights else {})
    remaining = [int(d) for d in qp_depths]
    completion = [0.0] * n
    first_flush_counts: Optional[List[int]] = None
    t, flushes = 0.0, 0
    state: Dict = {}                    # persists across flushes
    while any(remaining):
        windows = [(i, tuple(range(remaining[i])))
                   for i in range(n) if remaining[i]]
        _, counts = schedule_plan(windows, scheduler=scheduler,
                                  weights=wmap, budget=budget,
                                  state=state, promote_after=promote_after)
        served = sum(counts.values())
        flushes += 1
        if first_flush_counts is None:
            first_flush_counts = [counts.get(i, 0) for i in range(n)]
        t += doorbell_flush_time(served, payload, qp_location, hw)
        for i, c in counts.items():
            if c:
                remaining[i] -= c
                if remaining[i] == 0:
                    completion[i] = t

    if first_flush_counts is None:      # nothing to schedule at all
        first_flush_counts = [0] * n
    served1 = max(1, sum(first_flush_counts))
    return {
        "first_flush_shares": [c / served1 for c in first_flush_counts],
        "completion_us": [c * 1e6 for c in completion],
        "completion_spread_us": (max(completion) - min(completion)) * 1e6,
        "makespan_us": t * 1e6,
        "jain_index": jain_fairness_index(first_flush_counts),
        "flushes": flushes,
    }


def simulate_lc_offload(m: int, k: int, n: int, elem_bytes: int = 4,
                        qp_location: str = "dev_mem",
                        hw: PaperHW = PAPER_HW,
                        lc: LCOffload = LC_OFFLOAD) -> Dict[str, float]:
    """Model one offloaded (M,K)x(K,N) matmul vs the host-staged baseline.

    Offloaded (paper §IV-C): the Lookaside kernel RDMA-reads A and B from
    the remote peer in ``chunk_bytes`` WQEs (one batched doorbell),
    computes on the NIC's systolic array, and RDMA-writes C back — bytes
    cross the wire once and never touch PCIe.

    Host-staged: the same wire transfers land in dev_mem, but the host
    must QDMA the operands over PCIe into host RAM, compute on the CPU,
    and QDMA the result back before the write-back — every byte moves
    twice (wire + PCIe), which is exactly the copy the shared-engine
    design eliminates.
    """
    a_b, b_b, c_b = m * k * elem_bytes, k * n * elem_bytes, m * n * elem_bytes
    chunk = lc.chunk_bytes
    rd_wqes = max(1, -(-(a_b + b_b) // chunk))
    wr_wqes = max(1, -(-c_b // chunk))
    rd = simulate_rdma("read", chunk, rd_wqes, qp_location, hw).total_time
    wr = simulate_rdma("write", chunk, wr_wqes, qp_location, hw).total_time
    flops = 2.0 * m * k * n
    offload = rd + flops / lc.systolic_flops + wr
    dma_in = (a_b + b_b) / simulate_dma(a_b + b_b, hw=hw)
    dma_out = c_b / simulate_dma(c_b, hw=hw)
    host = rd + dma_in + flops / lc.host_mm_flops + dma_out + wr
    wire = float(a_b + b_b + c_b)
    return {
        "offload_latency_us": offload * 1e6,
        "host_latency_us": host * 1e6,
        "offload_speedup": host / offload,
        "wire_bytes": wire,
        "offload_pcie_bytes": 0.0,
        "host_pcie_bytes": wire,
        "offload_bytes_moved": wire,
        "host_bytes_moved": 2.0 * wire,
        "bytes_moved_ratio": 2.0,
        "read_wqes": float(rd_wqes),
        "write_wqes": float(wr_wqes),
    }


def simulate_streaming_rx(n_pkts: int, burst: int = 32,
                          pipeline_depth: int = 4,
                          qp_location: str = "dev_mem",
                          hw: PaperHW = PAPER_HW,
                          srx: StreamingRX = STREAMING_RX
                          ) -> Dict[str, float]:
    """Model the §IV-D streaming-compute datapath three ways.

    *ControlMsg batches* (the Lookaside ControlMsg path): the host
    dispatches one ControlMsg per ``burst`` packets — every burst pays the
    doorbell MMIO, a READ round trip for the operand fetch, the parse, a
    write-back dispatch, and the host's CQ/status poll.

    *RX ring, serial*: packets already sit in the device-resident ring
    (landed off the MAC), so a burst costs only the on-card descriptor
    gather, the parse, the meta write-back, and a status-FIFO push — no
    per-invocation host round trip.

    *RX ring, pipelined*: invocation *i+1*'s gather overlaps invocation
    *i*'s parse (the LookasideBlock double-buffer), so the steady-state
    interval is ``max(move, parse)`` instead of their sum.

    Latency outputs model a fully backlogged ring (the bench pushes the
    whole stream, then drains): the p99 ring-to-status latency is the
    LAST burst's — it waits out every earlier burst's service, so p99 ≈
    stream makespan, exactly what the executed pow2-µs histogram shows.
    Throughputs are packets/s over the whole stream.
    """
    if n_pkts <= 0 or burst <= 0:
        raise ValueError((n_pkts, burst))
    o = _request_overheads(hw, qp_location)
    n_bursts = -(-n_pkts // burst)
    data = burst * srx.slot_bytes / hw.line_rate
    meta = burst * srx.meta_bytes / hw.line_rate
    parse = burst * srx.parse_per_pkt_s

    # ControlMsg burst: doorbell + READ round trip + data, then the
    # write-back dispatch and the software status poll.
    ctrl_burst = (o["doorbell"] + o["fetch_first"] + o["request_wire"]
                  + o["response_start"] + data + hw.wire_prop
                  + parse
                  + o["doorbell"] + o["fetch_first"] + meta
                  + 0.5 * o["response_start"] + hw.wire_prop
                  + o["completion"])
    # Ring burst: on-card gather (descriptor fetch + data) + parse +
    # meta write-back + status FIFO; no MMIO, no software poll.
    move = (o["fetch_first"] + data) + (o["fetch_next"] + meta)
    ring_burst = move + parse + srx.status_fifo_s
    interval = max(move, parse + srx.status_fifo_s)
    ctrl_total = n_bursts * ctrl_burst
    serial_total = n_bursts * ring_burst
    if pipeline_depth >= 2:
        # pipeline fill (first gather) + steady intervals + last parse
        pipe_total = (move + (n_bursts - 1) * interval + parse
                      + srx.status_fifo_s)
    else:
        # depth 1 IS the serial path — no overlap to model
        pipe_total = serial_total
    out = {
        "bursts": float(n_bursts),
        "ctrl_pkts_per_s": n_pkts / ctrl_total,
        "ring_serial_pkts_per_s": n_pkts / serial_total,
        "ring_pipelined_pkts_per_s": n_pkts / pipe_total,
        "ring_speedup_vs_ctrl": ctrl_total / serial_total,
        "pipeline_speedup": serial_total / pipe_total,
        "ctrl_p99_us": ctrl_total * 1e6,
        "ring_serial_p99_us": serial_total * 1e6,
        "ring_pipelined_p99_us": pipe_total * 1e6,
    }
    return out


def simulate_dispatch(n_pkts: int, shares: Sequence[float] = (0.5, 0.5),
                      burst: int = 32, pipeline_depth: int = 4,
                      qp_location: str = "dev_mem",
                      hw: PaperHW = PAPER_HW,
                      srx: StreamingRX = STREAMING_RX) -> Dict[str, float]:
    """Model the match→action dispatch plane: one MIXED-class RX ring
    whose per-round handler sub-bursts share a flush, vs N SEPARATE
    single-class rings each drained independently (the single-class ring
    shape per class — what you'd build without a dispatch plane).

    ``shares`` splits ``n_pkts`` across the handler classes. Mixed: each
    service round runs one sub-burst per backlogged class; the round's
    operand gathers execute as ONE descriptor table, so the fixed
    per-flush engine cost (first WQE fetch) is paid once per ROUND, and
    with ``pipeline_depth >= 2`` round *i+1*'s gather overlaps round
    *i*'s compute. Split: every class pays its own per-round fixed costs
    and pipeline fill — flushes scale with the number of rings.

    The flush counts are the deterministic quantities the benchmark
    pins: a mixed stream of C backlogged classes takes ``rounds + 1``
    flushes (one shared fetch table per round + the trailing write-back)
    where the split layout takes ``sum_i (rounds_i + 1)`` — and a
    single-class mix (C = 1) reduces exactly to the single-class
    pipelined ring's count (flush-count parity).
    """
    if n_pkts <= 0 or burst <= 0 or not shares:
        raise ValueError((n_pkts, burst, shares))
    total = float(sum(shares))
    # largest-remainder apportionment: floors + extras to the biggest
    # fractional parts, so counts always sum to n_pkts and never go
    # negative however skewed the shares are
    raw = [s / total * n_pkts for s in shares]
    counts = [int(c) for c in raw]
    order = sorted(range(len(shares)), key=lambda i: raw[i] - counts[i],
                   reverse=True)
    for j in range(n_pkts - sum(counts)):
        counts[order[j % len(counts)]] += 1
    counts = [c for c in counts if c > 0]
    assert sum(counts) == n_pkts, (counts, n_pkts)
    o = _request_overheads(hw, qp_location)

    def per_burst(n_burst: int) -> Tuple[float, float]:
        """(gather+writeback move, compute) seconds of one sub-burst."""
        data = n_burst * srx.slot_bytes / hw.line_rate
        meta = n_burst * srx.meta_bytes / hw.line_rate
        move = (o["fetch_next"] + data) + (o["fetch_next"] + meta)
        compute = n_burst * srx.parse_per_pkt_s + srx.status_fifo_s
        return move, compute

    # -- mixed: one ring, per-round sub-bursts share the flush ----------
    rounds_per_class = [-(-c // burst) for c in counts]
    rounds = max(rounds_per_class)
    mixed_flushes = rounds + 1           # + trailing write-back flush
    left = list(counts)
    round_costs = []                     # (move, compute) per round
    for _ in range(rounds):
        move = o["fetch_first"]          # ONE shared descriptor fetch
        compute = 0.0
        for i, c in enumerate(left):
            if c <= 0:
                continue
            b = min(c, burst)
            m, cp = per_burst(b)
            move += m
            compute += cp
            left[i] = c - b
        round_costs.append((move, compute))
    if pipeline_depth >= 2:              # gather i+1 overlaps compute i
        mixed_total = round_costs[0][0]
        for (m, _), (_, cp_prev) in zip(round_costs[1:], round_costs):
            mixed_total += max(m, cp_prev)
        mixed_total += round_costs[-1][1]
    else:
        mixed_total = sum(m + cp for m, cp in round_costs)

    # -- split: one single-class ring per class, drained independently --
    split_total = 0.0
    split_flushes = 0
    for c, r in zip(counts, rounds_per_class):
        split_flushes += r + 1
        bursts = [min(burst, c - j * burst) for j in range(r)]
        costs = [(o["fetch_first"] + per_burst(b)[0], per_burst(b)[1])
                 for b in bursts]
        if pipeline_depth >= 2:
            t = costs[0][0]
            for (m, _), (_, cp_prev) in zip(costs[1:], costs):
                t += max(m, cp_prev)
            t += costs[-1][1]
        else:
            t = sum(m + cp for m, cp in costs)
        split_total += t

    return {
        "classes": float(len(counts)),
        "rounds": float(rounds),
        "mixed_flushes": float(mixed_flushes),
        "split_flushes": float(split_flushes),
        "flush_ratio": split_flushes / mixed_flushes,
        "mixed_pkts_per_s": n_pkts / mixed_total,
        "split_pkts_per_s": n_pkts / split_total,
        "mixed_speedup_vs_split": split_total / mixed_total,
        "mixed_p99_us": mixed_total * 1e6,
        "split_p99_us": split_total * 1e6,
    }


def simulate_chain(n_pkts: int, rows: Sequence[int] = (64, 65, 2),
                   burst: int = 32, pipeline_depth: int = 4,
                   qp_location: str = "dev_mem", hw: PaperHW = PAPER_HW,
                   srx: StreamingRX = STREAMING_RX) -> Dict[str, float]:
    """Model a service CHAIN (BALBOA-style kernel pipeline) on the
    dispatch plane vs the staged-serial alternative.

    ``rows`` gives the row geometry at each stage boundary in words:
    ``rows[s]`` is stage *s*'s input row width, ``rows[s + 1]`` its
    output row width — so ``len(rows) - 1`` stages. CHAINED: stage *s*'s
    write-back region is stage *s+1*'s fetch source, every stage's
    gathers riding the shared descriptor tables of ONE grouped service
    pass — B = ceil(n/burst) stage-0 bursts and S stages pipeline
    systolically through roughly ``B + 2S`` flushes (burst *b*'s stage
    *s+1* fetch shares a flush with burst *b+1*'s stage *s* work).
    STAGED-SERIAL: each stage is its own single-class drain — every
    stage pays its own per-burst fetch flushes and trailing write-back,
    ``S * (B + 1)`` flushes and no cross-stage overlap.

    The flush counts are the deterministic quantities a chain benchmark
    pins; the throughput/latency numbers thread the paper-hardware cost
    model (wire serialization per row word, per-row stage compute from
    the streaming-RX profile)."""
    if n_pkts <= 0 or burst <= 0 or len(rows) < 2:
        raise ValueError((n_pkts, burst, rows))
    n_stages = len(rows) - 1
    n_bursts = -(-n_pkts // burst)
    bursts = [min(burst, n_pkts - j * burst) for j in range(n_bursts)]
    o = _request_overheads(hw, qp_location)

    def cell(s: int, b: int) -> Tuple[float, float]:
        """(move, compute) seconds of stage ``s`` on a ``b``-row burst."""
        move = (o["fetch_next"] + b * rows[s] * 4 / hw.line_rate
                + o["fetch_next"] + b * rows[s + 1] * 4 / hw.line_rate)
        compute = b * srx.parse_per_pkt_s + srx.status_fifo_s
        return move, compute

    chained_flushes = n_bursts + 2 * n_stages
    staged_flushes = n_stages * (n_bursts + 1)

    # chained: systolic ticks — at tick t, stage s works burst t - s, all
    # active cells sharing the tick's flush (pipeline_depth >= 2 overlaps
    # them; a depth-1 block serializes every cell)
    if pipeline_depth >= 2:
        chained_total = o["fetch_first"]
        for t in range(n_bursts + n_stages - 1):
            active = [sum(cell(s, bursts[t - s])) for s in range(n_stages)
                      if 0 <= t - s < n_bursts]
            chained_total += max(active)
    else:
        chained_total = o["fetch_first"] + sum(
            sum(cell(s, b)) for s in range(n_stages) for b in bursts)

    # staged-serial: per-stage independent drains (the single-class
    # shape of ``simulate_dispatch``), summed — no cross-stage overlap
    staged_total = 0.0
    for s in range(n_stages):
        costs = [(o["fetch_first"] + cell(s, b)[0], cell(s, b)[1])
                 for b in bursts]
        if pipeline_depth >= 2:
            t = costs[0][0]
            for (m, _), (_, cp_prev) in zip(costs[1:], costs):
                t += max(m, cp_prev)
            t += costs[-1][1]
        else:
            t = sum(m + cp for m, cp in costs)
        staged_total += t

    return {
        "stages": float(n_stages),
        "bursts": float(n_bursts),
        "chained_flushes": float(chained_flushes),
        "staged_flushes": float(staged_flushes),
        "flush_ratio": staged_flushes / chained_flushes,
        "chained_pkts_per_s": n_pkts / chained_total,
        "staged_pkts_per_s": n_pkts / staged_total,
        "chained_speedup_vs_staged": staged_total / chained_total,
        "chained_p99_us": chained_total * 1e6,
        "staged_p99_us": staged_total * 1e6,
    }


def simulate_collective(payload: int, n_peers: int, algorithm: str = "ring",
                        n_buckets: int = 1, pipeline_depth: int = 2,
                        qp_location: str = "dev_mem",
                        hw: PaperHW = PAPER_HW) -> Dict[str, float]:
    """α–β model of a gradient-bucket all-reduce over the flush engine.

    ``payload`` is the full per-peer gradient size in bytes, split evenly
    over ``n_buckets`` buckets. Each collective round is ONE engine flush
    (every peer posts its chunk READ deferred, one doorbell serves them
    all — the dense descriptor mix), so a round costs
    ``doorbell_flush_time(wqes, chunk)``; reduce rounds additionally pay
    the host round-trip for the arriving chunk (read + write-back over
    PCIe). Pipelining overlaps up to ``pipeline_depth`` buckets: their
    same-numbered rounds share a single flush, amortizing the doorbell
    startup exactly as ``train.collectives`` does with ``defer=True``.

    Mirrors ``repro_torch.train.collectives.RDMACollective`` round for
    round:
    ring = (n-1) reduce-scatter + (n-1) all-gather rounds of P/n chunks;
    recursive doubling = fold + log2(m) XOR + bcast rounds of the full
    vector (m = largest power of two <= n).
    """
    assert n_peers >= 1 and n_buckets >= 1 and pipeline_depth >= 1
    bkt = payload / n_buckets
    # per-bucket round structure: (wqes_in_flush, xfer_bytes, reduce_bytes)
    rounds_: List[Tuple[int, float, float]] = []
    if n_peers == 1:
        pass
    elif algorithm == "ring":
        chunk = bkt / n_peers
        rounds_ += [(n_peers, chunk, chunk)] * (n_peers - 1)   # RS
        rounds_ += [(n_peers, chunk, 0.0)] * (n_peers - 1)     # AG
    elif algorithm == "rd":
        m = 1
        while m * 2 <= n_peers:
            m *= 2
        extras = n_peers - m
        if extras:
            rounds_.append((extras, bkt, bkt))                 # fold
        k = m
        while k > 1:
            rounds_.append((m, bkt, bkt))                      # XOR
            k //= 2
        if extras:
            rounds_.append((extras, bkt, 0.0))                 # bcast
    else:
        raise ValueError(algorithm)
    n_rounds = len(rounds_)
    wire_bytes = n_buckets * sum(w * b for w, b, _ in rounds_)

    def _round_time(group: int, wqes: int, xfer: float, red: float):
        return (doorbell_flush_time(group * wqes, xfer, qp_location, hw)
                + group * 2.0 * red / hw.pcie_rate)

    serial = n_buckets * sum(_round_time(1, w, b, r) for w, b, r in rounds_)
    # pipelined: buckets advance in windows of pipeline_depth; each tick
    # is one flush serving every in-flight bucket's current round
    pipelined, ticks, overlapped = 0.0, 0, 0
    done = 0
    while done < n_buckets:
        group = min(pipeline_depth, n_buckets - done)
        for w, b, r in rounds_:
            pipelined += _round_time(group, w, b, r)
            ticks += 1
            overlapped += group > 1
        done += group
    return {
        "algorithm": algorithm,
        "rounds": n_rounds,
        "wire_bytes": wire_bytes,
        "per_peer_wire_bytes": wire_bytes / max(1, n_peers),
        "serial_us": serial * 1e6,
        "pipelined_us": pipelined * 1e6,
        "pipeline_speedup": serial / pipelined if pipelined else 1.0,
        "overlap_fraction": overlapped / ticks if ticks else 0.0,
    }


def simulate_dma(nbytes: int, direction: str = "read",
                 hw: PaperHW = PAPER_HW) -> float:
    """§VI-B.1: host<->dev_mem DMA throughput over QDMA AXI4-MM (bytes/s)."""
    del direction  # read/write symmetric at 13.00/13.07 GB/s in the paper
    setup = 2e-6
    t = setup + nbytes / hw.pcie_rate
    return nbytes / t


def simulate_host_access(nbytes: int, hw: PaperHW = PAPER_HW) -> float:
    """§VI-B.2 / Fig 8: FPGA-master access latency to host memory."""
    return hw.host_access_latency(nbytes)


# ---------------------------------------------------------------------------
# JSON testcase framework (paper §V analogue of run_testcase.py)
# ---------------------------------------------------------------------------

def run_testcase(path_or_dict) -> Dict:
    """Run one JSON testcase and verify golden anchors.

    Testcase schema::

      {"name": str, "op": "read"|"write"|"dma"|"host_access"
                          |"fair_schedule"|"lc_offload"|"streaming_rx"
                          |"dispatch"|"chain"|"collective",
       "payload": int, "batch": int, "qp_location": "host_mem"|"dev_mem",
       "golden": {"throughput_gbps": float | null,
                  "latency_us": float | null,
                  "rtol": float}}

    ``fair_schedule`` testcases (the multi-QP scheduler golden traces)
    instead carry ``qp_depths`` (list), optional ``weights`` (list),
    ``scheduler`` ("rr"|"drr"|"fifo"), ``budget`` and optional
    ``promote_after``, and may pin any produced metric in ``golden`` —
    scalars with relative tolerance, lists (e.g. ``first_flush_shares``)
    elementwise, ints exactly.

    ``lc_offload`` testcases carry ``m``/``k``/``n`` (matmul dims, plus
    optional ``elem_bytes``/``qp_location``) and pin the offloaded-vs-
    host-staged latency and bytes-moved metrics of
    ``simulate_lc_offload``.

    ``streaming_rx`` testcases carry ``n_pkts``/``burst`` (and optional
    ``pipeline_depth``/``qp_location``) and pin the ControlMsg-vs-ring
    and serial-vs-pipelined throughput/latency metrics of
    ``simulate_streaming_rx``.

    ``dispatch`` testcases carry ``n_pkts``/``shares`` (per-class packet
    shares, plus optional ``burst``/``pipeline_depth``/``qp_location``)
    and pin the mixed-ring-vs-split-rings flush and throughput metrics
    of ``simulate_dispatch``.

    ``chain`` testcases carry ``n_pkts``/``rows`` (row words at each
    stage boundary, plus optional ``burst``/``pipeline_depth``/
    ``qp_location``) and pin the chained-vs-staged-serial flush and
    throughput metrics of ``simulate_chain``.

    ``collective`` testcases carry ``payload``/``n_peers`` (plus optional
    ``algorithm``/``n_buckets``/``pipeline_depth``/``qp_location``) and
    pin the ring / recursive-doubling all-reduce wire-bytes and
    serial-vs-pipelined round metrics of ``simulate_collective``.
    """
    tc = (json.load(open(path_or_dict)) if isinstance(path_or_dict, str)
          else path_or_dict)
    op = tc["op"]
    golden = tc.get("golden", {})
    rtol = golden.get("rtol", 0.15)
    out = {"name": tc.get("name", "?"), "pass": True, "checks": []}

    if op in ("read", "write"):
        r = simulate_rdma(op, tc["payload"], tc.get("batch", 1),
                          tc.get("qp_location", "host_mem"))
        out["throughput_gbps"] = r.throughput_bps / 1e9
        out["latency_us"] = r.latency_per_op * 1e6
    elif op == "dma":
        out["throughput_gbps"] = simulate_dma(tc["payload"]) * 8 / 1e9
        out["latency_us"] = tc["payload"] / simulate_dma(tc["payload"]) * 1e6
    elif op == "host_access":
        out["latency_us"] = simulate_host_access(tc["payload"]) * 1e6
        out["throughput_gbps"] = tc["payload"] * 8 / (
            simulate_host_access(tc["payload"]) * 1e9)
    elif op == "fair_schedule":
        r = simulate_fair_schedule(
            tc["qp_depths"], scheduler=tc.get("scheduler", "rr"),
            weights=tc.get("weights"), budget=tc.get("budget", 16),
            payload=tc.get("payload", 4096),
            qp_location=tc.get("qp_location", "host_mem"),
            promote_after=tc.get("promote_after"))
        out.update(r)
        out["latency_us"] = r["makespan_us"]
    elif op == "lc_offload":
        r = simulate_lc_offload(
            tc["m"], tc["k"], tc["n"],
            elem_bytes=tc.get("elem_bytes", 4),
            qp_location=tc.get("qp_location", "dev_mem"))
        out.update(r)
        out["latency_us"] = r["offload_latency_us"]
    elif op == "streaming_rx":
        r = simulate_streaming_rx(
            tc["n_pkts"], burst=tc.get("burst", 32),
            pipeline_depth=tc.get("pipeline_depth", 4),
            qp_location=tc.get("qp_location", "dev_mem"))
        out.update(r)
        out["latency_us"] = r["ring_pipelined_p99_us"]
    elif op == "dispatch":
        r = simulate_dispatch(
            tc["n_pkts"], shares=tc.get("shares", (0.5, 0.5)),
            burst=tc.get("burst", 32),
            pipeline_depth=tc.get("pipeline_depth", 4),
            qp_location=tc.get("qp_location", "dev_mem"))
        out.update(r)
        out["latency_us"] = r["mixed_p99_us"]
    elif op == "chain":
        r = simulate_chain(
            tc["n_pkts"], rows=tc.get("rows", (64, 65, 2)),
            burst=tc.get("burst", 32),
            pipeline_depth=tc.get("pipeline_depth", 4),
            qp_location=tc.get("qp_location", "dev_mem"))
        out.update(r)
        out["latency_us"] = r["chained_p99_us"]
    elif op == "collective":
        r = simulate_collective(
            tc["payload"], tc["n_peers"],
            algorithm=tc.get("algorithm", "ring"),
            n_buckets=tc.get("n_buckets", 1),
            pipeline_depth=tc.get("pipeline_depth", 2),
            qp_location=tc.get("qp_location", "dev_mem"))
        out.update(r)
        out["latency_us"] = r["pipelined_us"]
    else:
        raise ValueError(op)

    def _close(got, want):
        if isinstance(want, int) and not isinstance(want, bool):
            return got == want
        return abs(got - want) <= rtol * max(abs(want), 1e-12)

    for key, want in golden.items():
        if key == "rtol" or want is None:
            continue
        got = out.get(key)
        if got is None:                 # typo'd / op-mismatched golden key
            ok = False
        elif isinstance(want, list):
            ok = (isinstance(got, list) and len(got) == len(want)
                  and all(_close(g, w) for g, w in zip(got, want)))
        else:
            ok = _close(got, want)
        out["checks"].append((key, want, got, ok))
        out["pass"] &= ok
    return out

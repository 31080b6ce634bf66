"""Self-tuning transport: online bucket learning + knob auto-sweep.

``TransportTuning`` holds every hand-picked transport/datapath knob as
one value; the engine, the Lookaside block and the streaming dispatch
plane read their defaults from it.

1. **Online bucket learner** (``BucketLearner``) — the transport's
   decaying (slots, chunk) histogram: every dispatch observes its shape
   bucket, buckets the traffic stopped using age out
   (``bucket_decay_events``), and pow2-adjacent buckets merge into one
   widened span (``bucket_merges``). ``transport.prewarm()`` with no
   arguments reads its prediction. The counters are host bookkeeping and
   match the JAX package's ledger under the same traffic.

2. **Deterministic auto-sweep tuner** (``AutoTuner``) — a seeded
   coordinate sweep over ``TuningGrid``: each candidate runs one trial
   on a scratch engine on the live engine's device (host READs plus
   Lookaside streaming bursts through the real flush path and its
   descriptor executor), and the measured flush/WQE counts are priced by
   the paper-hardware flush model (``modeled_flush_seconds``). Counts are
   deterministic for a fixed seed, so the chosen point is the same on
   every run and on every device — wall-clocks are recorded for
   information but never drive the choice. The chosen point and the
   full sweep surface land in ``engine.stats["autotune"]`` and thread
   into ``simulator.predict_from_stats`` as ``autotune_*`` terms.
"""
from __future__ import annotations

import time
from dataclasses import asdict, dataclass, replace
from typing import Dict, List, Optional, Tuple

from repro_torch._device import numpy_dtype
from repro_torch.core.rdma.cost_model import EXECUTOR_COST, ExecutorCost
from repro_torch.core.rdma.simulator import doorbell_flush_time


# ---------------------------------------------------------------------------
# The one knob surface
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class TransportTuning:
    """Every hand-picked transport/datapath knob as one value.

    Defaults are the repo's historical literals (the hand-picked
    configuration every bench baseline was recorded with):

    * ``ring_burst``     — packets claimed per streaming invocation
                           (``LCKernel.ring_burst`` / ``StreamDispatcher``)
    * ``pipeline_depth`` — lookaside multi-invocation pipeline depth
                           (``LookasideBlock``)
    * ``flush_budget``   — WQEs executed per engine flush (None = drain)
    * ``qp_window``      — per-QP WQE cap per flush (None = budget only);
                           bounds how much one deep SQ contributes to a
                           single descriptor table
    * ``rx_depth``       — RX ring depth in slots (``RXRing``); a layout
                           knob consolidated here but not swept (changing
                           it mid-stream would drop in-flight slots)
    """
    ring_burst: int = 32
    pipeline_depth: int = 1
    flush_budget: Optional[int] = None
    qp_window: Optional[int] = None
    rx_depth: int = 64

    def key(self) -> Tuple:
        """Hashable identity of the swept knobs (rx_depth excluded)."""
        return (self.ring_burst, self.pipeline_depth, self.flush_budget,
                self.qp_window)

    def as_dict(self) -> Dict:
        return asdict(self)


@dataclass(frozen=True)
class TuningGrid:
    """Candidate values per swept knob. Every grid axis must contain the
    hand-picked default (it does), so the coordinate sweep's score is
    monotone non-decreasing from the default point — tuned >= hand-picked
    by construction, not by luck."""
    ring_burst: Tuple[int, ...] = (8, 16, 32, 64)
    pipeline_depth: Tuple[int, ...] = (1, 2, 4)
    flush_budget: Tuple[Optional[int], ...] = (None, 8, 16, 32)
    qp_window: Tuple[Optional[int], ...] = (None, 4, 8, 16)

    KNOBS = ("ring_burst", "pipeline_depth", "flush_budget", "qp_window")


# ---------------------------------------------------------------------------
# Online bucket learner
# ---------------------------------------------------------------------------

class _Span:
    """One learned bucket span: contiguous pow2 chunks [lo, hi] at a
    fixed slot bucket, with a decaying observation weight and the max
    observed fill fractions (how close traffic runs to the top edge)."""

    __slots__ = ("lo", "hi", "weight", "fill_chunk", "fill_slots")

    def __init__(self, chunk: int):
        self.lo = chunk
        self.hi = chunk
        self.weight = 0.0
        self.fill_chunk = 0.0   # max observed max_len / chunk of the hi edge
        self.fill_slots = 0.0   # max observed n_wqes / slots

    def covers(self, chunk: int) -> bool:
        return self.lo <= chunk <= self.hi

    def chunks(self) -> List[int]:
        out, c = [], self.lo
        while c <= self.hi:
            out.append(c)
            c <<= 1
        return out


class BucketLearner:
    """Decaying (slots, chunk) histogram with pow2-neighbor merging.

    ``observe`` is called by the transport on every dispatch (it IS the
    online half of ``stats["bucket_hist"]`` — the recorded histogram
    stays for replay/debug, the learner is what ``prewarm()`` reads).
    Each observation decays every span by ``decay``; spans falling below
    ``min_weight`` are evicted (one ``bucket_decay_events`` tick each).
    A new chunk landing pow2-adjacent to an existing span merges into it
    (one ``bucket_merges`` tick): aliasing neighbors are ONE widened
    bucket, not two competing entries.

    ``predict()`` expands each live span into its covered pow2 chunks
    and — when the observed fill runs past ``widen_threshold`` of the
    top edge — widens one pow2 outward on that axis, so the next shape
    wobble re-enters a pre-compiled bucket instead of missing.
    """

    def __init__(self, decay: float = 0.9, min_weight: float = 0.02,
                 widen_threshold: float = 0.75,
                 stats: Optional[Dict] = None):
        assert 0.0 < decay <= 1.0 and min_weight > 0.0
        self.decay = decay
        self.min_weight = min_weight
        self.widen_threshold = widen_threshold
        self._spans: Dict[int, List[_Span]] = {}    # slots -> spans
        # counters mirror into the owning transport's stats dict when one
        # is attached (the engine's single stats surface)
        self.stats = stats if stats is not None else {
            "bucket_decay_events": 0, "bucket_merges": 0,
            "learned_buckets": 0}

    # ------------------------------------------------------------------
    def observe(self, slots: int, chunk: int,
                n_wqes: Optional[int] = None,
                max_len: Optional[int] = None) -> None:
        slots, chunk = int(slots), int(chunk)
        # decay + evict
        for s, spans in list(self._spans.items()):
            live = []
            for sp in spans:
                sp.weight *= self.decay
                if sp.weight < self.min_weight and not (
                        s == slots and sp.covers(chunk)):
                    self.stats["bucket_decay_events"] += 1
                else:
                    live.append(sp)
            if live:
                self._spans[s] = live
            else:
                del self._spans[s]
        spans = self._spans.setdefault(slots, [])
        target = next((sp for sp in spans if sp.covers(chunk)), None)
        if target is None:
            target = _Span(chunk)
            spans.append(target)
            spans.sort(key=lambda sp: sp.lo)
            self._merge_adjacent(spans)
        target = next(sp for sp in spans if sp.covers(chunk))
        target.weight += 1.0
        if max_len is not None and chunk == target.hi:
            target.fill_chunk = max(target.fill_chunk,
                                    min(1.0, max_len / chunk))
        if n_wqes is not None:
            target.fill_slots = max(target.fill_slots,
                                    min(1.0, n_wqes / slots))
        self.stats["learned_buckets"] = sum(
            len(sp.chunks()) for ss in self._spans.values() for sp in ss)

    def _merge_adjacent(self, spans: List[_Span]) -> None:
        """Collapse pow2-adjacent or overlapping spans (sorted by lo)."""
        i = 0
        while i + 1 < len(spans):
            a, b = spans[i], spans[i + 1]
            if b.lo <= a.hi * 2:             # adjacent or overlapping pow2s
                a.hi = max(a.hi, b.hi)
                a.weight += b.weight
                a.fill_chunk = max(a.fill_chunk, b.fill_chunk)
                a.fill_slots = max(a.fill_slots, b.fill_slots)
                del spans[i + 1]
                self.stats["bucket_merges"] += 1
            else:
                i += 1

    # ------------------------------------------------------------------
    def predict(self) -> List[Tuple[int, int]]:
        """Buckets worth pre-compiling: every covered pow2 chunk of every
        live span, widened one pow2 up per axis where traffic runs near
        the top edge. Deterministic order (slots asc, chunk asc)."""
        out: List[Tuple[int, int]] = []
        seen = set()

        def emit(s: int, c: int) -> None:
            if (s, c) not in seen:
                seen.add((s, c))
                out.append((s, c))

        for slots in sorted(self._spans):
            for sp in self._spans[slots]:
                chunks = sp.chunks()
                if sp.fill_chunk >= self.widen_threshold:
                    chunks.append(sp.hi * 2)
                for c in chunks:
                    emit(slots, c)
                if sp.fill_slots >= self.widen_threshold:
                    for c in chunks:
                        emit(slots * 2, c)
        return out

    def buckets(self) -> List[Tuple[int, int]]:
        """Live (un-widened) buckets, for introspection/tests."""
        return [(s, c) for s in sorted(self._spans)
                for sp in self._spans[s] for c in sp.chunks()]

    def __iter__(self):
        return iter(self.predict())


# ---------------------------------------------------------------------------
# Deterministic auto-sweep tuner
# ---------------------------------------------------------------------------

def modeled_flush_seconds(flushes: int, wqes: int, qdma_writes: int = 0,
                          payload: int = 256,
                          qp_location: str = "dev_mem",
                          executor: ExecutorCost = EXECUTOR_COST) -> float:
    """Paper-hardware time for a measured (flushes, wqes) profile: each
    flush pays the fixed doorbell startup + completion, each executed
    descriptor the steady-state interval (``doorbell_flush_time``'s
    decomposition), each QDMA staging write the executor's staging
    dispatch. Counts come from REAL execution; the model only prices
    them — which keeps the score deterministic on any host."""
    base = doorbell_flush_time(0, payload, qp_location)
    per_wqe = doorbell_flush_time(1, payload, qp_location) - base
    return (flushes * base + wqes * per_wqe
            + qdma_writes * executor.staging_dispatch_s)


@dataclass
class TrialResult:
    tuning: TransportTuning
    rows: int                    # useful work units processed
    flushes: int
    wqes: int                    # post-coalesce descriptor WQEs
    modeled_s: float
    wall_s: float                # informational only — never scored
    score: float                 # rows / modeled_s

    def as_dict(self) -> Dict:
        d = asdict(self)
        d["tuning"] = self.tuning.as_dict()
        return d


class AutoTuner:
    """Seeded coordinate sweep over ``TuningGrid`` on real engine traffic.

    ``sweep()`` walks the knobs in a fixed order, holding the others at
    the best point so far; each candidate runs one *trial*: a scratch
    ``RDMAEngine`` with the candidate tuning (the live engine's peer/pool
    geometry, dtype and device, so trials run on the same executor),
    seeded host READ windows whose lengths re-enter the live engine's
    LEARNED buckets, and a lookaside streaming kernel whose burst size /
    pipeline depth are the candidate's. The score is measured work over
    the flush model priced on the measured flush/WQE counts — fully
    deterministic for one seed, so two sweeps choose the same point.

    Results land in ``engine.stats["autotune"]`` (chosen point, scores,
    full surface); ``apply=True`` (default) also installs the chosen
    tuning on the live engine (`flush_budget`/`qp_window` take effect on
    the next flush; `ring_burst`/`pipeline_depth` seed every block built
    from ``engine.tuning`` afterwards).
    """

    def __init__(self, engine, grid: Optional[TuningGrid] = None,
                 seed: int = 0, passes: int = 2, rows: int = 128,
                 host_reads: int = 12, payload: int = 256,
                 executor: ExecutorCost = EXECUTOR_COST):
        self.engine = engine
        self.grid = grid or TuningGrid()
        self.seed = int(seed)
        self.passes = max(1, int(passes))
        self.rows = int(rows)
        self.host_reads = int(host_reads)
        self.payload = int(payload)
        self.executor = executor
        self._memo: Dict[Tuple, TrialResult] = {}
        self.surface: List[TrialResult] = []
        self.result: Optional[Dict] = None
        # row length sized so the deepest pipeline's scratch partition
        # still holds the widest burst's gather
        pool = engine.pool_size
        max_burst = max(self.grid.ring_burst)
        max_depth = max(self.grid.pipeline_depth)
        self.rowlen = max(2, min(16, (pool // 2) // (max_depth * max_burst)))

    # ------------------------------------------------------------------
    def _trial_lengths(self, rng) -> List[int]:
        """Host-READ lengths drawn from the live engine's learned bucket
        histogram (the engine's OWN traffic profile), so trials re-enter
        already-seen chunk buckets. Falls back to a canonical small mix
        when nothing has been learned yet."""
        learner = getattr(self.engine.transport, "bucket_learner", None)
        buckets = learner.buckets() if learner is not None else []
        pool_cap = self.engine.pool_size
        chunks = sorted({c for _, c in buckets if c <= pool_cap // 4})
        if not chunks:
            chunks = [16, 32, 64]
        lens = []
        for i in range(self.host_reads):
            c = chunks[i % len(chunks)]
            lo = max(1, c // 2 + 1)
            lens.append(int(rng.integers(lo, c + 1)))
        return lens

    def measure(self, tuning: TransportTuning) -> TrialResult:
        """One deterministic trial of ``tuning`` (memoized per point)."""
        key = tuning.key()
        hit = self._memo.get(key)
        if hit is not None:
            return hit
        import numpy as np
        from repro_torch.core.lookaside.control import ControlMsg
        from repro_torch.core.lookaside.registry import LookasideBlock
        from repro_torch.core.rdma.engine import RDMAEngine
        from repro_torch.core.rdma.verbs import Opcode, WQE

        rng = np.random.default_rng(self.seed)
        live = self.engine
        eng = RDMAEngine(n_peers=max(2, live.n_peers),
                         pool_size=live.pool_size,
                         dtype=numpy_dtype(live.pool.dtype),
                         device=live.pool.device,
                         scheduler=live.scheduler
                         if live.scheduler != "fifo" else "rr",
                         tuning=tuning)
        pool = eng.pool_size
        rowlen = self.rowlen
        burst = int(tuning.ring_burst)
        in_mr = eng.register_mr(1, 0, pool // 4)
        out_base = pool // 4
        out_mr = eng.register_mr(1, out_base, pool // 8)
        blk = LookasideBlock(eng, peer=0, scratch_base=pool // 2,
                             scratch_size=pool // 2,
                             eager_writeback=False, tuning=tuning)

        def fn(ctx, start, count):
            buf = ctx.alloc(count * rowlen)
            for j in range(count):
                ctx.read_remote(1, in_mr.rkey, (start + j) * rowlen,
                                buf + j * rowlen, rowlen)
            ctx.commit(wait=False)
            yield                        # fetch phase armed (deferred)
            ctx.write_remote(1, out_mr.rkey, buf,
                             out_base + (start % 64) * rowlen, rowlen)
            ctx.commit(wait=False)

        k = blk.register(1, fn, name="tuner_burst")
        wid = k.workload_id

        # host verbs traffic armed alongside the streaming bursts — the
        # shared-engine contention the tuner must price in
        qps = [eng.create_qp(0, 1) for _ in range(2)]
        lens = self._trial_lengths(rng)
        for i, ln in enumerate(lens):
            qp = qps[i % len(qps)]
            src = int(rng.integers(0, pool // 4 - ln))
            dst = int(rng.integers(0, pool // 4 - ln))
            eng.post_send(qp, WQE(Opcode.READ, qp.qp_num, wr_id=i,
                                  local_addr=dst, remote_addr=src,
                                  length=ln, rkey=in_mr.rkey))
        for qp in qps:
            eng.ring_sq_doorbell(qp, defer=True)

        f0, w0 = eng.stats["flushes"], eng.transport.stats["wqes"]
        d0 = eng.transport.stats["dispatches"]
        q0 = eng.transport.stats["qdma_writes"]
        t0 = time.perf_counter()
        start = 0
        while start < self.rows:
            count = min(burst, self.rows - start)
            msg = ControlMsg(wid, args=(start, count), tag=start)
            if blk.dispatch(msg, service=False) is not None:
                blk.service(wid)         # backpressure: drain, re-enqueue
                blk.dispatch(msg, service=False)
            start += count
        blk.service(wid)
        guard = 0
        while eng._armed:
            served = eng.flush_doorbells()
            guard += 1
            if not any(served.values()) or guard > 10_000:
                break
        wall = time.perf_counter() - t0
        flushes = eng.stats["flushes"] - f0
        wqes = eng.transport.stats["wqes"] - w0
        dispatches = eng.transport.stats["dispatches"] - d0
        qdma = eng.transport.stats["qdma_writes"] - q0
        modeled = modeled_flush_seconds(dispatches, wqes, qdma,
                                        payload=self.payload,
                                        executor=self.executor)
        res = TrialResult(tuning=tuning, rows=self.rows, flushes=flushes,
                          wqes=wqes, modeled_s=modeled, wall_s=wall,
                          score=self.rows / modeled if modeled else 0.0)
        self._memo[key] = res
        self.surface.append(res)
        return res

    # ------------------------------------------------------------------
    def sweep(self, apply: bool = True) -> TransportTuning:
        """Coordinate sweep from the engine's current (hand-picked)
        tuning; returns the chosen point. Ties keep the earlier
        candidate in grid order — deterministic by construction."""
        base = getattr(self.engine, "tuning", None) or TransportTuning()
        default_res = self.measure(base)
        current, current_res = base, default_res
        for _ in range(self.passes):
            for knob in TuningGrid.KNOBS:
                best, best_res = current, current_res
                for v in getattr(self.grid, knob):
                    cand = replace(current, **{knob: v})
                    res = self.measure(cand)
                    if res.score > best_res.score:
                        best, best_res = cand, res
                current, current_res = best, best_res
        self.result = {
            "chosen": current.as_dict(),
            "default": base.as_dict(),
            "score": current_res.score,
            "default_score": default_res.score,
            "improvement": (current_res.score / default_res.score
                            if default_res.score else 1.0),
            "trials": len(self._memo),
            "passes": self.passes,
            "seed": self.seed,
            "rows_per_trial": self.rows,
            "surface": [r.as_dict() for r in self.surface],
        }
        self.engine.stats["autotune"] = self.result
        if apply:
            self.engine.apply_tuning(current)
        return current

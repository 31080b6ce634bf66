"""Transport knobs and the online bucket learner.

``TransportTuning`` holds every hand-picked transport/datapath knob as
one value; the engine, the Lookaside block and (later) the streaming
dispatch plane read their defaults from it.

``BucketLearner`` is the transport's decaying (slots, chunk) histogram:
every dispatch observes its shape bucket, buckets the traffic stopped
using age out (``bucket_decay_events``), and pow2-adjacent buckets merge
into one widened span (``bucket_merges``). ``transport.prewarm()`` with
no arguments reads its prediction. The counters are host bookkeeping and
match the JAX package's ledger under the same traffic.

The auto-sweep tuner (``AutoTuner``/``TuningGrid``) and its cost model
are not in this package yet.
"""
from __future__ import annotations

from dataclasses import asdict, dataclass
from typing import Dict, List, Optional, Tuple


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

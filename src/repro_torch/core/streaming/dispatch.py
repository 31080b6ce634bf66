"""Match→action dispatch plane: handlers and service CHAINS (paper §IV-D).

The paper's programmable compute blocks are multi-tenant: developers drop
RTL/HLS/**Vitis Networking P4** accelerators into the streaming path, and
each one sees its own slice of ingress traffic. ``MatchTable`` is the
software analogue of that Vitis Networking P4 block — a prioritized
match→action table whose keys are the PARSED HEADER FIELD VECTORS the
``packet_parser`` kernel extracts (``FIELD_NAMES`` columns: is_rdma,
opcode, dest_qp, cls, eth_type, ip_proto, udp_dport, udp_sport) and whose
actions are STRUCTURED objects:

  * ``Forward()``  — hand the packet to the RDMA engine;
  * ``Drop()``     — discard at the MAC;
  * ``Stream()``   — land it in the RX ring untagged (the attached
    dispatcher's default owner claims it — the seed ``TrafficRouter``
    behavior re-expressed as a table default);
  * ``Handler(workload_id)`` — tag the packet for one registered
    lookaside kernel (FPsPIN's per-packet handler dispatch);
  * ``Chain((wid_a, wid_b, ...))`` — tag it for an ordered PIPELINE of
    lookaside kernels. This is RoCE BALBOA's service-pipeline model on
    the RDMA datapath: BALBOA attaches chains of µs-scale services
    (parse, transform, reduce...) to the NIC so data is transformed *in
    flight*; here stage N's RDMA write-back region is stage N+1's
    operand-fetch source, and every stage's gather/write-back WQEs ride
    the SAME shared shape-bucketed descriptor table per flush as the
    other handlers' and any armed host verbs traffic (ORCA's co-design
    lesson: a µs-scale stage must never hide behind a bulk transfer on
    a transport it doesn't share).

Every action carries a ``shed`` flag (folded into the action — no more
bolted-on per-entry boolean): shed-marked traffic is best-effort, dropped
at the MAC under retransmit pressure (the reliability layer's
``LoadShedder``) instead of admitted. The legacy ``int`` workload-id
actions and ``"rdma"``/``"drop"``/``"stream"`` sentinels still coerce
through :func:`as_action` with one ``DeprecationWarning``.

The table itself stays host-side numpy over the field vectors: the
classifier kernel (K4) parses a burst on the device and its (n, 8) field
matrix comes back to the host once per burst for ``classify_ex``.

The INGRESS consults the table once per packet
(``TrafficRouter.ingest_packets``); the EGRESS side (``StreamDispatcher``)
drains the ring in bursts and DEMUXES the claimed slots into per-owner
sub-bursts — each sub-burst is one generator-kernel invocation through
the shared ``LookasideBlock``, and all owners' operand-fetch READ gathers
for one service round are armed deferred so they execute as ONE
shape-bucketed descriptor table per flush. Per-class result rows are
RDMA-written to class-mirrored meta rings (one per handler / chain
stage, slot index mirrored from the packet ring).

Chain dataflow (the inter-kernel generalization of the pipeline-credit
plumbing in ``LookasideBlock._service_grouped``): stage 0 of a claimed
sub-burst fetches the RX-ring slots themselves; when stage *i*'s
write-back CQE lands — and only then — its finalize hook enqueues stage
*i+1*'s ControlMsg, whose operand-fetch spans are recomputed over stage
*i*'s slot-mirrored output ring. Because the grouped service loop
re-checks every listed kernel's control FIFO each round, the downstream
stage is admitted in a LATER round of the SAME service pass and its
fetch rides a later shared flush — B bursts × S stages pipeline through
roughly B + 2S flushes where the staged-serial path needs S separate
drains.

Matching semantics: every field condition of an entry must hold
(``lo <= field <= hi``; exact matches are degenerate ranges, unnamed
fields are wildcards). The highest-priority matching entry wins; among
equal priorities the most recently added wins. No match → the table's
``default`` action — the PR-4 single-parser path is exactly a table
whose default is that one parser.

Per-class telemetry lands in ``engine.stats["dispatch"]``
(``dispatch_rounds`` / ``dispatch_mixed_rounds`` plus per-handler
``classes`` and per-chain ``chains`` ledgers), key for key as in the
JAX package.
"""
from __future__ import annotations

import warnings
from dataclasses import dataclass, replace
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.lookaside.control import ControlMsg
from repro_torch.kernels.packet_parser import FIELD_NAMES

#: Legacy string sentinels — accepted by :func:`as_action` only (one
#: DeprecationWarning); new code uses Forward()/Drop()/Stream().
ACTION_RDMA = "rdma"
ACTION_DROP = "drop"
ACTION_STREAM = "stream"

_FIELD_INDEX = {name: i for i, name in enumerate(FIELD_NAMES)}


class Action:
    """Base of all structured table actions.

    ``shed`` marks the matched traffic best-effort: under retransmit
    pressure (the reliability layer's ``LoadShedder``) the ingress drops
    it at the MAC instead of admitting it — graceful degradation rather
    than wedging the ring."""
    shed: bool = False


@dataclass(frozen=True)
class Forward(Action):
    """Hand the packet to the RDMA engine (ex-``ACTION_RDMA``)."""
    shed: bool = False


@dataclass(frozen=True)
class Drop(Action):
    """Discard at the MAC (ex-``ACTION_DROP``). Dropping already is the
    degraded mode, so ``Drop`` carries no shed flag."""


@dataclass(frozen=True)
class Stream(Action):
    """Land the packet in the RX ring untagged — the attached
    dispatcher's default owner claims it (ex-``ACTION_STREAM``)."""
    shed: bool = False


@dataclass(frozen=True)
class Handler(Action):
    """Route to one registered lookaside kernel (ex-``int`` action)."""
    workload_id: int
    shed: bool = False


@dataclass(frozen=True)
class Chain(Action):
    """Route to an ordered PIPELINE of lookaside kernels (BALBOA's
    service chains): stage ``stages[i]``'s write-back region is stage
    ``stages[i+1]``'s operand-fetch source, all within the shared
    descriptor tables of one dispatcher service pass. Bind the concrete
    per-stage output rings with ``StreamDispatcher.register_chain``."""
    stages: Tuple[int, ...]
    name: str = ""
    shed: bool = False

    def __post_init__(self):
        stages = tuple(int(w) for w in self.stages)
        if not stages:
            raise ValueError("a Chain needs at least one stage")
        object.__setattr__(self, "stages", stages)

    @property
    def tag(self) -> int:
        """Deterministic ring tag of this pipeline. The 0x43 high byte
        keeps chain tags disjoint from handler workload ids, so a chain
        and its own stage kernels can share one table."""
        t = 0x205
        for w in self.stages:
            t = (t * 33 + int(w)) & 0xFFFFFF
        return 0x43000000 | t


_LEGACY_SENTINELS = {ACTION_RDMA: Forward, ACTION_DROP: Drop,
                     ACTION_STREAM: Stream}


def as_action(action, shed: bool = False) -> Action:
    """Coerce a table action to the structured API.

    Structured ``Action`` instances pass through (``shed=True`` folds
    into the action); the legacy forms — ``int`` handler workload ids
    and the ``"rdma"``/``"drop"``/``"stream"`` sentinels — still coerce,
    each emitting one ``DeprecationWarning``."""
    if isinstance(action, Action):
        if shed and not action.shed and not isinstance(action, Drop):
            action = replace(action, shed=True)
        return action
    if isinstance(action, bool):
        raise TypeError(f"unsupported table action {action!r}")
    if isinstance(action, (int, np.integer)):
        warnings.warn(
            "int table actions are deprecated: use Handler(workload_id)",
            DeprecationWarning, stacklevel=3)
        return Handler(int(action), shed=shed)
    if isinstance(action, str) and action in _LEGACY_SENTINELS:
        cls = _LEGACY_SENTINELS[action]
        warnings.warn(
            f"the {action!r} sentinel is deprecated: use {cls.__name__}()",
            DeprecationWarning, stacklevel=3)
        a = cls()
        if shed and not isinstance(a, Drop):
            a = replace(a, shed=True)
        return a
    raise TypeError(
        f"unsupported table action {action!r}: expected an Action "
        "(Forward / Drop / Stream / Handler / Chain)")


@dataclass(frozen=True)
class MatchEntry:
    """One prioritized match→action row.

    ``fields`` is a tuple of ``(name, lo, hi)`` inclusive range
    conditions over the parsed field vector; all must hold for the entry
    to match (absent fields are wildcards, exact matches have
    ``lo == hi``). The action itself carries the ``shed`` flag (see
    :class:`Action`); legacy int/sentinel actions coerce on
    construction."""
    action: Action
    fields: Tuple[Tuple[str, int, int], ...] = ()
    priority: int = 0

    def __post_init__(self):
        object.__setattr__(self, "action", as_action(self.action))
        for name, lo, hi in self.fields:
            if name not in _FIELD_INDEX:
                raise KeyError(
                    f"unknown match field {name!r}; parsed fields are "
                    f"{FIELD_NAMES}")
            if lo > hi:
                raise ValueError(f"empty range for {name}: [{lo}, {hi}]")

    @property
    def shed(self) -> bool:
        return self.action.shed


class MatchTable:
    """Prioritized field-match table over parsed header vectors — the
    Vitis Networking P4 block of the dispatch plane."""

    def __init__(self, entries: Sequence[MatchEntry] = (),
                 default: Action = Drop()):
        self.default = as_action(default)
        self.entries: List[MatchEntry] = list(entries)

    def add(self, action: Action, priority: int = 0, shed: bool = False,
            **matches) -> "MatchTable":
        """Append one entry: ``table.add(Handler(wid), udp_dport=9000)``
        or ranges ``table.add(Chain((a, b)), opcode=(6, 11))``;
        ``shed=True`` folds the best-effort flag into the action.
        Returns self (chains)."""
        fields = []
        for name, cond in matches.items():
            lo, hi = cond if isinstance(cond, tuple) else (cond, cond)
            fields.append((name, int(lo), int(hi)))
        self.entries.append(MatchEntry(as_action(action, shed=shed),
                                       tuple(fields), priority))
        return self

    def classify_ex(self, fields: np.ndarray
                    ) -> Tuple[List[Action], List[bool]]:
        """Vectorized match of (n, N_FIELDS) parsed vectors → one
        ``(action, sheddable)`` pair per packet (as two parallel lists).
        Entries apply in ascending (priority, insertion) order, later
        applications overwriting — so the highest priority wins, ties
        going to the most recently added entry."""
        fields = np.asarray(fields)
        n = fields.shape[0]
        out = np.zeros(n, np.int64)          # indices into actions list
        actions: List[Action] = [self.default]
        order = sorted(range(len(self.entries)),
                       key=lambda i: (self.entries[i].priority, i))
        for i in order:
            e = self.entries[i]
            mask = np.ones(n, bool)
            for name, lo, hi in e.fields:
                col = fields[:, _FIELD_INDEX[name]]
                mask &= (col >= lo) & (col <= hi)
            actions.append(e.action)
            out[mask] = len(actions) - 1
        acts = [actions[i] for i in out]
        return acts, [a.shed for a in acts]

    def classify(self, fields: np.ndarray) -> List[Action]:
        """``classify_ex`` without the shed flags."""
        return self.classify_ex(fields)[0]

    def match(self, field_vec) -> Action:
        """Single parsed field vector → action."""
        return self.classify(np.asarray(field_vec)[None])[0]

    @property
    def handler_ids(self) -> List[int]:
        """Every distinct ``Handler`` workload id, table order, default
        last."""
        out: List[int] = []
        for e in self.entries:
            if isinstance(e.action, Handler) \
                    and e.action.workload_id not in out:
                out.append(e.action.workload_id)
        if isinstance(self.default, Handler) \
                and self.default.workload_id not in out:
            out.append(self.default.workload_id)
        return out

    @property
    def chain_actions(self) -> List[Chain]:
        """Every distinct ``Chain`` action, table order, default last."""
        out: List[Chain] = []
        for e in self.entries:
            if isinstance(e.action, Chain) and e.action not in out:
                out.append(e.action)
        if isinstance(self.default, Chain) and self.default not in out:
            out.append(self.default)
        return out


@dataclass
class _HandlerBinding:
    """One registered handler kernel's egress binding: where its
    class-mirrored output ring lives (rows at
    ``out_base + (seq % depth) * row_words``, row width owned by the
    kernel)."""
    workload_id: int
    out_peer: int
    out_rkey: int
    out_base: int


@dataclass
class _StageBinding:
    """One chain stage's egress binding: its slot-mirrored output ring
    plus the row geometry the dispatcher needs to turn claimed seqs into
    the NEXT stage's fetch spans (``in_row`` input words per slot,
    ``out_row`` output words per slot)."""
    workload_id: int
    out_peer: int
    out_rkey: int
    out_base: int
    in_row: int
    out_row: int


@dataclass
class _ChainBinding:
    """One registered chain: the action plus its concrete stage rings."""
    chain: Chain
    stages: List[_StageBinding]
    name: str


def _row_spans(seqs: Sequence[int], base: int, row: int,
               depth: int) -> List[Tuple[int, int]]:
    """Claimed ring seqs → contiguous ``(addr, count)`` spans over a
    slot-mirrored row region (row index = seq % depth), splitting at
    wrap and at slot gaps — the inter-stage analogue of
    ``RXRing._spans``, parameterized by row width."""
    spans: List[Tuple[int, int]] = []
    prev = None
    for seq in seqs:
        slot = seq % depth
        if prev is not None and slot == prev + 1:
            addr, cnt = spans[-1]
            spans[-1] = (addr, cnt + 1)
        else:
            spans.append((base + slot * row, 1))
        prev = slot
    return spans


class StreamDispatcher:
    """Drains one RX ring into per-owner sub-bursts (the egress half of
    the dispatch plane). Owners are handler kernels
    (``register_handler``) and service chains (``register_chain``).

    One ``service()`` call runs claim ROUNDS — per round, each owner
    claims up to ``burst`` of its oldest pending slots (per-owner FIFO,
    wrap splits included) and gets one ControlMsg invocation enqueued
    (a chain enqueues its STAGE-0 invocation; later stages self-enqueue
    as upstream write-backs land) — then drives ALL touched kernels
    through one ``LookasideBlock.service_group`` pass, where every
    owner's operand-fetch gather is armed deferred and executed in one
    shared shape-bucketed descriptor table per flush. The default owner
    (a registered ``Handler`` or ``Chain`` table default) additionally
    claims untagged and unknown-class slots — P4 default-action
    semantics — while a non-owner default sweeps them as counted drops
    so the ring can never wedge.
    """

    def __init__(self, block, ring, table: MatchTable,
                 burst: Optional[int] = None):
        self.block = block
        self.ring = ring
        self.table = table
        # burst defaults from the block's TransportTuning (the autotuner's
        # ring_burst knob); an explicit value still wins for this plane
        if burst is None:
            burst = getattr(block, "tuning", None).ring_burst \
                if getattr(block, "tuning", None) is not None else 32
        self.burst = max(1, int(burst))
        self.handlers: Dict[int, _HandlerBinding] = {}
        self.chains: Dict[int, _ChainBinding] = {}   # keyed by Chain.tag
        stats = block.engine.stats.setdefault("dispatch", {})
        for key in ("dispatch_rounds", "dispatch_mixed_rounds",
                    "dispatch_dropped_pkts"):
            stats.setdefault(key, 0)
        stats.setdefault("classes", {})
        stats.setdefault("chains", {})
        self._stats = stats

    def register_handler(self, workload_id: int, out_peer: int,
                         out_rkey: int, out_base: int) -> _HandlerBinding:
        """Bind a registered LC kernel as a handler with its
        class-mirrored output ring base (re-registering rebinds)."""
        if workload_id not in self.block.kernels:
            raise KeyError(f"workload {workload_id:#x} not registered on "
                           "the block")
        h = _HandlerBinding(workload_id, out_peer, out_rkey, out_base)
        self.handlers[workload_id] = h
        name = self.block.kernels[workload_id].name
        self._stats["classes"].setdefault(
            name, {"pkts": 0, "bursts": 0, "wqes": 0})
        return h

    def register_chain(self, chain: Chain, out_peer: int, out_rkey: int,
                       stage_bases: Sequence[int]) -> _ChainBinding:
        """Bind a ``Chain`` action to concrete per-stage output rings.

        Stage *i*'s result rows land slot-mirrored at ``stage_bases[i]``
        (row index = ring seq % depth, ``out_row`` words per slot from
        the kernel's ``stage_spec``); that same region is stage *i+1*'s
        operand-fetch source. Every stage kernel must be registered on
        the block and chain-capable — i.e. carry a ``stage_spec``
        declaring its row geometry (``kernels.lc_offload.ChainStageSpec``)
        — and the row widths must compose (stage *i*'s ``out_row``
        satisfies stage *i+1*'s ``fixed_in_row``/``min_in_row``)."""
        chain = as_action(chain)
        if not isinstance(chain, Chain):
            raise TypeError(f"expected a Chain action, got {chain!r}")
        if len(stage_bases) != len(chain.stages):
            raise ValueError(
                f"chain has {len(chain.stages)} stages but "
                f"{len(stage_bases)} stage_bases")
        in_row = self.ring.slot_bytes
        stages: List[_StageBinding] = []
        for wid, base in zip(chain.stages, stage_bases):
            if wid not in self.block.kernels:
                raise KeyError(f"workload {wid:#x} not registered on "
                               "the block")
            spec = getattr(self.block.kernels[wid], "stage_spec", None)
            if spec is None:
                raise TypeError(
                    f"workload {wid:#x} is not chain-capable: no "
                    "stage_spec (see register_chain_kernels)")
            fixed = getattr(spec, "fixed_in_row", None)
            if fixed is not None and in_row != fixed:
                raise ValueError(
                    f"stage {wid:#x} needs in_row == {fixed} words, "
                    f"upstream provides {in_row}")
            if in_row < getattr(spec, "min_in_row", 1):
                raise ValueError(
                    f"stage {wid:#x} needs in_row >= {spec.min_in_row} "
                    f"words, upstream provides {in_row}")
            stages.append(_StageBinding(wid, out_peer, out_rkey,
                                        int(base), in_row, spec.out_row))
            in_row = spec.out_row
        cb = _ChainBinding(chain, stages,
                           chain.name or f"chain_{chain.tag:#x}")
        self.chains[chain.tag] = cb
        self._stats["chains"].setdefault(cb.name, {
            "pkts": 0, "bursts": 0, "stages": len(stages),
            "stage_invocations": 0, "wqes": 0, "dataflow_msgs": 0,
            "completed_pkts": 0})
        return cb

    # ------------------------------------------------------------ matching
    def _owned_tags(self):
        """Every ring tag a registered owner claims: handler workload
        ids plus chain tags."""
        return frozenset(self.handlers) | frozenset(self.chains)

    def _default_key(self) -> Optional[int]:
        """The registered owner the table's default action names — a
        ``Handler``'s workload id or a ``Chain``'s tag — else None."""
        d = self.table.default
        if isinstance(d, Handler) and d.workload_id in self.handlers:
            return d.workload_id
        if isinstance(d, Chain) and d.tag in self.chains:
            return d.tag
        return None

    def _matcher(self, key: int) -> Callable[[Optional[int]], bool]:
        """Slot-tag predicate of one owner: its own tag, plus — for the
        table-default owner — untagged and orphaned tags."""
        if self._default_key() == key:
            others = frozenset(t for t in self._owned_tags() if t != key)
            return lambda cls: cls not in others
        return lambda cls: cls == key

    def _enqueue(self, h: _HandlerBinding, n: int) -> int:
        """Claim one sub-burst for a handler and enqueue its invocation
        (fetch spans ride the ControlMsg; slot release and latency-stamp
        hooks ride the block's per-message lifecycle)."""
        block, ring = self.block, self.ring
        seqs, spans, stamps = ring.claim(n, self._matcher(h.workload_id))
        msg = ControlMsg(h.workload_id,
                         (block.peer, ring.mr.rkey, ring.base,
                          h.out_peer, h.out_rkey, h.out_base,
                          tuple(spans)),
                         tag=block.stats["dispatched"])
        st = block.dispatch(msg, service=False)
        if st is not None:               # control FIFO backpressure:
            block.service_group([h.workload_id])    # drain, re-dispatch
            st = block.dispatch(msg, service=False)
            if st is not None:           # FIFO still full after a full
                raise RuntimeError(      # drain: nothing can progress
                    f"stream burst rejected twice: {st.detail}")
        hooks = block._hooks.setdefault(id(msg), {})
        hooks["on_fetched"] = (lambda ring=ring, seqs=seqs:
                               ring.complete_seqs(seqs))
        hooks["on_finalized"] = (lambda ring=ring, stamps=stamps:
                                 ring.record_status(stamps))
        ledger = self._stats["classes"][
            block.kernels[h.workload_id].name]
        ledger["pkts"] += n
        ledger["bursts"] += 1
        ledger["wqes"] += len(spans)
        return n

    # -------------------------------------------------------------- chains
    def _enqueue_chain(self, cb: _ChainBinding, n: int) -> int:
        """Claim one sub-burst for a chain and enqueue its STAGE-0
        invocation; later stages self-enqueue via finalize hooks as the
        pipeline's write-backs land."""
        seqs, spans, stamps = self.ring.claim(
            n, self._matcher(cb.chain.tag))
        ledger = self._stats["chains"][cb.name]
        ledger["pkts"] += n
        ledger["bursts"] += 1
        self._start_stage(cb, 0, tuple(seqs), tuple(spans), stamps)
        return n

    def _start_stage(self, cb: _ChainBinding, idx: int,
                     seqs: Tuple[int, ...],
                     spans: Optional[Tuple[Tuple[int, int], ...]],
                     stamps) -> None:
        """Enqueue stage ``idx`` of one claimed sub-burst.

        Stage 0 fetches the RX-ring slots themselves; stage *i > 0*
        fetches the slot-mirrored rows stage *i-1* just wrote back —
        inter-kernel dataflow: the upstream finalize hook (which fires
        only once its write-back CQE has landed) calls this, so the
        downstream fetch is admitted in a LATER round of the same
        grouped service pass and rides a later shared flush."""
        block, ring = self.block, self.ring
        st = cb.stages[idx]
        if idx == 0:
            src = (block.peer, ring.mr.rkey, ring.base)
        else:
            prev = cb.stages[idx - 1]
            src = (prev.out_peer, prev.out_rkey, prev.out_base)
            spans = tuple(_row_spans(seqs, prev.out_base, prev.out_row,
                                     ring.depth))
        msg = ControlMsg(st.workload_id,
                         src + (st.out_peer, st.out_rkey, st.out_base,
                                tuple(spans), st.in_row),
                         tag=block.stats["dispatched"])
        err = block.dispatch(msg, service=False)
        if err is not None:              # control FIFO backpressure
            if idx == 0:                 # pre-pass: drain and retry
                block.service_group(self._service_wids(), keep_idle=True)
                err = block.dispatch(msg, service=False)
            if err is not None:          # mid-pass overflow cannot be
                raise RuntimeError(      # drained reentrantly
                    f"chain stage {idx} rejected: {err.detail}")
        ledger = self._stats["chains"][cb.name]
        ledger["stage_invocations"] += 1
        ledger["wqes"] += len(spans)
        if idx > 0:
            ledger["dataflow_msgs"] += 1
        hooks = block._hooks.setdefault(id(msg), {})
        if idx == 0:                     # RX slots free once gathered
            hooks["on_fetched"] = (lambda ring=ring, seqs=seqs:
                                   ring.complete_seqs(seqs))
        if idx == len(cb.stages) - 1:    # end of pipe: stamp latency
            hooks["on_finalized"] = (
                lambda cb=cb, seqs=seqs, stamps=stamps:
                self._finish_chain(cb, seqs, stamps))
        else:                            # dataflow: enqueue next stage
            hooks["on_finalized"] = (
                lambda cb=cb, idx=idx, seqs=seqs, stamps=stamps:
                self._start_stage(cb, idx + 1, seqs, None, stamps))

    def _finish_chain(self, cb: _ChainBinding, seqs, stamps) -> None:
        """Final stage's write-back landed: ring-to-status latency stamp
        plus the per-chain completion ledger."""
        self.ring.record_status(stamps)
        self._stats["chains"][cb.name]["completed_pkts"] += len(seqs)

    def _service_wids(self) -> List[int]:
        """Every kernel one service pass may touch: handlers plus every
        chain stage (idle stages included — their messages arrive
        mid-pass via the dataflow hooks)."""
        wids = list(self.handlers)
        for cb in self.chains.values():
            for st in cb.stages:
                if st.workload_id not in wids:
                    wids.append(st.workload_id)
        return wids

    def _sweep_orphans(self) -> None:
        """Slots whose tag no REGISTERED owner claims would wedge the
        ring (head stuck behind them forever): claim and free them as
        counted drops instead. A registered default owner's matcher
        already covers untagged and unknown tags, so nothing can orphan;
        a default that was never registered must NOT suppress the
        sweep."""
        if self._default_key() is not None:
            return                       # default owner claims them
        matchers = [self._matcher(k) for k in self._owned_tags()]
        orphan = lambda cls: not any(m(cls) for m in matchers)  # noqa: E731
        n = self.ring.available_for(orphan)
        if n:
            seqs, _, _ = self.ring.claim(n, orphan)
            self.ring.drop_seqs(seqs)    # swept, NOT consumed
            self._stats["dispatch_dropped_pkts"] += n

    # ------------------------------------------------------------- service
    def service(self, max_bursts: Optional[int] = None) -> int:
        """One dispatch drain: claim rounds over the owner mix (handlers
        and chains), then one shared service pass — chains run ALL their
        stages within that pass, each stage's fetch riding a later
        shared flush than its upstream's write-back. Returns packets
        consumed by owners (``max_bursts`` caps sub-bursts claimed this
        call)."""
        consumed = 0
        bursts = 0
        while max_bursts is None or bursts < max_bursts:
            claimed_classes = 0
            for wid, h in self.handlers.items():
                if max_bursts is not None and bursts >= max_bursts:
                    break
                avail = self.ring.available_for(self._matcher(wid))
                if not avail:
                    continue
                consumed += self._enqueue(h, min(avail, self.burst))
                bursts += 1
                claimed_classes += 1
            for tag, cb in self.chains.items():
                if max_bursts is not None and bursts >= max_bursts:
                    break
                avail = self.ring.available_for(self._matcher(tag))
                if not avail:
                    continue
                consumed += self._enqueue_chain(cb, min(avail, self.burst))
                bursts += 1
                claimed_classes += 1
            if claimed_classes:
                self._stats["dispatch_rounds"] += 1
                if claimed_classes > 1:
                    self._stats["dispatch_mixed_rounds"] += 1
            else:
                break
        self._sweep_orphans()
        self.block.service_group(self._service_wids(),
                                 keep_idle=bool(self.chains))
        return consumed

"""Streaming Compute: traffic classification + routing (paper §III-C, §IV-D).

Two levels, mirroring the paper:

* **Byte level** — ``classify_headers`` runs the ``parse_packet_fields``
  kernel (K4) over packed RoCEv2-style headers (the P4 example verbatim)
  on the engine's device and returns the FULL parsed field vector per
  packet (``packet_parser.FIELD_NAMES`` columns, opcode/dest_qp
  unmasked) — the match keys of the dispatch plane's ``MatchTable``.
* **Descriptor level** — in the training/serving system, "packets" are
  transfer descriptors. ``TrafficRouter`` classifies each descriptor into
  a traffic class and routes it to the offloaded ICI path (RDMA engine)
  or the host path — the paper's RDMA vs non-RDMA split, extended with
  the classes a training system actually carries.

The packet-level RDMA-vs-ring split is no longer hardwired: the router
consults a ``MatchTable`` whose DEFAULT instance is exactly the old
behavior expressed as two table rows — ``is_rdma == 1 → Forward()``
plus a catch-all ``Stream()`` default — and a custom table routes each
ingress packet to a per-class ``Handler`` kernel or a ``Chain``
pipeline instead (the packet lands in the RX ring tagged with the
handler's workload id or the chain's tag, and the egress
``StreamDispatcher`` demuxes).
"""
from __future__ import annotations

import enum
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.core.streaming.dispatch import (Chain, Drop, Forward,
                                                 Handler, MatchTable, Stream)
from repro_torch.kernels import ops as kops


class TrafficClass(enum.Enum):
    BULK_GRAD = "bulk_grad"          # gradient buckets (all-reduce path)
    KV_PAGE = "kv_page"              # KV-cache page moves (one-sided READ)
    EXPERT_DISPATCH = "expert"       # MoE token routing (all-to-all path)
    PIPELINE_ACT = "pipeline"        # PP stage activations (permute path)
    HOST_IO = "host_io"              # data/checkpoint staging (PCIe path)
    CTRL = "ctrl"                    # small control messages


#: which classes ride the offloaded engine vs the host software stack
OFFLOADED = {TrafficClass.BULK_GRAD, TrafficClass.KV_PAGE,
             TrafficClass.EXPERT_DISPATCH, TrafficClass.PIPELINE_ACT}


@dataclass(frozen=True)
class TransferDesc:
    traffic_class: TrafficClass
    nbytes: int
    src: int = 0
    dst: int = 0
    meta: tuple = ()


#: The seed RDMA-vs-ring split as a match→action table: RoCEv2 traffic
#: to the engine, everything else streamed untagged (the attached
#: dispatcher's default handler claims it).
def default_ingress_table() -> MatchTable:
    return MatchTable(default=Stream()).add(Forward(), is_rdma=1)


class TrafficRouter:
    """Routes descriptors to registered path handlers and keeps per-class
    byte/dispatch counters (the NIC's telemetry role).

    With an ``rx_ring`` attached it is also the §IV-D MAC ingress:
    ``ingest_packets`` parses raw headers byte-level and consults the
    match→action ``table`` per packet — ``Forward()`` rows count toward
    the RDMA engine, ``Drop()`` rows are discarded, ``Handler`` rows
    land in the RX ring tagged with the handler's workload id and
    ``Chain`` rows tagged with the chain's deterministic tag (the
    egress ``StreamDispatcher`` demuxes the ring by those tags). No
    table given → ``default_ingress_table()``, the seed RDMA-vs-ring
    split.

    ``shedder`` (a reliability ``LoadShedder``) arms graceful
    degradation: while the engine's un-ACKed retransmit window exceeds
    the shedder's threshold, packets matched by ``shed=True`` table rows
    are dropped at the MAC (counted in ``pkt_counters["shed"]`` and the
    engine's ``stats["reliability"]["shed"]`` ledger) instead of
    admitted — best-effort streaming load yields to recovery traffic.

    Headers are parsed on the ring engine's device; a router with no
    ring parses on ``device`` (``None`` = the GPU, raising without
    one)."""

    def __init__(self, rx_ring=None, table: Optional[MatchTable] = None,
                 shedder=None, device=None):
        self.rx_ring = rx_ring
        self.device = (rx_ring.engine.pool.device if rx_ring is not None
                       else resolve_device(device))
        self.table = table if table is not None else default_ingress_table()
        self.shedder = shedder
        self.handlers: Dict[str, Callable[[List[TransferDesc]], None]] = {}
        self.counters: Dict[TrafficClass, Dict[str, int]] = {
            tc: {"bytes": 0, "count": 0} for tc in TrafficClass}
        self.pkt_counters = {"rdma": 0, "streamed": 0, "dropped": 0,
                             "backpressure": 0, "shed": 0}
        # per-action ingress ledger, keyed by the (hashable, frozen)
        # Action object: finer-grained than the 4-key pkt_counters
        # outcome view. On a table without Drop() rows, pkt_counters'
        # drop/backpressure entries equal the ring's rx_ring_* refusal
        # counters; table-level drops also land in pkt_counters
        # ["dropped"] (split out here under Drop()) without touching
        # the ring.
        self.class_counters: Dict[object, int] = {}

    def ingest_packets(self, headers: np.ndarray) -> Dict[str, int]:
        """MAC-side packet ingress (paper §IV-D): parse headers with the
        streaming classifier kernel, then match→action each packet.
        When the ring refuses a packet the outcome matches the ring's
        policy — ``dropped`` (lost) vs ``backpressure`` (retryable after
        a drain) — so router and ring/transport telemetry agree. With no
        ring attached the streamed share is dropped. Table-level
        ``Drop()`` packets also count as ``dropped`` (see
        ``class_counters[Drop()]`` for the split). Returns this call's
        counts."""
        headers = np.asarray(headers)
        fields = classify_headers(headers, device=self.device)
        actions, shed_flags = self.table.classify_ex(fields)
        out = {"rdma": 0, "streamed": 0, "dropped": 0, "backpressure": 0,
               "shed": 0}
        refused = ("dropped" if self.rx_ring is None
                   or self.rx_ring.policy == "drop" else "backpressure")
        # one pressure check per ingest burst — the MAC samples the
        # retransmit gauge, it does not re-read it per packet
        shedding = self.shedder is not None and self.shedder.should_shed()
        for h, act, sheddable in zip(headers, actions, shed_flags):
            self.class_counters[act] = self.class_counters.get(act, 0) + 1
            if shedding and sheddable:
                out["shed"] += 1
                self.shedder.record_shed()
            elif isinstance(act, Forward):
                out["rdma"] += 1
            elif isinstance(act, Drop):
                out["dropped"] += 1
            else:
                if isinstance(act, Handler):
                    cls = act.workload_id
                elif isinstance(act, Chain):
                    cls = act.tag
                else:                    # Stream(): untagged
                    cls = None
                if self.rx_ring is not None and self.rx_ring.push(
                        h, cls=cls):
                    out["streamed"] += 1
                else:
                    out[refused] += 1
        for key, n in out.items():
            self.pkt_counters[key] += n
        return out

    def register_path(self, name: str,
                      handler: Callable[[List[TransferDesc]], None]) -> None:
        self.handlers[name] = handler

    @staticmethod
    def path_of(desc: TransferDesc) -> str:
        return "offloaded" if desc.traffic_class in OFFLOADED else "host"

    def route(self, descs: List[TransferDesc]) -> Dict[str, int]:
        batches: Dict[str, List[TransferDesc]] = {}
        for d in descs:
            self.counters[d.traffic_class]["bytes"] += d.nbytes
            self.counters[d.traffic_class]["count"] += 1
            batches.setdefault(self.path_of(d), []).append(d)
        for path, batch in batches.items():
            h = self.handlers.get(path)
            if h is not None:
                h(batch)
        return {p: len(b) for p, b in batches.items()}


def classify_headers(headers, device=None) -> np.ndarray:
    """(n, 64) uint8 RoCEv2-style headers -> (n, N_FIELDS) int32 FULL
    parsed field vectors (``packet_parser.FIELD_NAMES`` order: is_rdma,
    opcode, dest_qp, cls, eth_type, ip_proto, udp_dport, udp_sport —
    opcode/dest_qp raw, so a match table can split non-RDMA classes by
    port).

    The headers go to ``device`` (``None`` = the GPU, raising without
    one) and K4 parses them there; the field matrix comes back to the
    host once, for the host-side ``MatchTable``."""
    pkts = torch.as_tensor(np.asarray(headers, np.uint8)).to(
        resolve_device(device))
    return kops.classify_packet_fields(pkts).cpu().numpy()


def make_roce_header(opcode: int, dest_qp: int, is_rdma: bool = True,
                     dport: Optional[int] = None) -> np.ndarray:
    """Build one synthetic 64-byte header (test/bench stimulus generator —
    the packet_gen.py analogue). ``dport`` overrides the UDP destination
    port (default: 4791 RoCEv2 / 80 non-RDMA) — the knob multi-class
    dispatch stimuli steer their match tables with."""
    h = np.zeros(64, np.uint8)
    h[12], h[13] = 0x08, 0x00                     # IPv4
    h[23] = 17                                    # UDP
    port = dport if dport is not None else (4791 if is_rdma else 80)
    h[36], h[37] = port >> 8, port & 0xFF
    h[42] = opcode
    h[47], h[48], h[49] = ((dest_qp >> 16) & 0xFF, (dest_qp >> 8) & 0xFF,
                           dest_qp & 0xFF)
    return h

"""RoCEv2 packet parser/classifier — the Streaming Compute example of the
paper (§IV-D), where a P4 program parses Ethernet/IP/UDP/BTH headers and
splits RDMA from non-RDMA traffic (K3 ``parse_packets``), and the
dispatch plane's full field view of the same parse (K4
``parse_packet_fields``).

Packets arrive as a (n_packets, 64) uint8 tensor. ``parse_packets``
outputs ``[is_rdma, bth_opcode, dest_qp, class]`` per packet as int32,
with opcode and dest_qp masked to 0 on non-RDMA packets;
``parse_packet_fields`` outputs all eight raw fields in ``FIELD_NAMES``
order, opcode and dest_qp unmasked, so a match table can split non-RDMA
classes by port.

Header layout parsed (no VLAN, IPv4):
  eth.type   @12:14   (0x0800 = IPv4)
  ip.proto   @23      (17 = UDP)
  udp.dport  @36:38   (4791 = RoCEv2)
  bth.opcode @42      bth.destQP @47:50

Traffic classes (RC opcodes): 0 non-RDMA, 1 SEND(0-5), 2 WRITE(6-11),
3 READ-REQ(12), 4 READ-RESP(13-16), 5 ACK(17), 6 other RDMA.

Each wrapper runs its plain PyTorch version for a tensor on the CPU and
launches its CUDA kernel (``csrc/packet_parser.cu``) for a tensor on the
GPU; ``.launches`` on each wrapper counts its launches.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build

HDR_BYTES = 64
ROCE_UDP_PORT = 4791

CLS_NON_RDMA, CLS_SEND, CLS_WRITE, CLS_READ_REQ, CLS_READ_RESP, CLS_ACK, \
    CLS_OTHER = range(7)

#: Column order of the FULL parsed field vector (the dispatch plane's
#: match keys; opcode/dest_qp RAW, not masked by is_rdma).
FIELD_NAMES = ("is_rdma", "opcode", "dest_qp", "cls",
               "eth_type", "ip_proto", "udp_dport", "udp_sport")
N_FIELDS = len(FIELD_NAMES)


def _raw_fields(pkts: torch.Tensor) -> torch.Tensor:
    """pkts: (n, HDR_BYTES) int32 (0..255) -> (n, N_FIELDS) raw fields."""
    eth_type = pkts[:, 12] * 256 + pkts[:, 13]
    ip_proto = pkts[:, 23]
    udp_sport = pkts[:, 34] * 256 + pkts[:, 35]
    udp_dport = pkts[:, 36] * 256 + pkts[:, 37]
    opcode = pkts[:, 42]
    dest_qp = pkts[:, 47] * 65536 + pkts[:, 48] * 256 + pkts[:, 49]

    is_rdma = ((eth_type == 0x0800) & (ip_proto == 17)
               & (udp_dport == ROCE_UDP_PORT)).to(torch.int32)

    cls = torch.full_like(opcode, CLS_OTHER)
    cls = torch.where(opcode <= 5, CLS_SEND, cls)
    cls = torch.where((opcode >= 6) & (opcode <= 11), CLS_WRITE, cls)
    cls = torch.where(opcode == 12, CLS_READ_REQ, cls)
    cls = torch.where((opcode >= 13) & (opcode <= 16), CLS_READ_RESP, cls)
    cls = torch.where(opcode == 17, CLS_ACK, cls)
    cls = torch.where(is_rdma == 0, CLS_NON_RDMA, cls)

    return torch.stack([is_rdma, opcode, dest_qp, cls,
                        eth_type, ip_proto, udp_dport, udp_sport], dim=-1)


def parse_packets_plain(pkts: torch.Tensor) -> torch.Tensor:
    """(n, HDR_BYTES) uint8 -> (n, 4) int32 meta rows."""
    f = _raw_fields(pkts.to(torch.int32))
    is_rdma = f[:, 0]
    return torch.stack([is_rdma, f[:, 1] * is_rdma, f[:, 2] * is_rdma,
                        f[:, 3]], dim=-1)


def parse_packet_fields_plain(pkts: torch.Tensor) -> torch.Tensor:
    """(n, HDR_BYTES) uint8 -> (n, N_FIELDS) int32 raw field rows."""
    return _raw_fields(pkts.to(torch.int32))


def _parse(wrapper, plain, entry: str, width: int,
           pkts: torch.Tensor) -> torch.Tensor:
    """Check ``pkts``; run ``plain`` for a CPU tensor, else launch C
    entry point ``entry`` writing an ``(n, width)`` int32 result on the
    GPU (counted on ``wrapper``)."""
    if pkts.ndim != 2 or pkts.shape[1] != HDR_BYTES:
        raise ValueError(f"expected (n, {HDR_BYTES}) headers, got "
                         f"{tuple(pkts.shape)}")
    if pkts.dtype != torch.uint8:
        raise TypeError(f"{wrapper.__name__}: expected uint8, got "
                        f"{pkts.dtype}")
    if pkts.device.type == "cpu":
        return plain(pkts)
    _build.check_cuda(wrapper.__name__, pkts)
    n = pkts.shape[0]
    out = torch.empty((n, width), dtype=torch.int32, device=pkts.device)
    if n:
        _build.launch(entry, pkts.data_ptr(), out.data_ptr(), n,
                      _build.stream_ptr(pkts.device))
        wrapper.launches += 1
    return out


def parse_packets(pkts: torch.Tensor) -> torch.Tensor:
    """pkts: (n, HDR_BYTES) uint8 -> (n, 4) int32, any n."""
    return _parse(parse_packets, parse_packets_plain,
                  "reconic_parse_packets", 4, pkts)


def parse_packet_fields(pkts: torch.Tensor) -> torch.Tensor:
    """pkts: (n, HDR_BYTES) uint8 -> (n, N_FIELDS) int32 raw field rows
    in ``FIELD_NAMES`` order (opcode and dest_qp unmasked), any n — the
    match→action dispatch plane's view of the parsed headers."""
    return _parse(parse_packet_fields, parse_packet_fields_plain,
                  "reconic_parse_packet_fields", N_FIELDS, pkts)


parse_packets.launches = 0
parse_packet_fields.launches = 0

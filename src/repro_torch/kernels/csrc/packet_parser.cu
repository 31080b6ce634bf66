// K3 parse_packets and K4 parse_packet_fields: the Streaming Compute
// block's RoCEv2 header parser and the dispatch plane's classifier.
//
// Replaces src/repro/kernels/packet_parser.py:parse_packets
// (_parser_kernel, _parse_block) and :parse_packet_fields
// (_fields_kernel), both over _raw_fields: the TPU versions parse one
// VMEM block of (block_p, 64) uint8 headers per grid step with vector
// integer ops.
//
// What bounds them on the H100: bytes, and below them the launch. Each
// packet reads 64 header bytes and writes 16 meta bytes (K3) or 32 field
// bytes (K4); 65536 packets move 6 MiB for K4, about 1.9 us at
// 3.35 TB/s, so at the path's burst sizes the few microseconds of a
// launch dominate.
//
// Design: one thread per packet reads the ten header bytes it needs and
// does integer math only, so the rows are byte-exact against the
// reference. raw_fields() is the whole parse; parse_packets writes the
// 4-word meta view (opcode and dest_qp masked to 0 off RDMA), and
// parse_packet_fields writes all eight raw fields in FIELD_NAMES order as
// two 16-byte stores per packet. Neither kernel needs padding to a block
// multiple: the tail threads past n return.
#include "common.cuh"

namespace {

constexpr int kHdrBytes = 64;
constexpr int kRoceUdpPort = 4791;
constexpr int kThreads = 256;

// Traffic classes (packet_parser.py: CLS_*).
constexpr int kClsNonRdma = 0, kClsSend = 1, kClsWrite = 2, kClsReadReq = 3,
              kClsReadResp = 4, kClsAck = 5, kClsOther = 6;

struct Fields {
  int is_rdma, opcode, dest_qp, cls, eth_type, ip_proto, udp_dport,
      udp_sport;
};

__device__ __forceinline__ Fields raw_fields(const uint8_t* p) {
  Fields f;
  f.eth_type = p[12] * 256 + p[13];
  f.ip_proto = p[23];
  f.udp_sport = p[34] * 256 + p[35];
  f.udp_dport = p[36] * 256 + p[37];
  f.opcode = p[42];
  f.dest_qp = p[47] * 65536 + p[48] * 256 + p[49];
  f.is_rdma = (f.eth_type == 0x0800 && f.ip_proto == 17 &&
               f.udp_dport == kRoceUdpPort)
                  ? 1
                  : 0;
  const int op = f.opcode;
  int cls = kClsOther;
  if (op <= 5) cls = kClsSend;
  if (op >= 6 && op <= 11) cls = kClsWrite;
  if (op == 12) cls = kClsReadReq;
  if (op >= 13 && op <= 16) cls = kClsReadResp;
  if (op == 17) cls = kClsAck;
  f.cls = f.is_rdma ? cls : kClsNonRdma;
  return f;
}

__global__ void __launch_bounds__(kThreads)
    parse_packets_kernel(const uint8_t* __restrict__ pkts,
                         int32_t* __restrict__ meta, int n) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  const Fields f = raw_fields(pkts + static_cast<size_t>(i) * kHdrBytes);
  int32_t* row = meta + static_cast<size_t>(i) * 4;
  row[0] = f.is_rdma;
  row[1] = f.opcode * f.is_rdma;
  row[2] = f.dest_qp * f.is_rdma;
  row[3] = f.cls;
}

__global__ void __launch_bounds__(kThreads)
    parse_packet_fields_kernel(const uint8_t* __restrict__ pkts,
                               int32_t* __restrict__ fields, int n) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  const Fields f = raw_fields(pkts + static_cast<size_t>(i) * kHdrBytes);
  // FIELD_NAMES order: is_rdma, opcode, dest_qp, cls, eth_type, ip_proto,
  // udp_dport, udp_sport; a row is 32 bytes, so both halves are aligned.
  int4* row = reinterpret_cast<int4*>(fields + static_cast<size_t>(i) * 8);
  row[0] = make_int4(f.is_rdma, f.opcode, f.dest_qp, f.cls);
  row[1] = make_int4(f.eth_type, f.ip_proto, f.udp_dport, f.udp_sport);
}

}  // namespace

// pkts: (n, 64) uint8, meta: (n, 4) int32, both contiguous.
RECONIC_API int reconic_parse_packets(const void* pkts, void* meta, int n,
                                      void* stream) {
  const int blocks = (n + kThreads - 1) / kThreads;
  parse_packets_kernel<<<blocks, kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(pkts), static_cast<int32_t*>(meta), n);
  return reconic::launch_status();
}

// pkts: (n, 64) uint8, fields: (n, 8) int32, both contiguous, fields
// 16-byte aligned (PyTorch's allocations are).
RECONIC_API int reconic_parse_packet_fields(const void* pkts, void* fields,
                                            int n, void* stream) {
  const int blocks = (n + kThreads - 1) / kThreads;
  parse_packet_fields_kernel<<<blocks, kThreads, 0,
                               static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(pkts), static_cast<int32_t*>(fields), n);
  return reconic::launch_status();
}

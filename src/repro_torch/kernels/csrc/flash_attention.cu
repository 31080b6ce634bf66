// K6 flash_attention: online-softmax attention, the serving path's prefill.
//
// Replaces src/repro/kernels/flash_attention.py:flash_attention
// (_attn_kernel): the TPU version walks a (batch*heads, Sq/bq, Skv/bk)
// grid with the KV sweep innermost and sequential, carrying the running
// max, denominator and f32 accumulator in VMEM scratch from one grid step
// to the next, and skips KV blocks that no query of the block can see.
// GQA went through a repeat of the KV heads in ops.attention.
//
// What bounds it on the H100: operations. At the tinyllama prefill shape
// (8 sequences x 32 q heads over 4 kv heads, S = 512, d = 64, causal, f32)
// QK^T and PV are 4 * 256 * 512 * 513 / 2 * 64 ~ 8.6 GFLOP, 0.128 ms at
// the 67 TFLOP/s f32 peak outside the tensor cores; q, k, v and the output
// are ~76 MB without the KV repeat, 0.023 ms at 3.35 TB/s.
//
// Design: CUDA blocks run in parallel and carry nothing between them, so
// one 256-thread block owns one (sequence, q head, 64-row q tile) and
// loops over the KV tiles itself. Each q row belongs to a quad of four
// threads; a thread keeps a quarter of the row's scaled q and of its f32
// accumulator in registers (interleaved float4 slices, so a quad reads 64
// contiguous bytes of a shared-memory K or V row without bank conflicts).
// A score is the quad's four partial dots summed with two shuffles, so
// all four lanes hold it bit-identically and keep one running max and
// denominator; each lane exponentiates a quarter of the scores and
// shares them by shuffle. K and V tiles are staged in shared memory as
// f32 (bf16 widens on load); at most 128 registers a thread keep two
// blocks resident per SM. The kernel reads q, k and v in their (B, S, H, d)
// layout and maps q head h to kv head h / (Hq / Hkv) itself: no KV
// repeat, no transpose, no padding; the ragged edges of Sq and Skv are
// masked here. The KV loop covers only the tiles the block's queries can
// see under the causal and window masks (the TPU kernel's block skip).
//
// Arithmetic kept from the TPU kernel, so the 2e-4 tolerance holds:
// q * scale in f32 before the dot, masked scores set to -1e30, expf (the
// library is never built with fast math), and a row with no visible key
// writes 0. A masked key contributes an exact 0 to the sums (the TPU
// kernel's exp(-1e30 - m) is 0 as soon as m is a real score). wgmma and
// TMA are later work.
#include "common.cuh"

namespace {

constexpr int kBQ = 64;                   // q rows per block
constexpr int kLanes = 4;                 // threads per q row
constexpr int kThreads = kBQ * kLanes;    // 256
constexpr float kNegInf = -1e30f;

// KV rows per shared-memory tile, sized so that a thread's scores, q and
// accumulator slices fit the 128 registers that two blocks per SM allow.
template <int D>
struct Tile {
  static constexpr int BK = D >= 64 ? 32 : 64;
};

template <typename T, int D>
__global__ void __launch_bounds__(kThreads, 2)
    flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                           const T* __restrict__ v, T* __restrict__ o,
                           int hq, int hkv, int sq, int skv, int causal,
                           int window, float scale) {
  constexpr int BK = Tile<D>::BK;
  constexpr int kVec = D / 4;             // float4 slots in a row
  constexpr int kPer = D / 16;            // float4 slots per lane
  __shared__ float4 ks[BK][kVec];
  __shared__ float4 vs[BK][kVec];

  const int bh = blockIdx.y;
  const int b = bh / hq;
  const int h = bh % hq;
  const int hk = h / (hq / hkv);
  const int tid = threadIdx.x;
  const int lane = tid % kLanes;
  const int q0 = blockIdx.x * kBQ;
  const int qi = q0 + tid / kLanes;
  const bool live = qi < sq;
  const size_t q_row = static_cast<size_t>(hq) * D;
  const size_t kv_row = static_cast<size_t>(hkv) * D;
  const T* qb = q + static_cast<size_t>(b) * sq * q_row + h * D;
  const T* kb = k + static_cast<size_t>(b) * skv * kv_row + hk * D;
  const T* vb = v + static_cast<size_t>(b) * skv * kv_row + hk * D;

  float qr[kPer][4];
  float acc[kPer][4];
#pragma unroll
  for (int e = 0; e < kPer; ++e)
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int d = (e * kLanes + lane) * 4 + c;
      qr[e][c] = live ? __fmul_rn(reconic::to_f32(qb[qi * q_row + d]), scale)
                      : 0.f;
      acc[e][c] = 0.f;
    }
  float m = kNegInf;
  float l = 0.f;

  // KV range any query of this block can see (tile-aligned start).
  const int last_q = min(q0 + kBQ, sq) - 1;
  const int k_end = causal ? min(skv, last_q + 1) : skv;
  const int k_begin = window > 0 ? max(0, q0 - window + 1) / BK * BK : 0;

  for (int k0 = k_begin; k0 < k_end; k0 += BK) {
    __syncthreads();                      // the previous tile is consumed
    for (int e = tid; e < BK * kVec; e += kThreads) {
      const int j = e / kVec;
      const int c4 = e % kVec;
      const int kj = k0 + j;
      float4 kk = make_float4(0.f, 0.f, 0.f, 0.f);
      float4 vv = kk;
      if (kj < skv) {
        const T* kr = kb + kj * kv_row + c4 * 4;
        const T* vr = vb + kj * kv_row + c4 * 4;
        kk = make_float4(reconic::to_f32(kr[0]), reconic::to_f32(kr[1]),
                         reconic::to_f32(kr[2]), reconic::to_f32(kr[3]));
        vv = make_float4(reconic::to_f32(vr[0]), reconic::to_f32(vr[1]),
                         reconic::to_f32(vr[2]), reconic::to_f32(vr[3]));
      }
      ks[j][c4] = kk;
      vs[j][c4] = vv;
    }
    __syncthreads();

    float s[BK];
    float m_cur = kNegInf;
#pragma unroll
    for (int j = 0; j < BK; ++j) {
      float part = 0.f;
#pragma unroll
      for (int e = 0; e < kPer; ++e) {
        const float4 kk = ks[j][e * kLanes + lane];
        part = fmaf(qr[e][0], kk.x, part);
        part = fmaf(qr[e][1], kk.y, part);
        part = fmaf(qr[e][2], kk.z, part);
        part = fmaf(qr[e][3], kk.w, part);
      }
      part += __shfl_xor_sync(0xffffffffu, part, 1);
      part += __shfl_xor_sync(0xffffffffu, part, 2);
      const int kj = k0 + j;
      bool vis = kj < skv;
      if (causal) vis = vis && qi >= kj;
      if (window > 0) vis = vis && (qi - kj) < window;
      s[j] = vis ? part : kNegInf;
      m_cur = fmaxf(m_cur, s[j]);
    }
    const float m_new = fmaxf(m, m_cur);
    const float alpha = expf(m - m_new);
    // each lane of the quad exponentiates every fourth key (a masked key
    // adds an exact zero); the PV loop takes p from its owner by shuffle
    float own[BK / kLanes];
    float psum = 0.f;
#pragma unroll
    for (int jj = 0; jj < BK / kLanes; ++jj) {
      const int j0 = jj * kLanes;
      const float sj = lane == 0   ? s[j0]
                       : lane == 1 ? s[j0 + 1]
                       : lane == 2 ? s[j0 + 2]
                                   : s[j0 + 3];
      own[jj] = sj == kNegInf ? 0.f : expf(sj - m_new);
      psum += own[jj];
    }
    psum += __shfl_xor_sync(0xffffffffu, psum, 1);
    psum += __shfl_xor_sync(0xffffffffu, psum, 2);
    const int quad = tid & ~(kLanes - 1);
#pragma unroll
    for (int e = 0; e < kPer; ++e)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[e][c] *= alpha;
#pragma unroll
    for (int j = 0; j < BK; ++j) {
      const float p = __shfl_sync(0xffffffffu, own[j / kLanes],
                                  quad | (j % kLanes));
#pragma unroll
      for (int e = 0; e < kPer; ++e) {
        const float4 vv = vs[j][e * kLanes + lane];
        acc[e][0] = fmaf(p, vv.x, acc[e][0]);
        acc[e][1] = fmaf(p, vv.y, acc[e][1]);
        acc[e][2] = fmaf(p, vv.z, acc[e][2]);
        acc[e][3] = fmaf(p, vv.w, acc[e][3]);
      }
    }
    l = l * alpha + psum;
    m = m_new;
  }

  if (!live) return;
  T* ob = o + static_cast<size_t>(b) * sq * q_row + h * D + qi * q_row;
#pragma unroll
  for (int e = 0; e < kPer; ++e)
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int d = (e * kLanes + lane) * 4 + c;
      // a row with no visible key keeps l == 0 and writes 0
      reconic::store_f32(ob, d, l == 0.f ? 0.f : acc[e][c] / l);
    }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* o, int batch,
           int hq, int hkv, int sq, int skv, int d, int causal, int window,
           float scale, cudaStream_t stream) {
  const dim3 grid((sq + kBQ - 1) / kBQ, batch * hq);
  const T* qp = static_cast<const T*>(q);
  const T* kp = static_cast<const T*>(k);
  const T* vp = static_cast<const T*>(v);
  T* op = static_cast<T*>(o);
  switch (d) {
    case 16:
      flash_attention_kernel<T, 16><<<grid, kThreads, 0, stream>>>(
          qp, kp, vp, op, hq, hkv, sq, skv, causal, window, scale);
      break;
    case 32:
      flash_attention_kernel<T, 32><<<grid, kThreads, 0, stream>>>(
          qp, kp, vp, op, hq, hkv, sq, skv, causal, window, scale);
      break;
    case 64:
      flash_attention_kernel<T, 64><<<grid, kThreads, 0, stream>>>(
          qp, kp, vp, op, hq, hkv, sq, skv, causal, window, scale);
      break;
    case 128:
      flash_attention_kernel<T, 128><<<grid, kThreads, 0, stream>>>(
          qp, kp, vp, op, hq, hkv, sq, skv, causal, window, scale);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return reconic::launch_status();
}

}  // namespace

// q: (B, Sq, Hq, d), k and v: (B, Skv, Hkv, d), out: (B, Sq, Hq, d), all
// contiguous and of one dtype (f32, or bf16 when is_bf16); Hq % Hkv == 0,
// d in {16, 32, 64, 128}, B * Hq <= 65535. window 0 means no window.
RECONIC_API int reconic_flash_attention(const void* q, const void* k,
                                        const void* v, void* out, int batch,
                                        int hq, int hkv, int sq, int skv,
                                        int d, int causal, int window,
                                        float scale, int is_bf16,
                                        void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch<__nv_bfloat16>(q, k, v, out, batch, hq, hkv, sq, skv, d,
                                 causal, window, scale, s);
  return launch<float>(q, k, v, out, batch, hq, hkv, sq, skv, d, causal,
                       window, scale, s);
}

// K6 flash_attention: online-softmax attention, the serving path's prefill.
//
// The mma.sync route. It takes the calls that the wgmma kernels
// (flash_attention_sm90.cu in bf16, flash_attention_sm90_tf32.cu in f32)
// do not: head dims 16 and 32, and calls of 64 query rows or fewer, which
// one 64-row tile here covers (kernels/flash_attention.py:
// flash_attention_route).
//
// Replaces src/repro/kernels/flash_attention.py:flash_attention
// (_attn_kernel): the TPU version walks a (batch*heads, Sq/bq, Skv/bk)
// grid with the KV sweep innermost and sequential, carrying the running
// max, denominator and f32 accumulator in VMEM scratch from one grid step
// to the next, and skips KV blocks that no query of the block can see.
// GQA went through a repeat of the KV heads in ops.attention.
//
// What bounds it on the H100: operations. At the tinyllama prefill shape
// (8 sequences x 32 q heads over 4 kv heads, S = 512, d = 64, causal)
// QK^T and PV are 4 * 256 * 512 * 513 / 2 * 64 ~ 8.6 GFLOP: 0.128 ms on
// the CUDA cores' 67 TFLOP/s of f32, 0.052 ms as 3xTF32 on the tensor
// cores (three 495 TFLOP/s products each), 0.0087 ms in bf16 at 989
// TFLOP/s, where the ~38 MB of bf16 q, k, v and output (0.011 ms at
// 3.35 TB/s) bound it instead. So the work has to run on the tensor
// cores, and the softmax between the two products must not leave the
// registers.
//
// Design, FlashAttention-2 on mma.sync: CUDA blocks run in parallel and
// carry nothing between them, so one 4-warp block owns one (sequence, q
// head, 64-row q tile) and loops over the KV tiles itself; each warp owns
// 16 q rows, whose Q fragments it loads into registers once (f32 at d =
// 128 stages them in shared memory, where registers run out). 64-key K and
// V tiles stream into dynamic shared memory by 16-byte cp.async (zero-
// filled past Skv), double-buffered so that tile j+1 loads while tile j
// is multiplied; rows are padded so that the fragment loads hit distinct
// banks. S = QK^T stays in the mma accumulators: in the m16n8 layout a
// row lies across a quad of lanes, so its max takes two shuffles, and the
// accumulator of S is already the A operand of PV, so P never goes
// through shared memory. Only tiles that cross the causal diagonal, the
// window edge or Skv are masked element by element; the causal and window
// tile skip are the loop bounds. The kernel reads q, k and v in their (B,
// S, H, d) layout and maps q head h to kv head h / (Hq / Hkv) itself: no
// KV repeat, no transpose, no padding. Blocks start with the longest
// causal rows, so the short ones fill the tail.
//
// V and the output may have a head dim DV narrower than q and k's DQK:
// DeepSeek-V2's MLA attends with q.k over 192 dims (128 nope + 64 rope)
// and v over 128. Each gets its own row stride, K/V tile width and
// output tiles; (192, 128) in f32 takes 221,184 bytes of shared memory
// for two K/V stages and q (V padded to 192 would need 253,952, over the
// 232,448 a block may have), bf16 86,016.
//
// The two routes keep the reference's f32 arithmetic (the 2e-4
// tolerance; no fast math; masked scores -1e30 and an exact 0 weight; a
// row with no visible key writes 0):
// - bf16: mma m16n8k16 bf16 -> f32. A bf16 x bf16 product is exact in
//   f32, so S is the reference's f32 dot; scale multiplies S in f32. K
//   comes in by ldmatrix, V by ldmatrix.trans. P is split as P_hi =
//   bf16(p) and P_lo = bf16(p - P_hi) with two PV products, so PV is the
//   reference's f32 p @ v to ~2^-16 rather than a single bf16 P's 2^-9
//   (1.5x the flops of plain FA2).
// - f32: 3xTF32 on mma m16n8k8: x_hi = tf32_rna(x), x_lo = tf32_rna(x -
//   x_hi), a.b ~ a_lo.b_hi + a_hi.b_lo + a_hi.b_hi, for QK^T (of q * scale,
//   as the reference scales it) and PV: ~2^-21 relative per product
//   where a single TF32 product gives ~2^-11. Each k-step's columns are
//   permuted (logical k, k + 4 -> physical 2k, 2k + 1) on both operands,
//   which leaves the sum unchanged and lets a K fragment come in as one
//   8-byte load and the S accumulator serve as PV's A operand as it is.
//   Each tile's PV goes into fresh accumulators that are then added to
//   O in f32: the tensor cores truncate as they add into C, so an O
//   accumulated there across all tiles drifts with the key count (on an
//   H100, 2e-4 of the output at 32768 keys against float64, where the
//   plain f32 sum stays under 1e-5; 2e-6 with the fresh accumulators,
//   ``tools/k6_drift.py``). The bf16 route keeps O in C: its drift stays
//   under its output's rounding.
#include "flash_attention_mma.cuh"

namespace {

using namespace reconic::mma_attention;
using reconic::cp_async_wait;

constexpr int kBQ = 64;                   // q rows per block, 16 per warp
constexpr int kWarps = kBQ / 16;
constexpr int kThreads = 32 * kWarps;     // 128

// Dynamic shared memory: two K/V stages and, for f32 at d >= 128, q.
template <typename T, int DQK, int DV>
constexpr int smem_bytes() {
  using C = Cfg<T, DQK, DV>;
  return (2 * (C::kKTile + C::kVTile) + (C::kQSmem ? kBQ * C::kKStride : 0)) *
         (int)sizeof(T);
}

template <typename T, int DQK, int DV>
__global__ void __launch_bounds__(kThreads)
    flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                           const T* __restrict__ v, T* __restrict__ o,
                           int hq, int hkv, int sq, int skv, int causal,
                           int window, int qoff, float scale) {
  using C = Cfg<T, DQK, DV>;
  constexpr int kDT = C::kDT;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* ks = reinterpret_cast<T*>(smem_raw);           // [2][kBK][kKStride]
  T* vs = ks + 2 * C::kKTile;                        // [2][kBK][kVStride]
  T* qs = vs + 2 * C::kVTile;                        // [kBQ][kKStride]

  const int n_qt = (sq + kBQ - 1) / kBQ;
  const int q0 = (n_qt - 1 - static_cast<int>(blockIdx.x)) * kBQ;
  const int b = blockIdx.y / hq;
  const int h = blockIdx.y % hq;
  const int hk = h / (hq / hkv);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;                // fragment row (and key) group
  const int t = lane & 3;                 // lane within the quad
  const int r0 = q0 + warp * 16 + g;      // this lane's rows r0, r0 + 8
  const size_t q_row = static_cast<size_t>(hq) * DQK;
  const size_t o_row = static_cast<size_t>(hq) * DV;
  const size_t k_row = static_cast<size_t>(hkv) * DQK;
  const size_t v_row = static_cast<size_t>(hkv) * DV;
  const T* qb = q + static_cast<size_t>(b) * sq * q_row + h * DQK;
  const T* kb = k + static_cast<size_t>(b) * skv * k_row + hk * DQK;
  const T* vb = v + static_cast<size_t>(b) * skv * v_row + hk * DV;
  const bool live0 = r0 < sq;
  const bool live1 = r0 + 8 < sq;

  // KV range any query of this block can see (tile-aligned start); row
  // r sits at position qoff + r among the keys
  const int p0 = qoff + q0;
  const int last_q = qoff + min(q0 + kBQ, sq) - 1;
  const int k_end = causal ? min(skv, last_q + 1) : skv;
  const int k_begin = window > 0 ? max(0, p0 - window + 1) / kBK * kBK : 0;
  const int n_tiles = k_end > k_begin ? (k_end - k_begin + kBK - 1) / kBK
                                      : 0;
  if (n_tiles > 0)
    load_tile<T, DQK, DV, kThreads>(ks, vs, kb, vb, k_row, v_row, k_begin,
                                    skv);

  // Q fragments, loaded once (f32 at d >= 128: the block's 64 rows of
  // q * scale, read by the first tile's sync)
  uint32_t qa[C::kQSmem ? 1 : C::kQK][4];
  uint32_t qlo[C::kBF16 || C::kQSmem ? 1 : C::kQK][4];
  const T* q0p = qb + static_cast<size_t>(r0) * q_row;
  if constexpr (C::kQSmem)
    stage_q<T, DQK, DV, kThreads>(
        qs, kBQ,
        [&](int rr) -> const T* {
          return q0 + rr < sq ? qb + static_cast<size_t>(q0 + rr) * q_row
                              : nullptr;
        },
        scale);
  else
    load_q<T, DQK, DV>(qa, qlo, q0p, q0p + 8 * q_row, live0, live1, scale,
                       t);
  const int qpos[2] = {qoff + r0, qoff + r0 + 8};

  float acc[kDT][4];
#pragma unroll
  for (int n = 0; n < kDT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.f, 0.f};

  for (int it = 0; it < n_tiles; ++it) {
    const int k0 = k_begin + it * kBK;
    const int st = it & 1;
    if (it + 1 < n_tiles) {
      load_tile<T, DQK, DV, kThreads>(ks + (st ^ 1) * C::kKTile,
                                      vs + (st ^ 1) * C::kVTile, kb, vb,
                                      k_row, v_row, k0 + kBK, skv);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const T* kst = ks + st * C::kKTile;
    const T* vst = vs + st * C::kVTile;
    const T* qsw = qs + warp * 16 * C::kKStride;
    // only tiles that cross the causal diagonal, the window edge or Skv
    // are masked element by element
    const bool edge = k0 + kBK > skv || (causal && k0 + kBK - 1 > p0) ||
                      (window > 0 && p0 + kBQ - 1 - k0 >= window);
    attend_tile<T, DQK, DV>(qa, qlo, qsw, kst, vst, acc, m, l, scale, edge,
                            qpos, k0 + 2 * t, skv, causal, window);
    __syncthreads();                      // the tile is consumed
  }

  reduce_l(l);
  T* ob = o + static_cast<size_t>(b) * sq * o_row + h * DV;
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int row = r0 + 8 * hr;
    if (row >= sq) continue;
    T* orow = ob + static_cast<size_t>(row) * o_row + 2 * t;
#pragma unroll
    for (int n = 0; n < kDT; ++n)
      store_pair(orow + n * 8, acc[n][2 * hr], acc[n][2 * hr + 1], l[hr]);
  }
}

template <typename T, int DQK, int DV>
int launch_d(const void* q, const void* k, const void* v, void* o, int batch,
             int hq, int hkv, int sq, int skv, int causal, int window,
             int qoff, float scale, cudaStream_t stream) {
  constexpr int smem = smem_bytes<T, DQK, DV>();
  auto kern = flash_attention_kernel<T, DQK, DV>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid((sq + kBQ - 1) / kBQ, batch * hq);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), hq, hkv, sq, skv, causal,
      window, qoff, scale);
  return reconic::launch_status();
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* o, int batch,
           int hq, int hkv, int sq, int skv, int d, int dv, int causal,
           int window, int qoff, float scale, cudaStream_t stream) {
#define RECONIC_FA_CASE(DQK, DV)                                           \
  if (d == DQK && dv == DV)                                                \
    return launch_d<T, DQK, DV>(q, k, v, o, batch, hq, hkv, sq, skv, causal, \
                                window, qoff, scale, stream);
  RECONIC_FA_CASE(16, 16)
  RECONIC_FA_CASE(32, 32)
  RECONIC_FA_CASE(64, 64)
  RECONIC_FA_CASE(128, 128)
  RECONIC_FA_CASE(192, 128)
#undef RECONIC_FA_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// q: (B, Sq, Hq, d), k: (B, Skv, Hkv, d), v: (B, Skv, Hkv, dv), out: (B,
// Sq, Hq, dv), all contiguous, 16-byte aligned and of one dtype (f32, or
// bf16 when is_bf16); Hq % Hkv == 0, (d, dv) one of (16, 16), (32, 32),
// (64, 64), (128, 128), (192, 128); B * Hq <= 65535. window 0 means no
// window; q_offset (>= 0) is the position of q's first row among the keys.
RECONIC_API int reconic_flash_attention(const void* q, const void* k,
                                        const void* v, void* out, int batch,
                                        int hq, int hkv, int sq, int skv,
                                        int d, int dv, int causal, int window,
                                        int q_offset, float scale,
                                        int is_bf16, void* stream) {
  if (q_offset < 0) return static_cast<int>(cudaErrorInvalidValue);
  if ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
       reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(out)) %
      16)
    return static_cast<int>(cudaErrorMisalignedAddress);
  auto s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch<__nv_bfloat16>(q, k, v, out, batch, hq, hkv, sq, skv, d,
                                 dv, causal, window, q_offset, scale, s);
  return launch<float>(q, k, v, out, batch, hq, hkv, sq, skv, d, dv, causal,
                       window, q_offset, scale, s);
}

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
#include <type_traits>

#include "common.cuh"

namespace {

using reconic::cp_async16;
using reconic::cp_async_commit;
using reconic::cp_async_wait;
using reconic::mma_tf32;
using reconic::smem_u32;
using reconic::split_tf32;

constexpr int kBQ = 64;                   // q rows per block, 16 per warp
constexpr int kBK = 64;                   // keys per K/V tile
constexpr int kWarps = kBQ / 16;
constexpr int kThreads = 32 * kWarps;     // 128
constexpr int kNT = kBK / 8;              // 8-key n-tiles of S per tile
constexpr float kNegInf = -1e30f;

// DQK: the head dim of q and k; DV: that of v and the output.
template <typename T, int DQK, int DV>
struct Cfg {
  static constexpr bool kBF16 = std::is_same<T, __nv_bfloat16>::value;
  // Row strides in elements. bf16: +8 (16 bytes) puts the 8 rows of an
  // ldmatrix on 8 distinct 16-byte bank groups. f32: K rows +8 words make
  // a half-warp's 8-byte fragment loads distinct, V rows +4 words the
  // warp's 4-byte loads of 8 keys x 4 rows.
  static constexpr int kKStride = DQK + 8;
  static constexpr int kVStride = DV + (kBF16 ? 8 : 4);
  static constexpr int kKTile = kBK * kKStride;
  static constexpr int kVTile = kBK * kVStride;
  // f32 at d >= 128 keeps q * scale in shared memory (K's row stride):
  // in registers it would push the kernel past 255 and spill
  static constexpr bool kQSmem = !kBF16 && DQK > 64;
  static constexpr int kQTile = kQSmem ? kBQ * kKStride : 0;
  static constexpr int kSmem =
      (2 * (kKTile + kVTile) + kQTile) * (int)sizeof(T);
  static constexpr int kVec = 16 / (int)sizeof(T);   // elements per copy
  static constexpr int kKCopies = DQK / kVec;        // copies per K row
  static constexpr int kVCopies = DV / kVec;         // copies per V row
};

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
// (p0, p1) = hi + lo as bf16 pairs: hi rounds p, lo rounds the residual.
__device__ __forceinline__ void split_bf16(float p0, float p1, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(p0, p1);
  const __nv_bfloat162 l = __floats2bfloat162_rn(p0 - __low2float(h),
                                                 p1 - __high2float(h));
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

// One 64-key tile of K and V into shared memory (one commit group).
// k_row and v_row are the global row strides in elements.
template <typename T, int DQK, int DV>
__device__ __forceinline__ void load_tile(T* ks, T* vs, const T* kb,
                                          const T* vb, size_t k_row,
                                          size_t v_row, int k0, int skv) {
  using C = Cfg<T, DQK, DV>;
  if constexpr (DQK == DV) {
    // each row's K and V copies issued together: K's, then V's, in two
    // loops timed slower on the square shapes (PERF.md §6)
#pragma unroll
    for (int e = threadIdx.x; e < kBK * C::kKCopies; e += kThreads) {
      const int j = e / C::kKCopies;
      const int c = (e % C::kKCopies) * C::kVec;
      const bool valid = k0 + j < skv;
      const size_t off = valid ? static_cast<size_t>(k0 + j) * k_row + c : 0;
      cp_async16(ks + j * C::kKStride + c, kb + off, valid);
      cp_async16(vs + j * C::kVStride + c, vb + off, valid);
    }
  } else {
#pragma unroll
    for (int e = threadIdx.x; e < kBK * C::kKCopies; e += kThreads) {
      const int j = e / C::kKCopies;
      const int c = (e % C::kKCopies) * C::kVec;
      const bool valid = k0 + j < skv;
      cp_async16(ks + j * C::kKStride + c,
                 kb + (valid ? static_cast<size_t>(k0 + j) * k_row + c : 0),
                 valid);
    }
#pragma unroll
    for (int e = threadIdx.x; e < kBK * C::kVCopies; e += kThreads) {
      const int j = e / C::kVCopies;
      const int c = (e % C::kVCopies) * C::kVec;
      const bool valid = k0 + j < skv;
      cp_async16(vs + j * C::kVStride + c,
                 vb + (valid ? static_cast<size_t>(k0 + j) * v_row + c : 0),
                 valid);
    }
  }
  cp_async_commit();
}

// The online softmax of one tile on a thread's S fragments: rows r0 and
// r0 + 8 (fragment elements 0-1 and 2-3), keys kc + 8j and kc + 8j + 1.
// Turns s into p, updates the running max m and this lane's partial
// denominator l, and returns each row's rescale factor in alpha.
template <bool kMask>
__device__ __forceinline__ void softmax_tile(float (&s)[kNT][4],
                                             float (&m)[2], float (&l)[2],
                                             float (&alpha)[2], float scale,
                                             int r0, int kc, int skv,
                                             int causal, int window) {
#pragma unroll
  for (int j = 0; j < kNT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float x = s[j][e] * scale;
      if (kMask) {
        const int qi = r0 + (e >> 1) * 8;
        const int kj = kc + 8 * j + (e & 1);
        bool vis = kj < skv;
        if (causal) vis = vis && qi >= kj;
        if (window > 0) vis = vis && (qi - kj) < window;
        x = vis ? x : kNegInf;
      }
      s[j][e] = x;
    }
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    float mx = kNegInf;
#pragma unroll
    for (int j = 0; j < kNT; ++j)
      mx = fmaxf(mx, fmaxf(s[j][2 * hr], s[j][2 * hr + 1]));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(m[hr], mx);
    alpha[hr] = expf(m[hr] - m_new);
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < kNT; ++j)
#pragma unroll
      for (int c = 2 * hr; c < 2 * hr + 2; ++c) {
        // a masked key weighs an exact 0 (the reference's exp(-1e30 - m))
        const float p = (kMask && s[j][c] == kNegInf) ? 0.f
                                                      : expf(s[j][c] - m_new);
        s[j][c] = p;
        sum += p;
      }
    l[hr] = l[hr] * alpha[hr] + sum;
    m[hr] = m_new;
  }
}

template <typename T, int DQK, int DV>
__global__ void __launch_bounds__(kThreads)
    flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                           const T* __restrict__ v, T* __restrict__ o,
                           int hq, int hkv, int sq, int skv, int causal,
                           int window, int qoff, float scale) {
  using C = Cfg<T, DQK, DV>;
  constexpr bool kBF16 = C::kBF16;
  constexpr int kDT = DV / 8;             // 8-wide n-tiles of the output
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
    load_tile<T, DQK, DV>(ks, vs, kb, vb, k_row, v_row, k_begin, skv);

  // Q fragments, loaded once. bf16: the m16n8k16 A layout as it is. f32:
  // q * scale in the permuted m16n8k8 A layout (elements 0/2 of a k-step
  // are columns 2t and 2t + 1 of row r0, 1/3 the same of row r0 + 8),
  // split into TF32 hi and lo; at d >= 128 staged in shared memory and
  // split at each use.
  constexpr int kQK = kBF16 ? DQK / 16 : DQK / 8;    // k-steps of QK^T
  constexpr bool kQSmem = C::kQSmem;
  uint32_t qa[kQSmem ? 1 : kQK][4];
  uint32_t qlo[kBF16 || kQSmem ? 1 : kQK][4];
  const T* q0p = qb + static_cast<size_t>(r0) * q_row;
  const T* q1p = q0p + 8 * q_row;
  if constexpr (kQSmem) {
    // the block's 64 rows of q * scale (read by the first tile's sync)
#pragma unroll
    for (int e = threadIdx.x; e < kBQ * DQK / 4; e += kThreads) {
      const int rr = e / (DQK / 4);
      const int c = (e % (DQK / 4)) * 4;
      float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
      if (q0 + rr < sq)
        x = *reinterpret_cast<const float4*>(
            qb + static_cast<size_t>(q0 + rr) * q_row + c);
      *reinterpret_cast<float4*>(qs + rr * C::kKStride + c) =
          make_float4(__fmul_rn(x.x, scale), __fmul_rn(x.y, scale),
                      __fmul_rn(x.z, scale), __fmul_rn(x.w, scale));
    }
  }
#pragma unroll
  for (int kk = 0; kk < (kQSmem ? 0 : kQK); ++kk) {
    if constexpr (kBF16) {
      const int col = kk * 16 + 2 * t;
      qa[kk][0] = live0 ? *reinterpret_cast<const uint32_t*>(q0p + col) : 0u;
      qa[kk][1] = live1 ? *reinterpret_cast<const uint32_t*>(q1p + col) : 0u;
      qa[kk][2] =
          live0 ? *reinterpret_cast<const uint32_t*>(q0p + col + 8) : 0u;
      qa[kk][3] =
          live1 ? *reinterpret_cast<const uint32_t*>(q1p + col + 8) : 0u;
    } else {
      const int col = kk * 8 + 2 * t;
      const float2 x0 = live0 ? *reinterpret_cast<const float2*>(q0p + col)
                              : make_float2(0.f, 0.f);
      const float2 x1 = live1 ? *reinterpret_cast<const float2*>(q1p + col)
                              : make_float2(0.f, 0.f);
      const float xs[4] = {__fmul_rn(x0.x, scale), __fmul_rn(x1.x, scale),
                           __fmul_rn(x0.y, scale), __fmul_rn(x1.y, scale)};
#pragma unroll
      for (int i = 0; i < 4; ++i) split_tf32(xs[i], qa[kk][i], qlo[kk][i]);
    }
  }
  // bf16 scales S after the product; f32 scaled q before it
  const float s_scale = kBF16 ? scale : 1.0f;

  (void)qa;
  (void)qlo;
  (void)qs;
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
      load_tile<T, DQK, DV>(ks + (st ^ 1) * C::kKTile,
                            vs + (st ^ 1) * C::kVTile, kb, vb, k_row, v_row,
                            k0 + kBK, skv);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const T* kst = ks + st * C::kKTile;
    const T* vst = vs + st * C::kVTile;

    float s[kNT][4];
#pragma unroll
    for (int j = 0; j < kNT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;

    // ---- S = Q K^T
    if constexpr (kBF16) {
      const int mi = lane >> 3;
#pragma unroll
      for (int kk = 0; kk < kQK; ++kk)
#pragma unroll
        for (int jp = 0; jp < kNT / 2; ++jp) {
          // matrices: keys +0/+8 x dims +0/+8 -> b0, b1 of n-tiles 2jp, 2jp+1
          uint32_t bk[4];
          const int key = jp * 16 + (lane & 7) + ((mi >> 1) << 3);
          ldsm_x4(bk, kst + key * C::kKStride + kk * 16 + ((mi & 1) << 3));
          mma_bf16(s[2 * jp], qa[kk], bk[0], bk[1]);
          mma_bf16(s[2 * jp + 1], qa[kk], bk[2], bk[3]);
        }
    } else {
#pragma unroll
      for (int kk = 0; kk < kQK; ++kk) {
        uint32_t ah[4], al[4];
        if constexpr (kQSmem) {
          const T* qr = qs + (warp * 16 + g) * C::kKStride + kk * 8 + 2 * t;
          const float2 x0 = *reinterpret_cast<const float2*>(qr);
          const float2 x1 =
              *reinterpret_cast<const float2*>(qr + 8 * C::kKStride);
          split_tf32(x0.x, ah[0], al[0]);
          split_tf32(x1.x, ah[1], al[1]);
          split_tf32(x0.y, ah[2], al[2]);
          split_tf32(x1.y, ah[3], al[3]);
        } else {
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            ah[i] = qa[kk][i];
            al[i] = qlo[kk][i];
          }
        }
#pragma unroll
        for (int j = 0; j < kNT; ++j) {
          const float2 kv = *reinterpret_cast<const float2*>(
              kst + (j * 8 + g) * C::kKStride + kk * 8 + 2 * t);
          uint32_t bh0, bl0, bh1, bl1;
          split_tf32(kv.x, bh0, bl0);
          split_tf32(kv.y, bh1, bl1);
          mma_tf32(s[j], al, bh0, bh1);
          mma_tf32(s[j], ah, bl0, bl1);
          mma_tf32(s[j], ah, bh0, bh1);
        }
      }
    }

    // ---- online softmax on the fragments; only edge tiles are masked
    const bool edge = k0 + kBK > skv || (causal && k0 + kBK - 1 > p0) ||
                      (window > 0 && p0 + kBQ - 1 - k0 >= window);
    float alpha[2];
    if (edge)
      softmax_tile<true>(s, m, l, alpha, s_scale, qoff + r0, k0 + 2 * t, skv,
                         causal, window);
    else
      softmax_tile<false>(s, m, l, alpha, s_scale, qoff + r0, k0 + 2 * t,
                          skv, causal, window);
#pragma unroll
    for (int n = 0; n < kDT; ++n) {
      acc[n][0] *= alpha[0];
      acc[n][1] *= alpha[0];
      acc[n][2] *= alpha[1];
      acc[n][3] *= alpha[1];
    }

    // ---- O += P V, P straight from the S accumulators
    if constexpr (kBF16) {
      const int mi = lane >> 3;
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk) {
        uint32_t ph[4], pl[4];
        split_bf16(s[2 * kk][0], s[2 * kk][1], ph[0], pl[0]);
        split_bf16(s[2 * kk][2], s[2 * kk][3], ph[1], pl[1]);
        split_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1], ph[2], pl[2]);
        split_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3], ph[3], pl[3]);
#pragma unroll
        for (int np = 0; np < kDT / 2; ++np) {
          // matrices: keys +0/+8 x dims +0/+8, transposed -> b0, b1 of
          // n-tiles 2np, 2np+1
          uint32_t bv[4];
          const int key = kk * 16 + (lane & 7) + ((mi & 1) << 3);
          ldsm_x4_t(bv, vst + key * C::kVStride + np * 16 + ((mi >> 1) << 3));
          mma_bf16(acc[2 * np], pl, bv[0], bv[1]);
          mma_bf16(acc[2 * np], ph, bv[0], bv[1]);
          mma_bf16(acc[2 * np + 1], pl, bv[2], bv[3]);
          mma_bf16(acc[2 * np + 1], ph, bv[2], bv[3]);
        }
      }
    } else {
      // the tile's PV in fresh accumulators, added to O in f32 (see the
      // f32 route above)
      float pv[kDT][4];
#pragma unroll
      for (int n = 0; n < kDT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) pv[n][e] = 0.f;
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
        // A of k-step j in the permuted layout: keys 2t (elements 0, 1)
        // and 2t + 1 (2, 3) of rows r0 and r0 + 8
        uint32_t ph[4], pl[4];
        split_tf32(s[j][0], ph[0], pl[0]);
        split_tf32(s[j][2], ph[1], pl[1]);
        split_tf32(s[j][1], ph[2], pl[2]);
        split_tf32(s[j][3], ph[3], pl[3]);
        const T* v0 = vst + (j * 8 + 2 * t) * C::kVStride + g;
#pragma unroll
        for (int n = 0; n < kDT; ++n) {
          uint32_t bh0, bl0, bh1, bl1;
          split_tf32(v0[n * 8], bh0, bl0);
          split_tf32(v0[C::kVStride + n * 8], bh1, bl1);
          mma_tf32(pv[n], pl, bh0, bh1);
          mma_tf32(pv[n], ph, bl0, bl1);
          mma_tf32(pv[n], ph, bh0, bh1);
        }
      }
#pragma unroll
      for (int n = 0; n < kDT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[n][e] += pv[n][e];
    }
    __syncthreads();                      // the tile is consumed
  }

  // the row's denominator is the quad's partial sums
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    l[hr] += __shfl_xor_sync(0xffffffffu, l[hr], 1);
    l[hr] += __shfl_xor_sync(0xffffffffu, l[hr], 2);
  }
  T* ob = o + static_cast<size_t>(b) * sq * o_row + h * DV;
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int row = r0 + 8 * hr;
    if (row >= sq) continue;
    T* orow = ob + static_cast<size_t>(row) * o_row + 2 * t;
    // a row with no visible key keeps l == 0 and writes 0
    const float lr = l[hr];
#pragma unroll
    for (int n = 0; n < kDT; ++n) {
      const float v0 = lr == 0.f ? 0.f : acc[n][2 * hr] / lr;
      const float v1 = lr == 0.f ? 0.f : acc[n][2 * hr + 1] / lr;
      if constexpr (kBF16)
        *reinterpret_cast<__nv_bfloat162*>(orow + n * 8) =
            __floats2bfloat162_rn(v0, v1);
      else
        *reinterpret_cast<float2*>(orow + n * 8) = make_float2(v0, v1);
    }
  }
}

template <typename T, int DQK, int DV>
int launch_d(const void* q, const void* k, const void* v, void* o, int batch,
             int hq, int hkv, int sq, int skv, int causal, int window,
             int qoff, float scale, cudaStream_t stream) {
  using C = Cfg<T, DQK, DV>;
  auto kern = flash_attention_kernel<T, DQK, DV>;
  if (C::kSmem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, C::kSmem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid((sq + kBQ - 1) / kBQ, batch * hq);
  kern<<<grid, kThreads, C::kSmem, stream>>>(
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

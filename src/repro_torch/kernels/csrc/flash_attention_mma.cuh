// The mma.sync attention machinery of K6's two mma.sync kernels: the
// mma_sync route (flash_attention.cu, a 64-row q tile a block) and the
// split_kv route (flash_attention_splitkv.cu, a GQA group's short rows
// over one split of the keys). flash_attention.cu's note gives the
// arithmetic; in short:
// - K and V come in 64-key tiles of padded rows (bank-conflict-free
//   fragment loads), filled by 16-byte cp.async and zero past Skv;
// - a warp owns 16 q rows: Q fragments in registers (bf16 as they are;
//   f32 as q * scale split into TF32 hi and lo; f32 at d >= 128 staged in
//   shared memory and split at each use);
// - one tile is S = QK^T in the mma accumulators, the online softmax on
//   the fragments (masked scores -1e30 with an exact 0 weight), then
//   O += PV with P straight from the S accumulators: bf16 on m16n8k16
//   with P split as bf16(p) + bf16(p - hi), f32 as 3xTF32 on m16n8k8
//   into fresh accumulators added to O in f32.
// A row's mask position is passed per row, so that a kernel may pack
// rows of several q heads (split_kv's GQA group) into one tile.
#pragma once

#include <type_traits>

#include "common.cuh"

namespace reconic {
namespace mma_attention {

constexpr int kBK = 64;                   // keys per K/V tile
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
  static constexpr int kVec = 16 / (int)sizeof(T);   // elements per copy
  static constexpr int kKCopies = DQK / kVec;        // copies per K row
  static constexpr int kVCopies = DV / kVec;         // copies per V row
  static constexpr int kQK = kBF16 ? DQK / 16 : DQK / 8;  // QK^T k-steps
  static constexpr int kDT = DV / 8;      // 8-wide n-tiles of the output
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

// One 64-key tile of K and V into shared memory (one commit group), by
// the block's threads: kThreads of them, or nthreads where kThreads is 0
// (a block size known only at run time). k_row and v_row are the global
// row strides in elements.
template <typename T, int DQK, int DV, int kThreads>
__device__ __forceinline__ void load_tile(T* ks, T* vs, const T* kb,
                                          const T* vb, size_t k_row,
                                          size_t v_row, int k0, int skv,
                                          int nthreads = kThreads) {
  using C = Cfg<T, DQK, DV>;
  if constexpr (kThreads > 0) nthreads = kThreads;
  if constexpr (DQK == DV) {
    // each row's K and V copies issued together: K's, then V's, in two
    // loops timed slower on the square shapes (PERF.md §6)
#pragma unroll
    for (int e = threadIdx.x; e < kBK * C::kKCopies; e += nthreads) {
      const int j = e / C::kKCopies;
      const int c = (e % C::kKCopies) * C::kVec;
      const bool valid = k0 + j < skv;
      const size_t off = valid ? static_cast<size_t>(k0 + j) * k_row + c : 0;
      cp_async16(ks + j * C::kKStride + c, kb + off, valid);
      cp_async16(vs + j * C::kVStride + c, vb + off, valid);
    }
  } else {
#pragma unroll
    for (int e = threadIdx.x; e < kBK * C::kKCopies; e += nthreads) {
      const int j = e / C::kKCopies;
      const int c = (e % C::kKCopies) * C::kVec;
      const bool valid = k0 + j < skv;
      cp_async16(ks + j * C::kKStride + c,
                 kb + (valid ? static_cast<size_t>(k0 + j) * k_row + c : 0),
                 valid);
    }
#pragma unroll
    for (int e = threadIdx.x; e < kBK * C::kVCopies; e += nthreads) {
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

// The Q fragments of a warp's rows r and r + 8 (this lane's, at q0p and
// q1p; live0 / live1 false for a row past the call), loaded once. bf16:
// the m16n8k16 A layout as it is. f32: q * scale in the permuted m16n8k8
// A layout (elements 0/2 of a k-step are columns 2t and 2t + 1 of row r,
// 1/3 the same of row r + 8), split into TF32 hi and lo. Not used where
// Cfg::kQSmem (stage_q below).
template <typename T, int DQK, int DV>
__device__ __forceinline__ void load_q(
    uint32_t (&qa)[Cfg<T, DQK, DV>::kQSmem ? 1 : Cfg<T, DQK, DV>::kQK][4],
    uint32_t (&qlo)[Cfg<T, DQK, DV>::kBF16 || Cfg<T, DQK, DV>::kQSmem
                        ? 1
                        : Cfg<T, DQK, DV>::kQK][4],
    const T* q0p, const T* q1p, bool live0, bool live1, float scale,
    int t) {
  using C = Cfg<T, DQK, DV>;
#pragma unroll
  for (int kk = 0; kk < (C::kQSmem ? 0 : C::kQK); ++kk) {
    if constexpr (C::kBF16) {
      const int col = kk * 16 + 2 * t;
      qa[kk][0] = live0 ? *reinterpret_cast<const uint32_t*>(q0p + col) : 0u;
      qa[kk][1] = live1 ? *reinterpret_cast<const uint32_t*>(q1p + col) : 0u;
      qa[kk][2] =
          live0 ? *reinterpret_cast<const uint32_t*>(q0p + col + 8) : 0u;
      qa[kk][3] =
          live1 ? *reinterpret_cast<const uint32_t*>(q1p + col + 8) : 0u;
    } else if constexpr (!C::kQSmem) {
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
}

// f32 at d >= 128: q * scale of a block's n_rows rows into qs (row stride
// kKStride; row_ptr(rr) the rr-th row's start, nullptr past the call,
// whose row is zero), by the block's threads (as load_tile counts them).
// A __syncthreads must follow before the first use.
template <typename T, int DQK, int DV, int kThreads, typename RowPtr>
__device__ __forceinline__ void stage_q(T* qs, int n_rows, RowPtr row_ptr,
                                        float scale,
                                        int nthreads = kThreads) {
  using C = Cfg<T, DQK, DV>;
  if constexpr (kThreads > 0) nthreads = kThreads;
#pragma unroll
  for (int e = threadIdx.x; e < n_rows * DQK / 4; e += nthreads) {
    const int rr = e / (DQK / 4);
    const int c = (e % (DQK / 4)) * 4;
    const T* src = row_ptr(rr);
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (src != nullptr) x = *reinterpret_cast<const float4*>(src + c);
    *reinterpret_cast<float4*>(qs + rr * C::kKStride + c) =
        make_float4(__fmul_rn(x.x, scale), __fmul_rn(x.y, scale),
                    __fmul_rn(x.z, scale), __fmul_rn(x.w, scale));
  }
}

// The online softmax of one tile on a thread's S fragments: rows at
// positions qpos[0] and qpos[1] (fragment elements 0-1 and 2-3), keys kc
// + 8j and kc + 8j + 1. Turns s into p, updates the running max m and
// this lane's partial denominator l, and returns each row's rescale
// factor in alpha.
template <bool kMask>
__device__ __forceinline__ void softmax_tile(float (&s)[kNT][4],
                                             float (&m)[2], float (&l)[2],
                                             float (&alpha)[2], float scale,
                                             const int (&qpos)[2], int kc,
                                             int skv, int causal,
                                             int window) {
#pragma unroll
  for (int j = 0; j < kNT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float x = s[j][e] * scale;
      if (kMask) {
        const int qi = qpos[e >> 1];
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

// One 64-key tile (kst, vst in shared memory) for a warp's 16 rows: S =
// QK^T from the Q fragments qa / qlo (or, where Cfg::kQSmem, from qsw,
// the warp's 16 rows of q * scale in shared memory), the online softmax
// (masked element by element on an edge tile only), and acc = acc *
// alpha + PV. The products are written once, the softmax twice: two
// copies of the whole tile would double the hot loop's code.
template <typename T, int DQK, int DV>
__device__ __forceinline__ void attend_tile(
    const uint32_t (&qa)[Cfg<T, DQK, DV>::kQSmem ? 1 : Cfg<T, DQK, DV>::kQK]
                        [4],
    const uint32_t (&qlo)[Cfg<T, DQK, DV>::kBF16 || Cfg<T, DQK, DV>::kQSmem
                              ? 1
                              : Cfg<T, DQK, DV>::kQK][4],
    const T* qsw, const T* kst, const T* vst,
    float (&acc)[Cfg<T, DQK, DV>::kDT][4], float (&m)[2], float (&l)[2],
    float scale, bool edge, const int (&qpos)[2], int kc, int skv,
    int causal, int window) {
  using C = Cfg<T, DQK, DV>;
  constexpr int kDT = C::kDT;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;
  const int t = lane & 3;

  float s[kNT][4];
#pragma unroll
  for (int j = 0; j < kNT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] = 0.f;

  // ---- S = Q K^T
  if constexpr (C::kBF16) {
    const int mi = lane >> 3;
#pragma unroll
    for (int kk = 0; kk < C::kQK; ++kk)
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
    for (int kk = 0; kk < C::kQK; ++kk) {
      uint32_t ah[4], al[4];
      if constexpr (C::kQSmem) {
        const T* qr = qsw + g * C::kKStride + kk * 8 + 2 * t;
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

  // ---- online softmax on the fragments; bf16 scales S after the
  // product, f32 scaled q before it
  float alpha[2];
  const float s_scale = C::kBF16 ? scale : 1.0f;
  if (edge)
    softmax_tile<true>(s, m, l, alpha, s_scale, qpos, kc, skv, causal,
                       window);
  else
    softmax_tile<false>(s, m, l, alpha, s_scale, qpos, kc, skv, causal,
                        window);
#pragma unroll
  for (int n = 0; n < kDT; ++n) {
    acc[n][0] *= alpha[0];
    acc[n][1] *= alpha[0];
    acc[n][2] *= alpha[1];
    acc[n][3] *= alpha[1];
  }

  // ---- O += P V, P straight from the S accumulators
  if constexpr (C::kBF16) {
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
    // the tile's PV in fresh accumulators, added to O in f32 (see
    // flash_attention.cu's f32 route)
    float pv[kDT][4];
#pragma unroll
    for (int n = 0; n < kDT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) pv[n][e] = 0.f;
#pragma unroll
    for (int j = 0; j < kNT; ++j) {
      // A of k-step j in the permuted layout: keys 2t (elements 0, 1)
      // and 2t + 1 (2, 3) of rows r and r + 8
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
}

// A row's denominator is its quad's partial sums.
__device__ __forceinline__ void reduce_l(float (&l)[2]) {
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    l[hr] += __shfl_xor_sync(0xffffffffu, l[hr], 1);
    l[hr] += __shfl_xor_sync(0xffffffffu, l[hr], 2);
  }
}

// This lane's two columns of output n-tile n, acc / l in f32 (0 for a row
// with no visible key: l == 0), stored as T at dst.
template <typename T>
__device__ __forceinline__ void store_pair(T* dst, float a0, float a1,
                                           float lr) {
  const float v0 = lr == 0.f ? 0.f : a0 / lr;
  const float v1 = lr == 0.f ? 0.f : a1 / lr;
  if constexpr (std::is_same<T, __nv_bfloat16>::value)
    *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(v0, v1);
  else
    *reinterpret_cast<float2*>(dst) = make_float2(v0, v1);
}

}  // namespace mma_attention
}  // namespace reconic

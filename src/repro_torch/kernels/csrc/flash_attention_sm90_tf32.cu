// K6 flash_attention, f32 route for Hopper: 3xTF32 on wgmma over TMA-fed
// K-major tiles and a producer warp.
//
// Replaces src/repro/kernels/flash_attention.py:_attn_kernel for f32
// inputs at the served head dims (64, 64), (128, 128) and MLA's (192,
// 128) with more than 64 query rows; flash_attention.cu's mma.sync kernel
// keeps f32 at head dims 16 and 32 and at 64 rows or fewer
// (kernels/flash_attention.py:flash_attention_route). The TPU version
// walks a (batch*heads, Sq/bq, Skv/bk) grid with the KV sweep innermost
// and sequential, carrying the running max, denominator and f32
// accumulator in VMEM scratch from one grid step to the next.
//
// The f32 contract is the mma.sync route's: QK^T of q * scale (scaled in
// f32 before the product), 3xTF32 products (x_hi = tf32_rna(x), x_lo =
// tf32_rna(x - x_hi), a.b ~ a_lo.b_hi + a_hi.b_lo + a_hi.b_hi), masked
// scores -1e30 with an exact 0 weight, 0 for a row with no visible key,
// expf and no fast math. One operand reaches the tensor cores with its
// low 13 bits set: K itself, as K's hi part, which they read as TF32 by
// dropping those bits. So K_hi = trunc(K), and the pre-pass writes only
// K_lo = tf32_rna(K - trunc(K)); every other operand's low bits are 0.
// (Measured on an H100: with this K_lo the error stays within 1.2x of a
// split that rounds K_hi first, tools/k6_ablation.py's tf32_rnahi; a hi
// part the tensor cores rounded would leave a TF32 step uncorrected, the
// error of a single TF32 product, 8-13x the f32 limit.)
//
// What bounds it on the H100: operations. At deepseek-v2-lite's MLA
// prefill (8 x 512 rows, 16 heads, q/k 192 and v 128, causal) QK^T and PV
// are 10.8 GFLOP of the function's own work, 0.16 ms at the 67 TFLOP/s of
// f32 outside the tensor cores; as three TF32 products each they take
// 0.0652 ms at the 495 TFLOP/s of dense TF32, against 0.050 ms for the
// bytes of q, k, v and the output. The split below adds a pre-pass over K
// and V (read once; K's lo part and V's two written: 0.060 ms of bytes at
// this shape, small at the GQA shapes, whose K and V are a fifth of q or
// less).
//
// wgmma in TF32 takes its operands K-major only (the transpose flags are
// the 16-bit types'). QK^T is K-major as it stands: q and k rows have d
// contiguous. PV's B is V with keys along K, so V has to reach shared
// memory with keys contiguous. A pre-pass kernel (flash_attention_tf32_
// split, one block per 32 keys of a kv head) makes the lo parts and the
// transpose once per call into scratch that the wrapper allocates:
// K_lo in K's (B, Skv, Hkv, d) layout, and V^T_hi and V^T_lo as (B, Hkv,
// dv, Skv8), Skv rounded up to 8 with zero keys. Within each 8
// keys V^T is permuted (position i holds key 2 (i % 4) + i / 4): P's A
// fragments then come from the S accumulators as they are (a thread's
// S holds keys 2t and 2t + 1 of an 8-key chunk, and wgmma's TF32 A
// fragment takes k = t and t + 4), the permutation the mma.sync route
// makes on both operands. Q * scale is split on chip, once per block:
// TMA brings q into the hi buffer, the warpgroup that owns the rows
// rewrites them as hi in place and lo beside them, and
// fence.proxy.async makes those generic-proxy writes visible to wgmma.
// P's hi and lo are made in registers from the raw S accumulators.
//
// Design (the bf16 wgmma kernel's, K-major throughout). A block owns one
// (sequence, q head, 64-row q tile) and runs one consumer warpgroup and
// one producer warp. Blocks start with the longest causal rows; under
// GQA every head's longest tile comes before any head's next (the q
// heads of a kv head side by side), and with one q head a kv head a
// head's tiles come side by side instead, so that the blocks reading its
// K and V run together and find them in L2 (at deepseek's MLA shape the
// heads' K and V, hi and lo, are 167 MB: heads first ran 23-29% slower).
// One producer thread issues every TMA load: Q once, then K_hi + K_lo
// of tile j + 1 before V^T_hi + V^T_lo of tile j, through rings of SK and
// SV stages of BN keys, each with a full mbarrier (expect_tx) and an
// empty one that the 128 consumer threads arrive at. The tensor maps are 4-D
// over (B, S, H, d) and (B, Hkv, dv, Skv8), built on the host by
// cuTensorMapEncodeTiled and passed __grid_constant__: rows past Sq or
// Skv read 0, q head h reads kv head h / (Hq / Hkv) through the H
// coordinate. A box is 32 f32 columns (128 bytes, one swizzle atom) by
// the tile's rows, 128-byte swizzled; tiles are 1024-byte aligned, and
// the wgmma descriptors step 32 bytes (8 TF32 values) along K within an
// atom.
//
// S = Q K^T is three m64n32k8 wgmmas a k step from shared memory; the
// online softmax runs on the accumulator (a row across a quad of lanes:
// two shuffles for its max); only tiles crossing the causal diagonal, the
// window edge or Skv are masked element by element. Tile j + 1's QK^T and
// tile j's PV (three m64nDVk8 wgmmas a k step, P from registers) are
// issued together, and tile j + 1's softmax runs while PV is in flight.
// Each tile's PV goes into fresh accumulators (scale-d 0 on its first
// wgmma) that are then added to O in f32: the tensor cores truncate as
// they add into C, and an O kept there across tiles drifts with the key
// count (2e-4 of the output at 32768 keys on the mma.sync route).
//
// Shared memory, in 4-byte words (a swizzle atom is 32 columns): Q hi +
// lo for 64 rows, SK stages of K hi + lo and SV stages of V^T hi + lo of
// BN = 32 keys. (64, 64), SK = SV = 2: 32 + 2 x 16 + 2 x 16 = 96 KB, two
// blocks an SM. (128, 128), SK = SV = 2: 64 + 2 x 32 + 2 x 32 = 192 KB.
// (192, 128), SK 2, SV 1: 96 + 2 x 48 + 32 = 224 KB, 230,456 bytes with
// the barriers and the alignment slack, of the 232,448 a block may have.
// 64-key stages fit only at d 64 (one block an SM: slower) and at d 128
// with one stage each (spills).
//
// Registers. A consumer thread holds O (DV / 2), the fresh PV (DV / 2), S
// (BN / 2) and P's hi and lo (BN / 2 each): at (192, 128) and (128, 128)
// 64 + 64 + 16 + 32 = 176 of the 255 a 160-thread block allows (ptxas
// uses 225, no spill), at (64, 64) 32 + 32 + 16 + 32 = 112 of the 168
// that two blocks an SM allow (ptxas: 164, no spill).
// Two consumer warpgroups a block (128-row tiles) were tried: ptxas holds
// a 288-thread block to 168 registers, and the kernel spilled.
// chip_smoke.py prints ptxas's count and spills for each instantiation.
#include "sm90.cuh"

namespace {

using namespace reconic;

constexpr int kAtom = 128;            // a swizzled row: 32 f32 columns
constexpr int kRows = 64;             // q rows a block: one warpgroup's
constexpr int kThreads = 128 + 32;    // the warpgroup and a producer warp
constexpr float kNegInf = -1e30f;

// Shared memory, from a 1024-byte aligned base: Q hi, Q lo, SK stages of
// K (hi, lo), SV stages of V^T (hi, lo), each cut into 32-column atoms of
// rows x 128 bytes, then the mbarriers.
template <int DQK, int DV, int BN, int SK, int SV>
struct Tf32Cfg {
  static constexpr int kQHalf = DQK / 32 * kRows * kAtom;  // hi or lo
  static constexpr int kKHalf = DQK / 32 * BN * kAtom;
  static constexpr int kVHalf = BN / 32 * DV * kAtom;
  static constexpr int kKOff = 2 * kQHalf;
  static constexpr int kVOff = kKOff + SK * 2 * kKHalf;
  static constexpr int kBarOff = kVOff + SV * 2 * kVHalf;
  static constexpr int kSmem = kBarOff + 8 * (1 + 2 * SK + 2 * SV) + 1024;
  // blocks an SM can hold by shared memory (228 KB an SM, 1 KB of it
  // reserved a block), so that ptxas keeps registers for them
  static constexpr int kBlocks = 2 * (kSmem + 1024) <= 233472 ? 2 : 1;
  static_assert(DQK % 32 == 0 && DV % 32 == 0, "32-column atoms");
  static_assert(BN == 32 || BN == 64, "QK^T's N");
  static_assert(DV == 64 || DV == 128, "PV's N");
  static_assert(kSmem <= 232448, "over the 227 KB a block may have");
};

// ---- wgmma in TF32 -------------------------------------------------------

#define F8(i)                                                              \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),              \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])

// D (64 x 32, f32) (+)= A (64 x 8) . B (8 x 32), TF32 in shared memory
// through their descriptors, both K-major; D is kept when scale_d.
__device__ __forceinline__ void wgmma_tf32_ss_n32(float (&d)[16], uint64_t da,
                                                  uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1;\n}\n"
      : F8(0), F8(8)
      : "l"(da), "l"(db), "r"(scale_d));
}

// D (64 x 64, f32) (+)= A (64 x 8) . B (8 x 64), as above.
__device__ __forceinline__ void wgmma_tf32_ss_n64(float (&d)[32], uint64_t da,
                                                  uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1;\n}\n"
      : F8(0), F8(8), F8(16), F8(24)
      : "l"(da), "l"(db), "r"(scale_d));
}

// D (64 x 64, f32) (+)= A (64 x 8) . B (8 x 64): A TF32 fragments in
// registers (a[0..3] = A[g][t], A[g+8][t], A[g][t+4], A[g+8][t+4] of the
// warp's 16 rows), B TF32 in shared memory, K-major.
__device__ __forceinline__ void wgmma_tf32_rs_n64(float (&d)[32],
                                                  const uint32_t (&a)[4],
                                                  uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : F8(0), F8(8), F8(16), F8(24)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

// D (64 x 128, f32) (+)= A (64 x 8) . B (8 x 128), as above.
__device__ __forceinline__ void wgmma_tf32_rs_n128(float (&d)[64],
                                                   const uint32_t (&a)[4],
                                                   uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : F8(0), F8(8), F8(16), F8(24), F8(32), F8(40), F8(48), F8(56)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

#undef F8

template <int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t da,
                                         uint64_t db, int scale_d) {
  if constexpr (N == 32)
    wgmma_tf32_ss_n32(d, da, db, scale_d);
  else
    wgmma_tf32_ss_n64(d, da, db, scale_d);
}
template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2],
                                         const uint32_t (&a)[4], uint64_t db,
                                         int scale_d) {
  if constexpr (N == 64)
    wgmma_tf32_rs_n64(d, a, db, scale_d);
  else
    wgmma_tf32_rs_n128(d, a, db, scale_d);
}

// x with its low 13 bits cleared: the TF32 value the tensor cores read.
__device__ __forceinline__ float trunc_tf32(float x) {
  return __uint_as_float(__float_as_uint(x) & 0xffffe000u);
}

__device__ __forceinline__ void split4(float4 x, float4& hi, float4& lo) {
  uint32_t h[4], l[4];
  split_tf32(x.x, h[0], l[0]);
  split_tf32(x.y, h[1], l[1]);
  split_tf32(x.z, h[2], l[2]);
  split_tf32(x.w, h[3], l[3]);
  hi = make_float4(__uint_as_float(h[0]), __uint_as_float(h[1]),
                   __uint_as_float(h[2]), __uint_as_float(h[3]));
  lo = make_float4(__uint_as_float(l[0]), __uint_as_float(l[1]),
                   __uint_as_float(l[2]), __uint_as_float(l[3]));
}

// ---- the pre-pass: K's and V^T's hi and lo -------------------------------

// One block per 32 keys of one (sequence, kv head). K_lo = tf32_rna(K -
// trunc(K)) in K's (B, Skv, Hkv, DQK) layout (K itself is the hi part the
// tensor cores read); V^T_hi and V^T_lo as (B, Hkv, DV, skv8), the
// keys of each 8 permuted (position i holds key 2 (i % 4) + i / 4), keys
// past Skv written as 0. (Loops unrolled to issue each thread's loads
// together ran slower, tools/k6_ablation.py.)
template <int DQK, int DV>
__global__ void __launch_bounds__(256)
    flash_attention_tf32_split(const float* __restrict__ k,
                               const float* __restrict__ v,
                               float* __restrict__ klo,
                               float* __restrict__ vth,
                               float* __restrict__ vtl, int hkv, int skv,
                               int skv8) {
  __shared__ float tile[32][DV + 1];
  const int k0 = blockIdx.x * 32;
  const int hk = blockIdx.y;
  const int b = blockIdx.z;
  const size_t k_row = static_cast<size_t>(hkv) * DQK;
  const size_t v_row = static_cast<size_t>(hkv) * DV;
  const size_t row0 = static_cast<size_t>(b) * skv + k0;
  for (int e = threadIdx.x; e < 32 * DQK / 4; e += 256) {
    const int j = e / (DQK / 4);
    const int c = (e % (DQK / 4)) * 4;
    if (k0 + j >= skv) break;
    const size_t off = (row0 + j) * k_row + hk * DQK + c;
    const float4 x = *reinterpret_cast<const float4*>(k + off);
    float4 lo, rest;
    split4(make_float4(x.x - trunc_tf32(x.x), x.y - trunc_tf32(x.y),
                       x.z - trunc_tf32(x.z), x.w - trunc_tf32(x.w)),
           lo, rest);
    *reinterpret_cast<float4*>(klo + off) = lo;
  }
  for (int e = threadIdx.x; e < 32 * DV; e += 256) {
    const int j = e / DV;
    const int c = e % DV;
    tile[j][c] = k0 + j < skv ? v[(row0 + j) * v_row + hk * DV + c] : 0.f;
  }
  __syncthreads();
  const size_t vt_head = (static_cast<size_t>(b) * hkv + hk) * DV;
  for (int e = threadIdx.x; e < 32 * DV; e += 256) {
    const int c = e / 32;
    const int i = e % 32;
    if (k0 + i >= skv8) continue;
    const int key = (i & ~7) | ((i & 3) << 1) | ((i >> 2) & 1);
    uint32_t h, l;
    split_tf32(tile[key][c], h, l);
    const size_t off = (vt_head + c) * skv8 + k0 + i;
    vth[off] = __uint_as_float(h);
    vtl[off] = __uint_as_float(l);
  }
}

// ---- the attention kernel ------------------------------------------------

// The online softmax of one tile on a thread's S accumulator: rows r0 and
// r0 + 8 (elements 4j + 0..1 and 4j + 2..3 of chunk j), keys kc + 8j and
// kc + 8j + 1 (S is of q * scale already). Turns s into p = exp(s - m),
// updates the running max m and this lane's partial denominator l, and
// returns each row's rescale factor in alpha.
template <bool kMask, int BN>
__device__ __forceinline__ void softmax_tile(float (&s)[BN / 2],
                                             float (&m)[2], float (&l)[2],
                                             float (&alpha)[2], int r0,
                                             int kc, int skv, int causal,
                                             int window) {
  constexpr int kNT = BN / 8;           // 8-key column chunks of S
  if (kMask) {
#pragma unroll
    for (int j = 0; j < kNT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qi = r0 + (e >> 1) * 8;
        const int kj = kc + 8 * j + (e & 1);
        bool vis = kj < skv;
        if (causal) vis = vis && qi >= kj;
        if (window > 0) vis = vis && (qi - kj) < window;
        if (!vis) s[4 * j + e] = kNegInf;
      }
  }
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    float mx = kNegInf;
#pragma unroll
    for (int j = 0; j < kNT; ++j)
      mx = fmaxf(mx, fmaxf(s[4 * j + 2 * hr], s[4 * j + 2 * hr + 1]));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(m[hr], mx);
    alpha[hr] = expf(m[hr] - m_new);
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < kNT; ++j)
#pragma unroll
      for (int e = 2 * hr; e < 2 * hr + 2; ++e) {
        // a masked key weighs an exact 0 (the reference's exp(-1e30 - m))
        const float x = s[4 * j + e];
        const float p = (kMask && x == kNegInf) ? 0.f : expf(x - m_new);
        s[4 * j + e] = p;
        sum += p;
      }
    l[hr] = l[hr] * alpha[hr] + sum;
    m[hr] = m_new;
  }
}

// P (in s) as TF32 hi and lo A fragments of PV's k steps: step kk takes
// chunk kk, keys 2t (elements 0 and 2: rows g, g + 8) as k = t and 2t + 1
// (elements 1 and 3) as k = t + 4, which V^T's permutation matches.
template <int BN>
__device__ __forceinline__ void to_p(const float (&s)[BN / 2],
                                     uint32_t (&ph)[BN / 8][4],
                                     uint32_t (&pl)[BN / 8][4]) {
#pragma unroll
  for (int kk = 0; kk < BN / 8; ++kk) {
    split_tf32(s[4 * kk + 0], ph[kk][0], pl[kk][0]);
    split_tf32(s[4 * kk + 2], ph[kk][1], pl[kk][1]);
    split_tf32(s[4 * kk + 1], ph[kk][2], pl[kk][2]);
    split_tf32(s[4 * kk + 3], ph[kk][3], pl[kk][3]);
  }
}

// S = Q K^T of one warpgroup's 64 rows against a K stage, 3xTF32 (one
// group) from Q's and the K stage's hi and lo. The addresses are hidden
// from the compiler at each call: otherwise it keeps Q's descriptors of
// every k step in registers from tile to tile, and at d 128 and 192 the
// kernel spills (160 bytes at 192, 5% slower; tools/k6_ablation.py).
template <int DQK, int BN>
__device__ __forceinline__ void issue_qk(float (&s)[BN / 2], uint32_t qh,
                                         uint32_t ql, uint32_t kh,
                                         uint32_t kl) {
  asm volatile("" : "+r"(qh), "+r"(ql), "+r"(kh), "+r"(kl));
  wg_fence();
#pragma unroll
  for (int kk = 0; kk < DQK / 8; ++kk) {
    const uint32_t qo = (kk / 4) * kRows * kAtom + (kk % 4) * 32;
    const uint32_t ko = (kk / 4) * BN * kAtom + (kk % 4) * 32;
    const uint64_t ah = desc_k_major(qh + qo);
    const uint64_t bh = desc_k_major(kh + ko);
    wgmma_ss<BN>(s, desc_k_major(ql + qo), bh, kk > 0);
    wgmma_ss<BN>(s, ah, desc_k_major(kl + ko), 1);
    wgmma_ss<BN>(s, ah, bh, 1);
  }
  wg_commit();
}

// PV = P_lo V_hi + P_hi V_lo + P_hi V_hi over a V^T stage into fresh
// accumulators (one group).
template <int DV, int BN>
__device__ __forceinline__ void issue_pv(float (&pv)[DV / 2],
                                         const uint32_t (&ph)[BN / 8][4],
                                         const uint32_t (&pl)[BN / 8][4],
                                         uint32_t vh, uint32_t vl) {
  wg_fence();
#pragma unroll
  for (int kk = 0; kk < BN / 8; ++kk) {
    const uint32_t vo = (kk / 4) * DV * kAtom + (kk % 4) * 32;
    const uint64_t bh = desc_k_major(vh + vo);
    wgmma_rs<DV>(pv, pl[kk], bh, kk > 0);
    wgmma_rs<DV>(pv, ph[kk], desc_k_major(vl + vo), 1);
    wgmma_rs<DV>(pv, ph[kk], bh, 1);
  }
  wg_commit();
}

template <int DQK, int DV, int BN, int SK, int SV>
__global__ void __launch_bounds__(kThreads,
                                  Tf32Cfg<DQK, DV, BN, SK, SV>::kBlocks)
    flash_attention_sm90_tf32_kernel(const __grid_constant__ CUtensorMap tq,
                                     const __grid_constant__ CUtensorMap tkh,
                                     const __grid_constant__ CUtensorMap tkl,
                                     const __grid_constant__ CUtensorMap tvh,
                                     const __grid_constant__ CUtensorMap tvl,
                                     float* __restrict__ o, int hq, int hkv,
                                     int sq, int skv, int causal, int window,
                                     int qoff, float scale) {
  using C = Tf32Cfg<DQK, DV, BN, SK, SV>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* const sbase = smem_raw + (base - raw);
  const uint32_t s_qh = base;
  const uint32_t s_ql = base + C::kQHalf;
  const uint32_t s_k = base + C::kKOff;
  const uint32_t s_v = base + C::kVOff;
  // mbarriers: Q full, K full and empty per stage, V full and empty
  const uint32_t q_full = base + C::kBarOff;
  const uint32_t k_full = q_full + 8;
  const uint32_t k_empty = k_full + 8 * SK;
  const uint32_t v_full = k_empty + 8 * SK;
  const uint32_t v_empty = v_full + 8 * SV;

  // one (sequence, q head, q tile) a block, longest causal rows first.
  // GQA: every head's longest tile before any head's next (the q heads of
  // a kv head side by side, their K and V a fraction of q). One q head a
  // kv head: a head's tiles side by side, so that the blocks that read its
  // K and V run together and find them in L2 (at deepseek's 8 x 512 x 16
  // the heads' K and V, hi and lo, are 167 MB: heads first ran 23-29%
  // slower, tools/k6_ablation.py).
  const int group = hq / hkv;
  const int n_qt = (sq + kRows - 1) / kRows;
  const int n_bh = static_cast<int>(gridDim.x) / n_qt;
  const int tile = group > 1 ? blockIdx.x / n_bh : blockIdx.x % n_qt;
  const int bh = group > 1 ? blockIdx.x % n_bh : blockIdx.x / n_qt;
  const int b = bh / hq;
  const int h = bh % hq;
  const int hk = h / group;
  const int q0 = (n_qt - 1 - tile) * kRows;
  // KV range any query of this block can see (tile-aligned start); row
  // r sits at position qoff + r among the keys
  const int p0 = qoff + q0;
  const int last_q = qoff + min(q0 + kRows, sq) - 1;
  const int k_end = causal ? min(skv, last_q + 1) : skv;
  const int k_begin = window > 0 ? max(0, p0 - window + 1) / BN * BN : 0;
  const int n_tiles = k_end > k_begin ? (k_end - k_begin + BN - 1) / BN : 0;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
#pragma unroll
    for (int st = 0; st < SK; ++st) {
      mbar_init(k_full + 8 * st, 1);
      mbar_init(k_empty + 8 * st, 128);
    }
#pragma unroll
    for (int st = 0; st < SV; ++st) {
      mbar_init(v_full + 8 * st, 1);
      mbar_init(v_empty + 8 * st, 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= 128) {
    // ---- producer: one thread keeps the loads in flight
    if (threadIdx.x != 128 || n_tiles == 0) return;
    const CUtensorMap* mkh = &tkh;
    const CUtensorMap* mkl = &tkl;
    const CUtensorMap* mvh = &tvh;
    const CUtensorMap* mvl = &tvl;
    auto load_k = [&](int j) {
      const int st = j % SK;
      const uint32_t hi = s_k + st * 2 * C::kKHalf;
      mbar_wait(k_empty + 8 * st, ((j / SK) & 1) ^ 1);
      mbar_expect_tx(k_full + 8 * st, 2 * C::kKHalf);
#pragma unroll
      for (int a = 0; a < DQK / 32; ++a) {
        const uint32_t off = a * BN * kAtom;
        tma_load(hi + off, mkh, k_full + 8 * st, a * 32, hk,
                 k_begin + j * BN, b);
        tma_load(hi + C::kKHalf + off, mkl, k_full + 8 * st, a * 32, hk,
                 k_begin + j * BN, b);
      }
    };
    auto load_v = [&](int j) {
      const int st = j % SV;
      const uint32_t hi = s_v + st * 2 * C::kVHalf;
      mbar_wait(v_empty + 8 * st, ((j / SV) & 1) ^ 1);
      mbar_expect_tx(v_full + 8 * st, 2 * C::kVHalf);
#pragma unroll
      for (int a = 0; a < BN / 32; ++a) {
        const uint32_t off = a * DV * kAtom;
        tma_load(hi + off, mvh, v_full + 8 * st, k_begin + j * BN + a * 32,
                 0, hk, b);
        tma_load(hi + C::kVHalf + off, mvl, v_full + 8 * st,
                 k_begin + j * BN + a * 32, 0, hk, b);
      }
    };
    mbar_expect_tx(q_full, C::kQHalf);
#pragma unroll
    for (int a = 0; a < DQK / 32; ++a)
      tma_load(s_qh + a * kRows * kAtom, &tq, q_full, a * 32, h, q0, b);
    // K runs a tile ahead of V, so that with one V stage K of tile j + 1
    // is in flight while PV of tile j - 1 holds V's stage
    load_k(0);
    for (int j = 0; j < n_tiles; ++j) {
      if (j + 1 < n_tiles) load_k(j + 1);
      load_v(j);
    }
    return;
  }

  // ---- the consumer warpgroup: the block's 64 q rows
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int r0 = q0 + warp * 16 + g;      // this lane's rows r0, r0 + 8

  float acc[DV / 2];
#pragma unroll
  for (int i = 0; i < DV / 2; ++i) acc[i] = 0.f;
  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.f, 0.f};

  if (n_tiles > 0) {
    // q * scale into hi (in place) and lo; the swizzle moves whole 16-byte
    // chunks, so the same offset in the two buffers is the same element
    mbar_wait(q_full, 0);
    float4* qhp = reinterpret_cast<float4*>(sbase);
    float4* qlp = reinterpret_cast<float4*>(sbase + C::kQHalf);
#pragma unroll 4
    for (int i = threadIdx.x; i < C::kQHalf / 16; i += 128) {
      const float4 x = qhp[i];
      split4(make_float4(__fmul_rn(x.x, scale), __fmul_rn(x.y, scale),
                         __fmul_rn(x.z, scale), __fmul_rn(x.w, scale)),
             qhp[i], qlp[i]);
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    asm volatile("bar.sync 1, 128;\n" ::: "memory");

    float s[BN / 2];
    float pv[DV / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) s[i] = 0.f;
#pragma unroll
    for (int i = 0; i < DV / 2; ++i) pv[i] = 0.f;
    uint32_t ph[BN / 8][4], pl[BN / 8][4];
    float alpha[2];
    // only tiles that cross the causal diagonal, the window edge or Skv
    // are masked element by element
    auto softmax = [&](int k0) {
      const bool edge = k0 + BN > skv || (causal && k0 + BN - 1 > p0) ||
                        (window > 0 && p0 + kRows - 1 - k0 >= window);
      if (edge)
        softmax_tile<true, BN>(s, m, l, alpha, qoff + r0, k0 + 2 * t, skv,
                               causal, window);
      else
        softmax_tile<false, BN>(s, m, l, alpha, qoff + r0, k0 + 2 * t, skv,
                                causal, window);
    };
    auto k_hi = [&](int st) { return s_k + st * 2 * C::kKHalf; };
    auto v_hi = [&](int st) { return s_v + st * 2 * C::kVHalf; };

    mbar_wait(k_full, 0);
    issue_qk<DQK, BN>(s, s_qh, s_ql, k_hi(0), k_hi(0) + C::kKHalf);
    wg_wait<0>();
    fence_regs(s);
    mbar_arrive(k_empty);
    softmax(k_begin);
    to_p<BN>(s, ph, pl);

    for (int j = 1; j < n_tiles; ++j) {
      const int st = j % SK;
      const int pst = (j - 1) % SV;
      mbar_wait(k_full + 8 * st, (j / SK) & 1);
      mbar_wait(v_full + 8 * pst, ((j - 1) / SV) & 1);
      issue_qk<DQK, BN>(s, s_qh, s_ql, k_hi(st), k_hi(st) + C::kKHalf);
      issue_pv<DV, BN>(pv, ph, pl, v_hi(pst), v_hi(pst) + C::kVHalf);
      wg_wait<1>();                       // S of tile j is in
      fence_regs(s);
      mbar_arrive(k_empty + 8 * st);
      softmax(k_begin + j * BN);
      wg_wait<0>();                       // PV of tile j - 1 is in
      fence_regs(pv);
      fence_regs(ph);
      fence_regs(pl);
      mbar_arrive(v_empty + 8 * pst);
#pragma unroll
      for (int i = 0; i < DV / 2; ++i) acc[i] += pv[i];
      // once the running max settles most tiles leave every row's alpha
      // at exactly 1, and the multiplies would change nothing
      if (__any_sync(0xffffffffu, alpha[0] != 1.f || alpha[1] != 1.f)) {
#pragma unroll
        for (int i = 0; i < DV / 2; ++i) acc[i] *= alpha[(i >> 1) & 1];
      }
      to_p<BN>(s, ph, pl);
    }
    const int st = (n_tiles - 1) % SV;
    mbar_wait(v_full + 8 * st, ((n_tiles - 1) / SV) & 1);
    issue_pv<DV, BN>(pv, ph, pl, v_hi(st), v_hi(st) + C::kVHalf);
    wg_wait<0>();
    fence_regs(pv);
    mbar_arrive(v_empty + 8 * st);
#pragma unroll
    for (int i = 0; i < DV / 2; ++i) acc[i] += pv[i];
  }

  // the row's denominator is the quad's partial sums
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    l[hr] += __shfl_xor_sync(0xffffffffu, l[hr], 1);
    l[hr] += __shfl_xor_sync(0xffffffffu, l[hr], 2);
  }
  const size_t o_row = static_cast<size_t>(hq) * DV;
  float* ob = o + static_cast<size_t>(b) * sq * o_row + h * DV;
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int row = r0 + 8 * hr;
    if (row >= sq) continue;
    float* orow = ob + static_cast<size_t>(row) * o_row + 2 * t;
    // a row with no visible key keeps l == 0 and writes 0
    const float lr = l[hr];
#pragma unroll
    for (int n = 0; n < DV / 8; ++n) {
      const float v0 = lr == 0.f ? 0.f : acc[4 * n + 2 * hr] / lr;
      const float v1 = lr == 0.f ? 0.f : acc[4 * n + 2 * hr + 1] / lr;
      *reinterpret_cast<float2*>(orow + n * 8) = make_float2(v0, v1);
    }
  }
}

// ---- host: tensor maps and the launches ----------------------------------

// A 4-D map over a contiguous f32 tensor of dims (innermost first) whose
// boxes are 32 columns by box[1..3], 128-byte swizzled; reads past a
// dimension's end give 0.
bool make_map(CUtensorMap* map, const void* ptr, const int (&dims)[4],
              const int (&box)[4]) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  cuuint64_t size[4], strides[3];
  cuuint32_t bx[4];
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  cuuint64_t stride = 4;
  for (int i = 0; i < 4; ++i) {
    size[i] = static_cast<cuuint64_t>(dims[i]);
    bx[i] = static_cast<cuuint32_t>(box[i]);
    if (i > 0) strides[i - 1] = stride;
    stride *= size[i];
  }
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4,
                const_cast<void*>(ptr), size, strides, bx, elem,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The pre-pass's scratch, in f32 words from its base: K's lo part in K's
// (B, Skv, Hkv, d) layout, then V^T's hi part and its lo part, each (B,
// Hkv, dv, Skv8) with Skv8 = Skv rounded up to a multiple of 8. The one
// account of it: the wrapper allocates what words() says
// (reconic_flash_attention_sm90_tf32_scratch_words), and the entry point
// refuses a scratch that holds fewer.
struct Scratch {
  size_t k_words, vt_words;
  Scratch(int batch, int hkv, int skv, int d, int dv)
      : k_words(static_cast<size_t>(batch) * skv * hkv * d),
        vt_words(static_cast<size_t>(batch) * hkv * dv *
                 ((static_cast<size_t>(skv) + 7) / 8 * 8)) {}
  size_t words() const { return k_words + 2 * vt_words; }
};

template <int DQK, int DV, int BN, int SK, int SV>
int launch_tf32(const float* q, const float* k, const float* v, float* o,
                float* scratch, int batch, int hq, int hkv, int sq, int skv,
                int causal, int window, int qoff, float scale,
                cudaStream_t stream) {
  using C = Tf32Cfg<DQK, DV, BN, SK, SV>;
  const int skv8 = (skv + 7) / 8 * 8;
  const Scratch sc(batch, hkv, skv, DQK, DV);
  float* klo = scratch;
  float* vth = klo + sc.k_words;
  float* vtl = vth + sc.vt_words;
  CUtensorMap tq, tkh, tkl, tvh, tvl;
  if (!make_map(&tq, q, {DQK, hq, sq, batch}, {32, 1, kRows, 1}))
    return static_cast<int>(cudaErrorInvalidValue);
  if (skv > 0) {
    flash_attention_tf32_split<DQK, DV>
        <<<dim3((skv8 + 31) / 32, hkv, batch), 256, 0, stream>>>(
            k, v, klo, vth, vtl, hkv, skv, skv8);
    const int e = reconic::launch_status();
    if (e != 0) return e;
    if (!make_map(&tkh, k, {DQK, hkv, skv, batch}, {32, 1, BN, 1}) ||
        !make_map(&tkl, klo, {DQK, hkv, skv, batch}, {32, 1, BN, 1}) ||
        !make_map(&tvh, vth, {skv8, DV, hkv, batch}, {32, DV, 1, 1}) ||
        !make_map(&tvl, vtl, {skv8, DV, hkv, batch}, {32, DV, 1, 1}))
      return static_cast<int>(cudaErrorInvalidValue);
  } else {
    // with no keys no tile is loaded: the map over q stands in
    tkh = tkl = tvh = tvl = tq;
  }
  auto kern = flash_attention_sm90_tf32_kernel<DQK, DV, BN, SK, SV>;
  const cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, C::kSmem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const long long blocks =
      static_cast<long long>(batch) * hq * ((sq + kRows - 1) / kRows);
  if (blocks > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  kern<<<static_cast<unsigned>(blocks), kThreads, C::kSmem, stream>>>(
      tq, tkh, tkl, tvh, tvl, o, hq, hkv, sq, skv, causal, window, qoff,
      scale);
  return reconic::launch_status();
}

// (d, dv) pairs the kernel is built for
bool built_for(int d, int dv) {
  return (d == 64 && dv == 64) || (d == 128 && dv == 128) ||
         (d == 192 && dv == 128);
}

}  // namespace

// q: (B, Sq, Hq, d), k: (B, Skv, Hkv, d), v: (B, Skv, Hkv, dv), out: (B,
// Sq, Hq, dv), all f32, contiguous and 16-byte aligned; Hq % Hkv == 0,
// (d, dv) one of (64, 64), (128, 128), (192, 128); B Hq ceil(Sq / 64) <
// 2^31 (blocks of 64 q rows). scratch: 16-byte aligned, scratch_words
// f32 words, at least reconic_flash_attention_sm90_tf32_scratch_words.
// window 0 means no window; q_offset (>= 0) is the position of q's first
// row among the keys.
RECONIC_API int reconic_flash_attention_sm90_tf32(
    const void* q, const void* k, const void* v, void* out, void* scratch,
    long long scratch_words, int batch, int hq, int hkv, int sq, int skv,
    int d, int dv, int causal, int window, int q_offset, float scale,
    void* stream) {
  if (!built_for(d, dv) || batch < 0 || hkv <= 0 || skv < 0 ||
      q_offset < 0 ||
      scratch_words < 0 ||
      static_cast<size_t>(scratch_words) <
          Scratch(batch, hkv, skv, d, dv).words())
    return static_cast<int>(cudaErrorInvalidValue);
  if ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
       reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(out) |
       reinterpret_cast<uintptr_t>(scratch)) %
      16)
    return static_cast<int>(cudaErrorMisalignedAddress);
  auto s = static_cast<cudaStream_t>(stream);
  const auto* qf = static_cast<const float*>(q);
  const auto* kf = static_cast<const float*>(k);
  const auto* vf = static_cast<const float*>(v);
  auto* of = static_cast<float*>(out);
  auto* sf = static_cast<float*>(scratch);
  // (d, dv, keys a stage, K stages, V stages)
#define RECONIC_TF32_CASE(D, DV, BN, SK, SV)                                \
  if (d == D && dv == DV)                                                   \
    return launch_tf32<D, DV, BN, SK, SV>(qf, kf, vf, of, sf, batch, hq, hkv, \
                                          sq, skv, causal, window, q_offset, \
                                          scale, s);
  RECONIC_TF32_CASE(64, 64, 32, 2, 2)
  RECONIC_TF32_CASE(128, 128, 32, 2, 2)
  RECONIC_TF32_CASE(192, 128, 32, 2, 1)
#undef RECONIC_TF32_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}

// The scratch reconic_flash_attention_sm90_tf32 takes, in f32 words; 0 for
// head dims it is not built for.
RECONIC_API long long reconic_flash_attention_sm90_tf32_scratch_words(
    int batch, int hkv, int skv, int d, int dv) {
  if (!built_for(d, dv) || batch < 0 || hkv < 0 || skv < 0) return 0;
  return static_cast<long long>(Scratch(batch, hkv, skv, d, dv).words());
}

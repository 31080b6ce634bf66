// K6 flash_attention, bf16 route for Hopper: wgmma with a TMA-fed K/V ring
// and a producer warpgroup.
//
// Replaces src/repro/kernels/flash_attention.py:_attn_kernel for bf16
// inputs at the served head dims (64, 64), (128, 128) and MLA's (192,
// 128) with more than 64 query rows; flash_attention_sm90_tf32.cu takes
// f32 at those dims over 64 rows and flash_attention.cu's mma.sync kernel
// every other call (kernels/flash_attention.py:flash_attention_route says which
// call goes where, and why). The TPU version walks a (batch*heads, Sq/bq,
// Skv/bk) grid with the KV sweep innermost and sequential, carrying the
// running max, denominator and f32 accumulator in VMEM scratch from one
// grid step to the next.
//
// What bounds it on the H100: operations. At tinyllama's prefill_32k share
// (2 sequences x 32768 rows, 32 q heads over 4 kv heads of 64, causal) QK^T
// and PV are 8.8 TFLOP of the function's own work: 8.89 ms at the 989
// TFLOP/s of dense bf16, against 0.08 ms of bytes (q, k, v and the output
// read or written once). The split P below makes PV twice the work, so
// the route's products take 13.3 ms at that peak. Only wgmma reaches the
// tensor cores' full rate, and the softmax between the two products must
// neither leave the registers nor hold the tensor cores up.
//
// Design (FlashAttention-3's shape). A block of 384 threads owns one
// (sequence, q head, 128-row q tile); blocks start with the longest causal
// rows (grid.y reversed) of every head (grid.x), so the short ones fill the
// tail. Warpgroup 2 is the producer: one of its threads issues every TMA
// load, the rest idle. Q comes in once per block; K and V stream through
// rings of ST stages of BN keys in shared memory, each stage with a "full"
// mbarrier that the TMA completes (expect_tx bytes) and an "empty" one
// that the 256 consumer threads arrive at when they are done with it. K
// and V have rings of their own, so K of tile j + ST loads as soon as S of
// tile j is computed, while V of tile j is still in use.
//
// The tensor maps are 4-D over the port's (B, S, H, d) layout, built on the
// host by cuTensorMapEncodeTiled (from cudaGetDriverEntryPoint, so the
// library links nothing beyond the runtime) and passed as __grid_constant__
// parameters: S is a dimension apart from B, so rows past Sq or Skv are
// zero-filled by the hardware and never read from the next sequence, and q
// head h reads kv head h / (Hq / Hkv) through the K/V maps' H coordinate:
// no repeat, no transpose, no padding. A box is 64 columns (128 bytes) by
// 128 (Q) or BN (K, V) rows with 128-byte swizzle; d = 128 and 192 come in
// as two or three such column atoms, each 1024-byte aligned, and the wgmma
// descriptors use the same swizzle (K-major for Q and K; V as an MN-major
// B, wgmma's transpose flag, since its natural layout has keys along K).
//
// Each consumer warpgroup owns 64 q rows. S = Q K^T is m64nBNk16 wgmmas
// from shared memory; the online softmax runs on the accumulator, whose
// warp rows have mma.m16n8's C layout (a row across a quad of lanes: two
// shuffles for its max), with exp2 of one fma (scale * log2 e folded in);
// only tiles crossing the causal diagonal, the window edge or Skv are
// masked element by element, a masked key weighing an exact 0. P then
// becomes bf16 A fragments in place and O += P V is register-A wgmmas with
// O in their accumulators. Overlap: tile j + 1's QK^T and tile j's PV are
// issued together, and tile j + 1's softmax runs while PV is in flight
// (wgmma.wait_group 1, then 0 before O is rescaled, where a row's max
// moved, and P overwritten);
// and the two consumer warpgroups take turns on named barriers to issue
// their groups, so that one's softmax runs under the other's products
// (FA3's pingpong; not at d = 192, where the turns cost a spill).
// Epilogue: O / l in f32, 0 for a row with no visible key, stored as bf16
// pairs straight from the registers.
//
// Registers set the tile. With 384 threads a block ptxas holds every
// thread, setmaxnreg regions included, to 65536 / 384 = 168 registers
// (CUDA 12.9: a consumer setmaxnreg.inc to 240 buys none, with the launch
// bounds or __maxnreg__; tools/k6_ablation.py's maxnreg variants).
// In flight at once a consumer holds S (BN / 2), P's two halves (BN / 2)
// and O (DV / 2): 128-key stages spilled up to 512 bytes and serialized
// the wgmmas, so stages are 64 keys (96 at d = 64, where O is half as
// wide), which fit without a spill, and there is no setmaxnreg.
// tools/k6_ablation.py times the alternatives (stages of 64 to 128 keys,
// one to four stages, no pingpong, no softmax, a single P).
//
// P is split, P_hi = bf16(p) and P_lo = bf16(p - P_hi), with two PV
// wgmmas per k step (1.5x the products of plain FA2). A single bf16 P was
// measured against the port's bf16 contract (2e-4 plus one bf16 step of
// the result, against the reference): its emulation misses it at head
// dims 64, 128 and 192/128 where the split's meets it
// (tests/test_torch_tc_numerics.py, the bf16 contract test), so the
// split stays. O stays in the accumulators across tiles, as the mma.sync
// route's bf16 O does: its drift against float64 stays under the
// output's rounding up to 32768 keys (tools/k6_drift.py).
#include "sm90.cuh"

namespace {

using namespace reconic;

constexpr int kBM = 128;              // q rows per block
constexpr int kConsumers = 2;         // warpgroups of 64 q rows
constexpr int kThreads = 128 * (kConsumers + 1);
constexpr int kAtomBytes = 128;       // a swizzled row: 64 bf16 columns
// The consumer warpgroups take turns to issue their wgmmas, so that one's
// softmax runs under the other's products (at d <= 128: at 192 the turns
// cost a spill and gained nothing, tools/k6_ablation.py).
constexpr bool kPingpong = true;
constexpr float kNegInf = -1e30f;

// Shared memory, from a 1024-byte aligned base: Q, ST K stages, ST V stages
// of BN keys (each cut into 64-column atoms of rows x 128 bytes), then the
// mbarriers.
template <int DQK, int DV, int BN, int ST>
struct Sm90Cfg {
  static constexpr int kQBytes = DQK / 64 * kBM * kAtomBytes;
  static constexpr int kKBytes = DQK / 64 * BN * kAtomBytes;
  static constexpr int kVBytes = DV / 64 * BN * kAtomBytes;
  static constexpr int kKOff = kQBytes;
  static constexpr int kVOff = kKOff + ST * kKBytes;
  static constexpr int kBarOff = kVOff + ST * kVBytes;
  static constexpr int kSmem = kBarOff + 8 * (1 + 4 * ST) + 1024;
  static_assert(DQK % 64 == 0 && DV % 64 == 0, "64-column atoms");
  static_assert(BN % 16 == 0 && BN <= 128, "16-key PV steps");
  static_assert(kSmem <= 232448, "over the 227 KB a block may have");
};

// ---- wgmma ---------------------------------------------------------------

// MN-major (V as PV's B): 8-key groups 1024 bytes apart, 64-column atoms
// BN rows apart.
template <int BN>
__device__ __forceinline__ uint64_t desc_mn_major(uint32_t addr) {
  return smem_desc(addr, BN * kAtomBytes, 1024);
}

#define F8(i)                                                              \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),              \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])

// D (64 x 64, f32) (+)= A (64 x 16) . B (16 x 64), both bf16 in shared
// memory through their descriptors, K-major; D is kept when scale_d.
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da,
                                           uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : F8(0), F8(8), F8(16), F8(24)
      : "l"(da), "l"(db), "r"(scale_d));
}

// D (64 x 80, f32) (+)= A (64 x 16) . B (16 x 80), both bf16 in shared
// memory through their descriptors, K-major; D is kept when scale_d.
__device__ __forceinline__ void wgmma_ss_n80(float (&d)[40], uint64_t da,
                                           uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %42, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n80k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39}, "
      "%40, %41, p, 1, 1, 0, 0;\n}\n"
      : F8(0), F8(8), F8(16), F8(24), F8(32)
      : "l"(da), "l"(db), "r"(scale_d));
}

// D (64 x 96, f32) (+)= A (64 x 16) . B (16 x 96), both bf16 in shared
// memory through their descriptors, K-major; D is kept when scale_d.
__device__ __forceinline__ void wgmma_ss_n96(float (&d)[48], uint64_t da,
                                           uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %50, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47}, "
      "%48, %49, p, 1, 1, 0, 0;\n}\n"
      : F8(0), F8(8), F8(16), F8(24), F8(32), F8(40)
      : "l"(da), "l"(db), "r"(scale_d));
}

// D (64 x 128, f32) (+)= A (64 x 16) . B (16 x 128), both bf16 in shared
// memory through their descriptors, K-major; D is kept when scale_d.
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da,
                                           uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : F8(0), F8(8), F8(16), F8(24), F8(32), F8(40),
        F8(48), F8(56)
      : "l"(da), "l"(db), "r"(scale_d));
}

// D (64 x 64, f32) += A (64 x 16) . B (16 x 64): A bf16 fragments in
// registers, B bf16 in shared memory with N contiguous (transposed).
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                           const uint32_t (&a)[4],
                                           uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : F8(0), F8(8), F8(16), F8(24)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "n"(1));
}

// D (64 x 128, f32) += A (64 x 16) . B (16 x 128): A bf16 fragments in
// registers, B bf16 in shared memory with N contiguous (transposed).
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                           const uint32_t (&a)[4],
                                           uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : F8(0), F8(8), F8(16), F8(24), F8(32), F8(40),
        F8(48), F8(56)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "n"(1));
}

#undef F8

template <int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t da,
                                         uint64_t db, int scale_d) {
  if constexpr (N == 64)
    wgmma_ss_n64(d, da, db, scale_d);
  else if constexpr (N == 80)
    wgmma_ss_n80(d, da, db, scale_d);
  else if constexpr (N == 96)
    wgmma_ss_n96(d, da, db, scale_d);
  else
    wgmma_ss_n128(d, da, db, scale_d);
}
template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2],
                                         const uint32_t (&a)[4], uint64_t db) {
  if constexpr (N == 64)
    wgmma_rs_n64(d, a, db);
  else
    wgmma_rs_n128(d, a, db);
}

// Pingpong turns on named barriers 1 (warpgroup 0's) and 2 (warpgroup 1's),
// 256 consumer threads each: a warpgroup waits for its turn before it
// issues a group of wgmmas and passes the turn on after.
template <bool kOn>
__device__ __forceinline__ void turn_wait(int wg) {
  if (kOn) asm volatile("bar.sync %0, 256;\n" ::"r"(1 + wg) : "memory");
}
template <bool kOn>
__device__ __forceinline__ void turn_pass(int wg) {
  if (kOn) asm volatile("bar.arrive %0, 256;\n" ::"r"(2 - wg) : "memory");
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
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

// The online softmax of one tile on a thread's S accumulator: rows r0 and
// r0 + 8 (elements 4j + 0..1 and 4j + 2..3 of chunk j), keys kc + 8j and
// kc + 8j + 1. Turns s into p = 2^((s - m) c) with c = scale * log2 e,
// updates the running max m (of the unscaled scores) and this lane's
// partial denominator l, and returns each row's rescale factor in alpha.
template <bool kMask, int BN>
__device__ __forceinline__ void softmax_tile(float (&s)[BN / 2],
                                             float (&m)[2], float (&l)[2],
                                             float (&alpha)[2], float c,
                                             int r0, int kc, int skv,
                                             int causal, int window) {
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
    alpha[hr] = ex2((m[hr] - m_new) * c);
    const float off = -m_new * c;
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < kNT; ++j)
#pragma unroll
      for (int e = 2 * hr; e < 2 * hr + 2; ++e) {
        // a masked key weighs an exact 0 (the reference's exp(-1e30 - m))
        const float x = s[4 * j + e];
        const float p = (kMask && x == kNegInf) ? 0.f : ex2(fmaf(x, c, off));
        s[4 * j + e] = p;
        sum += p;
      }
    l[hr] = l[hr] * alpha[hr] + sum;
    m[hr] = m_new;
  }
}

// P (in s) as bf16 A fragments of PV's k steps: step kk takes chunks 2kk
// (keys 2t, 2t + 1 of rows g, g + 8) and 2kk + 1 (keys 8 + 2t, 9 + 2t).
template <int BN>
__device__ __forceinline__ void to_p(const float (&s)[BN / 2],
                                     uint32_t (&ph)[BN / 16][4],
                                     uint32_t (&pl)[BN / 16][4]) {
#pragma unroll
  for (int kk = 0; kk < BN / 16; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i)
      split_bf16(s[8 * kk + 2 * i], s[8 * kk + 2 * i + 1], ph[kk][i],
                 pl[kk][i]);
}

// S = Q K^T of one warpgroup's 64 rows against a K stage (one group).
template <int DQK, int BN>
__device__ __forceinline__ void issue_qk(float (&s)[BN / 2], uint32_t q_wg,
                                         uint32_t k_st) {
  wg_fence();
#pragma unroll
  for (int kk = 0; kk < DQK / 16; ++kk) {
    const uint32_t col = (kk % 4) * 32;       // 16 columns = 32 bytes
    const uint32_t atom = kk / 4;
    wgmma_ss<BN>(s, desc_k_major(q_wg + atom * kBM * kAtomBytes + col),
                 desc_k_major(k_st + atom * BN * kAtomBytes + col), kk > 0);
  }
  wg_commit();
}

// O += P_lo V + P_hi V over a V stage (one group).
template <int DV, int BN>
__device__ __forceinline__ void issue_pv(float (&o)[DV / 2],
                                         const uint32_t (&ph)[BN / 16][4],
                                         const uint32_t (&pl)[BN / 16][4],
                                         uint32_t v_st) {
  wg_fence();
#pragma unroll
  for (int kk = 0; kk < BN / 16; ++kk) {
    const uint64_t db = desc_mn_major<BN>(v_st + kk * 16 * kAtomBytes);
    wgmma_rs<DV>(o, pl[kk], db);
    wgmma_rs<DV>(o, ph[kk], db);
  }
  wg_commit();
}

template <int DQK, int DV, int BN, int ST>
__global__ void __launch_bounds__(kThreads, 1)
    flash_attention_sm90_kernel(const __grid_constant__ CUtensorMap tq,
                                const __grid_constant__ CUtensorMap tk,
                                const __grid_constant__ CUtensorMap tv,
                                __nv_bfloat16* __restrict__ o, int hq,
                                int hkv, int sq, int skv, int causal,
                                int window, int qoff, float c) {
  using C = Sm90Cfg<DQK, DV, BN, ST>;
  constexpr bool kTurns = kPingpong && DQK <= 128;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t s_q = base;
  const uint32_t s_k = base + C::kKOff;
  const uint32_t s_v = base + C::kVOff;
  // mbarriers: Q full, then K full, K empty, V full, V empty per stage
  const uint32_t q_full = base + C::kBarOff;
  const uint32_t k_full = q_full + 8;
  const uint32_t k_empty = k_full + 8 * ST;
  const uint32_t v_full = k_empty + 8 * ST;
  const uint32_t v_empty = v_full + 8 * ST;

  const int b = blockIdx.x / hq;
  const int h = blockIdx.x % hq;
  const int hk = h / (hq / hkv);
  const int n_qt = (sq + kBM - 1) / kBM;
  const int q0 = (n_qt - 1 - static_cast<int>(blockIdx.y)) * kBM;
  // KV range any query of this block can see (tile-aligned start); row
  // r sits at position qoff + r among the keys
  const int last_q = qoff + min(q0 + kBM, sq) - 1;
  const int k_end = causal ? min(skv, last_q + 1) : skv;
  const int k_begin =
      window > 0 ? max(0, qoff + q0 - window + 1) / BN * BN : 0;
  const int n_tiles = k_end > k_begin ? (k_end - k_begin + BN - 1) / BN : 0;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
#pragma unroll
    for (int st = 0; st < ST; ++st) {
      mbar_init(k_full + 8 * st, 1);
      mbar_init(k_empty + 8 * st, 128 * kConsumers);
      mbar_init(v_full + 8 * st, 1);
      mbar_init(v_empty + 8 * st, 128 * kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == kConsumers) {
    // ---- producer: one thread keeps the loads in flight
    if (threadIdx.x == 128 * kConsumers && n_tiles > 0) {
      mbar_expect_tx(q_full, C::kQBytes);
#pragma unroll
      for (int a = 0; a < DQK / 64; ++a)
        tma_load(s_q + a * kBM * kAtomBytes, &tq, q_full, a * 64, h, q0, b);
      for (int j = 0; j < n_tiles; ++j) {
        const int st = j % ST;
        const uint32_t par = ((j / ST) & 1) ^ 1;
        const int k0 = k_begin + j * BN;
        mbar_wait(k_empty + 8 * st, par);
        mbar_expect_tx(k_full + 8 * st, C::kKBytes);
#pragma unroll
        for (int a = 0; a < DQK / 64; ++a)
          tma_load(s_k + st * C::kKBytes + a * BN * kAtomBytes, &tk,
                   k_full + 8 * st, a * 64, hk, k0, b);
        mbar_wait(v_empty + 8 * st, par);
        mbar_expect_tx(v_full + 8 * st, C::kVBytes);
#pragma unroll
        for (int a = 0; a < DV / 64; ++a)
          tma_load(s_v + st * C::kVBytes + a * BN * kAtomBytes, &tv,
                   v_full + 8 * st, a * 64, hk, k0, b);
      }
    }
  } else {
    // ---- consumers: 64 q rows each
    const int tid = threadIdx.x % 128;
    const int warp = tid / 32;
    const int lane = tid % 32;
    const int g = lane >> 2;
    const int t = lane & 3;
    const int q0w = q0 + 64 * wg;
    const int r0 = q0w + warp * 16 + g;   // this lane's rows r0, r0 + 8
    const int p0w = qoff + q0w;           // the position of row q0w
    const uint32_t q_wg = s_q + wg * 64 * kAtomBytes;

    float acc[DV / 2];
#pragma unroll
    for (int i = 0; i < DV / 2; ++i) acc[i] = 0.f;
    float m[2] = {kNegInf, kNegInf};
    float l[2] = {0.f, 0.f};

    if (n_tiles > 0) {
      float s[BN / 2];
      uint32_t ph[BN / 16][4], pl[BN / 16][4];
      float alpha[2];
      // only tiles that cross the causal diagonal, the window edge or Skv
      // (for this warpgroup's rows) are masked element by element
      auto softmax = [&](int k0) {
        const bool edge = k0 + BN > skv || (causal && k0 + BN - 1 > p0w) ||
                          (window > 0 && p0w + 63 - k0 >= window);
        if (edge)
          softmax_tile<true, BN>(s, m, l, alpha, c, qoff + r0, k0 + 2 * t,
                                 skv, causal, window);
        else
          softmax_tile<false, BN>(s, m, l, alpha, c, qoff + r0, k0 + 2 * t,
                                  skv, causal, window);
      };

      // warpgroup 0 has the first turn; the last group's pass is only 0's,
      // so that every turn waited for is passed exactly once
      if (wg == 1) turn_pass<kTurns>(wg);
      mbar_wait(q_full, 0);
      mbar_wait(k_full, 0);
      turn_wait<kTurns>(wg);
      issue_qk<DQK, BN>(s, q_wg, s_k);
      turn_pass<kTurns>(wg);
      wg_wait<0>();
      fence_regs(s);
      mbar_arrive(k_empty);
      softmax(k_begin);
      to_p<BN>(s, ph, pl);

      for (int j = 1; j < n_tiles; ++j) {
        const int st = j % ST;
        const int pst = (j - 1) % ST;
        mbar_wait(k_full + 8 * st, (j / ST) & 1);
        mbar_wait(v_full + 8 * pst, ((j - 1) / ST) & 1);
        turn_wait<kTurns>(wg);
        issue_qk<DQK, BN>(s, q_wg, s_k + st * C::kKBytes);
        issue_pv<DV, BN>(acc, ph, pl, s_v + pst * C::kVBytes);
        turn_pass<kTurns>(wg);
        wg_wait<1>();                     // S of tile j is in
        fence_regs(s);
        mbar_arrive(k_empty + 8 * st);
        softmax(k_begin + j * BN);
        wg_wait<0>();                     // PV of tile j - 1 is in
        fence_regs(acc);
        fence_regs(ph);
        fence_regs(pl);
        mbar_arrive(v_empty + 8 * pst);
        // once the running max settles most tiles leave every row's alpha
        // at exactly 1 (2^0), and the multiplies would change nothing
        if (__any_sync(0xffffffffu, alpha[0] != 1.f || alpha[1] != 1.f)) {
#pragma unroll
          for (int i = 0; i < DV / 2; ++i) acc[i] *= alpha[(i >> 1) & 1];
        }
        to_p<BN>(s, ph, pl);
      }
      const int st = (n_tiles - 1) % ST;
      mbar_wait(v_full + 8 * st, ((n_tiles - 1) / ST) & 1);
      turn_wait<kTurns>(wg);
      issue_pv<DV, BN>(acc, ph, pl, s_v + st * C::kVBytes);
      if (wg == 0) turn_pass<kTurns>(wg);
      wg_wait<0>();
      fence_regs(acc);
      mbar_arrive(v_empty + 8 * st);
    }

    // the row's denominator is the quad's partial sums
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      l[hr] += __shfl_xor_sync(0xffffffffu, l[hr], 1);
      l[hr] += __shfl_xor_sync(0xffffffffu, l[hr], 2);
    }
    const size_t o_row = static_cast<size_t>(hq) * DV;
    __nv_bfloat16* ob = o + static_cast<size_t>(b) * sq * o_row + h * DV;
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int row = r0 + 8 * hr;
      if (row >= sq) continue;
      __nv_bfloat16* orow = ob + static_cast<size_t>(row) * o_row + 2 * t;
      // a row with no visible key keeps l == 0 and writes 0
      const float lr = l[hr];
#pragma unroll
      for (int n = 0; n < DV / 8; ++n) {
        const float v0 = lr == 0.f ? 0.f : acc[4 * n + 2 * hr] / lr;
        const float v1 = lr == 0.f ? 0.f : acc[4 * n + 2 * hr + 1] / lr;
        *reinterpret_cast<__nv_bfloat162*>(orow + n * 8) =
            __floats2bfloat162_rn(v0, v1);
      }
    }
  }
}

// ---- host: tensor maps and the launch ------------------------------------

// A 4-D map over a contiguous bf16 (B, S, H, W) tensor whose boxes are 64
// columns of one head by `rows` rows, 128-byte swizzled; rows past S read 0.
bool make_map(CUtensorMap* map, const void* ptr, int batch, int s, int heads,
              int w, int rows) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(w),
                              static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(s),
                              static_cast<cuuint64_t>(batch)};
  const cuuint64_t row = static_cast<cuuint64_t>(w) * 2;
  const cuuint64_t strides[3] = {row, row * heads, row * heads * s};
  const cuuint32_t box[4] = {64, 1, static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                const_cast<void*>(ptr), dims, strides, box, elem,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int DQK, int DV, int BN, int ST>
int launch_sm90(const void* q, const void* k, const void* v, void* o,
                int batch, int hq, int hkv, int sq, int skv, int causal,
                int window, int qoff, float scale, cudaStream_t stream) {
  using C = Sm90Cfg<DQK, DV, BN, ST>;
  auto kern = flash_attention_sm90_kernel<DQK, DV, BN, ST>;
  CUtensorMap tq, tk, tv;
  // with no keys no tile is loaded: maps over q stand in for empty k and v
  const bool keys = skv > 0;
  if (!make_map(&tq, q, batch, sq, hq, DQK, kBM) ||
      !make_map(&tk, keys ? k : q, batch, keys ? skv : sq, keys ? hkv : hq,
                DQK, BN) ||
      !make_map(&tv, keys ? v : q, batch, keys ? skv : sq, keys ? hkv : hq,
                keys ? DV : DQK, BN))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, C::kSmem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid(batch * hq, (sq + kBM - 1) / kBM);
  kern<<<grid, kThreads, C::kSmem, stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(o), hq, hkv, sq, skv, causal,
      window, qoff, static_cast<float>(scale * 1.4426950408889634));
  return reconic::launch_status();
}

}  // namespace

// q: (B, Sq, Hq, d), k: (B, Skv, Hkv, d), v: (B, Skv, Hkv, dv), out: (B,
// Sq, Hq, dv), all bf16, contiguous and 16-byte aligned; Hq % Hkv == 0,
// (d, dv) one of (64, 64), (128, 128), (192, 128); ceil(Sq / 128) <= 65535.
// window 0 means no window; q_offset (>= 0) is the position of q's first
// row among the keys.
RECONIC_API int reconic_flash_attention_sm90(const void* q, const void* k,
                                             const void* v, void* out,
                                             int batch, int hq, int hkv,
                                             int sq, int skv, int d, int dv,
                                             int causal, int window,
                                             int q_offset, float scale,
                                             void* stream) {
  if (q_offset < 0) return static_cast<int>(cudaErrorInvalidValue);
  if ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
       reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(out)) %
      16)
    return static_cast<int>(cudaErrorMisalignedAddress);
  auto s = static_cast<cudaStream_t>(stream);
  // (d, dv, keys a stage, stages)
#define RECONIC_SM90_CASE(D, DV, BN, ST)                                   \
  if (d == D && dv == DV)                                                   \
    return launch_sm90<D, DV, BN, ST>(q, k, v, out, batch, hq, hkv, sq, skv, \
                                      causal, window, q_offset, scale, s);
  RECONIC_SM90_CASE(64, 64, 96, 2)
  RECONIC_SM90_CASE(128, 128, 64, 2)
  RECONIC_SM90_CASE(192, 128, 64, 2)
#undef RECONIC_SM90_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}

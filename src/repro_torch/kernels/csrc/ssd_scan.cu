// K7 ssd_scan: the Mamba-2 SSD chunked scan, the SSM prefill's kernel.
//
// Replaces src/repro/kernels/ssd_scan.py:ssd_scan (_ssd_kernel): the TPU
// version walks a (batch, heads, chunks) grid with the chunk sweep
// innermost and sequential, holds a whole chunk's x, B and C in VMEM,
// runs the chunk's quadratic form on the MXU and carries the (head_dim,
// d_state) state in VMEM scratch from one grid step to the next. It
// starts from a zero state and never returns the last one. This kernel
// also takes the initial state and writes the final state, which the
// model's prefill needs to seed decode (models/ssm.py), so the prefill
// and the forward without caches both run here.
//
// What bounds it on the H100: operations. At the mamba2-370m prefill
// shape (8 sequences x 512 tokens, 32 heads of head_dim 64, d_state 128,
// chunk 256, f32) the function needs C.B^T over each chunk's lower
// triangle once per (sequence, chunk), and per head the weighted sum of
// x over that triangle, C_i . S_prev and the state increment: ~6.6
// GFLOP, 0.098 ms at the 67 TFLOP/s f32 peak outside the tensor cores.
// Its route runs w.x, C_i . S_prev and the state increment as 3xTF32,
// three TF32 products each at 495 TFLOP/s, and C.B^T (2% of the work) on
// the FP64 tensor cores at 67: ~0.041 ms. x, y, dt, B, C and the two
// states are ~89 MB, 0.026 ms at 3.35 TB/s.
//
// Design: Mamba-2's own chunked algorithm, as five launches on one
// stream. Blocks run in parallel and in no order, so everything that does
// not need the previous chunk's state runs chunk-parallel, and only an
// elementwise recurrence walks the chunks in order:
// 1. cum (ssd_scan_cum): one block per (sequence, chunk, 32 heads) copies
//    the chunk's dt into shared memory by cp.async; one thread per head
//    sums da = dt * a in order (the plain version sums in the same order,
//    so both hold the same cum bit for bit: at |cum| ~ 3000, mamba2's
//    a = -16 over 256 steps, one f32 step is 2.4e-4, and another order
//    moves cum_i - cum_j by that much) and cum goes to scratch in dt's
//    (B, S, nh) layout. Passes 3-5 form exp(cum) and exp(seg_end - cum)
//    where they use them, in parallel.
// 2. C.B^T (ssd_scan_cb): with n_groups 1, B and C are shared by all
//    heads, so C.B^T is computed once per (sequence, chunk), one block per
//    64 x 64 tile on and below the diagonal, into an (Lp, Lp) scratch per
//    chunk, Lp the chunk rounded up to 64 (4 MB at mamba2's shape: it
//    stays in the 50 MB L2). It runs on the FP64 tensor cores, exact to
//    its f32 rounding (below).
// 3. chunk state (ssd_scan_chunk_state): per (sequence, chunk, head) the
//    increment sum_j exp(seg_end - cum_j) dt_j x_j B_j^T, a (hd x L) by
//    (L x N) product over 16-row tiles of x and B staged in shared memory.
// 4. state passing (ssd_scan_state_pass): one thread per four state
//    entries walks the chunks in order, S_c = exp(seg_end_c) S_{c-1} +
//    increment, from init_state or zeros; it overwrites each increment
//    with the state before its chunk and writes the final state.
// 5. chunk scan (ssd_scan_chunk_scan): per (sequence, chunk, head, 64-row
//    tile of outputs), 8 warps, y_i = sum_{j<=i} w_ij x_j + exp(cum_i)
//    C_i . S_prev with w_ij = (C.B^T)_ij exp(cum_i - cum_j) dt_j formed in
//    f32 from the C.B^T scratch, each entry once; tiles above the diagonal
//    are skipped, and blocks with the most source tiles start first. The
//    C_i . S_prev term is skipped where S_prev is the zero state.
// Tiles come into shared memory raw by cp.async (16-byte copies where the
// source is aligned), each issued before the previous tile's products so
// that it flies under them, and are split into TF32 halves there: no
// staging registers (staging through registers took all 255 and
// spilled). Chunk c's outputs depend only on chunk c and
// the state before it, no pass uses atomics and every sum runs in a fixed
// order, so two calls give the same bits and a scan's first chunks do not
// depend on how many follow.
//
// The products run on the tensor cores. w.x, C_i . S_prev and the state
// increment as 3xTF32 (mma.sync m16n8k8): x_hi = tf32_rna(x), x_lo =
// tf32_rna(x - x_hi), a.b ~ a_lo.b_hi + a_hi.b_lo + a_hi.b_hi, ~2^-21
// relative per product where one TF32 product gives ~2^-11 and misses
// the reference's 2e-5 (tests/test_torch_ssd_numerics.py emulates the
// route). Each k-step's three products go into a fresh accumulator that
// is added to the running sum with round-to-nearest (mma3): the tensor
// cores round toward zero, and a running sum kept in the mma accumulator
// missed 2e-5 at mamba2's shape. C.B^T runs on the FP64 tensor cores
// (mma m8n8k4), exact before its one rounding to f32: the plain version's
// f32 C.B^T is what moves it from float64, and 3xTF32 C.B^T added its own
// error to that distance, which the 2e-5 contract against the plain
// version has to hold (tests/test_torch_ssd_numerics.py shows both). x,
// wst_j B_j and w are split into TF32 halves once, in shared memory; the
// C rows and the state of C_i . S_prev as their fragments load. A bf16 x
// is exact in TF32, so the products with x as an operand drop their x_lo
// term. Each k-step's columns are permuted
// (logical k, k + 4 -> physical 2k, 2k + 1) on both operands, which leaves
// the sum unchanged and lets a fragment come in as two neighbouring words;
// rows in shared memory are padded so the fragment loads hit distinct
// banks.
//
// Arithmetic kept from the TPU kernel and models/ssm._ssd_chunked, so the
// 2e-5 tolerance holds and exp underflows where the reference's does:
// da = dt * a rounded before the in-chunk cumsum, which sums in order;
// rel = cum_i - cum_j is set to -1e30 where i < j BEFORE expf (no
// exp(cum_i) * exp(-cum_j) reformulation, which overflows);
// w = ((C.B^T)_ij * exp(rel)) * dt_j; y = y_intra + exp(cum_i) * (C_i .
// S_prev); S = exp(seg_end) * S_prev + increment. expf is the accurate one
// (the library is never built with fast math).
#include <type_traits>

#include "common.cuh"

namespace {

using reconic::cp_async_commit;
using reconic::cp_async_wait;
using reconic::mma_tf32;
using reconic::smem_u32;
using reconic::split_tf32;

constexpr int kThreads = 128;           // 4 warps: passes 1, 2 and 3
constexpr int kTile = 64;               // rows of a C.B^T or output tile
constexpr int kJ = 16;                  // source rows of a pass-3 stage
// pass-3 blocks an SM holds at once: with 16-row stages and this cap pass
// 3 ran faster at mamba2's shape than with 32-row stages uncapped, which
// took 255 registers and held two blocks an SM
constexpr int kStateBlocks = 4;
constexpr int kKC = 32;                 // depth (of N) of a staged k-chunk
constexpr int kCumRows = 256;           // positions of a pass-1 stage
constexpr int kHeads = 32;              // heads of a pass-1 block
constexpr int kPassThreads = 256;       // pass 4
constexpr int kSmemLimit = 232448;      // dynamic shared memory per block
// The longest chunk taken: the C.B^T scratch grows as chunk^2 (64 MB a
// chunk at 4096, past the L2) and one thread sums a chunk's cum in order.
constexpr int kMaxChunk = 4096;
constexpr float kNegInf = -1e30f;
// which of x, B and C are 16-byte aligned (their rows are 16-byte multiples)
constexpr int kXAligned = 1, kBAligned = 2, kCAligned = 4;

inline int round_up(int v, int m) { return (v + m - 1) / m * m; }

// Scratch, in floats: cum in dt's (B, S, nh) layout (rounded up to 64
// floats), C.B^T as (B, nc, Lp, Lp) with Lp the chunk rounded up to 64,
// the chunk states as (B, nc, nh, hd, N).
struct Work {
  float* cum;
  float* cb;
  float* st;
};

inline size_t cum_floats(int batch, int nh, int s) {
  return (static_cast<size_t>(batch) * s * nh + 63) / 64 * 64;
}

inline size_t work_floats(int batch, int nh, int s, int hd, int n,
                          int chunk) {
  const size_t nc = s / chunk, lp = round_up(chunk, kTile);
  return cum_floats(batch, nh, s) +
         static_cast<size_t>(batch) * nc *
             (lp * lp + static_cast<size_t>(nh) * hd * n);
}

// 4-byte global -> shared copy; writes a zero when !valid.
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 4 : 0));
}

// `rows` rows of row_bytes bytes (row strides in bytes) into shared memory
// by cp.async, one group's worth: 16-byte copies where v16 says the source
// allows them (base, strides and row_bytes multiples of 16), else 4-byte;
// rows at and past `valid` (>= 1) are zero-filled.
template <int NTH>
__device__ __forceinline__ void copy_rows(void* dst, int dst_stride,
                                          const void* src, size_t src_stride,
                                          int rows, int row_bytes, int valid,
                                          bool v16) {
  char* d = static_cast<char*>(dst);
  const char* s = static_cast<const char*>(src);
  const int unit = v16 ? 16 : 4, upr = row_bytes / unit;
  for (int u = threadIdx.x; u < rows * upr; u += NTH) {
    const int r = u / upr, c = (u % upr) * unit;
    const char* from = s + static_cast<size_t>(min(r, valid - 1)) *
                               src_stride + c;
    if (v16)
      reconic::cp_async16(d + r * dst_stride + c, from, r < valid);
    else
      cp_async4(d + r * dst_stride + c, from, r < valid);
  }
}

// acc += a.b over one 8-deep k-step as 3xTF32, small terms first, the
// step's products in a fresh mma accumulator that is then added to acc
// with round-to-nearest. The tensor cores round an accumulation toward
// zero, so a running sum kept in the mma accumulator drifts by about an
// ulp of the sum per step (it took y past the 2e-5 tolerance at mamba2's
// shape); here it drifts by an ulp of one step's sum, and the steps add
// as an f32 sum does. kALo / kBLo false drop the term of an
// operand whose low half is 0 (a bf16 x).
template <bool kALo, bool kBLo>
__device__ __forceinline__ void mma3(float (&acc)[4], const uint32_t (&ah)[4],
                                     const uint32_t (&al)[4], uint32_t bh0,
                                     uint32_t bh1, uint32_t bl0,
                                     uint32_t bl1) {
  float p[4] = {0.f, 0.f, 0.f, 0.f};
  if (kALo) mma_tf32(p, al, bh0, bh1);
  if (kBLo) mma_tf32(p, ah, bl0, bl1);
  mma_tf32(p, ah, bh0, bh1);
#pragma unroll
  for (int e = 0; e < 4; ++e) acc[e] = __fadd_rn(acc[e], p[e]);
}

// d += a.b on the FP64 tensor cores, m8n8k4: a = A[g][t], b = B[t][g],
// d = D[g][2t], D[g][2t + 1] (g = lane / 4, t = lane % 4).
__device__ __forceinline__ void mma_f64(double (&d)[2], double a, double b) {
  asm volatile(
      "mma.sync.aligned.m8n8k4.row.col.f64.f64.f64.f64 {%0,%1}, {%2}, {%3}, "
      "{%0,%1};\n"
      : "+d"(d[0]), "+d"(d[1])
      : "d"(a), "d"(b));
}

__device__ __forceinline__ float2 ld2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}

// ---- 1. the in-chunk cumsum, in order -------------------------------------
// grid (B * nc, head groups of kHeads): a chunk's dt comes in by 4-byte
// cp.async, kCumRows positions at a time; one thread per head sums in
// order, in place; cum goes out in dt's layout.
__global__ void __launch_bounds__(kThreads)
    ssd_scan_cum(const float* __restrict__ dt, const float* __restrict__ a,
                 float* __restrict__ cum, int nh, int L) {
  __shared__ float sd[kCumRows][kHeads + 1];
  const int tid = threadIdx.x;
  const int h0 = blockIdx.y * kHeads;
  const int hn = min(kHeads, nh - h0);
  const size_t base = static_cast<size_t>(blockIdx.x) * L * nh + h0;
  const float av = tid < hn ? a[h0 + tid] : 0.f;
  float run = 0.f;
  for (int l0 = 0; l0 < L; l0 += kCumRows) {
    const int ln = min(kCumRows, L - l0);
    __syncthreads();                    // the previous stage is written out
    for (int e = tid; e < kCumRows * kHeads; e += kThreads) {
      const int l = e / kHeads, h = e % kHeads;
      if (l < ln && h < hn)
        cp_async4(&sd[l][h], dt + base + static_cast<size_t>(l0 + l) * nh + h,
                  true);
    }
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    if (tid < hn) {
#pragma unroll 8
      for (int l = 0; l < ln; ++l) {
        run = __fadd_rn(run, __fmul_rn(sd[l][tid], av));
        sd[l][tid] = run;
      }
    }
    __syncthreads();
    for (int e = tid; e < kCumRows * kHeads; e += kThreads) {
      const int l = e / kHeads, h = e % kHeads;
      if (l < ln && h < hn)
        cum[base + static_cast<size_t>(l0 + l) * nh + h] = sd[l][h];
    }
  }
}

// ---- 2. C.B^T once per (sequence, chunk) ----------------------------------
// grid (B * nc, tiles on and below the diagonal); warp w owns 16 rows of
// the 64 x 64 tile. C and B rows come in by cp.async in kKC-deep k-chunks,
// and the product runs on the FP64 tensor cores (mma m8n8k4): an f32
// product is exact in f64 and the sum over N keeps 53 bits, so each entry
// is the exact C_i . B_j rounded once to f32. The plain version's own f32
// dot product is what lies farthest from that, and 3xTF32 here added its
// error to that distance.
template <int N>
__global__ void __launch_bounds__(kThreads)
    ssd_scan_cb(const float* __restrict__ bm, const float* __restrict__ cm,
                float* __restrict__ cb, int L, int lp, int aligned) {
  constexpr int KC = N < kKC ? N : kKC, SS = KC + 4;   // rows 4 words apart
  __shared__ __align__(16) float s[2][kTile * SS];   // C rows, B rows
  int k = blockIdx.y, ti = 0;
  while (k > ti) k -= ++ti;             // (ti, tj = k), k <= ti
  const int tj = k;
  const int bc = blockIdx.x;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const float* cr = cm + (static_cast<size_t>(bc) * L + ti * kTile) * N;
  const float* br = bm + (static_cast<size_t>(bc) * L + tj * kTile) * N;

  double acc[2][8][2];                  // rows 16 w + 8 m + g, cols 8 n + 2t
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int n = 0; n < 8; ++n) acc[m][n][0] = acc[m][n][1] = 0.0;

  for (int k0 = 0; k0 < N; k0 += KC) {
    __syncthreads();                    // the previous chunk is consumed
    copy_rows<kThreads>(s[0], SS * 4, cr + k0, N * 4, kTile, KC * 4,
                        L - ti * kTile, aligned & kCAligned);
    copy_rows<kThreads>(s[1], SS * 4, br + k0, N * 4, kTile, KC * 4,
                        L - tj * kTile, aligned & kBAligned);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
#pragma unroll 1
    for (int kk = 0; kk < KC; kk += 4) {
      double a[2];
#pragma unroll
      for (int m = 0; m < 2; ++m)
        a[m] = s[0][(warp * 16 + 8 * m + g) * SS + kk + t];
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        const double b = s[1][(n * 8 + g) * SS + kk + t];
#pragma unroll
        for (int m = 0; m < 2; ++m) mma_f64(acc[m][n], a[m], b);
      }
    }
  }
#pragma unroll
  for (int m = 0; m < 2; ++m) {
    const int r = ti * kTile + warp * 16 + 8 * m + g;
    float* out = cb + (static_cast<size_t>(bc) * lp + r) * lp + tj * kTile +
                 2 * t;
#pragma unroll
    for (int n = 0; n < 8; ++n)
      *reinterpret_cast<float2*>(out + n * 8) =
          make_float2(__double2float_rn(acc[m][n][0]),
                      __double2float_rn(acc[m][n][1]));
  }
}

// ---- 3. each chunk's state increment --------------------------------------
// One block per (sequence, chunk, head): inc[d][n] = sum_j x_j[d] *
// (wst_j B_j[n]) with wst_j = exp(seg_end - cum_j) dt_j, A = x^T (hd x L)
// and B' = wst B (L x N) staged kJ rows at a time as TF32 halves. The
// (hd/16) x (N/8) m16n8 output tiles are spread over a WM x WN grid of
// warps.
template <typename T, int HD, int N>
struct StateCfg {
  static constexpr int MT = HD / 16, NT = N / 8;
  static constexpr int WM = MT >= 2 ? 2 : 1, WN = 4 / WM;
  static constexpr int MPW = MT / WM, NPW = (NT + WN - 1) / WN;
  static constexpr int XS = HD + 4, BS = N + 4;   // padded rows
  static constexpr int kXRaw = kJ * HD * (int)sizeof(T) / 4;   // floats
  static constexpr int kSmem =
      (2 * kJ * XS + 2 * kJ * BS + kXRaw + kJ * N + 3 * kJ) * 4;
};

template <typename T, int HD, int N>
__global__ void __launch_bounds__(kThreads, kStateBlocks)
    ssd_scan_chunk_state(const T* __restrict__ x,
                         const float* __restrict__ dt,
                         const float* __restrict__ bm, Work w, int nh,
                         int L, int aligned) {
  using C = StateCfg<T, HD, N>;
  constexpr bool kExact = !std::is_same<T, float>::value;   // bf16 x
  extern __shared__ __align__(16) float smem[];
  float* xh = smem;                     // [kJ][XS] x, TF32 high half
  float* xl = xh + kJ * C::XS;          // [kJ][XS] x, low half
  float* bh = xl + kJ * C::XS;          // [kJ][BS] wst_j B_j, high half
  float* bl = bh + kJ * C::BS;          // [kJ][BS] low half
  T* xr = reinterpret_cast<T*>(bl + kJ * C::BS);   // [kJ][HD] raw x
  float* br = bl + kJ * C::BS + C::kXRaw;          // [kJ][N] raw B
  float* cumj = br + kJ * N;            // [kJ] raw cum_j
  float* dtj = cumj + kJ;               // [kJ] raw dt_j
  float* ws = dtj + kJ;                 // [kJ] wst_j

  const int vi = blockIdx.x;            // (bc, h)
  const int bc = vi / nh, h = vi % nh;
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp / C::WN, wn = warp % C::WN;
  const size_t tok0 = static_cast<size_t>(bc) * L;
  const float* cumc = w.cum + tok0 * nh + h;     // position stride nh
  const float* dtc = dt + tok0 * nh + h;
  const float seg_end = cumc[static_cast<size_t>(L - 1) * nh];
  const size_t xrow = static_cast<size_t>(nh) * HD;
  const T* xb = x + tok0 * xrow + h * HD;
  const float* bb = bm + tok0 * N;

  // the stage of kJ sources from j0 into the raw buffers, as one cp.async
  // group (rows past the chunk read as 0); it flies under the previous
  // stage's products
  const auto fetch = [&](int j0) {
    copy_rows<kThreads>(xr, HD * sizeof(T), xb + j0 * xrow, xrow * sizeof(T),
                        kJ, HD * sizeof(T), L - j0, aligned & kXAligned);
    copy_rows<kThreads>(br, N * 4, bb + static_cast<size_t>(j0) * N, N * 4,
                        kJ, N * 4, L - j0, aligned & kBAligned);
    if (tid < kJ) {
      const size_t jr = static_cast<size_t>(min(j0 + tid, L - 1)) * nh;
      cp_async4(cumj + tid, cumc + jr, true);
      cp_async4(dtj + tid, dtc + jr, j0 + tid < L);
    }
    cp_async_commit();
  };

  float acc[C::MPW][C::NPW][4];
#pragma unroll
  for (int i = 0; i < C::MPW; ++i)
#pragma unroll
    for (int k = 0; k < C::NPW; ++k)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][k][e] = 0.f;

  fetch(0);
  for (int j0 = 0; j0 < L; j0 += kJ) {
    cp_async_wait<0>();
    __syncthreads();                    // the stage is in; hi/lo are free
    if (tid < kJ)
      ws[tid] = __fmul_rn(expf(__fsub_rn(seg_end, cumj[tid])), dtj[tid]);
    for (int e = tid; e < kJ * HD; e += kThreads) {
      uint32_t hi, lo;
      split_tf32(reconic::to_f32(xr[e]), hi, lo);
      xh[(e / HD) * C::XS + e % HD] = __uint_as_float(hi);
      xl[(e / HD) * C::XS + e % HD] = __uint_as_float(lo);
    }
    __syncthreads();                    // ws is ready
    for (int e = tid; e < kJ * N; e += kThreads) {
      uint32_t hi, lo;
      split_tf32(__fmul_rn(ws[e / N], br[e]), hi, lo);
      bh[(e / N) * C::BS + e % N] = __uint_as_float(hi);
      bl[(e / N) * C::BS + e % N] = __uint_as_float(lo);
    }
    __syncthreads();                    // the raw buffers are free
    if (j0 + kJ < L) fetch(j0 + kJ);

#pragma unroll 1
    for (int ks = 0; ks < kJ / 8; ++ks) {
      const int k0 = ks * 8 + 2 * t;    // this lane's sources k0, k0 + 1
      uint32_t ah[C::MPW][4], al[C::MPW][4];
#pragma unroll
      for (int i = 0; i < C::MPW; ++i) {
        const int m = (wm + C::WM * i) * 16 + g;
        const float* p = xh + k0 * C::XS + m;
        const float* q = xl + k0 * C::XS + m;
        ah[i][0] = __float_as_uint(p[0]);
        ah[i][1] = __float_as_uint(p[8]);
        ah[i][2] = __float_as_uint(p[C::XS]);
        ah[i][3] = __float_as_uint(p[C::XS + 8]);
        al[i][0] = __float_as_uint(q[0]);
        al[i][1] = __float_as_uint(q[8]);
        al[i][2] = __float_as_uint(q[C::XS]);
        al[i][3] = __float_as_uint(q[C::XS + 8]);
      }
#pragma unroll
      for (int k = 0; k < C::NPW; ++k) {
        const int nt = wn + C::WN * k;
        if (nt >= C::NT) continue;
        const int nn = nt * 8 + g;
        const uint32_t bh0 = __float_as_uint(bh[k0 * C::BS + nn]);
        const uint32_t bh1 = __float_as_uint(bh[(k0 + 1) * C::BS + nn]);
        const uint32_t bl0 = __float_as_uint(bl[k0 * C::BS + nn]);
        const uint32_t bl1 = __float_as_uint(bl[(k0 + 1) * C::BS + nn]);
#pragma unroll
        for (int i = 0; i < C::MPW; ++i)
          mma3<!kExact, true>(acc[i][k], ah[i], al[i], bh0, bh1, bl0, bl1);
      }
    }
  }

  float* out = w.st + static_cast<size_t>(vi) * HD * N;
#pragma unroll
  for (int i = 0; i < C::MPW; ++i) {
    const int m = (wm + C::WM * i) * 16 + g;
#pragma unroll
    for (int k = 0; k < C::NPW; ++k) {
      const int nt = wn + C::WN * k;
      if (nt >= C::NT) continue;
      const int n = nt * 8 + 2 * t;
      *reinterpret_cast<float2*>(out + m * N + n) =
          make_float2(acc[i][k][0], acc[i][k][1]);
      *reinterpret_cast<float2*>(out + (m + 8) * N + n) =
          make_float2(acc[i][k][2], acc[i][k][3]);
    }
  }
}

// ---- 4. the state passed from chunk to chunk ------------------------------
// One thread per (sequence, head, 4 state entries); overwrites each
// chunk's increment with the state before that chunk.
__global__ void __launch_bounds__(kPassThreads)
    ssd_scan_state_pass(const float* __restrict__ init,
                        const float* __restrict__ cum,
                        float* __restrict__ st,
                        float* __restrict__ final_state, int nh, int nc,
                        int L, int per4, size_t total4) {
  const size_t e4 = static_cast<size_t>(blockIdx.x) * kPassThreads +
                    threadIdx.x;
  if (e4 >= total4) return;
  const size_t bh = e4 / per4;
  const int r4 = static_cast<int>(e4 % per4);
  const int b = static_cast<int>(bh / nh), h = static_cast<int>(bh % nh);
  float4 carry = make_float4(0.f, 0.f, 0.f, 0.f);
  if (init) {                           // the caller's: 4-byte aligned
    const float* p = init + 4 * e4;
    carry = make_float4(p[0], p[1], p[2], p[3]);
  }
  for (int c = 0; c < nc; ++c) {
    const size_t bcc = static_cast<size_t>(b) * nc + c;
    const float dec = expf(cum[((bcc + 1) * L - 1) * nh + h]);
    float4* p = reinterpret_cast<float4*>(st) + (bcc * nh + h) * per4 + r4;
    const float4 inc = *p;
    *p = carry;
    carry = make_float4(__fadd_rn(__fmul_rn(carry.x, dec), inc.x),
                        __fadd_rn(__fmul_rn(carry.y, dec), inc.y),
                        __fadd_rn(__fmul_rn(carry.z, dec), inc.z),
                        __fadd_rn(__fmul_rn(carry.w, dec), inc.w));
  }
  reinterpret_cast<float4*>(final_state)[e4] = carry;
}

// ---- 5. each chunk's outputs ----------------------------------------------
// grid (B * nc * nh, output tiles) of 8-warp blocks: warp w owns 16 output
// rows (w % 4) of the 64-row tile and half of the hd columns (w / 4).
// C_i . S_prev^T runs on the state and the tile's C rows, brought in raw
// by cp.async in one trip. Then, per 64-row source tile j, cp.async
// brings x, the (i, j) tile of the L2-resident C.B^T scratch, cum_j and
// dt_j into shared memory as they are (the first tile's copy flies under
// C_i . S_prev, each later one under the previous tile's products); the
// block splits x and forms w_ij (each entry once), both as TF32 halves,
// and each warp runs its products. On the diagonal tile a warp skips the
// k-steps whose sources all lie past its rows (w = 0 there).
constexpr int kScanThreads = 256;

template <typename T, int HD, int N>
struct ScanCfg {
  static constexpr int SS = N + 8;      // state and C rows: 8-byte loads apart
  static constexpr int XS = HD + 4;     // x rows
  static constexpr int WS = kTile + 8;  // w rows: 8-byte loads apart
  static constexpr int kInter = (HD + kTile) * SS;
  static constexpr int kIntra = 2 * kTile * XS + 2 * kTile * WS;
  static constexpr int kRegion = kInter > kIntra ? kInter : kIntra;
  static constexpr int kXRaw = kTile * HD * (int)sizeof(T) / 4;   // floats
  static constexpr int kSmem =
      (kRegion + kXRaw + kTile * kTile + 3 * kTile) * 4;
};

template <typename T, int HD, int N>
__global__ void __launch_bounds__(kScanThreads, 2)
    ssd_scan_chunk_scan(const T* __restrict__ x,
                        const float* __restrict__ dt,
                        const float* __restrict__ cm, Work w,
                        T* __restrict__ y, int nh, int nc, int L, int lp,
                        int seeded, int aligned) {
  using C = ScanCfg<T, HD, N>;
  constexpr bool kExact = !std::is_same<T, float>::value;   // bf16 x
  constexpr int NW = HD / 16;           // 8-wide n-tiles of a warp
  extern __shared__ __align__(16) float smem[];
  T* xr = reinterpret_cast<T*>(smem + C::kRegion);   // [kTile][HD] raw x
  float* cbr_s = smem + C::kRegion + C::kXRaw;       // [kTile][kTile]
  float* cumj = cbr_s + kTile * kTile;  // [kTile] cum of the source tile
  float* dtj = cumj + kTile;            // [kTile] dt of the source tile
  float* cumi = dtj + kTile;            // [kTile] cum of the output rows

  const int vi = blockIdx.x;            // (bc, h)
  const int bc = vi / nh, h = vi % nh;
  const int it = static_cast<int>(gridDim.y) - 1 -
                 static_cast<int>(blockIdx.y);   // longest first
  const int i0 = it * kTile;
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, t = lane & 3;
  const int rg = warp & 3;              // row group
  const int c0 = (warp >> 2) * (HD / 2);   // first column of the warp
  const int wr = rg * 16 + g;           // tile rows wr, wr + 8
  const int r0 = i0 + wr;
  const size_t tok0 = static_cast<size_t>(bc) * L;
  const float* cumc = w.cum + tok0 * nh + h;     // position stride nh
  const float* dtc = dt + tok0 * nh + h;
  const size_t xrow = static_cast<size_t>(nh) * HD;
  const T* xb = x + tok0 * xrow + h * HD;
  const float* cbr = w.cb + (static_cast<size_t>(bc) * lp + i0) * lp;

  // source tile jt into the raw buffers, as one cp.async group; rows past
  // the chunk read x and dt as 0 and cum as seg_end
  const auto fetch = [&](int jt) {
    const int j0 = jt * kTile;
    copy_rows<kScanThreads>(xr, HD * sizeof(T), xb + j0 * xrow,
                            xrow * sizeof(T), kTile, HD * sizeof(T), L - j0,
                            aligned & kXAligned);
    for (int e = tid; e < kTile * kTile / 4; e += kScanThreads) {
      const int r = e / (kTile / 4), c = (e % (kTile / 4)) * 4;
      reconic::cp_async16(cbr_s + r * kTile + c,
                          cbr + static_cast<size_t>(r) * lp + j0 + c, true);
    }
    if (tid < kTile) {
      const size_t jr = static_cast<size_t>(min(j0 + tid, L - 1)) * nh;
      cp_async4(cumj + tid, cumc + jr, true);
      cp_async4(dtj + tid, dtc + jr, j0 + tid < L);
    }
    cp_async_commit();
  };
  // C_i . S_prev^T needs the state (S_prev is zero for the first chunk of
  // an unseeded scan) and the tile's C rows, raw, in one trip
  const bool inter_on = seeded || bc % nc > 0;
  float* sr = smem;                     // [HD][SS] the state
  float* cr = sr + HD * C::SS;          // [kTile][SS] C rows
  if (inter_on) {
    copy_rows<kScanThreads>(sr, C::SS * 4,
                            w.st + static_cast<size_t>(vi) * HD * N, N * 4,
                            HD, N * 4, HD, true);
    copy_rows<kScanThreads>(cr, C::SS * 4, cm + (tok0 + i0) * N, N * 4,
                            kTile, N * 4, L - i0, aligned & kCAligned);
    cp_async_commit();
  }
  fetch(0);
  if (tid < kTile)
    cumi[tid] = cumc[static_cast<size_t>(min(i0 + tid, L - 1)) * nh];

  float acc[NW][4], inter[NW][4];
#pragma unroll
  for (int n = 0; n < NW; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = inter[n][e] = 0.f;

  // ---- inter = C_i . S_prev^T, fragments split as they load
  if (inter_on) {
    cp_async_wait<1>();                 // the state and C rows are in
    __syncthreads();
#pragma unroll 1
    for (int ks = 0; ks < N / 8; ++ks) {
      const int kk = ks * 8 + 2 * t;
      const float2 a0 = ld2(cr + wr * C::SS + kk);
      const float2 a1 = ld2(cr + (wr + 8) * C::SS + kk);
      uint32_t ah[4], al[4];
      split_tf32(a0.x, ah[0], al[0]);
      split_tf32(a1.x, ah[1], al[1]);
      split_tf32(a0.y, ah[2], al[2]);
      split_tf32(a1.y, ah[3], al[3]);
#pragma unroll
      for (int n = 0; n < NW; ++n) {
        const float2 b = ld2(sr + (c0 + n * 8 + g) * C::SS + kk);
        uint32_t bh0, bl0, bh1, bl1;
        split_tf32(b.x, bh0, bl0);
        split_tf32(b.y, bh1, bl1);
        mma3<true, true>(inter[n], ah, al, bh0, bh1, bl0, bl1);
      }
    }
  }

  // ---- acc = sum over source tiles j <= i of w_ij x_j
  float* xh = smem;                     // [kTile][XS] x, high half
  float* xl = xh + kTile * C::XS;
  float* wh = xl + kTile * C::XS;       // [kTile][WS] w, high half
  float* wl = wh + kTile * C::WS;
  const int wc = tid % kTile;           // this thread's w column
  for (int jt = 0; jt <= it; ++jt) {
    const bool diag = jt == it;
    cp_async_wait<0>();
    __syncthreads();                    // tile jt is in; the region is free
    for (int e = tid; e < kTile * HD; e += kScanThreads) {
      uint32_t hi, lo;
      split_tf32(reconic::to_f32(xr[e]), hi, lo);
      xh[(e / HD) * C::XS + e % HD] = __uint_as_float(hi);
      xl[(e / HD) * C::XS + e % HD] = __uint_as_float(lo);
    }
    // w_ij = (C.B^T)_ij * exp(cum_i - cum_j) * dt_j, masked before exp
    {
      const float cjc = cumj[wc], djc = dtj[wc];
#pragma unroll 4
      for (int r = tid / kTile; r < kTile; r += kScanThreads / kTile) {
        const float rel = (!diag || r >= wc) ? __fsub_rn(cumi[r], cjc)
                                             : kNegInf;
        uint32_t hi, lo;
        split_tf32(__fmul_rn(__fmul_rn(cbr_s[r * kTile + wc], expf(rel)),
                             djc),
                   hi, lo);
        wh[r * C::WS + wc] = __uint_as_float(hi);
        wl[r * C::WS + wc] = __uint_as_float(lo);
      }
    }
    __syncthreads();                    // the raw buffers are free
    if (jt < it) fetch(jt + 1);

    const int ks_end = diag ? 2 * rg + 2 : kTile / 8;
#pragma unroll 1
    for (int ks = 0; ks < ks_end; ++ks) {
      const int jl = ks * 8 + 2 * t;    // this lane's sources jl, jl + 1
      const float2 h0 = ld2(wh + wr * C::WS + jl);
      const float2 h1 = ld2(wh + (wr + 8) * C::WS + jl);
      const float2 l0 = ld2(wl + wr * C::WS + jl);
      const float2 l1 = ld2(wl + (wr + 8) * C::WS + jl);
      const uint32_t ah[4] = {__float_as_uint(h0.x), __float_as_uint(h1.x),
                              __float_as_uint(h0.y), __float_as_uint(h1.y)};
      const uint32_t al[4] = {__float_as_uint(l0.x), __float_as_uint(l1.x),
                              __float_as_uint(l0.y), __float_as_uint(l1.y)};
#pragma unroll
      for (int n = 0; n < NW; ++n) {
        const int o = jl * C::XS + c0 + n * 8 + g;
        mma3<true, !kExact>(acc[n], ah, al, __float_as_uint(xh[o]),
                            __float_as_uint(xh[o + C::XS]),
                            __float_as_uint(xl[o]),
                            __float_as_uint(xl[o + C::XS]));
      }
    }
  }

  // ---- y = acc + exp(cum_i) * inter
  const float e0 = expf(cumi[wr]), e1 = expf(cumi[wr + 8]);
  T* yb = y + tok0 * xrow + h * HD + c0 + 2 * t;
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int row = r0 + 8 * hr;
    if (row >= L) continue;
    const float ec = hr ? e1 : e0;
#pragma unroll
    for (int n = 0; n < NW; ++n)
#pragma unroll
      for (int q = 0; q < 2; ++q)
        reconic::store_f32(
            yb, row * xrow + n * 8 + q,
            __fadd_rn(acc[n][2 * hr + q],
                      __fmul_rn(ec, inter[n][2 * hr + q])));
  }
}

template <typename K>
int allow_smem(K kern, int bytes) {
  if (bytes <= 48 * 1024) return 0;
  if (bytes > kSmemLimit) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes));
}

template <typename T, int HD, int N>
int run(const void* x, const void* dt, const void* a, const void* bm,
        const void* cm, const void* init, void* y, void* final_state,
        float* work, int batch, int nh, int s, int L, cudaStream_t stream) {
  const int nc = s / L, lp = round_up(L, kTile), tiles = lp / kTile;
  float* cb = work + cum_floats(batch, nh, s);
  Work w{work, cb, cb + static_cast<size_t>(batch) * nc * lp * lp};
  const auto* xp = static_cast<const T*>(x);
  const auto* dtp = static_cast<const float*>(dt);
  const auto* bp = static_cast<const float*>(bm);
  const auto* cp = static_cast<const float*>(cm);
  const int aligned =
      (reinterpret_cast<uintptr_t>(x) % 16 ? 0 : kXAligned) |
      (reinterpret_cast<uintptr_t>(bm) % 16 ? 0 : kBAligned) |
      (reinterpret_cast<uintptr_t>(cm) % 16 ? 0 : kCAligned);
  int err;

  ssd_scan_cum<<<dim3(batch * nc, (nh + kHeads - 1) / kHeads), kThreads, 0,
                 stream>>>(dtp, static_cast<const float*>(a), w.cum, nh, L);
  if ((err = reconic::launch_status())) return err;

  ssd_scan_cb<N><<<dim3(batch * nc, tiles * (tiles + 1) / 2), kThreads, 0,
                   stream>>>(bp, cp, w.cb, L, lp, aligned);
  if ((err = reconic::launch_status())) return err;

  auto state = ssd_scan_chunk_state<T, HD, N>;
  constexpr int kStateSmem = StateCfg<T, HD, N>::kSmem;
  if ((err = allow_smem(state, kStateSmem))) return err;
  state<<<batch * nc * nh, kThreads, kStateSmem, stream>>>(xp, dtp, bp, w, nh,
                                                           L, aligned);
  if ((err = reconic::launch_status())) return err;

  const int per4 = HD * N / 4;
  const size_t total4 = static_cast<size_t>(batch) * nh * per4;
  ssd_scan_state_pass<<<static_cast<unsigned>(
                            (total4 + kPassThreads - 1) / kPassThreads),
                        kPassThreads, 0, stream>>>(
      static_cast<const float*>(init), w.cum, w.st,
      static_cast<float*>(final_state), nh, nc, L, per4, total4);
  if ((err = reconic::launch_status())) return err;

  auto scan = ssd_scan_chunk_scan<T, HD, N>;
  constexpr int kScanSmem = ScanCfg<T, HD, N>::kSmem;
  if ((err = allow_smem(scan, kScanSmem))) return err;
  scan<<<dim3(batch * nc * nh, tiles), kScanThreads, kScanSmem, stream>>>(
      xp, dtp, cp, w, static_cast<T*>(y), nh, nc, L, lp, init != nullptr,
      aligned);
  return reconic::launch_status();
}

template <typename T, int HD>
int run_h(int n, const void* x, const void* dt, const void* a,
          const void* bm, const void* cm, const void* init, void* y,
          void* final_state, float* work, int batch, int nh, int s,
          int chunk, cudaStream_t stream) {
  switch (n) {
    case 16:
      return run<T, HD, 16>(x, dt, a, bm, cm, init, y, final_state, work,
                            batch, nh, s, chunk, stream);
    case 32:
      return run<T, HD, 32>(x, dt, a, bm, cm, init, y, final_state, work,
                            batch, nh, s, chunk, stream);
    case 64:
      return run<T, HD, 64>(x, dt, a, bm, cm, init, y, final_state, work,
                            batch, nh, s, chunk, stream);
    case 128:
      return run<T, HD, 128>(x, dt, a, bm, cm, init, y, final_state, work,
                             batch, nh, s, chunk, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename T>
int run_t(int hd, int n, const void* x, const void* dt, const void* a,
          const void* bm, const void* cm, const void* init, void* y,
          void* final_state, float* work, int batch, int nh, int s,
          int chunk, cudaStream_t stream) {
  switch (hd) {
    case 16:
      return run_h<T, 16>(n, x, dt, a, bm, cm, init, y, final_state, work,
                          batch, nh, s, chunk, stream);
    case 32:
      return run_h<T, 32>(n, x, dt, a, bm, cm, init, y, final_state, work,
                          batch, nh, s, chunk, stream);
    case 64:
      return run_h<T, 64>(n, x, dt, a, bm, cm, init, y, final_state, work,
                          batch, nh, s, chunk, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// x: (B, S, nh, hd) f32, or bf16 when is_bf16; dt: (B, S, nh), a: (nh,),
// bm and cm: (B, S, n) (n_groups 1), init: (B, nh, hd, n) or null for a
// zero state, all f32 (x 4-byte aligned: x rows come in by 4-byte
// cp.async); y: (B, S, nh, hd) in x's dtype; final_state:
// (B, nh, hd, n) f32, 16-byte aligned; work: f32 scratch of
// reconic_ssd_scan_work_floats floats, 16-byte aligned, whose first B * S
// * nh floats hold the in-chunk cumsum in dt's layout after the call. All
// contiguous. hd in {16, 32, 64}, n in {16, 32, 64, 128},
// S % chunk == 0 and chunk <= 4096.
RECONIC_API int reconic_ssd_scan(const void* x, const void* dt,
                                 const void* a, const void* bm,
                                 const void* cm, const void* init, void* y,
                                 void* final_state, void* work,
                                 long long work_floats_given, int batch,
                                 int nh, int s, int hd, int n, int chunk,
                                 int is_bf16, void* stream) {
  if (chunk <= 0 || chunk > kMaxChunk || s % chunk != 0 || batch <= 0 ||
      nh <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (work_floats_given < 0 || static_cast<size_t>(work_floats_given) <
                                   work_floats(batch, nh, s, hd, n, chunk))
    return static_cast<int>(cudaErrorInvalidValue);
  if ((reinterpret_cast<uintptr_t>(work) |
       reinterpret_cast<uintptr_t>(final_state)) % 16 ||
      reinterpret_cast<uintptr_t>(x) % 4)
    return static_cast<int>(cudaErrorMisalignedAddress);
  auto st = static_cast<cudaStream_t>(stream);
  auto* wk = static_cast<float*>(work);
  if (is_bf16)
    return run_t<__nv_bfloat16>(hd, n, x, dt, a, bm, cm, init, y,
                                final_state, wk, batch, nh, s, chunk, st);
  return run_t<float>(hd, n, x, dt, a, bm, cm, init, y, final_state, wk,
                      batch, nh, s, chunk, st);
}

// The scratch reconic_ssd_scan takes, in floats; 0 for a chunk it refuses.
RECONIC_API long long reconic_ssd_scan_work_floats(int batch, int nh, int s,
                                                   int hd, int n,
                                                   int chunk) {
  if (chunk <= 0 || chunk > kMaxChunk || s % chunk != 0) return 0;
  return static_cast<long long>(work_floats(batch, nh, s, hd, n, chunk));
}

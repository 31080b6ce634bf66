// K7 ssd_scan: the Mamba-2 SSD chunked scan, the SSM prefill's kernel.
//
// Replaces src/repro/kernels/ssd_scan.py:ssd_scan (_ssd_kernel): the TPU
// version walks a (batch, heads, chunks) grid with the chunk sweep
// innermost and sequential, holds a whole chunk's x, B and C (L rows) in
// VMEM, runs the chunk's quadratic form on the MXU and carries the
// (head_dim, d_state) state in VMEM scratch from one grid step to the
// next. It starts from a zero state and never returns the last one.
// This kernel also takes the initial state and writes the final state,
// which the model's prefill needs to seed decode (models/ssm.py), so the
// prefill and the forward without caches both run here.
//
// What bounds it on the H100: operations. At the mamba2-370m prefill
// shape (8 sequences x 512 tokens, 32 heads of head_dim 64, d_state 128,
// chunk 256, f32) the function needs C.B^T over each chunk's lower
// triangle once per (sequence, chunk), and per head the weighted sum of
// x over that triangle, C_i . S_prev and the state update: ~6.6 GFLOP,
// 0.098 ms at the 67 TFLOP/s f32 peak outside the tensor cores; x, y,
// dt, B, C and the two states are ~89 MB, 0.026 ms at 3.35 TB/s.
//
// Design: blocks run in no order, so one 256-thread block owns one
// (sequence, head) and loops over the chunks itself, with the state in
// shared memory. A 256-long chunk's C.B^T alone (256 KB) and its B rows
// (128 KB) do not fit the 227 KB a block can use, so the quadratic form
// is tiled: 64-row tiles of outputs i against 64-row tiles of sources j,
// skipping the tiles above the diagonal. A thread computes a 4 x 4 piece
// of C_i . B_j (rows i = rg + 16q, sources j = dg + 16p; B and C rows are
// padded by one word so those reads hit 16 distinct banks), turns it into
// w = (C_i . B_j) * exp(cum_i - cum_j) * dt_j in shared memory, and
// accumulates y over 4 rows and head_dim / 16 columns in registers. The
// last row tile visits every source tile of the chunk, so the state
// update sum_j exp(seg_end - cum_j) dt_j x_j B_j^T is accumulated there
// from the same tiles (head_dim / 16 x d_state / 16 entries a thread)
// and no tile is loaded twice for it. C.B^T is computed per head (32x
// the count the bound makes at mamba2's shape), every product is an f32
// FMA on the CUDA cores, and one block fills an SM at d_state 128:
// sharing C.B^T across heads, tensor cores (3xTF32) and more blocks per
// SM are later work.
//
// Arithmetic kept from the TPU kernel and models/ssm._ssd_chunked, so the
// 2e-5 tolerance holds and exp underflows where the reference's does:
// da = dt * a rounded before the in-chunk cumsum, which sums in order;
// rel = cum_i - cum_j is set to -1e30 where i < j BEFORE expf (no
// exp(cum_i) * exp(-cum_j) reformulation, which overflows);
// w = (C_i . B_j) * exp(rel) * dt_j;
// y = y_intra + exp(cum_i) * C_i . S_prev; S = exp(seg_end) * S_prev +
// sum_j exp(seg_end - cum_j) dt_j x_j B_j^T. expf is the accurate one
// (the library is never built with fast math).
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 64;               // rows of an output or source tile
constexpr int kSmemLimit = 232448;      // dynamic shared memory per block
constexpr float kNegInf = -1e30f;

// Shared memory of one block, in floats: C and B tiles (rows padded by
// one word), the x tile, the w tile (padded), the state and four chunk
// vectors (cum, dt, exp(cum), exp(seg_end - cum) * dt).
inline size_t smem_bytes(int hd, int n, int chunk) {
  return sizeof(float) *
         (2 * kTile * (n + 1) + kTile * hd + kTile * (kTile + 1) +
          static_cast<size_t>(n) * hd + 4 * static_cast<size_t>(chunk));
}

template <typename T, int HD, int N>
__global__ void __launch_bounds__(kThreads, 1)
    ssd_scan_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                    const float* __restrict__ a,
                    const float* __restrict__ bm,
                    const float* __restrict__ cm,
                    const float* __restrict__ init, T* __restrict__ y,
                    float* __restrict__ final_state, int nh, int s, int L) {
  constexpr int PD = HD / 16;           // x / y columns of a thread
  constexpr int NPT = N / 16;           // state rows (n) of a thread
  constexpr int NP = N + 1;             // padded C / B row
  constexpr int WP = kTile + 1;         // padded w row
  extern __shared__ float smem[];
  float* cs = smem;                     // [kTile][NP]  C rows of the i tile
  float* bs = cs + kTile * NP;          // [kTile][NP]  B rows of the j tile
  float* xs = bs + kTile * NP;          // [kTile][HD]  x rows of the j tile
  float* ws = xs + kTile * HD;          // [kTile][WP]  w of the (i, j) pair
  float* st = ws + kTile * WP;          // [N][HD]      state S[d][n] at [n][d]
  float* cum = st + N * HD;             // [L]
  float* dts = cum + L;                 // [L]
  float* ecum = dts + L;                // [L] exp(cum)
  float* wst = ecum + L;                // [L] exp(seg_end - cum) * dt

  const int bh = blockIdx.x;
  const int b = bh / nh;
  const int h = bh % nh;
  const int tid = threadIdx.x;
  const int dg = tid % 16;              // column group: d, or source row j
  const int rg = tid / 16;              // row group: output row i, or n
  const float av = a[h];
  const size_t xrow = static_cast<size_t>(nh) * HD;
  const T* xb = x + static_cast<size_t>(b) * s * xrow + h * HD;
  T* yb = y + static_cast<size_t>(b) * s * xrow + h * HD;
  const float* dtb = dt + static_cast<size_t>(b) * s * nh + h;
  const float* bb = bm + static_cast<size_t>(b) * s * N;
  const float* cb = cm + static_cast<size_t>(b) * s * N;
  const size_t sbase = static_cast<size_t>(bh) * HD * N;

  for (int e = tid; e < HD * N; e += kThreads)
    st[(e % N) * HD + e / N] = init ? init[sbase + e] : 0.f;

  const int nc = s / L;
  for (int c = 0; c < nc; ++c) {
    const size_t t0 = static_cast<size_t>(c) * L;
    __syncthreads();                    // the previous chunk is done
    for (int l = tid; l < L; l += kThreads) dts[l] = dtb[(t0 + l) * nh];
    __syncthreads();
    if (tid == 0) {
      // in-chunk cumsum of dt * a, in order: the plain version sums in
      // the same order, so both hold the same cum bit for bit (at
      // |cum| ~ 3000, mamba2's a = -16 over 256 steps, one f32 step is
      // 2.4e-4, and another order moves cum_i - cum_j by that much)
      float run = 0.f;
      for (int l = 0; l < L; ++l) {
        run = __fadd_rn(run, __fmul_rn(dts[l], av));
        cum[l] = run;
      }
    }
    __syncthreads();
    const float seg_end = cum[L - 1];
    for (int l = tid; l < L; l += kThreads) {
      ecum[l] = expf(cum[l]);
      wst[l] = __fmul_rn(expf(__fsub_rn(seg_end, cum[l])), dts[l]);
    }

    float sacc[NPT][PD];                // the chunk's state increment
#pragma unroll
    for (int k = 0; k < NPT; ++k)
#pragma unroll
      for (int p = 0; p < PD; ++p) sacc[k][p] = 0.f;

    for (int i0 = 0; i0 < L; i0 += kTile) {
      const bool last = i0 + kTile >= L;
      __syncthreads();                  // cs is free
      for (int e = tid; e < kTile * N; e += kThreads) {
        const int r = e / N;
        cs[r * NP + e % N] =
            i0 + r < L ? cb[(t0 + i0 + r) * N + e % N] : 0.f;
      }
      float acc[4][PD];
#pragma unroll
      for (int q = 0; q < 4; ++q)
#pragma unroll
        for (int p = 0; p < PD; ++p) acc[q][p] = 0.f;

      const int j_end = min(i0 + kTile, L);
      for (int j0 = 0; j0 < j_end; j0 += kTile) {
        __syncthreads();                // bs, xs and ws are free
        for (int e = tid; e < kTile * N; e += kThreads) {
          const int r = e / N;
          bs[r * NP + e % N] =
              j0 + r < L ? bb[(t0 + j0 + r) * N + e % N] : 0.f;
        }
        for (int e = tid; e < kTile * HD; e += kThreads) {
          const int r = e / HD;
          xs[e] = j0 + r < L
                      ? reconic::to_f32(xb[(t0 + j0 + r) * xrow + e % HD])
                      : 0.f;
        }
        __syncthreads();

        // w_ij = (C_i . B_j) * exp(cum_i - cum_j) * dt_j, i >= j
        float cbv[4][4];
#pragma unroll
        for (int q = 0; q < 4; ++q)
#pragma unroll
          for (int p = 0; p < 4; ++p) cbv[q][p] = 0.f;
#pragma unroll 4
        for (int n = 0; n < N; ++n) {
          float cv[4], bv[4];
#pragma unroll
          for (int q = 0; q < 4; ++q) cv[q] = cs[(rg + 16 * q) * NP + n];
#pragma unroll
          for (int p = 0; p < 4; ++p) bv[p] = bs[(dg + 16 * p) * NP + n];
#pragma unroll
          for (int q = 0; q < 4; ++q)
#pragma unroll
            for (int p = 0; p < 4; ++p)
              cbv[q][p] = fmaf(cv[q], bv[p], cbv[q][p]);
        }
#pragma unroll
        for (int q = 0; q < 4; ++q)
#pragma unroll
          for (int p = 0; p < 4; ++p) {
            const int i = i0 + rg + 16 * q;
            const int j = j0 + dg + 16 * p;
            float w = 0.f;
            if (i < L && j < L) {
              const float rel = i >= j ? __fsub_rn(cum[i], cum[j]) : kNegInf;
              w = __fmul_rn(__fmul_rn(cbv[q][p], expf(rel)), dts[j]);
            }
            ws[(rg + 16 * q) * WP + dg + 16 * p] = w;
          }
        __syncthreads();

        // y_i += sum_j w_ij x_j
#pragma unroll 4
        for (int jj = 0; jj < kTile; ++jj) {
          float xv[PD], wv[4];
#pragma unroll
          for (int p = 0; p < PD; ++p) xv[p] = xs[jj * HD + dg + 16 * p];
#pragma unroll
          for (int q = 0; q < 4; ++q) wv[q] = ws[(rg + 16 * q) * WP + jj];
#pragma unroll
          for (int q = 0; q < 4; ++q)
#pragma unroll
            for (int p = 0; p < PD; ++p)
              acc[q][p] = fmaf(wv[q], xv[p], acc[q][p]);
        }
        if (last) {
          // the state increment from the same tiles:
          // sum_j exp(seg_end - cum_j) dt_j x_j B_j^T
          const int jn = min(kTile, L - j0);
          for (int jj = 0; jj < jn; ++jj) {
            const float wj = wst[j0 + jj];
            float u[PD], bv[NPT];
#pragma unroll
            for (int p = 0; p < PD; ++p)
              u[p] = __fmul_rn(wj, xs[jj * HD + dg + 16 * p]);
#pragma unroll
            for (int k = 0; k < NPT; ++k) bv[k] = bs[jj * NP + rg + 16 * k];
#pragma unroll
            for (int k = 0; k < NPT; ++k)
#pragma unroll
              for (int p = 0; p < PD; ++p)
                sacc[k][p] = fmaf(u[p], bv[k], sacc[k][p]);
          }
        }
      }

      // y_i += exp(cum_i) * C_i . S_prev
      float inter[4][PD];
#pragma unroll
      for (int q = 0; q < 4; ++q)
#pragma unroll
        for (int p = 0; p < PD; ++p) inter[q][p] = 0.f;
#pragma unroll 4
      for (int n = 0; n < N; ++n) {
        float cv[4], sv[PD];
#pragma unroll
        for (int q = 0; q < 4; ++q) cv[q] = cs[(rg + 16 * q) * NP + n];
#pragma unroll
        for (int p = 0; p < PD; ++p) sv[p] = st[n * HD + dg + 16 * p];
#pragma unroll
        for (int q = 0; q < 4; ++q)
#pragma unroll
          for (int p = 0; p < PD; ++p)
            inter[q][p] = fmaf(cv[q], sv[p], inter[q][p]);
      }
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int i = i0 + rg + 16 * q;
        if (i >= L) continue;
#pragma unroll
        for (int p = 0; p < PD; ++p)
          reconic::store_f32(
              yb, (t0 + i) * xrow + dg + 16 * p,
              __fadd_rn(acc[q][p], __fmul_rn(ecum[i], inter[q][p])));
      }
    }

    // S = exp(seg_end) * S_prev + increment (each thread its own entries)
    __syncthreads();                    // every read of S_prev is done
    const float dec = expf(seg_end);
#pragma unroll
    for (int k = 0; k < NPT; ++k)
#pragma unroll
      for (int p = 0; p < PD; ++p) {
        float* sp = st + (rg + 16 * k) * HD + dg + 16 * p;
        *sp = __fadd_rn(__fmul_rn(*sp, dec), sacc[k][p]);
      }
  }
  __syncthreads();
  for (int e = tid; e < HD * N; e += kThreads)
    final_state[sbase + e] = st[(e % N) * HD + e / N];
}

template <typename T, int HD, int N>
int launch_hn(const void* x, const void* dt, const void* a, const void* bm,
              const void* cm, const void* init, void* y, void* final_state,
              int batch, int nh, int s, int chunk, cudaStream_t stream) {
  const size_t smem = smem_bytes(HD, N, chunk);
  if (smem > kSmemLimit) return static_cast<int>(cudaErrorInvalidValue);
  auto kern = ssd_scan_kernel<T, HD, N>;
  const cudaError_t attr = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (attr != cudaSuccess) return static_cast<int>(attr);
  kern<<<batch * nh, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(a), static_cast<const float*>(bm),
      static_cast<const float*>(cm), static_cast<const float*>(init),
      static_cast<T*>(y), static_cast<float*>(final_state), nh, s, chunk);
  return reconic::launch_status();
}

template <typename T, int HD>
int launch_h(int n, const void* x, const void* dt, const void* a,
             const void* bm, const void* cm, const void* init, void* y,
             void* final_state, int batch, int nh, int s, int chunk,
             cudaStream_t stream) {
  switch (n) {
    case 16:
      return launch_hn<T, HD, 16>(x, dt, a, bm, cm, init, y, final_state,
                                  batch, nh, s, chunk, stream);
    case 32:
      return launch_hn<T, HD, 32>(x, dt, a, bm, cm, init, y, final_state,
                                  batch, nh, s, chunk, stream);
    case 64:
      return launch_hn<T, HD, 64>(x, dt, a, bm, cm, init, y, final_state,
                                  batch, nh, s, chunk, stream);
    case 128:
      return launch_hn<T, HD, 128>(x, dt, a, bm, cm, init, y, final_state,
                                   batch, nh, s, chunk, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename T>
int launch(int hd, int n, const void* x, const void* dt, const void* a,
           const void* bm, const void* cm, const void* init, void* y,
           void* final_state, int batch, int nh, int s, int chunk,
           cudaStream_t stream) {
  switch (hd) {
    case 16:
      return launch_h<T, 16>(n, x, dt, a, bm, cm, init, y, final_state,
                             batch, nh, s, chunk, stream);
    case 32:
      return launch_h<T, 32>(n, x, dt, a, bm, cm, init, y, final_state,
                             batch, nh, s, chunk, stream);
    case 64:
      return launch_h<T, 64>(n, x, dt, a, bm, cm, init, y, final_state,
                             batch, nh, s, chunk, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// x: (B, S, nh, hd) f32, or bf16 when is_bf16; dt: (B, S, nh), a: (nh,),
// bm and cm: (B, S, n) (n_groups 1), init: (B, nh, hd, n) or null for a
// zero state, all f32; y: (B, S, nh, hd) in x's dtype; final_state:
// (B, nh, hd, n) f32. All contiguous. hd in {16, 32, 64}, n in {16, 32,
// 64, 128}, S % chunk == 0, and the block's shared memory (smem_bytes)
// within 227 KB.
RECONIC_API int reconic_ssd_scan(const void* x, const void* dt,
                                 const void* a, const void* bm,
                                 const void* cm, const void* init, void* y,
                                 void* final_state, int batch, int nh,
                                 int s, int hd, int n, int chunk,
                                 int is_bf16, void* stream) {
  if (chunk <= 0 || s % chunk != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  auto st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch<__nv_bfloat16>(hd, n, x, dt, a, bm, cm, init, y,
                                 final_state, batch, nh, s, chunk, st);
  return launch<float>(hd, n, x, dt, a, bm, cm, init, y, final_state, batch,
                       nh, s, chunk, st);
}

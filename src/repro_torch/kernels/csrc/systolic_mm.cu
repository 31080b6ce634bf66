// K5 systolic_mm: the Lookaside Compute block's matrix multiply.
//
// Replaces src/repro/kernels/systolic_mm.py:systolic_mm (_mm_kernel): the
// TPU version tiles (M,K)x(K,N) into MXU blocks and carries an f32 VMEM
// accumulator across the sequential K axis of its grid.
//
// What bounds it on the H100: operations. At 2048^3 in f32 the product is
// 17.2 GFLOP; outside the tensor cores the card peaks at 67 TFLOP/s of
// f32, so 0.26 ms at best, against 0.015 ms for its 48 MiB of operands
// and result at 3.35 TB/s. At 512x16x512 it is bound by the launch.
//
// Design: CUDA blocks run in parallel and share no accumulator, so each
// 256-thread block owns one 64x64 output tile and walks K itself, staging
// 16-deep slices of A and B in shared memory. Each thread keeps a 4x4 f32
// accumulator in registers and issues 16 FMAs for every 8 shared-memory
// loads. The loads mask the ragged edges with zeros, so any M, N, K runs
// without padding. f32 inputs use plain f32 FMA: there is no TF32 path,
// because the reference's tolerance assumes full f32. bf16 inputs widen
// to f32 on load and accumulate in f32. wgmma/TMA pipelining is later
// work.
#include "common.cuh"

namespace {

constexpr int kBM = 64;
constexpr int kBN = 64;
constexpr int kBK = 16;
constexpr int kTM = 4;
constexpr int kTN = 4;
constexpr int kThreads = 256;  // (kBM / kTM) * (kBN / kTN)

template <typename Tin, typename Tout>
__global__ void __launch_bounds__(kThreads)
    systolic_mm_kernel(const Tin* __restrict__ x, const Tin* __restrict__ y,
                       Tout* __restrict__ out, int M, int N, int K) {
  // A is stored transposed (k-major) so the inner loop reads a column of
  // the A tile as a broadcast; +4 pads the rows against bank conflicts.
  __shared__ float As[kBK][kBM + 4];
  __shared__ float Bs[kBK][kBN + 4];
  const int tid = threadIdx.x;
  const int tx = tid % (kBN / kTN);
  const int ty = tid / (kBN / kTN);
  const int row0 = blockIdx.y * kBM;
  const int col0 = blockIdx.x * kBN;

  float acc[kTM][kTN];
#pragma unroll
  for (int i = 0; i < kTM; ++i)
#pragma unroll
    for (int j = 0; j < kTN; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += kBK) {
#pragma unroll
    for (int e = tid; e < kBM * kBK; e += kThreads) {
      const int m = e / kBK, kk = e % kBK;
      const int gr = row0 + m, gk = k0 + kk;
      As[kk][m] = (gr < M && gk < K)
                      ? reconic::to_f32(x[static_cast<size_t>(gr) * K + gk])
                      : 0.f;
    }
#pragma unroll
    for (int e = tid; e < kBK * kBN; e += kThreads) {
      const int kk = e / kBN, n = e % kBN;
      const int gk = k0 + kk, gc = col0 + n;
      Bs[kk][n] = (gk < K && gc < N)
                      ? reconic::to_f32(y[static_cast<size_t>(gk) * N + gc])
                      : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      float a[kTM], b[kTN];
#pragma unroll
      for (int i = 0; i < kTM; ++i) a[i] = As[kk][ty + i * (kBM / kTM)];
#pragma unroll
      for (int j = 0; j < kTN; ++j) b[j] = Bs[kk][tx + j * (kBN / kTN)];
#pragma unroll
      for (int i = 0; i < kTM; ++i)
#pragma unroll
        for (int j = 0; j < kTN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    const int r = row0 + ty + i * (kBM / kTM);
#pragma unroll
    for (int j = 0; j < kTN; ++j) {
      const int c = col0 + tx + j * (kBN / kTN);
      if (r < M && c < N)
        reconic::store_f32(out, static_cast<size_t>(r) * N + c, acc[i][j]);
    }
  }
}

template <typename Tin, typename Tout>
void launch(const void* x, const void* y, void* out, int M, int N, int K,
            cudaStream_t stream) {
  const dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM);
  systolic_mm_kernel<Tin, Tout><<<grid, kThreads, 0, stream>>>(
      static_cast<const Tin*>(x), static_cast<const Tin*>(y),
      static_cast<Tout*>(out), M, N, K);
}

}  // namespace

// x: (M, K), y: (K, N), out: (M, N), all row-major and contiguous. The
// inputs share one dtype (f32, or bf16 when in_bf16), the output is f32,
// or bf16 when out_bf16.
RECONIC_API int reconic_systolic_mm(const void* x, const void* y, void* out,
                                    int M, int N, int K, int in_bf16,
                                    int out_bf16, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (in_bf16 && out_bf16)
    launch<__nv_bfloat16, __nv_bfloat16>(x, y, out, M, N, K, s);
  else if (in_bf16)
    launch<__nv_bfloat16, float>(x, y, out, M, N, K, s);
  else if (out_bf16)
    launch<float, __nv_bfloat16>(x, y, out, M, N, K, s);
  else
    launch<float, float>(x, y, out, M, N, K, s);
  return reconic::launch_status();
}

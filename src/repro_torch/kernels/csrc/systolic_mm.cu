// K5 systolic_mm: the Lookaside Compute block's matrix multiply.
//
// Replaces src/repro/kernels/systolic_mm.py:systolic_mm (_mm_kernel): the
// TPU version tiles (M,K)x(K,N) into MXU blocks and carries an f32 VMEM
// accumulator across the sequential K axis of its grid.
//
// What bounds it on the H100: operations. At 2048^3 in f32 the product is
// 17.2 GFLOP. The contract is full f32 (the reference's 1e-5 * k / 128
// tolerance; no TF32 of any kind), so the tensor cores are out and the
// CUDA cores' 67 TFLOP/s give 0.26 ms at best, against 0.015 ms for its
// 48 MiB of operands and result at 3.35 TB/s. At 512x16x512 it is bound
// by the launch. To come near the FMA rate a thread has to run many
// FMAs per shared-memory load and never wait for device memory.
//
// Design, a register-tiled SIMT GEMM: CUDA blocks run in parallel and
// share no accumulator, so each 256-thread block owns one 128x128 output
// tile and walks K itself in 8-deep slices. Each thread keeps 8x8 f32
// accumulators as two 4x4 quadrants 64 rows and 64 columns apart, so its
// shared-memory reads are float4 and free of bank conflicts: 64 FMAs for
// every 4 loads. A comes in as float4 along K and is stored transposed
// (k-major, rows padded by 4 words so the transposing stores hit distinct
// banks); B comes in by 16-byte cp.async. Two shared-memory stages let
// slice k+1 load while slice k is multiplied. Two blocks fit an SM
// (at most 128 registers a thread), so 2048^3's 256 tiles run in one wave.
// Variants, chosen by the C entry point from the shapes and pointers
// alone: where N or K is not a multiple of 4, a pointer is not 16-byte
// aligned or the inputs are bf16 (widened to f32 on load), the loads are
// masked scalar loads; where 128x128 tiles would give fewer blocks than
// the card has SMs (512x16x512 gives 16), the tile is 64x64 with a 4x4
// accumulator per thread. Every variant masks the ragged edges with
// zeros, so any M, N, K runs without padding, and every output's K sum is
// one fmaf chain in k order starting from 0 (the sum order is part of the
// kernel's contract: outputs do not depend on the tile or the variant).
#include <type_traits>

#include "common.cuh"

namespace {

constexpr int kBK = 8;          // K slice per stage
constexpr int kThreads = 256;   // a 16 x 16 grid of threads

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::);
}

// VEC: f32 inputs, N % 4 == 0, K % 4 == 0 and 16-byte aligned pointers.
template <int BM, int BN, bool VEC, typename Tin, typename Tout>
__global__ void __launch_bounds__(kThreads, 2)
    systolic_mm_kernel(const Tin* __restrict__ x, const Tin* __restrict__ y,
                       Tout* __restrict__ out, int M, int N, int K) {
  static_assert(!VEC || std::is_same<Tin, float>::value,
                "vector loads take f32 inputs");
  constexpr int TM = BM / 16;             // rows per thread: 8 or 4
  constexpr int TN = BN / 16;             // columns per thread
  constexpr int kAS = BM + 4;             // A row stride (k-major)
  constexpr int kA4 = BM * kBK / 4;       // float4s of an A slice
  constexpr int kB4 = BN * kBK / 4;       // float4s of a B slice
  constexpr int kAPer = BM * kBK / kThreads;   // scalars per thread
  constexpr int kBPer = BN * kBK / kThreads;
  __shared__ __align__(16) float As[2][kBK][kAS];
  __shared__ __align__(16) float Bs[2][kBK][BN];

  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int row0 = blockIdx.y * BM;
  const int col0 = blockIdx.x * BN;

  // this thread's A element(s) of a slice: VEC one float4 (row tid / 2,
  // k 0-3 or 4-7), else kAPer scalars e = tid + i * 256 (row e / 8, k e % 8)
  float a_pf[VEC ? 4 : kAPer];
  float b_pf[VEC ? 1 : kBPer];
  (void)b_pf;

  auto load_a = [&](int k0) {
    if constexpr (VEC) {
      const int m = tid / 2;
      const int kk = k0 + (tid % 2) * 4;
      float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
      if (tid < kA4 && row0 + m < M && kk < K)
        val = *reinterpret_cast<const float4*>(
            x + static_cast<size_t>(row0 + m) * K + kk);
      a_pf[0] = val.x;
      a_pf[1] = val.y;
      a_pf[2] = val.z;
      a_pf[3] = val.w;
    } else {
#pragma unroll
      for (int i = 0; i < kAPer; ++i) {
        const int e = tid + i * kThreads;
        const int m = row0 + e / kBK;
        const int kk = k0 + e % kBK;
        a_pf[i] = (m < M && kk < K)
                      ? reconic::to_f32(x[static_cast<size_t>(m) * K + kk])
                      : 0.f;
      }
    }
  };
  auto store_a = [&](int st) {
    if constexpr (VEC) {
      if (tid < kA4) {
        const int m = tid / 2;
        const int kq = (tid % 2) * 4;
#pragma unroll
        for (int i = 0; i < 4; ++i) As[st][kq + i][m] = a_pf[i];
      }
    } else {
#pragma unroll
      for (int i = 0; i < kAPer; ++i) {
        const int e = tid + i * kThreads;
        As[st][e % kBK][e / kBK] = a_pf[i];
      }
    }
  };
  // VEC: straight into stage st by cp.async; else into b_pf
  auto load_b = [&](int k0, int st) {
    if constexpr (VEC) {
      if (tid < kB4) {
        const int kk = tid / (BN / 4);
        const int n = (tid % (BN / 4)) * 4;
        const bool valid = k0 + kk < K && col0 + n < N;
        const float* src =
            valid ? y + static_cast<size_t>(k0 + kk) * N + col0 + n : y;
        cp_async16(&Bs[st][kk][n], src, valid);
      }
      cp_async_commit();
    } else {
#pragma unroll
      for (int i = 0; i < kBPer; ++i) {
        const int e = tid + i * kThreads;
        const int kk = k0 + e / BN;
        const int n = col0 + e % BN;
        b_pf[i] = (kk < K && n < N)
                      ? reconic::to_f32(y[static_cast<size_t>(kk) * N + n])
                      : 0.f;
      }
    }
  };
  auto store_b = [&](int st) {
    if constexpr (!VEC) {
#pragma unroll
      for (int i = 0; i < kBPer; ++i) {
        const int e = tid + i * kThreads;
        Bs[st][e / BN][e % BN] = b_pf[i];
      }
    } else {
      cp_async_wait_all();
    }
  };

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  const int n_k = (K + kBK - 1) / kBK;
  if (n_k > 0) {
    load_a(0);
    load_b(0, 0);
    store_a(0);
    store_b(0);
  }
  __syncthreads();
  for (int it = 0; it < n_k; ++it) {
    const int st = it & 1;
    const bool more = it + 1 < n_k;
    if (more) {                           // slice it+1 loads meanwhile
      load_a((it + 1) * kBK);
      load_b((it + 1) * kBK, st ^ 1);
    }
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      float a[TM], b[TN];
#pragma unroll
      for (int qd = 0; qd < TM / 4; ++qd) {
        const float4 v4 = *reinterpret_cast<const float4*>(
            &As[st][kk][qd * (BM / 2) + ty * 4]);
        a[4 * qd] = v4.x;
        a[4 * qd + 1] = v4.y;
        a[4 * qd + 2] = v4.z;
        a[4 * qd + 3] = v4.w;
      }
#pragma unroll
      for (int qd = 0; qd < TN / 4; ++qd) {
        const float4 v4 = *reinterpret_cast<const float4*>(
            &Bs[st][kk][qd * (BN / 2) + tx * 4]);
        b[4 * qd] = v4.x;
        b[4 * qd + 1] = v4.y;
        b[4 * qd + 2] = v4.z;
        b[4 * qd + 3] = v4.w;
      }
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    if (more) {
      store_a(st ^ 1);
      store_b(st ^ 1);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = row0 + (i / 4) * (BM / 2) + ty * 4 + i % 4;
    if (r >= M) continue;
#pragma unroll
    for (int qd = 0; qd < TN / 4; ++qd) {
      const int c = col0 + qd * (BN / 2) + tx * 4;
      const size_t at = static_cast<size_t>(r) * N + c;
      if (VEC && std::is_same<Tout, float>::value && c < N) {
        *reinterpret_cast<float4*>(out + at) =
            make_float4(acc[i][4 * qd], acc[i][4 * qd + 1],
                        acc[i][4 * qd + 2], acc[i][4 * qd + 3]);
      } else {
#pragma unroll
        for (int jj = 0; jj < 4; ++jj)
          if (c + jj < N) reconic::store_f32(out, at + jj, acc[i][4 * qd + jj]);
      }
    }
  }
}

template <int BM, int BN, bool VEC, typename Tin, typename Tout>
int launch_tile(const void* x, const void* y, void* out, int M, int N, int K,
                cudaStream_t stream) {
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  systolic_mm_kernel<BM, BN, VEC, Tin, Tout><<<grid, kThreads, 0, stream>>>(
      static_cast<const Tin*>(x), static_cast<const Tin*>(y),
      static_cast<Tout*>(out), M, N, K);
  return reconic::launch_status();
}

template <bool VEC, typename Tin, typename Tout>
int launch(const void* x, const void* y, void* out, int M, int N, int K,
           bool small, cudaStream_t stream) {
  if (small)
    return launch_tile<64, 64, VEC, Tin, Tout>(x, y, out, M, N, K, stream);
  return launch_tile<128, 128, VEC, Tin, Tout>(x, y, out, M, N, K, stream);
}

template <typename Tin, typename Tout>
int launch_in(const void* x, const void* y, void* out, int M, int N, int K,
              bool vec, bool small, cudaStream_t stream) {
  if constexpr (std::is_same<Tin, float>::value) {
    if (vec)
      return launch<true, Tin, Tout>(x, y, out, M, N, K, small, stream);
  }
  return launch<false, Tin, Tout>(x, y, out, M, N, K, small, stream);
}

int sm_count() {
  int dev = 0, n = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess)
    return 0;
  return n;
}

}  // namespace

// x: (M, K), y: (K, N), out: (M, N), all row-major and contiguous. The
// inputs share one dtype (f32, or bf16 when in_bf16), the output is f32,
// or bf16 when out_bf16.
RECONIC_API int reconic_systolic_mm(const void* x, const void* y, void* out,
                                    int M, int N, int K, int in_bf16,
                                    int out_bf16, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  const bool vec =
      !in_bf16 && N % 4 == 0 && K % 4 == 0 &&
      (reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(y) |
       reinterpret_cast<uintptr_t>(out)) % 16 == 0;
  const long tiles128 =
      static_cast<long>((M + 127) / 128) * ((N + 127) / 128);
  const bool small = tiles128 < sm_count();
  if (in_bf16 && out_bf16)
    return launch_in<__nv_bfloat16, __nv_bfloat16>(x, y, out, M, N, K, vec,
                                                   small, s);
  if (in_bf16)
    return launch_in<__nv_bfloat16, float>(x, y, out, M, N, K, vec, small,
                                           s);
  if (out_bf16)
    return launch_in<float, __nv_bfloat16>(x, y, out, M, N, K, vec, small,
                                           s);
  return launch_in<float, float>(x, y, out, M, N, K, vec, small, s);
}

// Shared helpers of the port's CUDA kernels (built for sm_90a by
// kernels/_build.py into one shared library with a plain C interface).
//
// Every entry point is `extern "C"`, takes device pointers and the CUDA
// stream as `void*`, launches on that stream without synchronising, and
// returns cudaGetLastError() so the Python wrapper can raise on a launch
// that was refused.
#pragma once

#include <cstddef>
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#define RECONIC_API extern "C" __attribute__((visibility("default")))

namespace reconic {

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// f32 -> T with round-to-nearest-even (the cast JAX and PyTorch make).
__device__ __forceinline__ void store_f32(float* p, size_t i, float v) {
  p[i] = v;
}
__device__ __forceinline__ void store_f32(__nv_bfloat16* p, size_t i,
                                          float v) {
  p[i] = __float2bfloat16_rn(v);
}

inline int launch_status() { return static_cast<int>(cudaGetLastError()); }

// ---- tensor-core and async-copy helpers (K6 and K7) ----------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte global -> shared copy; writes zeros when !valid.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// d += a.b on the tensor cores, m16n8k8, TF32 operands, f32 accumulator.
// Fragments (g = lane / 4, t = lane % 4): a[0..3] = A[g][t], A[g+8][t],
// A[g][t+4], A[g+8][t+4]; b0 = B[t][g], b1 = B[t+4][g]; d[0..3] =
// D[g][2t], D[g][2t+1], D[g+8][2t], D[g+8][2t+1].
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// x = hi + lo with hi = tf32_rna(x) (nearest, ties away; low 13 bits 0)
// and lo = tf32_rna(x - hi), the residual exact in f32.
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  uint32_t h, l;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(h) : "f"(x));
  h &= 0xffffe000u;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(l) : "f"(x - __uint_as_float(h)));
  hi = h;
  lo = l & 0xffffe000u;
}

}  // namespace reconic

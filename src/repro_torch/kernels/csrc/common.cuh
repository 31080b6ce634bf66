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

}  // namespace reconic

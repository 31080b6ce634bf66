// K1 quantize_stream and K2 dequantize_stream: the Streaming Compute
// block's chunked int8 compression.
//
// Replaces src/repro/kernels/quantize_stream.py:quantize_stream
// (_quant_kernel) and dequantize_stream (_dequant_kernel): the TPU
// versions run one (1, chunk) row per grid step, with a max-abs reduction
// and an elementwise pass in VMEM.
//
// What bounds them on the H100: bytes. Quantize reads 4 bytes and writes
// 1 per element (plus 4 per row); dequantize reads 1 and writes 4. At
// 4096 x 1024 that is 20 MiB, about 6 us at 3.35 TB/s; at 1024 x 64 the
// launch dominates.
//
// Design: quantize gives each row to one warp. The lanes stride over the
// row for max|x| and reduce it with shuffles, then read the row again
// (from L1/L2) to quantize it, so any chunk works with no shared memory.
// The result is bit-exact against the reference:
//   * scale = amax * inv_qmax is one f32 multiply by the constant the
//     wrapper passes (quantize_stream.INV_QMAX), or 1 when amax == 0;
//   * x / scale is the correctly rounded division (__fdiv_rn; the library
//     is never built with fast math);
//   * rounding is rintf, half to even, as jnp.round;
//   * the max propagates NaN as jnp.max does (fmaxf alone would drop it).
// Dequantize is one thread per element: q * scale in f32, then a
// round-to-nearest-even cast when the output is bf16.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarpsPerBlock = kThreads / 32;

// max that returns NaN if either operand is NaN.
__device__ __forceinline__ float nan_max(float a, float b) {
  return (a != a || a > b) ? a : b;
}

template <typename Tin>
__global__ void __launch_bounds__(kThreads)
    quantize_kernel(const Tin* __restrict__ x, int8_t* __restrict__ q,
                    float* __restrict__ scales, int n, int chunk,
                    float inv_qmax) {
  const int row = blockIdx.x * kWarpsPerBlock + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= n) return;  // uniform across the warp
  const Tin* xr = x + static_cast<size_t>(row) * chunk;
  int8_t* qr = q + static_cast<size_t>(row) * chunk;

  float amax = 0.f;
  for (int c = lane; c < chunk; c += 32)
    amax = nan_max(amax, fabsf(reconic::to_f32(xr[c])));
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    amax = nan_max(amax, __shfl_xor_sync(0xffffffffu, amax, off));

  const float scale = (amax == 0.f) ? 1.f : __fmul_rn(amax, inv_qmax);
  for (int c = lane; c < chunk; c += 32) {
    float v = rintf(__fdiv_rn(reconic::to_f32(xr[c]), scale));
    v = fminf(fmaxf(v, -127.f), 127.f);
    qr[c] = static_cast<int8_t>(static_cast<int>(v));
  }
  if (lane == 0) scales[row] = scale;
}

template <typename Tout>
__global__ void __launch_bounds__(kThreads)
    dequantize_kernel(const int8_t* __restrict__ q,
                      const float* __restrict__ scales,
                      Tout* __restrict__ out, size_t total, int chunk) {
  const size_t stride = static_cast<size_t>(gridDim.x) * kThreads;
  for (size_t i = static_cast<size_t>(blockIdx.x) * kThreads + threadIdx.x;
       i < total; i += stride) {
    const float v = __fmul_rn(static_cast<float>(q[i]), scales[i / chunk]);
    reconic::store_f32(out, i, v);
  }
}

}  // namespace

// x: (n, chunk) f32 (bf16 when x_bf16) -> q: (n, chunk) int8 and
// scales: (n, 1) f32, all contiguous.
RECONIC_API int reconic_quantize(const void* x, int x_bf16, void* q,
                                 void* scales, int n, int chunk,
                                 float inv_qmax, void* stream) {
  const int blocks = (n + kWarpsPerBlock - 1) / kWarpsPerBlock;
  auto s = static_cast<cudaStream_t>(stream);
  if (x_bf16)
    quantize_kernel<__nv_bfloat16><<<blocks, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<int8_t*>(q),
        static_cast<float*>(scales), n, chunk, inv_qmax);
  else
    quantize_kernel<float><<<blocks, kThreads, 0, s>>>(
        static_cast<const float*>(x), static_cast<int8_t*>(q),
        static_cast<float*>(scales), n, chunk, inv_qmax);
  return reconic::launch_status();
}

// q: (n, chunk) int8 and scales: (n, 1) f32 -> out: (n, chunk) f32
// (bf16 when out_bf16), all contiguous.
RECONIC_API int reconic_dequantize(const void* q, const void* scales,
                                   void* out, int out_bf16, int n,
                                   int chunk, void* stream) {
  const size_t total = static_cast<size_t>(n) * chunk;
  const size_t want = (total + kThreads - 1) / kThreads;
  const int blocks = static_cast<int>(want < 4096 ? want : 4096);
  auto s = static_cast<cudaStream_t>(stream);
  if (out_bf16)
    dequantize_kernel<__nv_bfloat16><<<blocks, kThreads, 0, s>>>(
        static_cast<const int8_t*>(q), static_cast<const float*>(scales),
        static_cast<__nv_bfloat16*>(out), total, chunk);
  else
    dequantize_kernel<float><<<blocks, kThreads, 0, s>>>(
        static_cast<const int8_t*>(q), static_cast<const float*>(scales),
        static_cast<float*>(out), total, chunk);
  return reconic::launch_status();
}

// Message of a cudaError_t code, for the Python wrapper's exception.
RECONIC_API const char* reconic_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

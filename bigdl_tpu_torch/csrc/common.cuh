// Helpers shared by the kernel sources of bigdl_tpu_torch (each source is
// compiled into its own shared library; this header is part of every
// library's hash in ops/_build.py).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

// -inf-safe online-softmax rescaling, exactly as the TPU kernels do it:
// safe_m = new_m if finite else 0; corr = exp(m - safe_m) if m finite else 0
// (a running max is either finite or -inf: scores are finite or masked)
__device__ __forceinline__ float safe_max(float new_m) {
  return new_m == -INFINITY ? 0.f : new_m;
}
__device__ __forceinline__ float rescale(float m, float safe_m) {
  return m == -INFINITY ? 0.f : expf(m - safe_m);
}

}  // namespace

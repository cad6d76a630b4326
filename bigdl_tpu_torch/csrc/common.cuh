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

// 16 bytes of T, as the elementwise kernels (K6q, K7) load and store them
template <typename T>
struct Vec;
template <>
struct Vec<float> {
  static constexpr int N = 4;
  using Codes = uint32_t;  // N int8 codes
};
template <>
struct Vec<__nv_bfloat16> {
  static constexpr int N = 8;
  using Codes = uint2;
};

template <typename T>
__device__ __forceinline__ void unpack(const uint4& raw, float* f) {
  if constexpr (sizeof(T) == 4) {
    f[0] = __uint_as_float(raw.x);
    f[1] = __uint_as_float(raw.y);
    f[2] = __uint_as_float(raw.z);
    f[3] = __uint_as_float(raw.w);
  } else {
    const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      f[2 * i] = __uint_as_float(w[i] << 16);
      f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
}

// the inverse of unpack for values already rounded to T
template <typename T>
__device__ __forceinline__ uint4 pack(const float* f) {
  if constexpr (sizeof(T) == 4) {
    return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]),
                      __float_as_uint(f[2]), __float_as_uint(f[3]));
  } else {
    uint32_t w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      w[i] = (__float_as_uint(f[2 * i]) >> 16) |
             (__float_as_uint(f[2 * i + 1]) & 0xffff0000u);
    return make_uint4(w[0], w[1], w[2], w[3]);
  }
}

// |v|'s bits: for non-negative floats the bit order is the value order, so
// an atomicMax on them is an exact max independent of order, and a NaN
// (sign cleared: bits above +Inf's) wins and propagates
__device__ __forceinline__ uint32_t abs_bits(float v) {
  return __float_as_uint(v) & 0x7fffffffu;
}

__device__ __forceinline__ uint32_t warp_max_u32(uint32_t v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = max(v, __shfl_xor_sync(kFull, v, o));
  return v;
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

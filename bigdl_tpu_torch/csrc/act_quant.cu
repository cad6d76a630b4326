// K6q: dynamic symmetric per-tensor int8 quantization of an activation.
//
// Replaces bigdl_tpu/nn/quantized.py:88 _quantize_activation, which the
// JAX package computes as pure jnp (abs, max, maximum, divide, round,
// clip, cast: no pallas_call) ahead of every int8_conv (:110) and
// int8_matmul (:96).  The port ran it as six PyTorch passes on the card.
//
//   x_scale = max(max |x|, 1e-8) / 127          (0-d fp32, on the device)
//   x_q     = clamp(round_half_even(x / x_scale), -127, 127)   (int8)
//
// with the plain version's roundings: IEEE division (__fdiv_rn) for both
// quotients, __float2int_rn (round half to even) for torch.round, and a
// NaN anywhere in x makes the scale NaN, as torch.amax and clamp_min do
// (fmaxf alone would drop it).
//
// Two passes over x, launched back to back on the caller's stream after a
// cudaMemsetAsync of a 4-byte scratch (all three are nodes of a captured
// CUDA graph, so every replay starts from zero):
//   1. absmax: 16-byte loads over a grid-stride loop (a scalar loop for a
//      view that is not 16-byte aligned, and for the tail), reduced by
//      warp, then by block, then one atomicMax a block on the uint32 bits
//      of |x|.  For non-negative floats the bit order is the value order,
//      so the max is exact and independent of order; a NaN's cleared sign
//      leaves bits above +Inf's, so it wins and propagates.
//   2. quantize: every block forms the scale from the scratch; block 0
//      writes x_scale; x_q goes out as 4-byte (fp32 in) or 8-byte (bf16
//      in) stores.
//
// What bounds it on the H100: bytes.  4 + 4 + 1 bytes an fp32 element (2 +
// 2 + 1 for bf16) at 3.35 TB/s; nothing else is read or written.

#include <algorithm>

#include "common.cuh"

namespace {

constexpr int NT = 256;

__device__ __forceinline__ uint32_t abs_bits(float v) {
  return __float_as_uint(v) & 0x7fffffffu;
}

template <typename T>
struct Vec;  // 16 bytes of T
template <>
struct Vec<float> {
  static constexpr int N = 4;
  using Out = uint32_t;  // 4 int8 codes
};
template <>
struct Vec<__nv_bfloat16> {
  static constexpr int N = 8;
  using Out = uint2;  // 8 int8 codes
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

__device__ __forceinline__ uint32_t warp_max_u32(uint32_t v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = max(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

template <typename T, bool VEC>
__global__ void __launch_bounds__(NT)
    absmax_kernel(const T* __restrict__ x, int64_t n,
                  uint32_t* __restrict__ bits) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * NT;
  const int64_t tid = static_cast<int64_t>(blockIdx.x) * NT + threadIdx.x;
  uint32_t m = 0;
  int64_t done = 0;
  if constexpr (VEC) {
    constexpr int E = Vec<T>::N;
    const int64_t nv = n / E;
    const uint4* xv = reinterpret_cast<const uint4*>(x);
    for (int64_t i = tid; i < nv; i += stride) {
      float f[E];
      unpack<T>(__ldg(xv + i), f);
#pragma unroll
      for (int e = 0; e < E; ++e) m = max(m, abs_bits(f[e]));
    }
    done = nv * E;
  }
  for (int64_t i = done + tid; i < n; i += stride)
    m = max(m, abs_bits(to_f32(x[i])));
  __shared__ uint32_t partial[NT / 32];
  m = warp_max_u32(m);
  if ((threadIdx.x & 31) == 0) partial[threadIdx.x >> 5] = m;
  __syncthreads();
  if (threadIdx.x < 32) {
    m = threadIdx.x < NT / 32 ? partial[threadIdx.x] : 0u;
    m = warp_max_u32(m);
    if (threadIdx.x == 0 && m != 0) atomicMax(bits, m);
  }
}

// the scale from the absmax bits, with the plain version's roundings
__device__ __forceinline__ float scale_of(uint32_t bits) {
  const float a = __uint_as_float(bits);
  const float m = isnan(a) ? a : fmaxf(a, 1e-8f);
  return __fdiv_rn(m, 127.0f);
}

__device__ __forceinline__ int8_t code(float v, float scale) {
  const int q = __float2int_rn(__fdiv_rn(v, scale));  // NaN -> 0
  return static_cast<int8_t>(min(max(q, -127), 127));
}

template <typename T, bool VEC>
__global__ void __launch_bounds__(NT)
    quantize_kernel(const T* __restrict__ x, int64_t n,
                    const uint32_t* __restrict__ bits,
                    int8_t* __restrict__ q, float* __restrict__ x_scale) {
  const float scale = scale_of(*bits);
  if (blockIdx.x == 0 && threadIdx.x == 0) *x_scale = scale;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * NT;
  const int64_t tid = static_cast<int64_t>(blockIdx.x) * NT + threadIdx.x;
  int64_t done = 0;
  if constexpr (VEC) {
    constexpr int E = Vec<T>::N;
    using Out = typename Vec<T>::Out;
    const int64_t nv = n / E;
    const uint4* xv = reinterpret_cast<const uint4*>(x);
    Out* qv = reinterpret_cast<Out*>(q);
    for (int64_t i = tid; i < nv; i += stride) {
      float f[E];
      unpack<T>(__ldg(xv + i), f);
      uint32_t w[E / 4];
#pragma unroll
      for (int j = 0; j < E / 4; ++j) {
        w[j] = 0;
#pragma unroll
        for (int e = 0; e < 4; ++e)
          w[j] |= static_cast<uint32_t>(static_cast<uint8_t>(
                      code(f[4 * j + e], scale)))
                  << (8 * e);
      }
      if constexpr (E == 4)
        qv[i] = w[0];
      else
        qv[i] = make_uint2(w[0], w[1]);
    }
    done = nv * E;
  }
  for (int64_t i = done + tid; i < n; i += stride)
    q[i] = code(to_f32(x[i]), scale);
}

template <typename T>
int launch(const void* x, int64_t n, uint32_t* bits, int8_t* q,
           float* x_scale, int sms, cudaStream_t st) {
  const T* xt = static_cast<const T*>(x);
  // 16-byte loads need a 16-byte-aligned start; the output is a fresh
  // tensor, so the codes' stores line up with the loads
  const bool vec = reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(q) % 16 == 0;
  const int64_t items = vec ? (n + Vec<T>::N - 1) / Vec<T>::N : n;
  const int64_t want = (items + NT - 1) / NT;
  const int grid1 = static_cast<int>(std::min<int64_t>(want, 4LL * sms));
  const int grid2 = static_cast<int>(std::min<int64_t>(want, 8LL * sms));
  cudaError_t err = cudaMemsetAsync(bits, 0, sizeof(uint32_t), st);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (vec) {
    absmax_kernel<T, true><<<grid1, NT, 0, st>>>(xt, n, bits);
    quantize_kernel<T, true><<<grid2, NT, 0, st>>>(xt, n, bits, q, x_scale);
  } else {
    absmax_kernel<T, false><<<grid1, NT, 0, st>>>(xt, n, bits);
    quantize_kernel<T, false><<<grid2, NT, 0, st>>>(xt, n, bits, q,
                                                    x_scale);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// x: n elements of fp32 (dtype 0) or bf16 (dtype 1), contiguous, any
// alignment of its element type; scratch: 4 bytes (zeroed here, on the
// stream); q: n int8; x_scale: one fp32.  sms: the card's SM count, which
// sizes the grids.  Returns the CUDA error of the launches (0 when they
// were taken), -1 on an argument the kernels do not take.
int bigdl_act_quant(const void* x, int64_t n, int dtype, void* scratch,
                    void* q, void* x_scale, int sms, void* stream) {
  if (n <= 0 || sms <= 0) return -1;
  uint32_t* bits = static_cast<uint32_t*>(scratch);
  int8_t* qt = static_cast<int8_t*>(q);
  float* s = static_cast<float*>(x_scale);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(x, n, bits, qt, s, sms, st);
  if (dtype == 1) return launch<__nv_bfloat16>(x, n, bits, qt, s, sms, st);
  return -1;
}

}  // extern "C"

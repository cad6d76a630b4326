// K7: eval-mode BatchNorm, an optional residual add and an optional ReLU
// in one pass over a channels-last tensor, leaving max |y| for K6q.
//
// Replaces no TPU kernel: the JAX package leaves BatchNormalization's eval
// branch (bigdl_tpu/nn/normalization.py:69-103, the output at :102), ReLU
// (nn/activations.py:33) and CAddTable (nn/containers.py:150) to XLA,
// which fuses them.  On the card the port ran them as PyTorch passes: in
// the int8 ResNet-50 forward those fp32 passes were the largest cost, and
// the quantizer ahead of every convolution read each of their outputs
// twice (once for its absmax).  K7 computes exactly those modules:
//
//   y = act( x * s + t  [ + r  |  + (r * s_r + t_r) ] )   act: ReLU or none
//
// per channel c (the last axis), with s, t formed from the BatchNorm's
// buffers as nn/normalization.py forms them:
//
//   inv = rsqrt(var + eps);  s = inv * weight;  t = (-mean * inv) * weight
//                                                   + bias
//
// (without affine parameters s = inv, t = -mean * inv), each rounded as the
// plain version rounds it: every operation of the plain version is its own
// PyTorch kernel, so K7 rounds after each (__fmul_rn, __fadd_rn: never an
// FMA), calls rsqrtf as torch's CUDA rsqrt does, and in bf16 rounds s, t
// (``.to(dtype)``) and every result to bf16, as PyTorch's bf16
// elementwise kernels compute in fp32 and round.  ReLU keeps a NaN (as
// torch.relu's clamp_min does: isnan(v) ? v : max(v, 0)).
//
// s and t are formed in every block into shared memory at every launch,
// from the buffers' current contents: a captured CUDA graph reads the
// statistics a later load_state_tree copied in place, and no small ops on
// C elements run before it.
//
// On request (absmax != NULL) K7 also leaves max |y|'s uint32 bits in a
// 4-byte scratch, zeroed by a cudaMemsetAsync on the stream ahead of the
// kernel (a graph node, so every replay starts from zero), by K6q's
// atomicMax on the bits (common.cuh abs_bits): K6q's given route then
// quantizes y reading it once.
//
// What bounds it on the H100: bytes.  x read and y written once (8 bytes
// an fp32 element), 12 with a residual, 16 with the residual's own
// BatchNorm, at 3.35 TB/s.  Design: 16-byte loads and stores over a
// grid-stride loop (four vectors in flight a thread, loads marked
// streaming) sized from the SM count; where C is a multiple of the vector
// (4 fp32, 8 bf16) a vector never straddles a pixel, so lane e of a vector
// starting at element i has channel (i % C) + e, the channel advanced
// incrementally along the loop.  Other C, and views that are not 16-byte
// aligned, take a scalar loop.

#include <algorithm>

#include "common.cuh"

namespace {

constexpr int NT = 256;
constexpr int U = 4;  // vectors in flight a thread

// one BatchNorm's buffers (fp32, C each; weight and bias NULL without
// affine parameters) and eps
struct Bn {
  const float* mean;
  const float* var;
  const float* weight;
  const float* bias;
  float eps;
};

template <typename T>
__device__ __forceinline__ float rnd(float v) {
  if constexpr (sizeof(T) == 4)
    return v;
  else
    return __bfloat162float(__float2bfloat16(v));
}

// s, t of channel c with the plain version's roundings, rounded to T
template <typename T>
__device__ __forceinline__ void affine_of(const Bn& b, int c, float* s,
                                          float* t) {
  const float inv = rsqrtf(__fadd_rn(b.var[c], b.eps));
  float sc = inv;
  float sh = __fmul_rn(-b.mean[c], inv);
  if (b.weight != nullptr) {
    sc = __fmul_rn(sc, b.weight[c]);
    sh = __fadd_rn(__fmul_rn(sh, b.weight[c]), b.bias[c]);
  }
  *s = rnd<T>(sc);
  *t = rnd<T>(sh);
}

// RES: 0 no residual, 1 the residual added as it is, 2 through its own
// BatchNorm (sr, tr)
template <typename T, int RES>
__device__ __forceinline__ float element(float x, float r, float s, float t,
                                         float sr, float tr, bool relu) {
  float y = rnd<T>(__fadd_rn(rnd<T>(__fmul_rn(x, s)), t));
  if constexpr (RES == 2)
    r = rnd<T>(__fadd_rn(rnd<T>(__fmul_rn(r, sr)), tr));
  if constexpr (RES != 0) y = rnd<T>(__fadd_rn(y, r));
  if (relu && !isnan(y)) y = fmaxf(y, 0.0f);
  return y;
}

template <typename T, bool VEC, int RES>
__global__ void __launch_bounds__(NT)
    bn_act_kernel(const T* __restrict__ x, const T* __restrict__ r,
                  T* __restrict__ y, int64_t n, int C, Bn bn, Bn rbn,
                  int relu, uint32_t* __restrict__ absmax) {
  extern __shared__ float tab[];  // s, t (, s_r, t_r): C floats each
  float* s = tab;
  float* t = tab + C;
  float* sr = tab + 2 * C;
  float* tr = tab + 3 * C;
  for (int c = threadIdx.x; c < C; c += NT) {
    affine_of<T>(bn, c, s + c, t + c);
    if constexpr (RES == 2) affine_of<T>(rbn, c, sr + c, tr + c);
  }
  __syncthreads();
  const int64_t stride = static_cast<int64_t>(gridDim.x) * NT;
  const int64_t tid = static_cast<int64_t>(blockIdx.x) * NT + threadIdx.x;
  const bool act = relu != 0;
  uint32_t m = 0;
  if constexpr (VEC) {
    constexpr int E = Vec<T>::N;
    const int64_t nv = n / E;  // C % E == 0, so n % E == 0
    const uint4* xv = reinterpret_cast<const uint4*>(x);
    const uint4* rv = reinterpret_cast<const uint4*>(r);
    uint4* yv = reinterpret_cast<uint4*>(y);
    // the channel of the vector a thread takes next, and how far one step
    // of the grid-stride loop moves it
    int c = static_cast<int>((E * tid) % C);
    const int step = static_cast<int>((E * stride) % C);
    for (int64_t i0 = tid; i0 < nv; i0 += U * stride) {
      uint4 xr[U], rr[U];
      int cu[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        cu[u] = c;
        c += step;
        if (c >= C) c -= C;
        const int64_t i = i0 + u * stride;
        if (i < nv) {
          xr[u] = __ldcs(xv + i);
          if constexpr (RES != 0) rr[u] = __ldcs(rv + i);
        }
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int64_t i = i0 + u * stride;
        if (i < nv) {
          float f[E], g[E];
          unpack<T>(xr[u], f);
          if constexpr (RES != 0) unpack<T>(rr[u], g);
#pragma unroll
          for (int e = 0; e < E; ++e) {
            const int ce = cu[u] + e;
            f[e] = element<T, RES>(f[e], RES != 0 ? g[e] : 0.0f, s[ce],
                                   t[ce], RES == 2 ? sr[ce] : 0.0f,
                                   RES == 2 ? tr[ce] : 0.0f, act);
            m = max(m, abs_bits(f[e]));
          }
          yv[i] = pack<T>(f);
        }
      }
    }
  } else {
    int c = static_cast<int>(tid % C);
    const int step = static_cast<int>(stride % C);
    for (int64_t i = tid; i < n; i += stride) {
      const float v = element<T, RES>(
          to_f32(x[i]), RES != 0 ? to_f32(r[i]) : 0.0f, s[c], t[c],
          RES == 2 ? sr[c] : 0.0f, RES == 2 ? tr[c] : 0.0f, act);
      y[i] = from_f32<T>(v);
      m = max(m, abs_bits(v));
      c += step;
      if (c >= C) c -= C;
    }
  }
  if (absmax == nullptr) return;
  __shared__ uint32_t partial[NT / 32];
  m = warp_max_u32(m);
  if ((threadIdx.x & 31) == 0) partial[threadIdx.x >> 5] = m;
  __syncthreads();
  if (threadIdx.x < 32) {
    m = threadIdx.x < NT / 32 ? partial[threadIdx.x] : 0u;
    m = warp_max_u32(m);
    if (threadIdx.x == 0 && m != 0) atomicMax(absmax, m);
  }
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

template <typename T, bool VEC, int RES>
int launch(const T* x, const T* r, T* y, int64_t n, int C, const Bn& bn,
           const Bn& rbn, int relu, uint32_t* absmax, int sms,
           cudaStream_t st) {
  const int smem = (RES == 2 ? 4 : 2) * C * static_cast<int>(sizeof(float));
  auto kernel = bn_act_kernel<T, VEC, RES>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t items = VEC ? n / Vec<T>::N : n;
  const int64_t want = (items + NT * U - 1) / (NT * U);
  const int grid =
      static_cast<int>(std::max<int64_t>(1, std::min<int64_t>(want,
                                                              4LL * sms)));
  kernel<<<grid, NT, smem, st>>>(x, r, y, n, C, bn, rbn, relu, absmax);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int RES>
int dispatch_vec(const void* x, const void* r, void* y, int64_t n, int C,
                 const Bn& bn, const Bn& rbn, int relu, uint32_t* absmax,
                 int sms, cudaStream_t st) {
  const T* xt = static_cast<const T*>(x);
  const T* rt = static_cast<const T*>(r);
  T* yt = static_cast<T*>(y);
  const bool vec = C % Vec<T>::N == 0 && aligned16(x) && aligned16(y) &&
                   (RES == 0 || aligned16(r));
  if (vec)
    return launch<T, true, RES>(xt, rt, yt, n, C, bn, rbn, relu, absmax,
                                sms, st);
  return launch<T, false, RES>(xt, rt, yt, n, C, bn, rbn, relu, absmax, sms,
                               st);
}

template <typename T>
int dispatch(const void* x, const void* r, void* y, int64_t n, int C,
             const Bn& bn, const Bn* rbn, int relu, uint32_t* absmax,
             int sms, cudaStream_t st) {
  if (r == nullptr)
    return dispatch_vec<T, 0>(x, r, y, n, C, bn, bn, relu, absmax, sms, st);
  if (rbn == nullptr)
    return dispatch_vec<T, 1>(x, r, y, n, C, bn, bn, relu, absmax, sms, st);
  return dispatch_vec<T, 2>(x, r, y, n, C, bn, *rbn, relu, absmax, sms, st);
}

}  // namespace

extern "C" {

// x, r, y: n elements of fp32 (dtype 0) or bf16 (dtype 1), contiguous,
// channels last (C channels); r NULL for no residual.  mean, var, weight,
// bias: the BatchNorm's fp32 buffers of C elements (weight and bias both
// NULL without affine parameters), eps its epsilon; r_mean ... r_eps the
// same for the residual's own BatchNorm, r_mean NULL to add r as it is.
// relu: 1 for ReLU, 0 for none.  absmax: NULL, or 4 bytes zeroed here (on
// the stream) that end holding max |y|'s bits.  sms: the card's SM count,
// which sizes the grid.  Returns the CUDA error of the launches (0 when
// they were taken), -1 on an argument the kernel does not take.
int bigdl_bn_act(const void* x, const void* r, void* y, int64_t n, int c,
                 int dtype, const void* mean, const void* var,
                 const void* weight, const void* bias, float eps,
                 const void* r_mean, const void* r_var, const void* r_weight,
                 const void* r_bias, float r_eps, int relu, void* absmax,
                 int sms, void* stream) {
  if (n <= 0 || c <= 0 || n % c != 0 || sms <= 0 || mean == nullptr ||
      var == nullptr || (weight == nullptr) != (bias == nullptr))
    return -1;
  if (r_mean != nullptr &&
      (r == nullptr || r_var == nullptr ||
       (r_weight == nullptr) != (r_bias == nullptr)))
    return -1;
  const Bn bn{static_cast<const float*>(mean), static_cast<const float*>(var),
              static_cast<const float*>(weight),
              static_cast<const float*>(bias), eps};
  const Bn rbn{static_cast<const float*>(r_mean),
               static_cast<const float*>(r_var),
               static_cast<const float*>(r_weight),
               static_cast<const float*>(r_bias), r_eps};
  const Bn* rb = r_mean != nullptr ? &rbn : nullptr;
  uint32_t* am = static_cast<uint32_t*>(absmax);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (am != nullptr) {
    const cudaError_t err = cudaMemsetAsync(am, 0, sizeof(uint32_t), st);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (dtype == 0)
    return dispatch<float>(x, r, y, n, c, bn, rb, relu, am, sms, st);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(x, r, y, n, c, bn, rb, relu, am, sms, st);
  return -1;
}

}  // extern "C"

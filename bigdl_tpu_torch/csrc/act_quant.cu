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
// (fmaxf alone would drop it).  The absmax is an atomicMax (or a max) on
// the uint32 bits of |x| (common.cuh abs_bits): exact, independent of
// order, NaN-propagating.
//
// What bounds it on the H100: bytes.  4 + 1 bytes an fp32 element (2 + 1
// for bf16) at 3.35 TB/s: x read once, x_q written once.  The scale needs
// the absmax of ALL of x before the first code, so a quantizer that finds
// the absmax itself reads x twice, and past the 50 MiB L2 the second read
// comes from HBM too.  Three routes, chosen by the wrapper
// (ops/act_quant.py) from what it is given and from the input's size:
//
//   given  (bigdl_act_quant_given): the producer of x (K7, csrc/bn_act.cu)
//          left the absmax bits in a 4-byte scratch; one quantize pass
//          reads them and x once: the bound's 5 bytes an element;
//   small  (bigdl_act_quant_small): one launch of one thread-block
//          cluster (1-8 blocks): each block reduces its share, the
//          cluster's blocks read each other's maxima through distributed
//          shared memory, then each quantizes its share from the vectors
//          its threads kept in registers (x read once up to 8 x 1024 x 4
//          vectors; past that again from L2).  No memset and no second
//          kernel: for the small inputs of the int8 TransformerLM (decode
//          rows, prefill chunks), which three graph nodes of about 2 us
//          each bound;
//   three  (bigdl_act_quant): a cudaMemsetAsync of a 4-byte scratch, an
//          absmax pass (16-byte loads over a grid-stride loop, reduced by
//          warp, then block, then one atomicMax a block), a quantize pass
//          that forms the scale from the scratch.  All three are nodes of
//          a captured CUDA graph, so every replay starts from zero.
//
// Every pass takes 16-byte loads where x (and x_q) are 16-byte aligned and
// a scalar loop for a misaligned view and for the tail.

#include <algorithm>

#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int NT = 256;
constexpr int NT_SMALL = 1024;       // the small route's block
constexpr int MAX_SMALL_BLOCKS = 8;  // the portable cluster size

// the largest |x| bits of the elements [tid, n) a thread walks with
// ``stride``, 16-byte loads for VEC (four in flight a thread)
template <typename T, bool VEC>
__device__ __forceinline__ uint32_t absmax_walk(const T* __restrict__ x,
                                                int64_t n, int64_t tid,
                                                int64_t stride) {
  uint32_t m = 0;
  int64_t done = 0;
  if constexpr (VEC) {
    constexpr int E = Vec<T>::N;
    constexpr int U = 4;
    const int64_t nv = n / E;
    const uint4* xv = reinterpret_cast<const uint4*>(x);
    for (int64_t i0 = tid; i0 < nv; i0 += U * stride) {
      uint4 raw[U];
#pragma unroll
      for (int u = 0; u < U; ++u)
        if (i0 + u * stride < nv) raw[u] = __ldg(xv + i0 + u * stride);
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (i0 + u * stride < nv) {
          float f[E];
          unpack<T>(raw[u], f);
#pragma unroll
          for (int e = 0; e < E; ++e) m = max(m, abs_bits(f[e]));
        }
      }
    }
    done = nv * E;
  }
  for (int64_t i = done + tid; i < n; i += stride)
    m = max(m, abs_bits(to_f32(x[i])));
  return m;
}

// a block's max of ``m`` (every thread's), in thread 0
template <int THREADS>
__device__ __forceinline__ uint32_t block_max_u32(uint32_t m) {
  __shared__ uint32_t partial[THREADS / 32];
  m = warp_max_u32(m);
  if ((threadIdx.x & 31) == 0) partial[threadIdx.x >> 5] = m;
  __syncthreads();
  m = 0;
  if (threadIdx.x < 32) {
    m = threadIdx.x < THREADS / 32 ? partial[threadIdx.x] : 0u;
    m = warp_max_u32(m);
  }
  return m;
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

// the codes of one 16-byte vector of x: 4 bytes (fp32 in) or 8 (bf16 in)
template <typename T>
__device__ __forceinline__ typename Vec<T>::Codes codes_of(const uint4& raw,
                                                           float scale) {
  constexpr int E = Vec<T>::N;
  float f[E];
  unpack<T>(raw, f);
  uint32_t w[E / 4];
#pragma unroll
  for (int j = 0; j < E / 4; ++j) {
    w[j] = 0;
#pragma unroll
    for (int e = 0; e < 4; ++e)
      w[j] |= static_cast<uint32_t>(
                  static_cast<uint8_t>(code(f[4 * j + e], scale)))
              << (8 * e);
  }
  if constexpr (E == 4)
    return w[0];
  else
    return make_uint2(w[0], w[1]);
}

// x_q for the elements [tid, n) a thread walks with ``stride``: 4-byte
// (fp32 in) or 8-byte (bf16 in) stores of the codes
template <typename T, bool VEC>
__device__ __forceinline__ void quantize_walk(const T* __restrict__ x,
                                              int64_t n, float scale,
                                              int8_t* __restrict__ q,
                                              int64_t tid, int64_t stride) {
  int64_t done = 0;
  if constexpr (VEC) {
    constexpr int E = Vec<T>::N;
    constexpr int U = 4;
    using Codes = typename Vec<T>::Codes;
    const int64_t nv = n / E;
    const uint4* xv = reinterpret_cast<const uint4*>(x);
    Codes* qv = reinterpret_cast<Codes*>(q);
    for (int64_t i0 = tid; i0 < nv; i0 += U * stride) {
      uint4 raw[U];
#pragma unroll
      for (int u = 0; u < U; ++u)
        if (i0 + u * stride < nv) raw[u] = __ldg(xv + i0 + u * stride);
#pragma unroll
      for (int u = 0; u < U; ++u)
        if (i0 + u * stride < nv)
          qv[i0 + u * stride] = codes_of<T>(raw[u], scale);
    }
    done = nv * E;
  }
  for (int64_t i = done + tid; i < n; i += stride)
    q[i] = code(to_f32(x[i]), scale);
}

template <typename T, bool VEC>
__global__ void __launch_bounds__(NT)
    absmax_kernel(const T* __restrict__ x, int64_t n,
                  uint32_t* __restrict__ bits) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * NT;
  const int64_t tid = static_cast<int64_t>(blockIdx.x) * NT + threadIdx.x;
  const uint32_t m = block_max_u32<NT>(absmax_walk<T, VEC>(x, n, tid,
                                                           stride));
  if (threadIdx.x == 0 && m != 0) atomicMax(bits, m);
}

// every block forms the scale from the absmax bits; block 0 writes x_scale
template <typename T, bool VEC>
__global__ void __launch_bounds__(NT)
    quantize_kernel(const T* __restrict__ x, int64_t n,
                    const uint32_t* __restrict__ bits,
                    int8_t* __restrict__ q, float* __restrict__ x_scale) {
  const float scale = scale_of(*bits);
  if (blockIdx.x == 0 && threadIdx.x == 0) *x_scale = scale;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * NT;
  const int64_t tid = static_cast<int64_t>(blockIdx.x) * NT + threadIdx.x;
  quantize_walk<T, VEC>(x, n, scale, q, tid, stride);
}

// the small route: one cluster of gridDim.x blocks (the whole grid).  With
// 16-byte loads a thread keeps its first SMALL_KEEP vectors in registers
// from the absmax pass to the quantize pass (every vector of an input up
// to 8 x 1024 x SMALL_KEEP of them); the rest, and the scalar path, are
// read again from L2.  One block needs no cluster barrier.
constexpr int SMALL_KEEP = 4;

template <typename T, bool VEC>
__global__ void __launch_bounds__(NT_SMALL)
    act_quant_small_kernel(const T* __restrict__ x, int64_t n,
                           int8_t* __restrict__ q,
                           float* __restrict__ x_scale) {
  cg::cluster_group cluster = cg::this_cluster();
  const int blocks = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int64_t stride = static_cast<int64_t>(blocks) * NT_SMALL;
  const int64_t tid = static_cast<int64_t>(rank) * NT_SMALL + threadIdx.x;
  constexpr int E = Vec<T>::N;
  const int64_t nv = VEC ? n / E : 0;
  const int64_t kept = SMALL_KEEP * stride;  // vectors held in registers
  const uint4* xv = reinterpret_cast<const uint4*>(x);
  uint4 keep[SMALL_KEEP];
  uint32_t m = 0;
  if constexpr (VEC) {
#pragma unroll
    for (int u = 0; u < SMALL_KEEP; ++u)
      if (tid + u * stride < nv) keep[u] = __ldg(xv + tid + u * stride);
#pragma unroll
    for (int u = 0; u < SMALL_KEEP; ++u) {
      if (tid + u * stride < nv) {
        float f[E];
        unpack<T>(keep[u], f);
#pragma unroll
        for (int e = 0; e < E; ++e) m = max(m, abs_bits(f[e]));
      }
    }
    for (int64_t i = tid + kept; i < nv; i += stride) {
      float f[E];
      unpack<T>(__ldg(xv + i), f);
#pragma unroll
      for (int e = 0; e < E; ++e) m = max(m, abs_bits(f[e]));
    }
  }
  for (int64_t i = nv * E + tid; i < n; i += stride)
    m = max(m, abs_bits(to_f32(x[i])));
  __shared__ uint32_t block_max, cluster_max;
  m = block_max_u32<NT_SMALL>(m);
  if (blocks == 1) {
    if (threadIdx.x == 0) cluster_max = m;
    __syncthreads();
  } else {
    if (threadIdx.x == 0) block_max = m;
    cluster.sync();  // every block's max written (release / acquire)
    if (threadIdx.x < 32) {
      uint32_t all = threadIdx.x < static_cast<unsigned>(blocks)
                         ? *cluster.map_shared_rank(
                               &block_max, static_cast<int>(threadIdx.x))
                         : 0u;
      all = warp_max_u32(all);
      if (threadIdx.x == 0) cluster_max = all;
    }
    // no block leaves (its shared memory) while a peer still reads it;
    // and cluster_max is written before any thread of the block reads it
    cluster.sync();
  }
  const float scale = scale_of(cluster_max);
  if (rank == 0 && threadIdx.x == 0) *x_scale = scale;
  if constexpr (VEC) {
    using Codes = typename Vec<T>::Codes;
    Codes* qv = reinterpret_cast<Codes*>(q);
#pragma unroll
    for (int u = 0; u < SMALL_KEEP; ++u)
      if (tid + u * stride < nv)
        qv[tid + u * stride] = codes_of<T>(keep[u], scale);
    for (int64_t i = tid + kept; i < nv; i += stride)
      qv[i] = codes_of<T>(__ldg(xv + i), scale);
  }
  for (int64_t i = nv * E + tid; i < n; i += stride)
    q[i] = code(to_f32(x[i]), scale);
}

// 16-byte loads need a 16-byte-aligned start; the output is a fresh
// tensor, so the codes' stores line up with the loads
bool vectorized(const void* x, const void* q) {
  return reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
         reinterpret_cast<uintptr_t>(q) % 16 == 0;
}

template <typename T>
int grid_of(int64_t n, bool vec, int per_sm, int sms) {
  const int64_t items = vec ? (n + Vec<T>::N - 1) / Vec<T>::N : n;
  const int64_t want = (items + NT - 1) / NT;
  return static_cast<int>(std::min<int64_t>(want, int64_t{per_sm} * sms));
}

template <typename T>
int launch_three(const void* x, int64_t n, uint32_t* bits, int8_t* q,
                 float* x_scale, int sms, cudaStream_t st) {
  const T* xt = static_cast<const T*>(x);
  const bool vec = vectorized(x, q);
  const int grid1 = grid_of<T>(n, vec, 4, sms);
  const int grid2 = grid_of<T>(n, vec, 8, sms);
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

template <typename T>
int launch_given(const void* x, int64_t n, const uint32_t* bits, int8_t* q,
                 float* x_scale, int sms, cudaStream_t st) {
  const T* xt = static_cast<const T*>(x);
  const bool vec = vectorized(x, q);
  const int grid = grid_of<T>(n, vec, 8, sms);
  if (vec)
    quantize_kernel<T, true><<<grid, NT, 0, st>>>(xt, n, bits, q, x_scale);
  else
    quantize_kernel<T, false><<<grid, NT, 0, st>>>(xt, n, bits, q, x_scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, bool VEC>
int launch_small_kernel(const T* x, int64_t n, int8_t* q, float* x_scale,
                        int blocks, cudaStream_t st) {
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = blocks;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(NT_SMALL);
  cfg.stream = st;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, act_quant_small_kernel<T, VEC>, x, n, q, x_scale);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_small(const void* x, int64_t n, int8_t* q, float* x_scale,
                 int blocks, cudaStream_t st) {
  const T* xt = static_cast<const T*>(x);
  if (vectorized(x, q))
    return launch_small_kernel<T, true>(xt, n, q, x_scale, blocks, st);
  return launch_small_kernel<T, false>(xt, n, q, x_scale, blocks, st);
}

}  // namespace

extern "C" {

// The three-node route.  x: n elements of fp32 (dtype 0) or bf16 (dtype
// 1), contiguous, any alignment of its element type; scratch: 4 bytes
// (zeroed here, on the stream); q: n int8; x_scale: one fp32.  sms: the
// card's SM count, which sizes the grids.  Returns the CUDA error of the
// launches (0 when they were taken), -1 on an argument the kernels do not
// take.
int bigdl_act_quant(const void* x, int64_t n, int dtype, void* scratch,
                    void* q, void* x_scale, int sms, void* stream) {
  if (n <= 0 || sms <= 0) return -1;
  uint32_t* bits = static_cast<uint32_t*>(scratch);
  int8_t* qt = static_cast<int8_t*>(q);
  float* s = static_cast<float*>(x_scale);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_three<float>(x, n, bits, qt, s, sms, st);
  if (dtype == 1)
    return launch_three<__nv_bfloat16>(x, n, bits, qt, s, sms, st);
  return -1;
}

// The given route: bits holds max |x|'s uint32 bits, written by x's
// producer earlier on the stream (K7); the other arguments as above.
int bigdl_act_quant_given(const void* x, int64_t n, int dtype,
                          const void* bits, void* q, void* x_scale, int sms,
                          void* stream) {
  if (n <= 0 || sms <= 0) return -1;
  const uint32_t* b = static_cast<const uint32_t*>(bits);
  int8_t* qt = static_cast<int8_t*>(q);
  float* s = static_cast<float*>(x_scale);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_given<float>(x, n, b, qt, s, sms, st);
  if (dtype == 1)
    return launch_given<__nv_bfloat16>(x, n, b, qt, s, sms, st);
  return -1;
}

// The small route: one cluster of ``blocks`` blocks (1 to 8) of 1024
// threads; no scratch.
int bigdl_act_quant_small(const void* x, int64_t n, int dtype, void* q,
                          void* x_scale, int blocks, void* stream) {
  if (n <= 0 || blocks < 1 || blocks > MAX_SMALL_BLOCKS) return -1;
  int8_t* qt = static_cast<int8_t*>(q);
  float* s = static_cast<float*>(x_scale);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_small<float>(x, n, qt, s, blocks, st);
  if (dtype == 1)
    return launch_small<__nv_bfloat16>(x, n, qt, s, blocks, st);
  return -1;
}

}  // extern "C"

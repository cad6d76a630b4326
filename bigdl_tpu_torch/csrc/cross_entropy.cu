// Hand-written Hopper (sm_90a) fused softmax cross-entropy kernels.
//
// K4 ce_fwd_kernel replaces bigdl_tpu/ops/cross_entropy.py
//    fused_softmax_cross_entropy / _ce_fwd_kernel (:23, pallas_call :96):
//    per row, lse = m + log(max(s, 1e-30)) from an online max / sum-exp
//    over the vocabulary, and loss = lse - x[y] (x[y] taken as 0 for a
//    label outside [0, V), as the TPU kernel's one-hot gives).
// K5 ce_bwd_kernel replaces _ce_bwd_kernel (:57, pallas_call :134):
//    dx = (exp(x - lse) - onehot(y)) * g[row], written in the logits'
//    dtype.
//
// The vocabulary-parallel form (a tensor-parallel LM head: each rank
// holds the logits of V / P classes) runs the same two kernels on the
// shard.  Its labels are shifted by the shard's first class, and a label
// outside the shard is the sentinel -1: K4 reads x[row, label] only for a
// label inside [0, V) and writes the picked logit (0 for the sentinel)
// through bigdl_ce_fwd_shard, so three (N,) all-reductions over the ranks
// (max and sum-exp of the local lse, sum of the picked logit) give the
// global loss and lse; K5 then runs with the global lse, and its one-hot
// never matches the sentinel.
//
// Bound: bytes.  K4 reads each logit once and writes two floats a row
// (N*V*elt bytes); K5 reads each logit once and writes each gradient once
// (2*N*V*elt bytes).  One exp per element is far below the card's FLOP
// rate, so the floor is the memory rate.  Design: one block of 256
// threads per row; each thread streams its share of the row with 16-byte
// loads (4 fp32 or 8 bf16 values) where the row start allows, keeps a
// private (max, sum-exp) pair -- rescaled only when a chunk raises the
// max, with the TPU kernel's -inf guard -- and the pairs are merged by
// warp shuffles and then across the 8 warps through shared memory.  The
// ragged end of a row (V not a multiple of the vector width) is handled
// element by element in the kernel: no -1e30 padding copy of the logits
// (_pad_vocab :67) and no N % block_n requirement.  fp32 or bf16 logits,
// fp32 accumulation.  The C entry points return cudaGetLastError() after
// the launch (or -1 for an unknown dtype).

#include "common.cuh"

namespace {

constexpr int kCeThreads = 256;
constexpr int kCeWarps = kCeThreads / 32;

// VEC consecutive elements of a row, as fp32, from a 16-byte-aligned
// address (VEC > 1) or any address (VEC == 1)
template <typename T, int VEC>
struct VecIO;

template <typename T>
struct VecIO<T, 1> {
  static __device__ __forceinline__ void load(const T* p, float (&x)[1]) {
    x[0] = to_f32(*p);
  }
  static __device__ __forceinline__ void store(T* p, const float (&x)[1]) {
    *p = from_f32<T>(x[0]);
  }
};

template <>
struct VecIO<float, 4> {
  static __device__ __forceinline__ void load(const float* p,
                                              float (&x)[4]) {
    const float4 f = *reinterpret_cast<const float4*>(p);
    x[0] = f.x; x[1] = f.y; x[2] = f.z; x[3] = f.w;
  }
  static __device__ __forceinline__ void store(float* p,
                                               const float (&x)[4]) {
    *reinterpret_cast<float4*>(p) = make_float4(x[0], x[1], x[2], x[3]);
  }
};

template <>
struct VecIO<__nv_bfloat16, 8> {
  static __device__ __forceinline__ void load(const __nv_bfloat16* p,
                                              float (&x)[8]) {
    uint4 raw = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      x[2 * i] = f.x;
      x[2 * i + 1] = f.y;
    }
  }
  static __device__ __forceinline__ void store(__nv_bfloat16* p,
                                               const float (&x)[8]) {
    uint4 raw;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
    for (int i = 0; i < 4; ++i)
      h[i] = __floats2bfloat162_rn(x[2 * i], x[2 * i + 1]);
    *reinterpret_cast<uint4*>(p) = raw;
  }
};

// fold VEC values into a running (m, s): the sum is rescaled only when the
// max rises, and a running max of -inf contributes nothing (the TPU
// kernel's isfinite(m) guard, cross_entropy.py:41)
template <int VEC>
__device__ __forceinline__ void fold(float& m, float& s, const float (&x)[VEC]) {
  float bm = x[0];
#pragma unroll
  for (int i = 1; i < VEC; ++i) bm = fmaxf(bm, x[i]);
  if (bm > m) {
    s = m == -INFINITY ? 0.f : s * expf(m - bm);
    m = bm;
  }
  if (m == -INFINITY) return;
#pragma unroll
  for (int i = 0; i < VEC; ++i) s += expf(x[i] - m);
}

// merge (m2, s2) into (m, s)
__device__ __forceinline__ void merge(float& m, float& s, float m2, float s2) {
  const float nm = fmaxf(m, m2);
  if (nm == -INFINITY) return;
  s = (m == -INFINITY ? 0.f : s * expf(m - nm)) +
      (m2 == -INFINITY ? 0.f : s2 * expf(m2 - nm));
  m = nm;
}

template <typename T, int VEC>
__global__ void __launch_bounds__(kCeThreads)
ce_fwd_kernel(const T* __restrict__ x, const int* __restrict__ y,
              float* __restrict__ loss, float* __restrict__ lse,
              float* __restrict__ picked, int v, int64_t row_stride) {
  __shared__ float red_m[kCeWarps], red_s[kCeWarps];
  const int row = blockIdx.x;
  const T* xr = x + row * row_stride;
  float m = -INFINITY, s = 0.f;
  const int nvec = v / VEC;
#pragma unroll 4
  for (int i = threadIdx.x; i < nvec; i += kCeThreads) {
    float e[VEC];
    VecIO<T, VEC>::load(xr + static_cast<int64_t>(i) * VEC, e);
    fold<VEC>(m, s, e);
  }
  for (int c = nvec * VEC + threadIdx.x; c < v; c += kCeThreads) {
    float e[1];
    VecIO<T, 1>::load(xr + c, e);
    fold<1>(m, s, e);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float m2 = __shfl_xor_sync(kFull, m, o);
    const float s2 = __shfl_xor_sync(kFull, s, o);
    merge(m, s, m2, s2);
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) {
    red_m[warp] = m;
    red_s[warp] = s;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < kCeWarps; ++w) merge(m, s, red_m[w], red_s[w]);
    const float l = m + logf(fmaxf(s, 1e-30f));
    const int label = y[row];
    const float xy = (label >= 0 && label < v) ? to_f32(xr[label]) : 0.f;
    loss[row] = l - xy;
    lse[row] = l;
    if (picked != nullptr) picked[row] = xy;
  }
}

template <typename T, int VEC>
__global__ void __launch_bounds__(kCeThreads)
ce_bwd_kernel(const T* __restrict__ x, const int* __restrict__ y,
              const float* __restrict__ lse, const float* __restrict__ g,
              T* __restrict__ dx, int v, int64_t x_stride,
              int64_t dx_stride) {
  const int row = blockIdx.x;
  const T* xr = x + row * x_stride;
  T* dr = dx + row * dx_stride;
  const float l = lse[row], gr = g[row];
  const int label = y[row];
  const int nvec = v / VEC;
#pragma unroll 4
  for (int i = threadIdx.x; i < nvec; i += kCeThreads) {
    const int64_t c0 = static_cast<int64_t>(i) * VEC;
    float e[VEC];
    VecIO<T, VEC>::load(xr + c0, e);
#pragma unroll
    for (int k = 0; k < VEC; ++k)
      e[k] = (expf(e[k] - l) - (c0 + k == label ? 1.f : 0.f)) * gr;
    VecIO<T, VEC>::store(dr + c0, e);
  }
  for (int c = nvec * VEC + threadIdx.x; c < v; c += kCeThreads) {
    float e[1];
    VecIO<T, 1>::load(xr + c, e);
    e[0] = (expf(e[0] - l) - (c == label ? 1.f : 0.f)) * gr;
    VecIO<T, 1>::store(dr + c, e);
  }
}

// the widest vector every row start allows: 16 bytes when the base is
// 16-byte aligned and each row stride a whole number of vectors
template <typename T>
constexpr int vec_width() { return 16 / static_cast<int>(sizeof(T)); }

template <typename T>
bool rows_aligned(const void* p, int64_t stride) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 &&
         stride % vec_width<T>() == 0;
}

template <typename T>
int launch_fwd(const void* x, const int* y, float* loss, float* lse,
               float* picked, int n, int v, int64_t stride, cudaStream_t st) {
  constexpr int W = vec_width<T>();
  const T* x_ = static_cast<const T*>(x);
  if (rows_aligned<T>(x, stride))
    ce_fwd_kernel<T, W>
        <<<n, kCeThreads, 0, st>>>(x_, y, loss, lse, picked, v, stride);
  else
    ce_fwd_kernel<T, 1>
        <<<n, kCeThreads, 0, st>>>(x_, y, loss, lse, picked, v, stride);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_bwd(const void* x, const int* y, const float* lse, const float* g,
               void* dx, int n, int v, int64_t xs, int64_t dxs,
               cudaStream_t st) {
  const T* x_ = static_cast<const T*>(x);
  T* dx_ = static_cast<T*>(dx);
  constexpr int W = vec_width<T>();
  if (rows_aligned<T>(x, xs) && rows_aligned<T>(dx, dxs))
    ce_bwd_kernel<T, W><<<n, kCeThreads, 0, st>>>(x_, y, lse, g, dx_, v, xs,
                                                  dxs);
  else
    ce_bwd_kernel<T, 1>
        <<<n, kCeThreads, 0, st>>>(x_, y, lse, g, dx_, v, xs, dxs);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// x: (N, V) logits, row stride `stride` elements, unit column stride;
// y: (N,) int32 labels; loss, lse: (N,) fp32.  dtype 0 = float32,
// 1 = bfloat16.
int bigdl_ce_fwd(const void* x, const int* y, float* loss, float* lse,
                 int dtype, int n, int v, int64_t stride, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_fwd<float>(x, y, loss, lse, nullptr, n, v, stride, st);
  if (dtype == 1)
    return launch_fwd<__nv_bfloat16>(x, y, loss, lse, nullptr, n, v, stride,
                                     st);
  return -1;
}

// The vocabulary shard's pass: as bigdl_ce_fwd on (N, V_shard) logits whose
// labels are shard-local (-1: not in this shard), also writing the picked
// logit x[row, y[row]] (0 for a label outside [0, V_shard)) into picked.
int bigdl_ce_fwd_shard(const void* x, const int* y, float* loss, float* lse,
                       float* picked, int dtype, int n, int v, int64_t stride,
                       void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_fwd<float>(x, y, loss, lse, picked, n, v, stride, st);
  if (dtype == 1)
    return launch_fwd<__nv_bfloat16>(x, y, loss, lse, picked, n, v, stride,
                                     st);
  return -1;
}

// x, dx: (N, V) with row strides xs, dxs; y: (N,) int32; lse, g: (N,) fp32.
int bigdl_ce_bwd(const void* x, const int* y, const float* lse,
                 const float* g, void* dx, int dtype, int n, int v,
                 int64_t xs, int64_t dxs, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_bwd<float>(x, y, lse, g, dx, n, v, xs, dxs, st);
  if (dtype == 1)
    return launch_bwd<__nv_bfloat16>(x, y, lse, g, dx, n, v, xs, dxs, st);
  return -1;
}

}  // extern "C"

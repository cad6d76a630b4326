// Hand-written Hopper (sm_90a) backward of the K1 attention kernel.
//
// K1-bwd has no Pallas counterpart: bigdl_tpu/ops/flash_attention.py
// flash_attention (:63) defines no VJP, so the JAX package trains through
// the plain dot_product_attention (nn/attention.py:27).  This computes the
// same gradient -- dQ, dK, dV of softmax(scale * Q K^T, causal) V -- from
// q, k, v, the forward's output o, its row logsumexp lse (B, H, T) and dO.
//
// Scheme (FlashAttention-2's recompute): P is rebuilt tile by tile from
// exp(scale * q.k - lse), so no (T, T) matrix is stored; with
// delta_i = rowsum(dO_i * O_i) the score gradient is
// dS_ij = P_ij (dO_i . v_j - delta_i), and
//   dV_j = sum_i P_ij dO_i,  dK_j = scale sum_i dS_ij q_i,
//   dQ_i = scale sum_j dS_ij k_j.
// Three launches: bwd_delta_kernel (delta), bwd_dkdv_kernel (one block per
// (b*h, 64-key tile), walking the query tiles at or past the diagonal) and
// bwd_dq_kernel (one block per (b*h, 64-query tile), walking the key tiles
// up to the diagonal).  Each output row is owned by one block, so there
// are no atomics and the result is deterministic; the price is that P and
// dS are computed twice.
//
// Bound: operations.  The gradient needs 5 products of 2*D FLOPs per
// visible (query, key) pair -- 10*B*H*D*T(T+1)/2 FLOPs causal -- against
// about 8*B*T*H*D elements of traffic, far above the card's FLOP/byte
// balance, so the floor is the fp32 CUDA-core rate (no tensor cores here).
// Design: tiles staged in shared memory as fp32.  Q and dO rows are stored
// unpadded and read as 16-byte broadcasts; K and V rows are padded to D+1
// floats so the 32 lanes of a warp, which score 32 consecutive keys, hit
// distinct banks.  Each thread owns one key column and 16 query rows of
// the 64x64 tile pair for the scores, and 8 rows x D/32 columns of the
// output accumulators, kept in registers across the whole walk.  Causal
// tiles on the wrong side of the diagonal are never visited; ragged T is
// masked by global position.  Tensor-core MMA, TMA and a single fused pass
// with atomics are the work of a later, speed-minded change.
//
// q, k, v are read through (b, t, h) strides, so the views of a fused qkv
// projection need no copy; fp32 or bf16 inputs, fp32 accumulation,
// outputs in the input dtype.  The C entry point returns
// cudaGetLastError() after the launches (or -1 for a head_dim or dtype
// that has no instantiation).

#include "common.cuh"

namespace {

constexpr int kB = 64;                  // query and key rows per tile
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kRowsPerWarp = kB / kWarps;   // output rows per warp
constexpr int kPairRows = kB * kB / kThreads;  // score rows per thread (16)

struct BwdArgs {
  int t_len, heads, causal;
  float scale;
  // (b, t, h) element strides
  int64_t sq[3], sk[3], sv[3], so[3], sdo[3], sdq[3], sdk[3], sdv[3];
};

// Two blocks an SM where two fit in shared memory (D <= 64): the hint
// caps registers at 128 a thread, which doubles the warps in flight; at
// D 128 one block fills the shared memory, so the cap would only add
// spills.
template <int D>
constexpr int kMinBlocks = D <= 64 ? 2 : 1;

template <int D>
constexpr int bwd_smem_bytes() {
  // qs, dos (kB x D); ks, vs (kB x (D+1)); ps, dss (kB x kB); lse, delta
  return (2 * kB * D + 2 * kB * (D + 1) + 2 * kB * kB + 2 * kB) * 4;
}

template <typename T>
__device__ __forceinline__ const T* row_of(const T* base, const int64_t* s,
                                           int b, int t, int h) {
  return base + b * s[0] + static_cast<int64_t>(t) * s[1] + h * s[2];
}

// delta[b, h, t] = sum_d dO[b, t, h, d] * O[b, t, h, d]: one warp per row
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
bwd_delta_kernel(const T* __restrict__ o, const T* __restrict__ dout,
                 float* __restrict__ delta, BwdArgs a) {
  const int b = blockIdx.x / a.heads, h = blockIdx.x % a.heads;
  const int t = blockIdx.y * kWarps + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (t >= a.t_len) return;  // warp-uniform
  const T* orow = row_of(o, a.so, b, t, h);
  const T* drow = row_of(dout, a.sdo, b, t, h);
  float s = 0.f;
  for (int d = lane; d < D; d += 32) s += to_f32(orow[d]) * to_f32(drow[d]);
  s = warp_sum(s);
  if (lane == 0) delta[static_cast<int64_t>(blockIdx.x) * a.t_len + t] = s;
}

// Stage rows [r0, r0 + kB) of one head into shared memory as fp32 with
// row stride LD, zeros past t_len, each element times `mul`.
template <typename T, int D, int LD>
__device__ __forceinline__ void stage(float* dst, const T* src,
                                      const int64_t* s, int b, int h, int r0,
                                      int t_len, float mul) {
  for (int i = threadIdx.x; i < kB * D; i += kThreads) {
    const int r = i / D, c = i % D, t = r0 + r;
    dst[r * LD + c] = t < t_len ? to_f32(row_of(src, s, b, t, h)[c]) * mul
                                : 0.f;
  }
}

__device__ __forceinline__ void stage_rows(float* lse_s, float* delta_s,
                                           const float* lse,
                                           const float* delta, int64_t bh,
                                           int q0, int t_len) {
  for (int i = threadIdx.x; i < kB; i += kThreads) {
    const int t = q0 + i;
    lse_s[i] = t < t_len ? lse[bh * t_len + t] : 0.f;
    delta_s[i] = t < t_len ? delta[bh * t_len + t] : 0.f;
  }
}

// One (64-query, 64-key) tile pair: for the entries this thread owns (key
// column j = tid & 63, query rows i = (tid >> 6) + 4r) rebuild
// P = exp(qs.k - lse) (qs is pre-scaled) and dS = P (dO.v - delta), and
// write them to ps / dss (kB x kB, row i, column j); masked entries are 0.
template <int D, bool WRITE_P>
__device__ __forceinline__ void tile_p_ds(
    const float* qs, const float* dos, const float* ks, const float* vs,
    const float* lse_s, const float* delta_s, float* ps, float* dss, int q0,
    int k0, int t_len, int causal) {
  constexpr int LD = D + 1;
  const int j = threadIdx.x & (kB - 1);
  const int i0 = threadIdx.x / kB;
  constexpr int kStep = kThreads / kB;  // 4
  float s[kPairRows], dp[kPairRows];
#pragma unroll
  for (int r = 0; r < kPairRows; ++r) s[r] = dp[r] = 0.f;
  const float* kr = ks + j * LD;
  const float* vr = vs + j * LD;
#pragma unroll 2
  for (int c = 0; c < D; c += 4) {
    const float k0v = kr[c], k1v = kr[c + 1], k2v = kr[c + 2], k3v = kr[c + 3];
    const float v0v = vr[c], v1v = vr[c + 1], v2v = vr[c + 2], v3v = vr[c + 3];
#pragma unroll
    for (int r = 0; r < kPairRows; ++r) {
      const int i = i0 + kStep * r;
      const float4 qv = *reinterpret_cast<const float4*>(qs + i * D + c);
      const float4 dv = *reinterpret_cast<const float4*>(dos + i * D + c);
      s[r] = fmaf(qv.x, k0v, fmaf(qv.y, k1v, fmaf(qv.z, k2v,
                  fmaf(qv.w, k3v, s[r]))));
      dp[r] = fmaf(dv.x, v0v, fmaf(dv.y, v1v, fmaf(dv.z, v2v,
                   fmaf(dv.w, v3v, dp[r]))));
    }
  }
  const int kj = k0 + j;
#pragma unroll
  for (int r = 0; r < kPairRows; ++r) {
    const int i = i0 + kStep * r;
    const int qi = q0 + i;
    const bool ok = qi < t_len && kj < t_len && (!causal || kj <= qi);
    const float p = ok ? expf(s[r] - lse_s[i]) : 0.f;
    if (WRITE_P) ps[i * kB + j] = p;
    dss[i * kB + j] = ok ? p * (dp[r] - delta_s[i]) : 0.f;
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads, kMinBlocks<D>)
bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                const T* __restrict__ v, const T* __restrict__ dout,
                const float* __restrict__ lse,
                const float* __restrict__ delta, T* __restrict__ dk,
                T* __restrict__ dv, BwdArgs a) {
  constexpr int LD = D + 1;
  constexpr int DPL = (D + 31) / 32;
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;
  float* dos = qs + kB * D;
  float* ks = dos + kB * D;
  float* vs = ks + kB * LD;
  float* ps = vs + kB * LD;
  float* dss = ps + kB * kB;
  float* lse_s = dss + kB * kB;
  float* delta_s = lse_s + kB;

  const int b = blockIdx.x / a.heads, h = blockIdx.x % a.heads;
  const int k0 = blockIdx.y * kB;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  stage<T, D, LD>(ks, k, a.sk, b, h, k0, a.t_len, 1.f);
  stage<T, D, LD>(vs, v, a.sv, b, h, k0, a.t_len, 1.f);

  float dka[kRowsPerWarp][DPL], dva[kRowsPerWarp][DPL];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r)
#pragma unroll
    for (int c = 0; c < DPL; ++c) dka[r][c] = dva[r][c] = 0.f;

  const int n_qt = (a.t_len + kB - 1) / kB;
  // causal: query rows before k0 see none of these keys
  for (int qt = a.causal ? blockIdx.y : 0; qt < n_qt; ++qt) {
    const int q0 = qt * kB;
    __syncthreads();  // the previous tile's qs/dos/ps/dss are consumed
    stage<T, D, D>(qs, q, a.sq, b, h, q0, a.t_len, a.scale);
    stage<T, D, D>(dos, dout, a.sdo, b, h, q0, a.t_len, 1.f);
    stage_rows(lse_s, delta_s, lse, delta, blockIdx.x, q0, a.t_len);
    __syncthreads();
    tile_p_ds<D, true>(qs, dos, ks, vs, lse_s, delta_s, ps, dss, q0, k0,
                       a.t_len, a.causal);
    __syncthreads();
    const int n_i = min(kB, a.t_len - q0);
    for (int i = 0; i < n_i; ++i) {
      float dov[DPL], qv[DPL];
#pragma unroll
      for (int c = 0; c < DPL; ++c) {
        const int d = lane + 32 * c;
        dov[c] = d < D ? dos[i * D + d] : 0.f;
        qv[c] = d < D ? qs[i * D + d] : 0.f;
      }
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) {
        const int j = warp * kRowsPerWarp + r;
        const float p = ps[i * kB + j], ds = dss[i * kB + j];
#pragma unroll
        for (int c = 0; c < DPL; ++c) {
          dva[r][c] = fmaf(p, dov[c], dva[r][c]);
          dka[r][c] = fmaf(ds, qv[c], dka[r][c]);  // qs carries the scale
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int t = k0 + warp * kRowsPerWarp + r;
    if (t >= a.t_len) continue;
    T* dkr = dk + b * a.sdk[0] + static_cast<int64_t>(t) * a.sdk[1] +
             h * a.sdk[2];
    T* dvr = dv + b * a.sdv[0] + static_cast<int64_t>(t) * a.sdv[1] +
             h * a.sdv[2];
#pragma unroll
    for (int c = 0; c < DPL; ++c) {
      const int d = lane + 32 * c;
      if (d < D) {
        dkr[d] = from_f32<T>(dka[r][c]);
        dvr[d] = from_f32<T>(dva[r][c]);
      }
    }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads, kMinBlocks<D>)
bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, const T* __restrict__ dout,
              const float* __restrict__ lse, const float* __restrict__ delta,
              T* __restrict__ dq, BwdArgs a) {
  constexpr int LD = D + 1;
  constexpr int DPL = (D + 31) / 32;
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;
  float* dos = qs + kB * D;
  float* ks = dos + kB * D;
  float* vs = ks + kB * LD;
  float* dss = vs + kB * LD;
  float* lse_s = dss + kB * kB;
  float* delta_s = lse_s + kB;

  const int b = blockIdx.x / a.heads, h = blockIdx.x % a.heads;
  const int q0 = blockIdx.y * kB;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  stage<T, D, D>(qs, q, a.sq, b, h, q0, a.t_len, a.scale);
  stage<T, D, D>(dos, dout, a.sdo, b, h, q0, a.t_len, 1.f);
  stage_rows(lse_s, delta_s, lse, delta, blockIdx.x, q0, a.t_len);

  float dqa[kRowsPerWarp][DPL];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r)
#pragma unroll
    for (int c = 0; c < DPL; ++c) dqa[r][c] = 0.f;

  int n_kt = (a.t_len + kB - 1) / kB;
  if (a.causal) {
    const int last_q = min(q0 + kB - 1, a.t_len - 1);
    n_kt = min(n_kt, last_q / kB + 1);  // skip tiles past the diagonal
  }
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * kB;
    __syncthreads();  // the previous tile's ks/vs/dss are consumed
    stage<T, D, LD>(ks, k, a.sk, b, h, k0, a.t_len, 1.f);
    stage<T, D, LD>(vs, v, a.sv, b, h, k0, a.t_len, 1.f);
    __syncthreads();
    tile_p_ds<D, false>(qs, dos, ks, vs, lse_s, delta_s, nullptr, dss, q0,
                        k0, a.t_len, a.causal);
    __syncthreads();
    const int n_j = min(kB, a.t_len - k0);
    for (int j = 0; j < n_j; ++j) {
      float kv[DPL];
#pragma unroll
      for (int c = 0; c < DPL; ++c) {
        const int d = lane + 32 * c;
        kv[c] = d < D ? ks[j * LD + d] : 0.f;
      }
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) {
        const float ds = dss[(warp * kRowsPerWarp + r) * kB + j];
#pragma unroll
        for (int c = 0; c < DPL; ++c) dqa[r][c] = fmaf(ds, kv[c], dqa[r][c]);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int t = q0 + warp * kRowsPerWarp + r;
    if (t >= a.t_len) continue;
    T* dqr = dq + b * a.sdq[0] + static_cast<int64_t>(t) * a.sdq[1] +
             h * a.sdq[2];
#pragma unroll
    for (int c = 0; c < DPL; ++c) {
      const int d = lane + 32 * c;
      if (d < D) dqr[d] = from_f32<T>(dqa[r][c] * a.scale);
    }
  }
}

template <typename T, int D>
int launch_bwd(const void* q, const void* k, const void* v, const void* o,
               const void* dout, const float* lse, float* delta, void* dq,
               void* dk, void* dv, int b, const BwdArgs& a,
               cudaStream_t stream) {
  const T* q_ = static_cast<const T*>(q);
  const T* k_ = static_cast<const T*>(k);
  const T* v_ = static_cast<const T*>(v);
  const T* do_ = static_cast<const T*>(dout);
  const int tiles = (a.t_len + kB - 1) / kB;
  bwd_delta_kernel<T, D>
      <<<dim3(b * a.heads, (a.t_len + kWarps - 1) / kWarps), kThreads, 0,
         stream>>>(static_cast<const T*>(o), do_, delta, a);
  constexpr int smem = bwd_smem_bytes<D>();
  cudaFuncSetAttribute(bwd_dkdv_kernel<T, D>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  cudaFuncSetAttribute(bwd_dq_kernel<T, D>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  const dim3 grid(b * a.heads, tiles);
  bwd_dkdv_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      q_, k_, v_, do_, lse, delta, static_cast<T*>(dk), static_cast<T*>(dv),
      a);
  bwd_dq_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      q_, k_, v_, do_, lse, delta, static_cast<T*>(dq), a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_bwd(int d, const void* q, const void* k, const void* v,
                 const void* o, const void* dout, const float* lse,
                 float* delta, void* dq, void* dk, void* dv, int b,
                 const BwdArgs& a, cudaStream_t st) {
  switch (d) {
    case 16: return launch_bwd<T, 16>(q, k, v, o, dout, lse, delta, dq, dk, dv, b, a, st);
    case 32: return launch_bwd<T, 32>(q, k, v, o, dout, lse, delta, dq, dk, dv, b, a, st);
    case 64: return launch_bwd<T, 64>(q, k, v, o, dout, lse, delta, dq, dk, dv, b, a, st);
    case 128: return launch_bwd<T, 128>(q, k, v, o, dout, lse, delta, dq, dk, dv, b, a, st);
    default: return -1;
  }
}

}  // namespace

extern "C" {

// q, k, v, o, dout, dq, dk, dv: (B, T, H, D); strides[24] = (b, t, h)
// element strides of those eight in that order.  lse: (B, H, T) fp32 from
// the forward; delta: (B, H, T) fp32 scratch.  dtype 0 = float32,
// 1 = bfloat16.
int bigdl_flash_attention_bwd(const void* q, const void* k, const void* v,
                              const void* o, const void* dout,
                              const float* lse, float* delta, void* dq,
                              void* dk, void* dv, int dtype, int b, int t,
                              int h, int d, const int64_t* strides,
                              int causal, float scale, void* stream) {
  BwdArgs a{};
  a.t_len = t;
  a.heads = h;
  a.causal = causal;
  a.scale = scale;
  int64_t* dst[8] = {a.sq, a.sk, a.sv, a.so, a.sdo, a.sdq, a.sdk, a.sdv};
  for (int i = 0; i < 8; ++i)
    for (int j = 0; j < 3; ++j) dst[i][j] = strides[3 * i + j];
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_bwd<float>(d, q, k, v, o, dout, lse, delta, dq, dk, dv,
                               b, a, st);
  if (dtype == 1)
    return dispatch_bwd<__nv_bfloat16>(d, q, k, v, o, dout, lse, delta, dq,
                                       dk, dv, b, a, st);
  return -1;
}

}  // extern "C"

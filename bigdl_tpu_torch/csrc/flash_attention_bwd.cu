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
// Three launches: bwd_delta_kernel (delta), bwd_dkdv_kernel (one block
// per (b*h, 64-key tile), walking the query tiles at or past the
// diagonal) and bwd_dq_kernel (one block per (b*h, 64-query tile),
// walking the key tiles up to the diagonal).  Each output row is owned by
// one block and summed in a fixed order, so there are no atomics and two
// calls give bitwise-equal gradients; the price is that S and dP are
// computed in both passes (7 products where 5 are needed).
//
// Bound: operations.  The gradient needs 5 products of 2*D FLOPs per
// visible (query, key) pair -- 10*B*H*D*T(T+1)/2 FLOPs causal -- against
// about 8*B*T*H*D elements of traffic, far above the card's FLOP/byte
// balance, so the floor is the tensor-core rate: a third of the TF32 rate
// for fp32 inputs (3xTF32, mma.cuh), the bf16 rate for bf16.
// Design: every product runs on mma.sync, 4 warps a block, each owning 16
// rows of the block's 64.  In the dK/dV pass the block's K and V tiles
// stay in shared memory and the warps compute the transposed products
// S^T = K.Q^T and dP^T = V.dO^T, so P^T and dS^T lie in accumulator
// fragments whose rows are keys and feed dV += P^T.dO and dK += dS^T.Q as
// A operands with no transpose through shared memory (lse and delta are
// then indexed by column).  In the dQ pass S = Q.K^T, dP = dO.V^T and
// dQ += dS.K.  The walked tiles (Q, dO, lse, delta in the first pass; K, V
// in the second) are double-buffered by cp.async as in K1, rows padded by
// 16 bytes; two blocks fit on an SM at D <= 64.  Causal tiles on the
// wrong side of the diagonal are never visited; ragged T is masked by
// global position.  What still bounds it: the hi/lo split of every B
// fragment, done by each warp, and the two recomputed products; a single
// pass would need atomics on dQ (not deterministic).
//
// q, k, v are read through (b, t, h) strides, so the views of a fused qkv
// projection need no copy; fp32 or bf16 inputs, fp32 accumulation,
// outputs in the input dtype.  The C entry point returns
// cudaGetLastError() after the launches (or -1 for a head_dim or dtype
// that has no instantiation).

#include "mma.cuh"

namespace {

constexpr int kB = 64;                 // query and key rows a tile
constexpr int kWarps = 4;              // each owns 16 rows of the tile
constexpr int kThreads = kWarps * 32;
constexpr int kDeltaWarps = 8;

struct BwdArgs {
  int t_len, heads, causal, width;
  float scale;
  // (b, t, h) element strides
  int64_t sq[3], sk[3], sv[3], so[3], sdo[3], sdq[3], sdk[3], sdv[3];
};

// Two blocks an SM at D <= 64 (2 x 105 KB of shared memory at fp32); at
// D 128 one block holds 199 KB.
template <int D>
constexpr int kMinBlocks = D <= 64 ? 2 : 1;

// six 64-row tiles (two fixed, two double-buffered) and, in the dK/dV
// pass, the query rows' lse and delta for both buffers
template <typename T, int D>
constexpr int bwd_smem_bytes() {
  return 6 * kB * kPadded<T, D> * static_cast<int>(sizeof(T)) + 4 * kB * 4;
}

template <typename P>  // P: T or const T
__device__ __forceinline__ P* row_of(P* base, const int64_t* s, int b, int t,
                                     int h) {
  return base + b * s[0] + static_cast<int64_t>(t) * s[1] + h * s[2];
}

// delta[b, h, t] = sum_d dO[b, t, h, d] * O[b, t, h, d]: one warp per row
template <typename T, int D>
__global__ void __launch_bounds__(kDeltaWarps * 32)
bwd_delta_kernel(const T* __restrict__ o, const T* __restrict__ dout,
                 float* __restrict__ delta, BwdArgs a) {
  const int b = blockIdx.x / a.heads, h = blockIdx.x % a.heads;
  const int t = blockIdx.y * kDeltaWarps + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (t >= a.t_len) return;  // warp-uniform
  const T* orow = row_of(o, a.so, b, t, h);
  const T* drow = row_of(dout, a.sdo, b, t, h);
  float s = 0.f;
  for (int d = lane; d < D; d += 32) s += to_f32(orow[d]) * to_f32(drow[d]);
  s = warp_sum(s);
  if (lane == 0) delta[static_cast<int64_t>(blockIdx.x) * a.t_len + t] = s;
}

// Write a warp's two accumulator rows (r0 = its first row + g, r1 = r0 + 8)
// of a (16, D) output tile, times mul, into rows of dst (row stride st).
template <typename T, int D>
__device__ __forceinline__ void store_rows(T* dst, int64_t st,
                                           const float (*c)[4], int r0,
                                           int t_len, float mul) {
  const int tq = lane_t();
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = r0 + 8 * half;
    if (row >= t_len) continue;
    T* p = dst + row * st + 2 * tq;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      p[8 * n] = from_f32<T>(c[n][2 * half] * mul);
      p[8 * n + 1] = from_f32<T>(c[n][2 * half + 1] * mul);
    }
  }
}

template <int NS>
__device__ __forceinline__ void zero_acc(float (*c)[4]) {
#pragma unroll
  for (int j = 0; j < NS; ++j) c[j][0] = c[j][1] = c[j][2] = c[j][3] = 0.f;
}

// c (16 x 64) += the warp's 16 rows of x (ld LDS) times the 64 rows of y,
// both (., D): the transposed products of the dK/dV pass (K.Q^T, V.dO^T)
// and the plain ones of the dQ pass (Q.K^T, dO.V^T)
template <typename T, int D, int LDS>
__device__ __forceinline__ void rows_times_rows(float (*c)[4], const T* x,
                                                const T* y) {
  using M = Mma<T>;
  // not unrolled: each step's 8 products are independent enough, and an
  // unrolled loop hoists the loads of every step into registers (spills)
#pragma unroll 1
  for (int kk = 0; kk < D / M::K; ++kk) {
    const typename M::A xa = M::load_a(x + kk * M::K, LDS);
#pragma unroll
    for (int j = 0; j < kB / 8; ++j)
      M::mma(c[j], xa, M::load_b_nk(y + j * 8 * LDS + kk * M::K, LDS));
  }
}

// acc (16 x D) += p (16 x 64, accumulator fragments) times y (64 x D)
template <typename T, int D, int LDS>
__device__ __forceinline__ void acc_times_rows(float (*acc)[4],
                                               const float (*p)[4],
                                               const T* y) {
  using M = Mma<T>;
#pragma unroll
  for (int kk = 0; kk < kB / M::K; ++kk) {
    const typename M::A pa = M::acc_a(p, kk);
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      M::mma(acc[n], pa, M::load_b_kn(y + kk * M::K * LDS + n * 8, LDS));
  }
}

// dK/dV pass: one block per (b*h, 64-key tile), each warp owning 16 keys,
// walking the query tiles at or past the diagonal.  Per query tile:
// S^T = K.Q^T and dP^T = V.dO^T, whose accumulator rows are keys, so
// P^T and dS^T feed dV += P^T.dO and dK += dS^T.Q as A operands with no
// transpose through shared memory; lse and delta are indexed by column.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads, kMinBlocks<D>)
bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                const T* __restrict__ v, const T* __restrict__ dout,
                const float* __restrict__ lse,
                const float* __restrict__ delta, T* __restrict__ dk,
                T* __restrict__ dv, BwdArgs a) {
  constexpr int LDS = kPadded<T, D>, ND = D / 8, NS = kB / 8;
  constexpr int TILE = kB * LDS;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* ks = reinterpret_cast<T*>(smem_raw);
  T* vs = ks + TILE;
  T* qs = vs + TILE;        // 2 buffers
  T* dos = qs + 2 * TILE;   // 2 buffers
  float* lse_s = reinterpret_cast<float*>(dos + 2 * TILE);  // 2 x kB
  float* dl_s = lse_s + 2 * kB;                             // 2 x kB

  const int t_len = a.t_len;
  const int b = blockIdx.x / a.heads, h = blockIdx.x % a.heads;
  const int64_t bh = blockIdx.x;
  const int k0 = blockIdx.y * kB;  // causal: the first tiles walk longest
  const int warp = threadIdx.x >> 5, g = lane_g(), tq = lane_t();
  const T* qb = row_of(q, a.sq, b, 0, h);
  const T* dob = row_of(dout, a.sdo, b, 0, h);
  const float* lse_b = lse + bh * t_len;
  const float* dl_b = delta + bh * t_len;

  auto stage = [&](int q0, int buf) {
    copy_rows<T, D, LDS, kB, kThreads>(qs + buf * TILE, qb, a.sq[1], q0,
                                       t_len, a.width);
    copy_rows<T, D, LDS, kB, kThreads>(dos + buf * TILE, dob, a.sdo[1], q0,
                                       t_len, a.width);
    for (int i = threadIdx.x; i < 2 * kB; i += kThreads) {
      const int r = i % kB, t = q0 + r;
      const bool ok = t < t_len;
      const float* src = i < kB ? lse_b : dl_b;
      float* dst = (i < kB ? lse_s : dl_s) + buf * kB + r;
      cp_async<4>(dst, ok ? src + t : src, ok);
    }
  };

  copy_rows<T, D, LDS, kB, kThreads>(ks, row_of(k, a.sk, b, 0, h), a.sk[1],
                                     k0, t_len, a.width);
  copy_rows<T, D, LDS, kB, kThreads>(vs, row_of(v, a.sv, b, 0, h), a.sv[1],
                                     k0, t_len, a.width);
  const int n_qt = (t_len + kB - 1) / kB;
  // causal: query rows before k0 see none of these keys
  const int qt0 = a.causal ? blockIdx.y : 0;
  stage(qt0 * kB, 0);
  cp_async_commit();

  const int wk0 = k0 + warp * 16;  // the warp's first key row
  const int r0 = wk0 + g, r1 = r0 + 8;
  const float sl = a.scale * kLog2e;
  float dka[ND][4], dva[ND][4];
  zero_acc<ND>(dka);
  zero_acc<ND>(dva);

  for (int qt = qt0; qt < n_qt; ++qt) {
    const int q0 = qt * kB, buf = (qt - qt0) & 1;
    if (qt + 1 < n_qt) {
      stage(q0 + kB, buf ^ 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (wk0 < t_len) {  // warp-uniform
      const T* qc = qs + buf * TILE;
      const T* dc = dos + buf * TILE;
      const float* lc = lse_s + buf * kB;
      const float* dlc = dl_s + buf * kB;
      float pt[NS][4], dpt[NS][4];
      zero_acc<NS>(pt);
      rows_times_rows<T, D, LDS>(pt, ks + warp * 16 * LDS, qc);
      const bool edge = q0 + kB > t_len || (a.causal && wk0 + 15 > q0);
#pragma unroll
      for (int j = 0; j < NS; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = 8 * j + 2 * tq + (e & 1), qry = q0 + col;
          const int key = e < 2 ? r0 : r1;
          float p = exp2f(pt[j][e] * sl - lc[col] * kLog2e);
          if (edge && (qry >= t_len || (a.causal && key > qry))) p = 0.f;
          pt[j][e] = p;
        }
      }
      acc_times_rows<T, D, LDS>(dva, pt, dc);  // dV += P^T.dO
      zero_acc<NS>(dpt);
      rows_times_rows<T, D, LDS>(dpt, vs + warp * 16 * LDS, dc);
#pragma unroll
      for (int j = 0; j < NS; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          dpt[j][e] = pt[j][e] * (dpt[j][e] - dlc[8 * j + 2 * tq + (e & 1)]);
      }
      acc_times_rows<T, D, LDS>(dka, dpt, qc);  // dK += dS^T.Q
    }
    __syncthreads();  // every warp is done with this buffer
  }

  store_rows<T, D>(row_of(dk, a.sdk, b, 0, h), a.sdk[1], dka, r0, t_len,
                   a.scale);
  store_rows<T, D>(row_of(dv, a.sdv, b, 0, h), a.sdv[1], dva, r0, t_len,
                   1.f);
}

// dQ pass: one block per (b*h, 64-query tile), each warp owning 16 query
// rows, walking the key tiles up to the diagonal: S = Q.K^T, dP = dO.V^T,
// dS = P (dP - delta), dQ += dS.K.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads, kMinBlocks<D>)
bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, const T* __restrict__ dout,
              const float* __restrict__ lse, const float* __restrict__ delta,
              T* __restrict__ dq, BwdArgs a) {
  constexpr int LDS = kPadded<T, D>, ND = D / 8, NS = kB / 8;
  constexpr int TILE = kB * LDS;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* qs = reinterpret_cast<T*>(smem_raw);
  T* dos = qs + TILE;
  T* ks = dos + TILE;      // 2 buffers
  T* vs = ks + 2 * TILE;   // 2 buffers

  const int t_len = a.t_len;
  const int b = blockIdx.x / a.heads, h = blockIdx.x % a.heads;
  const int64_t bh = blockIdx.x;
  // the longest causal walks (the last query tiles) start first
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kB;
  const int warp = threadIdx.x >> 5, g = lane_g(), tq = lane_t();
  const T* kb = row_of(k, a.sk, b, 0, h);
  const T* vb = row_of(v, a.sv, b, 0, h);

  int n_kt = (t_len + kB - 1) / kB;
  if (a.causal) {
    const int last_q = min(q0 + kB - 1, t_len - 1);
    n_kt = min(n_kt, last_q / kB + 1);  // skip tiles past the diagonal
  }
  copy_rows<T, D, LDS, kB, kThreads>(qs, row_of(q, a.sq, b, 0, h), a.sq[1],
                                     q0, t_len, a.width);
  copy_rows<T, D, LDS, kB, kThreads>(dos, row_of(dout, a.sdo, b, 0, h),
                                     a.sdo[1], q0, t_len, a.width);
  copy_rows<T, D, LDS, kB, kThreads>(ks, kb, a.sk[1], 0, t_len, a.width);
  copy_rows<T, D, LDS, kB, kThreads>(vs, vb, a.sv[1], 0, t_len, a.width);
  cp_async_commit();

  const int wq0 = q0 + warp * 16;
  const int r0 = wq0 + g, r1 = r0 + 8;
  const float sl = a.scale * kLog2e;
  // the rows' lse (log2 units) and delta; rows past the end are not written
  const float lse0 = r0 < t_len ? lse[bh * t_len + r0] * kLog2e : 0.f;
  const float lse1 = r1 < t_len ? lse[bh * t_len + r1] * kLog2e : 0.f;
  const float dl0 = r0 < t_len ? delta[bh * t_len + r0] : 0.f;
  const float dl1 = r1 < t_len ? delta[bh * t_len + r1] : 0.f;
  float dqa[ND][4];
  zero_acc<ND>(dqa);

  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * kB, buf = kt & 1;
    if (kt + 1 < n_kt) {
      copy_rows<T, D, LDS, kB, kThreads>(ks + (buf ^ 1) * TILE, kb, a.sk[1],
                                         k0 + kB, t_len, a.width);
      copy_rows<T, D, LDS, kB, kThreads>(vs + (buf ^ 1) * TILE, vb, a.sv[1],
                                         k0 + kB, t_len, a.width);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (wq0 < t_len && !(a.causal && k0 > wq0 + 15)) {  // warp-uniform
      const T* kc = ks + buf * TILE;
      const T* vc = vs + buf * TILE;
      float p[NS][4], ds[NS][4];
      zero_acc<NS>(p);
      rows_times_rows<T, D, LDS>(p, qs + warp * 16 * LDS, kc);
      const bool edge = k0 + kB > t_len || (a.causal && k0 + kB - 1 > wq0);
#pragma unroll
      for (int j = 0; j < NS; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = k0 + 8 * j + 2 * tq + (e & 1);
          const int row = e < 2 ? r0 : r1;
          float x = exp2f(p[j][e] * sl - (e < 2 ? lse0 : lse1));
          if (edge && (key >= t_len || (a.causal && key > row))) x = 0.f;
          p[j][e] = x;
        }
      }
      zero_acc<NS>(ds);
      rows_times_rows<T, D, LDS>(ds, dos + warp * 16 * LDS, vc);
#pragma unroll
      for (int j = 0; j < NS; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          ds[j][e] = p[j][e] * (ds[j][e] - (e < 2 ? dl0 : dl1));
      }
      acc_times_rows<T, D, LDS>(dqa, ds, kc);  // dQ += dS.K
    }
    __syncthreads();
  }

  store_rows<T, D>(row_of(dq, a.sdq, b, 0, h), a.sdq[1], dqa, r0, t_len,
                   a.scale);
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
      <<<dim3(b * a.heads, (a.t_len + kDeltaWarps - 1) / kDeltaWarps),
         kDeltaWarps * 32, 0, stream>>>(static_cast<const T*>(o), do_,
                                        delta, a);
  constexpr int smem = bwd_smem_bytes<T, D>();
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
  // the views the passes copy by cp.async: q, k, v and dout
  const void* in[4] = {q, k, v, dout};
  const int64_t tile_strides[12] = {
      a.sq[0], a.sq[1], a.sq[2], a.sk[0], a.sk[1], a.sk[2],
      a.sv[0], a.sv[1], a.sv[2], a.sdo[0], a.sdo[1], a.sdo[2]};
  a.width = copy_width(in, 4, tile_strides, 12, dtype == 0 ? 4 : 2);
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

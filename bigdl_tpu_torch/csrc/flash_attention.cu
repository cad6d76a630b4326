// Hand-written Hopper (sm_90a) attention kernels for bigdl_tpu_torch.
//
// Three kernels, one per Pallas kernel of the JAX package's serving path:
//
// K1 flash_attn_kernel   replaces bigdl_tpu/ops/flash_attention.py
//    flash_attention / _attn_kernel (causal or full attention, fp32 online
//    softmax, the (T, T) score matrix never leaves the SM).
//    Bound: at the serving shapes (T <= 2048, D = 64, fp32) the work is
//    4*B*H*D*T^2/2 FLOPs against 4*B*T*H*D*4 bytes, so it is bounded by
//    operations: the CUDA-core fp32 rate (this fp32 kernel does not use
//    the tensor cores).  Design: one block of 8 warps per (b*h, 64-row
//    query tile); Q, K and V tiles of 64 rows are staged in shared memory
//    as fp32 (K rows padded to D+1 floats so the lanes of a warp hit
//    distinct banks); each warp owns 8 query rows, each lane scores two
//    keys and owns D/32 output columns, so the softmax state stays in
//    registers.  Causal tiles past the diagonal are never loaded; the
//    ragged last tile is masked by global position.  Tensor-core MMA and
//    a TMA/mbarrier pipeline are the work of a later, speed-minded change.
//
// K2 decode_kernel<PAGED=false> replaces flash_decode_attention /
//    _decode_kernel: one query row per (b, h) against a contiguous
//    (B, T, H, D) cache, masked at kpos <= pos[b].
// K3 decode_kernel<PAGED=true> replaces flash_paged_decode_attention /
//    _paged_decode_kernel (fp path): the same, with key position kp read
//    from pool block tables[b, kp / bs], row kp % bs, in place -- no
//    per-head copy of the pool.
//    Bound for both: bytes.  A decode step does 4*D FLOPs per 2*D*elt
//    bytes of K/V, far below the card's FLOP/byte balance, so the floor is
//    the K/V rows up to pos[b] read once at the memory rate.  Design: one
//    block of 8 warps per (b, h); the loop visits only the pos[b]+1
//    visible positions (the dynamic trip count of the TPU kernel), warps
//    split them 32 at a time, each lane scores one key with 16-byte row
//    loads, V rows are read coalesced across lanes, and the warps' partial
//    (m, l, acc) are merged through shared memory at the end.  Any block
//    size works because the table lookup is per key.
//
// Every kernel takes fp32 or bf16 inputs, accumulates in fp32 and reads
// the (B, T, H, D) layout through strides (last dim contiguous), so the
// q/k/v views of a fused qkv projection need no copy.  The C entry points
// return cudaGetLastError() after the launch (or -1 for a head_dim or
// dtype that has no instantiation).

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

// four consecutive elements starting at a 4-element-aligned address
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  uint2 raw = *reinterpret_cast<const uint2*>(p);
  __nv_bfloat162 lo = *reinterpret_cast<__nv_bfloat162*>(&raw.x);
  __nv_bfloat162 hi = *reinterpret_cast<__nv_bfloat162*>(&raw.y);
  float2 a = __bfloat1622float2(lo);
  float2 b = __bfloat1622float2(hi);
  return make_float4(a.x, a.y, b.x, b.y);
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

// ------------------------------------------------------------------------
// K1: flash attention forward
// ------------------------------------------------------------------------
constexpr int kBQ = 64;          // query rows per block
constexpr int kBK = 64;          // key rows per shared-memory tile
constexpr int kWarps = 8;        // warps per block
constexpr int kRows = kBQ / kWarps;  // query rows per warp

template <int D>
constexpr int attn_smem_bytes() {
  return (kBQ * (D + 1) + kBK * (D + 1) + kBK * D) * 4;
}

template <typename T, int D>
__global__ void __launch_bounds__(kWarps * 32)
flash_attn_kernel(const T* __restrict__ q, const T* __restrict__ k,
                  const T* __restrict__ v, T* __restrict__ o, int t_len,
                  int heads, int64_t sqb, int64_t sqt, int64_t sqh,
                  int64_t skb, int64_t skt, int64_t skh, int64_t svb,
                  int64_t svt, int64_t svh, int64_t sob, int64_t sot,
                  int64_t soh, int causal, float scale) {
  constexpr int LD = D + 1;
  constexpr int DPL = (D + 31) / 32;  // output columns per lane
  extern __shared__ float smem[];
  float* qs = smem;               // kBQ x LD, pre-scaled
  float* ks = qs + kBQ * LD;      // kBK x LD
  float* vs = ks + kBK * LD;      // kBK x D

  const int b = blockIdx.x / heads;
  const int h = blockIdx.x % heads;
  const int q0 = blockIdx.y * kBQ;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const T* qb = q + b * sqb + h * sqh;
  const T* kb = k + b * skb + h * skh;
  const T* vb = v + b * svb + h * svh;
  T* ob = o + b * sob + h * soh;

  for (int i = tid; i < kBQ * D; i += blockDim.x) {
    const int r = i / D, c = i % D, t = q0 + r;
    qs[r * LD + c] = t < t_len ? to_f32(qb[t * sqt + c]) * scale : 0.f;
  }

  float m[kRows], l[kRows], acc[kRows][DPL];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    m[r] = -INFINITY;
    l[r] = 0.f;
#pragma unroll
    for (int j = 0; j < DPL; ++j) acc[r][j] = 0.f;
  }

  int n_tiles = (t_len + kBK - 1) / kBK;
  if (causal) {
    const int last_q = min(q0 + kBQ - 1, t_len - 1);
    n_tiles = min(n_tiles, last_q / kBK + 1);  // skip tiles past the diagonal
  }

  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * kBK;
    __syncthreads();  // previous tile consumed (and Q staged)
    for (int i = tid; i < kBK * D; i += blockDim.x) {
      const int r = i / D, c = i % D, t = k0 + r;
      const bool ok = t < t_len;
      ks[r * LD + c] = ok ? to_f32(kb[t * skt + c]) : 0.f;
      vs[r * D + c] = ok ? to_f32(vb[t * svt + c]) : 0.f;
    }
    __syncthreads();

#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int qr = warp * kRows + r;
      const int qt = q0 + qr;
      if (qt >= t_len) continue;  // warp-uniform
      const float* qrow = qs + qr * LD;
      const float* ka = ks + lane * LD;
      const float* kc = ks + (lane + 32) * LD;
      float s0 = 0.f, s1 = 0.f;
#pragma unroll 16
      for (int c = 0; c < D; ++c) {
        const float qv = qrow[c];
        s0 = fmaf(qv, ka[c], s0);
        s1 = fmaf(qv, kc[c], s1);
      }
      const int kpa = k0 + lane, kpb = k0 + lane + 32;
      const bool va = kpa < t_len && (!causal || kpa <= qt);
      const bool vb_ = kpb < t_len && (!causal || kpb <= qt);
      s0 = va ? s0 : -INFINITY;
      s1 = vb_ ? s1 : -INFINITY;
      const float new_m = fmaxf(m[r], warp_max(fmaxf(s0, s1)));
      const float sm = safe_max(new_m);
      const float p0 = va ? expf(s0 - sm) : 0.f;
      const float p1 = vb_ ? expf(s1 - sm) : 0.f;
      const float corr = rescale(m[r], sm);
      l[r] = l[r] * corr + warp_sum(p0 + p1);
      m[r] = new_m;
#pragma unroll
      for (int j = 0; j < DPL; ++j) acc[r][j] *= corr;
      for (int kk = 0; kk < 32; ++kk) {
        const float pa = __shfl_sync(kFull, p0, kk);
        const float pb = __shfl_sync(kFull, p1, kk);
#pragma unroll
        for (int j = 0; j < DPL; ++j) {
          const int d = lane + 32 * j;
          if (d < D)
            acc[r][j] += pa * vs[kk * D + d] + pb * vs[(kk + 32) * D + d];
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int qt = q0 + warp * kRows + r;
    if (qt >= t_len) continue;
    const float denom = fmaxf(l[r], 1e-30f);
#pragma unroll
    for (int j = 0; j < DPL; ++j) {
      const int d = lane + 32 * j;
      if (d < D) ob[qt * sot + d] = from_f32<T>(acc[r][j] / denom);
    }
  }
}

template <typename T, int D>
int launch_attn(const void* q, const void* k, const void* v, void* o, int b,
                int t, int h, const int64_t* s, int causal, float scale,
                cudaStream_t stream) {
  constexpr int smem = attn_smem_bytes<D>();
  cudaFuncSetAttribute(flash_attn_kernel<T, D>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  dim3 grid(b * h, (t + kBQ - 1) / kBQ);
  flash_attn_kernel<T, D><<<grid, kWarps * 32, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), t, h, s[0], s[1], s[2],
      s[3], s[4], s[5], s[6], s[7], s[8], s[9], s[10], s[11], causal, scale);
  return static_cast<int>(cudaGetLastError());
}

// ------------------------------------------------------------------------
// K2 / K3: single-token decode against a contiguous cache or a paged pool
// ------------------------------------------------------------------------
constexpr int kDecWarps = 8;

struct DecodeArgs {
  const int* pos;      // (B,)
  const int* tables;   // (B, MB) row stride table_stride; paged only
  int heads;
  int limit;           // positions addressable: T (contiguous) / MB*bs
  int block_size;      // paged only
  int max_blocks;      // paged only
  int num_blocks;      // paged only
  int64_t table_stride;
  int64_t sqb, sqh;
  // contiguous: (row stride b, position stride t, head stride h)
  // paged:      (block stride, in-block row stride, head stride)
  int64_t sk0, sk1, skh, sv0, sv1, svh;
  int64_t sob, soh;
  float scale;
};

template <typename T, int D, bool PAGED>
__global__ void __launch_bounds__(kDecWarps * 32)
decode_kernel(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, T* __restrict__ o, DecodeArgs a) {
  constexpr int DPL = (D + 31) / 32;
  __shared__ float qs[D];
  __shared__ float red_m[kDecWarps], red_l[kDecWarps];
  __shared__ float red_acc[kDecWarps][D];

  const int b = blockIdx.x / a.heads;
  const int h = blockIdx.x % a.heads;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  for (int c = tid; c < D; c += blockDim.x)
    qs[c] = to_f32(q[b * a.sqb + h * a.sqh + c]) * a.scale;
  __syncthreads();

  // positions kpos <= pos[b] are visible: the dynamic trip count
  const int n_vis = max(0, min(a.pos[b] + 1, a.limit));

  float m = -INFINITY, l = 0.f, acc[DPL];
#pragma unroll
  for (int j = 0; j < DPL; ++j) acc[j] = 0.f;

  for (int base = warp * 32; base < n_vis; base += kDecWarps * 32) {
    const int kp = base + lane;
    const bool valid = kp < n_vis;
    int64_t ko = 0, vo = 0;
    float s = -INFINITY;
    if (valid) {
      int64_t row, off;
      if (PAGED) {
        const int lb = min(kp / a.block_size, a.max_blocks - 1);
        int bid = a.tables[b * a.table_stride + lb];
        bid = min(max(bid, 0), a.num_blocks - 1);
        row = bid;
        off = kp % a.block_size;
      } else {
        row = b;
        off = kp;
      }
      ko = row * a.sk0 + off * a.sk1 + h * a.skh;
      vo = row * a.sv0 + off * a.sv1 + h * a.svh;
      const T* kr = k + ko;
      float dot = 0.f;
#pragma unroll
      for (int c = 0; c < D; c += 4) {
        const float4 kv = load4(kr + c);
        dot = fmaf(qs[c], kv.x, dot);
        dot = fmaf(qs[c + 1], kv.y, dot);
        dot = fmaf(qs[c + 2], kv.z, dot);
        dot = fmaf(qs[c + 3], kv.w, dot);
      }
      s = dot;
    }
    const float new_m = fmaxf(m, warp_max(s));
    const float sm = safe_max(new_m);
    const float p = valid ? expf(s - sm) : 0.f;
    const float corr = rescale(m, sm);
    l = l * corr + warp_sum(p);
    m = new_m;
#pragma unroll
    for (int j = 0; j < DPL; ++j) acc[j] *= corr;
    const int cnt = min(32, n_vis - base);
    for (int kk = 0; kk < cnt; ++kk) {
      const float pk = __shfl_sync(kFull, p, kk);
      const int64_t vk = __shfl_sync(kFull, vo, kk);
      const T* vr = v + vk;
#pragma unroll
      for (int j = 0; j < DPL; ++j) {
        const int d = lane + 32 * j;
        if (d < D) acc[j] = fmaf(pk, to_f32(vr[d]), acc[j]);
      }
    }
  }

  if (lane == 0) {
    red_m[warp] = m;
    red_l[warp] = l;
  }
#pragma unroll
  for (int j = 0; j < DPL; ++j) {
    const int d = lane + 32 * j;
    if (d < D) red_acc[warp][d] = acc[j];
  }
  __syncthreads();
  if (tid < D) {
    float mg = -INFINITY;
#pragma unroll
    for (int w = 0; w < kDecWarps; ++w) mg = fmaxf(mg, red_m[w]);
    const float sm = safe_max(mg);
    float lt = 0.f, at = 0.f;
#pragma unroll
    for (int w = 0; w < kDecWarps; ++w) {
      const float wt = rescale(red_m[w], sm);
      lt += red_l[w] * wt;
      at += red_acc[w][tid] * wt;
    }
    o[b * a.sob + h * a.soh + tid] = from_f32<T>(at / fmaxf(lt, 1e-30f));
  }
}

template <typename T, int D, bool PAGED>
int launch_decode(const void* q, const void* k, const void* v, void* o,
                  int batch, const DecodeArgs& a, cudaStream_t stream) {
  decode_kernel<T, D, PAGED><<<batch * a.heads, kDecWarps * 32, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, bool PAGED>
int dispatch_decode(int d, const void* q, const void* k, const void* v,
                    void* o, int batch, const DecodeArgs& a,
                    cudaStream_t stream) {
  switch (d) {
    case 16: return launch_decode<T, 16, PAGED>(q, k, v, o, batch, a, stream);
    case 32: return launch_decode<T, 32, PAGED>(q, k, v, o, batch, a, stream);
    case 64: return launch_decode<T, 64, PAGED>(q, k, v, o, batch, a, stream);
    case 128: return launch_decode<T, 128, PAGED>(q, k, v, o, batch, a, stream);
    default: return -1;
  }
}

template <bool PAGED>
int decode_entry(int dtype, int d, const void* q, const void* k,
                 const void* v, void* o, int batch, const DecodeArgs& a,
                 cudaStream_t stream) {
  if (dtype == 0)
    return dispatch_decode<float, PAGED>(d, q, k, v, o, batch, a, stream);
  if (dtype == 1)
    return dispatch_decode<__nv_bfloat16, PAGED>(d, q, k, v, o, batch, a,
                                                 stream);
  return -1;
}

template <typename T>
int dispatch_attn(int d, const void* q, const void* k, const void* v, void* o,
                  int b, int t, int h, const int64_t* s, int causal,
                  float scale, cudaStream_t stream) {
  switch (d) {
    case 16: return launch_attn<T, 16>(q, k, v, o, b, t, h, s, causal, scale, stream);
    case 32: return launch_attn<T, 32>(q, k, v, o, b, t, h, s, causal, scale, stream);
    case 64: return launch_attn<T, 64>(q, k, v, o, b, t, h, s, causal, scale, stream);
    case 128: return launch_attn<T, 128>(q, k, v, o, b, t, h, s, causal, scale, stream);
    default: return -1;
  }
}

}  // namespace

extern "C" {

// q, k, v, o: (B, T, H, D); strides[12] = (b, t, h) element strides of
// q, k, v, o in that order.  dtype 0 = float32, 1 = bfloat16.
int bigdl_flash_attention(const void* q, const void* k, const void* v,
                          void* o, int dtype, int b, int t, int h, int d,
                          const int64_t* strides, int causal, float scale,
                          void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_attn<float>(d, q, k, v, o, b, t, h, strides, causal,
                                scale, st);
  if (dtype == 1)
    return dispatch_attn<__nv_bfloat16>(d, q, k, v, o, b, t, h, strides,
                                        causal, scale, st);
  return -1;
}

// q, o: (B, 1, H, D); k, v: (B, T, H, D); pos: (B,) int32.
// strides[10] = q (b, h), k (b, t, h), v (b, t, h), o (b, h).
int bigdl_flash_decode_attention(const void* q, const void* k, const void* v,
                                 void* o, const int* pos, int dtype, int b,
                                 int h, int d, int t, const int64_t* strides,
                                 float scale, void* stream) {
  DecodeArgs a{};
  a.pos = pos;
  a.tables = nullptr;
  a.heads = h;
  a.limit = t;
  a.sqb = strides[0];
  a.sqh = strides[1];
  a.sk0 = strides[2];
  a.sk1 = strides[3];
  a.skh = strides[4];
  a.sv0 = strides[5];
  a.sv1 = strides[6];
  a.svh = strides[7];
  a.sob = strides[8];
  a.soh = strides[9];
  a.scale = scale;
  return decode_entry<false>(dtype, d, q, k, v, o, b, a,
                             static_cast<cudaStream_t>(stream));
}

// q, o: (B, 1, H, D); k_pool, v_pool: (NB, bs, H, D); tables: (B, MB)
// int32 with row stride table_stride; pos: (B,) int32.
// strides[10] = q (b, h), k (block, row, h), v (block, row, h), o (b, h).
int bigdl_flash_paged_decode_attention(
    const void* q, const void* k_pool, const void* v_pool, void* o,
    const int* tables, const int* pos, int dtype, int b, int h, int d,
    int num_blocks, int block_size, int max_blocks, int64_t table_stride,
    const int64_t* strides, float scale, void* stream) {
  DecodeArgs a{};
  a.pos = pos;
  a.tables = tables;
  a.heads = h;
  a.limit = max_blocks * block_size;
  a.block_size = block_size;
  a.max_blocks = max_blocks;
  a.num_blocks = num_blocks;
  a.table_stride = table_stride;
  a.sqb = strides[0];
  a.sqh = strides[1];
  a.sk0 = strides[2];
  a.sk1 = strides[3];
  a.skh = strides[4];
  a.sv0 = strides[5];
  a.sv1 = strides[6];
  a.svh = strides[7];
  a.sob = strides[8];
  a.soh = strides[9];
  a.scale = scale;
  return decode_entry<true>(dtype, d, q, k_pool, v_pool, o, b, a,
                            static_cast<cudaStream_t>(stream));
}

}  // extern "C"

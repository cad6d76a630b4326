// Hand-written Hopper (sm_90a) attention kernels for bigdl_tpu_torch.
//
// Four kernels, one per Pallas kernel (or kernel path) of the JAX package's
// serving path:
//
// K1 flash_attn_kernel   replaces bigdl_tpu/ops/flash_attention.py
//    flash_attention / _attn_kernel (causal or full attention, fp32 online
//    softmax, the (T, T) score matrix never leaves the SM).
//    Bound: operations.  At the model's shapes (T <= 2048, D = 64) the
//    work is 4*B*H*D*T^2/2 FLOPs against 4*B*T*H*D elements, far above the
//    card's FLOP/byte balance, so the floor is the tensor-core rate: for
//    fp32 inputs a third of the 495 TFLOP/s TF32 rate, since each product
//    is three TF32 products (3xTF32, mma.cuh), which keeps the port's fp32
//    tolerances; for bf16 the 989 TFLOP/s rate, one m16n8k16 product.
//    Design (FlashAttention-2's work split): one block of 4 warps per
//    (b*h, 64-row query tile), each warp owning 16 query rows and walking
//    the 64-row key tiles up to its diagonal; the last query tiles, whose
//    causal walks are longest, are scheduled first.  Both products
//    (S = Q.K^T, O += P.V) are mma.sync; S stays in the accumulator
//    fragments, the row max and sum take two quad shuffles, and P is used
//    in registers as the A operand of P.V (summed over keys in permuted
//    order, mma.cuh, so no shuffle).  Q's fragments are split once and
//    held in registers (re-read from shared memory for fp32 at D 128).  K
//    and V tiles are double-buffered in shared memory by cp.async
//    (16-byte copies where every base and stride allows, else 4-byte, else
//    plain loads for a 2-byte-aligned bf16 view), so the next tile loads
//    while this one is computed; rows padded by 16 bytes keep every
//    fragment load free of bank conflicts.  A grid of fewer 64-row blocks
//    than SMs (B1 T200: 48) takes 16-row blocks of one warp instead (156),
//    the wrapper's choice.  Causal tiles past the diagonal are never
//    loaded; the ragged last tile is masked by global position.  The
//    softmax runs in log2 units (exp2f).  What still bounds it: every warp
//    splits each K/V fragment it loads into hi/lo itself (integer ops, 4
//    warps a block), and a warp's softmax sits between its two products;
//    wgmma with TMA waits for bf16 compute (mma.sync takes fragments in
//    any shared-memory layout, which fp32's split needs).
//    For training the kernel also writes each query row's logsumexp
//    lse = m + log(l) (B, H, T) fp32, which the backward
//    (flash_attention_bwd.cu) uses to rebuild P; serving passes no lse.
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
// K3q decode_kernel<PAGED=true, QUANT=true> replaces the quantized=True
//    path of the same Pallas kernel: int8 K/V pools with one fp32 scale
//    per (position, head) vector, (NB, bs, H, 1).  Each key row is read
//    as int8 (D bytes, 16-byte loads; scales at a stride of H*4 bytes)
//    and dequantized in registers right after the load, float(k8) *
//    scale, so no fp32 copy of the pool ever exists; the output is fp32
//    whatever q's dtype, as on the TPU.  Bound: bytes, 2*H*(D + 4) per
//    visible position against K3's 2*H*D*4 (3.76x fewer at D = 64).  The
//    loop, masking and softmax are K3's; split-K across blocks is later
//    work (with one block per (b, h) at B = 8, H = 12 only 96 of the 132
//    SMs hold a block).
//
// Every kernel takes fp32 or bf16 queries (K2/K3 also K/V of that dtype),
// accumulates in fp32 and reads
// the (B, T, H, D) layout through strides (last dim contiguous), so the
// q/k/v views of a fused qkv projection need no copy.  The C entry points
// return cudaGetLastError() after the launch (or -1 for a head_dim or
// dtype that has no instantiation).

#include <type_traits>

#include "mma.cuh"

namespace {

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

// ------------------------------------------------------------------------
// K1: flash attention forward
// ------------------------------------------------------------------------
constexpr int kBK = 64;  // key rows a tile

// K/V tiles twice (double-buffered), the query rows once
template <typename T, int D, int NW>
constexpr int attn_smem_bytes() {
  return (16 * NW + 4 * kBK) * kPadded<T, D> * static_cast<int>(sizeof(T));
}

struct AttnArgs {
  int t_len, heads, causal, width;
  float scale;
  int64_t sq[3], sk[3], sv[3], so[3];  // (b, t, h) element strides
  float* lse;                          // (B, H, T) fp32, or null
};

// One block of NW warps per (b*h, 16*NW query rows); each warp owns 16
// rows and walks the key tiles up to its diagonal.
template <typename T, int D, int NW>
__global__ void __launch_bounds__(NW * 32)
flash_attn_kernel(const T* __restrict__ q, const T* __restrict__ k,
                  const T* __restrict__ v, T* __restrict__ o, AttnArgs a) {
  using M = Mma<T>;
  constexpr int BQ = 16 * NW, NT = NW * 32, LDS = kPadded<T, D>;
  constexpr int KS = D / M::K;    // k-steps of Q.K^T
  constexpr int NS = kBK / 8;     // n-tiles of S (8 keys each)
  constexpr int ND = D / 8;       // n-tiles of O
  constexpr int PS = kBK / M::K;  // k-steps of P.V
  // Q's fragments stay in registers for the whole walk, except fp32 at
  // D 128 (128 registers of hi/lo): re-read from shared memory there
  constexpr bool kQRegs = sizeof(T) == 2 || D <= 64;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* qs = reinterpret_cast<T*>(smem_raw);  // BQ x LDS
  T* ks = qs + BQ * LDS;                   // 2 x kBK x LDS
  T* vs = ks + 2 * kBK * LDS;              // 2 x kBK x LDS

  const int t_len = a.t_len;
  const int b = blockIdx.x / a.heads, h = blockIdx.x % a.heads;
  // the longest causal walks (the last query tiles) start first
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;
  const int warp = threadIdx.x >> 5, g = lane_g(), tq = lane_t();
  const T* qb = q + b * a.sq[0] + h * a.sq[2];
  const T* kb = k + b * a.sk[0] + h * a.sk[2];
  const T* vb = v + b * a.sv[0] + h * a.sv[2];

  int n_tiles = (t_len + kBK - 1) / kBK;
  if (a.causal) {
    const int last_q = min(q0 + BQ - 1, t_len - 1);
    n_tiles = min(n_tiles, last_q / kBK + 1);  // skip tiles past the diagonal
  }

  copy_rows<T, D, LDS, BQ, NT>(qs, qb, a.sq[1], q0, t_len, a.width);
  copy_rows<T, D, LDS, kBK, NT>(ks, kb, a.sk[1], 0, t_len, a.width);
  copy_rows<T, D, LDS, kBK, NT>(vs, vb, a.sv[1], 0, t_len, a.width);
  cp_async_commit();

  const int wq0 = q0 + warp * 16;  // the warp's first query row
  const int r0 = wq0 + g, r1 = r0 + 8;
  const float sl = a.scale * kLog2e;  // scores in log2 units
  const T* qw = qs + warp * 16 * LDS;
  float acc[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;
  typename M::A qf[kQRegs ? KS : 1];

  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * kBK, buf = kt & 1;
    if (kt + 1 < n_tiles) {  // the next tile's copies fly during this one
      copy_rows<T, D, LDS, kBK, NT>(ks + (buf ^ 1) * kBK * LDS, kb, a.sk[1],
                                    k0 + kBK, t_len, a.width);
      copy_rows<T, D, LDS, kBK, NT>(vs + (buf ^ 1) * kBK * LDS, vb, a.sv[1],
                                    k0 + kBK, t_len, a.width);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if constexpr (kQRegs) {
      if (kt == 0) {
#pragma unroll
        for (int kk = 0; kk < KS; ++kk) qf[kk] = M::load_a(qw + kk * M::K, LDS);
      }
    }
    // warp-uniform: rows past the end, or every key past the warp's rows
    if (wq0 < t_len && !(a.causal && k0 > wq0 + 15)) {
      const T* kc = ks + buf * kBK * LDS;
      const T* vc = vs + buf * kBK * LDS;
      float s[NS][4];
#pragma unroll
      for (int j = 0; j < NS; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        typename M::A qa;
        if constexpr (kQRegs) qa = qf[kk];
        else qa = M::load_a(qw + kk * M::K, LDS);
#pragma unroll
        for (int j = 0; j < NS; ++j)
          M::mma(s[j], qa, M::load_b_nk(kc + j * 8 * LDS + kk * M::K, LDS));
      }
      // masked by global position: the ragged last tile, the diagonal
      const bool edge = k0 + kBK > t_len || (a.causal && k0 + kBK - 1 > wq0);
      float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
      for (int j = 0; j < NS; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = k0 + 8 * j + 2 * tq + (e & 1);
          const int row = e < 2 ? r0 : r1;
          float x = s[j][e] * sl;
          if (edge && (key >= t_len || (a.causal && key > row))) x = -INFINITY;
          s[j][e] = x;
        }
        mx0 = fmaxf(mx0, fmaxf(s[j][0], s[j][1]));
        mx1 = fmaxf(mx1, fmaxf(s[j][2], s[j][3]));
      }
      const float nm0 = fmaxf(m0, quad_max(mx0));
      const float nm1 = fmaxf(m1, quad_max(mx1));
      const float sm0 = safe_max(nm0), sm1 = safe_max(nm1);
      const float c0 = m0 == -INFINITY ? 0.f : exp2f(m0 - sm0);
      const float c1 = m1 == -INFINITY ? 0.f : exp2f(m1 - sm1);
      m0 = nm0;
      m1 = nm1;
      // each lane keeps its own part of l; the quad sums it at the end
      l0 *= c0;
      l1 *= c1;
#pragma unroll
      for (int j = 0; j < NS; ++j) {
        s[j][0] = exp2f(s[j][0] - sm0);
        s[j][1] = exp2f(s[j][1] - sm0);
        s[j][2] = exp2f(s[j][2] - sm1);
        s[j][3] = exp2f(s[j][3] - sm1);
        l0 += s[j][0] + s[j][1];
        l1 += s[j][2] + s[j][3];
      }
#pragma unroll
      for (int n = 0; n < ND; ++n) {
        acc[n][0] *= c0;
        acc[n][1] *= c0;
        acc[n][2] *= c1;
        acc[n][3] *= c1;
      }
      // O += P.V, P straight from the score accumulators
#pragma unroll
      for (int kk = 0; kk < PS; ++kk) {
        const typename M::A pa = M::acc_a(s, kk);
#pragma unroll
        for (int n = 0; n < ND; ++n)
          M::mma(acc[n], pa, M::load_b_kn(vc + kk * M::K * LDS + n * 8, LDS));
      }
    }
    __syncthreads();  // every warp is done with this buffer
  }

  l0 = quad_sum(l0);
  l1 = quad_sum(l1);
  T* ob = o + b * a.so[0] + h * a.so[2];
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = half ? r1 : r0;
    if (row >= t_len) continue;
    const float l = fmaxf(half ? l1 : l0, 1e-30f);
    const float inv = 1.f / l;
    T* orow = ob + row * a.so[1] + 2 * tq;
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      orow[8 * n] = from_f32<T>(acc[n][2 * half] * inv);
      orow[8 * n + 1] = from_f32<T>(acc[n][2 * half + 1] * inv);
    }
    // a row that sees no key gets lse = +inf, so the backward's
    // exp(s - lse) is 0 there (its output is 0 too)
    const float m = half ? m1 : m0;
    if (a.lse != nullptr && tq == 0)
      a.lse[static_cast<int64_t>(blockIdx.x) * t_len + row] =
          m == -INFINITY ? INFINITY : m * kLn2 + logf(l);
  }
}

template <typename T, int D, int NW>
int launch_attn(const void* q, const void* k, const void* v, void* o, int bh,
                const AttnArgs& a, cudaStream_t stream) {
  constexpr int smem = attn_smem_bytes<T, D, NW>();
  cudaFuncSetAttribute(flash_attn_kernel<T, D, NW>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  dim3 grid(bh, (a.t_len + 16 * NW - 1) / (16 * NW));
  flash_attn_kernel<T, D, NW><<<grid, NW * 32, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), a);
  return static_cast<int>(cudaGetLastError());
}

// ------------------------------------------------------------------------
// K2 / K3 / K3q: single-token decode against a contiguous cache or a pool
// ------------------------------------------------------------------------
constexpr int kDecWarps = 8;

struct DecodeArgs {
  const int* pos;      // (B,)
  const int* tables;   // (B, MB) row stride table_stride; paged only
  const float* k_scale;  // (NB, bs, H, 1) fp32; quantized only
  const float* v_scale;
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
  int64_t sks0, sks1, sksh, svs0, svs1, svsh;  // scales; quantized only
  int64_t sob, soh;
  float scale;
};

__device__ __forceinline__ float to_f32(int8_t x) {
  return static_cast<float>(x);
}

// K3q stores K/V as int8 and always writes fp32 (the TPU kernel's output
// dtype on the quantized path); K2/K3 read and write the input dtype
template <typename T, bool QUANT>
using DecKV = std::conditional_t<QUANT, int8_t, T>;
template <typename T, bool QUANT>
using DecOut = std::conditional_t<QUANT, float, T>;

template <typename T, int D, bool PAGED, bool QUANT>
__global__ void __launch_bounds__(kDecWarps * 32)
decode_kernel(const T* __restrict__ q, const DecKV<T, QUANT>* __restrict__ k,
              const DecKV<T, QUANT>* __restrict__ v,
              DecOut<T, QUANT>* __restrict__ o, DecodeArgs a) {
  using KV = DecKV<T, QUANT>;
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
    float s = -INFINITY, vsc = 1.f;
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
      const KV* kr = k + ko;
      float dot = 0.f;
      if constexpr (QUANT) {
        // the int8 row (D bytes) as 16-byte loads, each value dequantized
        // in registers right after its load: float(k8) * scale, the
        // product the plain version's dequantize_blockwise forms
        const float ks = a.k_scale[row * a.sks0 + off * a.sks1 + h * a.sksh];
        vsc = a.v_scale[row * a.svs0 + off * a.svs1 + h * a.svsh];
#pragma unroll
        for (int c = 0; c < D; c += 16) {
          const int4 raw = *reinterpret_cast<const int4*>(kr + c);
          const int8_t* k8 = reinterpret_cast<const int8_t*>(&raw);
#pragma unroll
          for (int i = 0; i < 16; ++i)
            dot = fmaf(qs[c + i], static_cast<float>(k8[i]) * ks, dot);
        }
      } else {
#pragma unroll
        for (int c = 0; c < D; c += 4) {
          const float4 kv = load4(kr + c);
          dot = fmaf(qs[c], kv.x, dot);
          dot = fmaf(qs[c + 1], kv.y, dot);
          dot = fmaf(qs[c + 2], kv.z, dot);
          dot = fmaf(qs[c + 3], kv.w, dot);
        }
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
      // a shuffle is never dead code: K2/K3 must not pay for the scale
      const float vs = QUANT ? __shfl_sync(kFull, vsc, kk) : 1.f;
      const KV* vr = v + vk;
#pragma unroll
      for (int j = 0; j < DPL; ++j) {
        const int d = lane + 32 * j;
        if (d < D) {
          const float vx = QUANT ? to_f32(vr[d]) * vs : to_f32(vr[d]);
          acc[j] = fmaf(pk, vx, acc[j]);
        }
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
    o[b * a.sob + h * a.soh + tid] =
        from_f32<DecOut<T, QUANT>>(at / fmaxf(lt, 1e-30f));
  }
}

template <typename T, int D, bool PAGED, bool QUANT>
int launch_decode(const void* q, const void* k, const void* v, void* o,
                  int batch, const DecodeArgs& a, cudaStream_t stream) {
  using KV = DecKV<T, QUANT>;
  using O = DecOut<T, QUANT>;
  decode_kernel<T, D, PAGED, QUANT>
      <<<batch * a.heads, kDecWarps * 32, 0, stream>>>(
          static_cast<const T*>(q), static_cast<const KV*>(k),
          static_cast<const KV*>(v), static_cast<O*>(o), a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, bool PAGED, bool QUANT>
int dispatch_decode(int d, const void* q, const void* k, const void* v,
                    void* o, int batch, const DecodeArgs& a,
                    cudaStream_t stream) {
  switch (d) {
    case 16: return launch_decode<T, 16, PAGED, QUANT>(q, k, v, o, batch, a, stream);
    case 32: return launch_decode<T, 32, PAGED, QUANT>(q, k, v, o, batch, a, stream);
    case 64: return launch_decode<T, 64, PAGED, QUANT>(q, k, v, o, batch, a, stream);
    case 128: return launch_decode<T, 128, PAGED, QUANT>(q, k, v, o, batch, a, stream);
    default: return -1;
  }
}

template <bool PAGED, bool QUANT>
int decode_entry(int dtype, int d, const void* q, const void* k,
                 const void* v, void* o, int batch, const DecodeArgs& a,
                 cudaStream_t stream) {
  if (dtype == 0)
    return dispatch_decode<float, PAGED, QUANT>(d, q, k, v, o, batch, a,
                                                stream);
  if (dtype == 1)
    return dispatch_decode<__nv_bfloat16, PAGED, QUANT>(d, q, k, v, o, batch,
                                                        a, stream);
  return -1;
}

template <typename T, int NW>
int dispatch_attn(int d, const void* q, const void* k, const void* v, void* o,
                  int bh, const AttnArgs& a, cudaStream_t stream) {
  switch (d) {
    case 16: return launch_attn<T, 16, NW>(q, k, v, o, bh, a, stream);
    case 32: return launch_attn<T, 32, NW>(q, k, v, o, bh, a, stream);
    case 64: return launch_attn<T, 64, NW>(q, k, v, o, bh, a, stream);
    case 128: return launch_attn<T, 128, NW>(q, k, v, o, bh, a, stream);
    default: return -1;
  }
}

template <typename T>
int attn_entry(int d, const void* q, const void* k, const void* v, void* o,
               int bh, const AttnArgs& a, bool small_tile,
               cudaStream_t stream) {
  return small_tile ? dispatch_attn<T, 1>(d, q, k, v, o, bh, a, stream)
                    : dispatch_attn<T, 4>(d, q, k, v, o, bh, a, stream);
}

// the paged arguments shared by K3 and K3q
DecodeArgs paged_args(const int* tables, const int* pos, int h,
                      int num_blocks, int block_size, int max_blocks,
                      int64_t table_stride, const int64_t* s, float scale) {
  DecodeArgs a{};
  a.pos = pos;
  a.tables = tables;
  a.heads = h;
  a.limit = max_blocks * block_size;
  a.block_size = block_size;
  a.max_blocks = max_blocks;
  a.num_blocks = num_blocks;
  a.table_stride = table_stride;
  a.sqb = s[0];
  a.sqh = s[1];
  a.sk0 = s[2];
  a.sk1 = s[3];
  a.skh = s[4];
  a.sv0 = s[5];
  a.sv1 = s[6];
  a.svh = s[7];
  a.sob = s[8];
  a.soh = s[9];
  a.scale = scale;
  return a;
}

}  // namespace

extern "C" {

// q, k, v, o: (B, T, H, D); strides[12] = (b, t, h) element strides of
// q, k, v, o in that order.  dtype 0 = float32, 1 = bfloat16.  flags: bit
// 0 causal, bit 1 query tiles of 16 rows (one warp) instead of 64 (four
// warps), for grids too small to fill the card.  lse: NULL, or (B, H, T)
// fp32 contiguous, written with each row's logsumexp.
int bigdl_flash_attention(const void* q, const void* k, const void* v,
                          void* o, int dtype, int b, int t, int h, int d,
                          const int64_t* strides, int flags, float scale,
                          float* lse, void* stream) {
  AttnArgs a{};
  a.t_len = t;
  a.heads = h;
  a.causal = flags & 1;
  a.scale = scale;
  a.lse = lse;
  int64_t* dst[4] = {a.sq, a.sk, a.sv, a.so};
  for (int i = 0; i < 4; ++i)
    for (int j = 0; j < 3; ++j) dst[i][j] = strides[3 * i + j];
  const void* in[3] = {q, k, v};
  a.width = copy_width(in, 3, strides, 9, dtype == 0 ? 4 : 2);
  const bool small_tile = (flags >> 1) & 1;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return attn_entry<float>(d, q, k, v, o, b * h, a, small_tile, st);
  if (dtype == 1)
    return attn_entry<__nv_bfloat16>(d, q, k, v, o, b * h, a, small_tile,
                                     st);
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
  return decode_entry<false, false>(dtype, d, q, k, v, o, b, a,
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
  const DecodeArgs a = paged_args(tables, pos, h, num_blocks, block_size,
                                  max_blocks, table_stride, strides, scale);
  return decode_entry<true, false>(dtype, d, q, k_pool, v_pool, o, b, a,
                                   static_cast<cudaStream_t>(stream));
}

// K3q: as above with int8 pools (rows 16-byte aligned) and their fp32
// scales k_scale, v_scale (NB, bs, H, 1); o is fp32 whatever q's dtype.
// strides[16] = the ten of the fp path, then k_scale (block, row, h) and
// v_scale (block, row, h).
int bigdl_flash_paged_decode_attention_int8(
    const void* q, const void* k_pool, const void* v_pool,
    const float* k_scale, const float* v_scale, void* o, const int* tables,
    const int* pos, int dtype, int b, int h, int d, int num_blocks,
    int block_size, int max_blocks, int64_t table_stride,
    const int64_t* strides, float scale, void* stream) {
  DecodeArgs a = paged_args(tables, pos, h, num_blocks, block_size,
                            max_blocks, table_stride, strides, scale);
  a.k_scale = k_scale;
  a.v_scale = v_scale;
  a.sks0 = strides[10];
  a.sks1 = strides[11];
  a.sksh = strides[12];
  a.svs0 = strides[13];
  a.svs1 = strides[14];
  a.svsh = strides[15];
  return decode_entry<true, true>(dtype, d, q, k_pool, v_pool, o, b, a,
                                  static_cast<cudaStream_t>(stream));
}

}  // extern "C"

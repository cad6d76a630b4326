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
//    held in registers (re-read from shared memory for fp32 past D 64).  K
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
// K2 paged_decode_kernel<QUANT=false, PAGED=false> replaces
//    flash_decode_attention / _decode_kernel: one query row per (b, h)
//    against a contiguous (B, T, H, D) cache, masked at kpos <= pos[b].
//    It is K3's split-KV kernel below without the tables: position kp of
//    row b lies at b*sk0 + kp*sk1 + h*skh, so no table window is loaded
//    and no position is divided by a block size.  Bound: bytes, as K3.
// K3 paged_decode_kernel<QUANT=false, PAGED=true> replaces
//    flash_paged_decode_attention / _paged_decode_kernel (fp path): the
//    same function, with key position kp read from pool block tables[b,
//    kp / bs], row kp % bs, in place -- no per-head copy of the pool.
// K3q paged_decode_kernel<QUANT=true, PAGED=true> replaces the
//    quantized=True path of the same Pallas kernel: int8 K/V pools with
//    one fp32 scale per (position, head) vector, (NB, bs, H, 1); the
//    output is fp32 whatever q's dtype, as on the TPU.  No fp32 copy of
//    the pool ever exists.
//    Bound for all three: bytes.  A decode step does 4*D FLOPs per
//    2*D*elt bytes of K/V, far below the card's FLOP/byte balance, so the
//    floor is the K/V rows up to pos[b] read once at the memory rate:
//    2*H*D*4 bytes a visible position for fp32, 2*H*(D + 4) for int8
//    (3.76x fewer at D 64).
//    At the serving shapes (B 8, H 12, a few hundred positions a row) that
//    is a few microseconds, so the kernel's fixed cost (launch, ramp,
//    cluster barriers) and the latency of its longest chain of dependent
//    loads matter as much as the rate.
//    Design (split-KV inside a thread-block cluster):
//    - Grid: S x B*H blocks of 4 warps, flattened on x, in clusters of S
//      (S = 1..8, the portable cluster size, chosen by the wrapper from
//      B*H and the addressable length, ops/flash_attention.decode_splits:
//      about three blocks an SM, from the card's SM count).  The block of
//      rank r takes tiles r, r + S, r + 2S, ... of 32 visible positions,
//      so its first page is known before pos[b]: K3's window of table
//      entries (256 pages, moved on only where its tiles reach past it)
//      loads together with pos[b] and q (contiguous ranges would put
//      pos[b] at the head of every block's chain).  A rank with no
//      visible tile keeps the neutral partial (m = -inf, l = 0, acc = 0).
//    - Bytes in flight: each tile's K and V rows of one head (32 x D at a
//      stride of H*D*elt) are copied by cp.async, 16-byte pieces (8 for
//      bf16 rows, which are only 8-byte aligned), into a ring of 3 to 8
//      stages in 48 KB, so the next tiles load while this one is scored;
//      positions past pos[b] are zero-filled, never read.
//    - Scores: each warp owns 8 keys of a tile; up to 8 lanes share one K
//      row (16-byte shared-memory reads, conflict-free), each lane keeps
//      four partial sums against q held in registers, and a few xor
//      shuffles finish the dot product; scores come in log2 units
//      (exp2f).  The V pass reads the staged rows, each lane owning D/32
//      adjacent output columns (one vector read a row), with no per-key
//      shuffle.  CUDA cores suffice: tensor cores buy nothing for one
//      query row.
//    - K3q stages the int8 tile and its fp32 scales and converts int8 to
//      fp32 in registers by the exponent trick (i8x4_f32); the K scale
//      multiplies the finished dot product and the V scale is folded into
//      p, so the sums run in another order than the plain version's
//      payload * scale.
//    - Merge: the 4 warps' (m, l, acc) merge through shared memory into
//      the block's; once the cluster barrier's first phase shows every
//      block started, each block writes its partial into rank 0's shared
//      memory (distributed shared memory) and arrives on the second phase;
//      rank 0 waits for it, merges the partials in rank order and writes
//      out, while the other blocks leave.  One launch, no global
//      workspace, no atomics: the result is the same bit for bit from
//      call to call.
//    What bounds it at the serving shapes (B8 H12 D64, a few hundred
//    positions a row, K/V hot in L2) is latency, not bytes: on the H100
//    (tools/torch_decode_splits.py) a call whose rows hold one tile each
//    takes 4.4-5.6 us, an empty launch of the same grid 1.4-1.9 us of
//    it, and each further tile of a block 0.8 (int8) to 1.1 us (fp32),
//    so the longest row's tiles over S set the time.  More splits shorten
//    that chain until the blocks no longer fit the card at once (S = 5
//    at fp32, 48 KB of ring a block): decode_splits takes 4 at B8 H12.
//    K2 is bounded the same way: at the contiguous engine's B9 H12 (S 3,
//    the longest row 1024 positions) it takes 12.6 us, 3.8-4.4 us with
//    one tile a row (no table to load) and 23.4-24.3 us with every row
//    full (56.6 MB of fp32 K/V, 2.4 TB/s).
//
// Every kernel takes fp32 or bf16 queries (K2/K3 also K/V of that dtype),
// accumulates in fp32 and reads
// the (B, T, H, D) layout through strides (last dim contiguous), so the
// q/k/v views of a fused qkv projection need no copy.  The C entry points
// return the launch's CUDA error, 0 on success (or -1 for a head_dim or
// dtype that has no instantiation).

#include <cooperative_groups.h>

#include <type_traits>

#include "mma.cuh"

namespace cg = cooperative_groups;

namespace {

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
  // Q's fragments stay in registers for the whole walk, except fp32 past
  // D 64 (96 or 128 registers of hi/lo): re-read from shared memory there
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
// K2 / K3 / K3q: split-KV decode, the splits merged inside a cluster
// ------------------------------------------------------------------------
constexpr int kPgWarps = 4;
constexpr int kPgThreads = kPgWarps * 32;
constexpr int kPgTile = 32;                  // key positions a tile
constexpr int kPgKeys = kPgTile / kPgWarps;  // keys a warp owns in a tile
constexpr int kPgWindow = 256;               // table entries held at once
constexpr int kPgMaxSplits = 8;              // the portable cluster size
constexpr int kPgRingBytes = 49152;          // the ring of K/V stages

// K2 takes the same arguments: no tables, one "block" of T positions a
// row (block_size T, max_blocks 1), and K/V strides (row b, position,
// head) in place of (block, in-block row, head)
struct PagedArgs {
  const int* pos;        // (B,)
  const int* tables;     // (B, MB), row stride table_stride; paged only
  const float* k_scale;  // (NB, bs, H, 1) fp32; K3q only
  const float* v_scale;
  int heads, block_size, max_blocks, num_blocks, splits;
  int64_t table_stride;
  int64_t sqb, sqh;
  int64_t sk0, sk1, skh, sv0, sv1, svh;        // (block, in-block row, head)
  int64_t sks0, sks1, sksh, svs0, svs1, svsh;  // scales; K3q only
  int64_t sob, soh;
  float scale;
};

// K3q stores K/V as int8 and always writes fp32 (the TPU kernel's output
// dtype on the quantized path); K2/K3 read and write the input dtype
template <typename T, bool QUANT>
using DecKV = std::conditional_t<QUANT, int8_t, T>;
template <typename T, bool QUANT>
using DecOut = std::conditional_t<QUANT, float, T>;

// four int8 values (the bytes of w) as fp32 by the exponent trick: the
// float with bits 0x4B0000uu is 2^23 + uu, and uu = x + 128 is x's byte
// with its top bit flipped; cheaper than four conversions
__device__ __forceinline__ void i8x4_f32(uint32_t w, float* x, int n = 4) {
  const uint32_t u = w ^ 0x80808080u;
#pragma unroll
  for (int j = 0; j < 4; ++j)
    if (j < n)
      x[j] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7650 + j)) -
             8388736.f;
}

// 16 bytes of a staged row as fp32: 4 fp32, 8 bf16 or 16 int8 values
template <typename KV>
struct Vec16;
template <>
struct Vec16<float> {
  static constexpr int N = 4;
  static __device__ __forceinline__ void load(const float* p, float* x) {
    const float4 r = *reinterpret_cast<const float4*>(p);
    x[0] = r.x;
    x[1] = r.y;
    x[2] = r.z;
    x[3] = r.w;
  }
};
template <>
struct Vec16<__nv_bfloat16> {
  static constexpr int N = 8;
  static __device__ __forceinline__ void load(const __nv_bfloat16* p,
                                              float* x) {
    const uint4 r = *reinterpret_cast<const uint4*>(p);
    const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f =
          __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[i]));
      x[2 * i] = f.x;
      x[2 * i + 1] = f.y;
    }
  }
};
template <>
struct Vec16<int8_t> {
  static constexpr int N = 16;
  static __device__ __forceinline__ void load(const int8_t* p, float* x) {
    const uint4 r = *reinterpret_cast<const uint4*>(p);
    i8x4_f32(r.x, x);
    i8x4_f32(r.y, x + 4);
    i8x4_f32(r.z, x + 8);
    i8x4_f32(r.w, x + 12);
  }
};

// N consecutive staged elements (N-element aligned) as fp32: N = 1, 2 or 4
// as one load, any other N (3 at D 96) element by element
template <int N>
__device__ __forceinline__ void load_n(const float* p, float* x) {
  if constexpr (N == 4) {
    Vec16<float>::load(p, x);
  } else if constexpr (N == 2) {
    const float2 r = *reinterpret_cast<const float2*>(p);
    x[0] = r.x;
    x[1] = r.y;
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) x[i] = p[i];
  }
}
template <int N>
__device__ __forceinline__ void load_n(const __nv_bfloat16* p, float* x) {
  if constexpr (N % 2 != 0) {
#pragma unroll
    for (int i = 0; i < N; ++i) x[i] = __bfloat162float(p[i]);
  } else {
#pragma unroll
    for (int i = 0; i < N; i += 2) {
      const float2 f =
          __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p + i));
      x[i] = f.x;
      x[i + 1] = f.y;
    }
  }
}
template <int N>
__device__ __forceinline__ void load_n(const int8_t* p, float* x) {
  if constexpr (N == 4) {
    i8x4_f32(*reinterpret_cast<const uint32_t*>(p), x);
  } else if constexpr (N == 2) {
    i8x4_f32(*reinterpret_cast<const uint16_t*>(p), x, 2);
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i)
      i8x4_f32(*reinterpret_cast<const uint8_t*>(p + i), x + i, 1);
  }
}

// one stage of the ring: a K and a V tile, and for K3q their scales
template <typename KV, int D, bool QUANT>
constexpr int kPgStageBytes =
    2 * kPgTile * D * static_cast<int>(sizeof(KV)) +
    (QUANT ? 2 * kPgTile * 4 : 0);

// as many stages as kPgRingBytes holds, at least 3 and at most 8
template <typename KV, int D, bool QUANT>
constexpr int kPgStages =
    (kPgRingBytes / kPgStageBytes<KV, D, QUANT>) < 3   ? 3
    : (kPgRingBytes / kPgStageBytes<KV, D, QUANT>) > 8 ? 8
    : (kPgRingBytes / kPgStageBytes<KV, D, QUANT>);

// x / d for 0 <= x < 2^24 through a float reciprocal, corrected to exact
__device__ __forceinline__ int div_small(int x, int d, float inv_d) {
  int q = __float2int_rz(__int2float_rn(x) * inv_d);
  const int r = x - q * d;
  if (r >= d) ++q;
  else if (r < 0) --q;
  return q;
}

// the online softmax's rescaling in log2 units (scores times log2(e)),
// -inf-safe as rescale() in common.cuh
__device__ __forceinline__ float rescale2(float m, float safe_m) {
  return m == -INFINITY ? 0.f : exp2f(m - safe_m);
}

// the cluster barrier in its two halves (all threads of every block)
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_arrive_release() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait_acquire() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// PAGED = false is K2: position kp of row b at b*sk0 + kp*sk1 + h*skh,
// with no table window, no table load and no division by the block size
template <typename T, int D, bool QUANT, bool PAGED>
__global__ void __launch_bounds__(kPgThreads)
paged_decode_kernel(const T* __restrict__ q,
                    const DecKV<T, QUANT>* __restrict__ k,
                    const DecKV<T, QUANT>* __restrict__ v,
                    DecOut<T, QUANT>* __restrict__ o, PagedArgs a) {
  using KV = DecKV<T, QUANT>;
  using V16 = Vec16<KV>;
  constexpr int EPV = V16::N;           // elements a 16-byte vector
  constexpr int C = D / EPV;            // vectors a row
  // lanes that score one key: the largest divisor of both C and 32 up
  // to 8 (D 96 gives C = 24, 12, 6: LPK 8, 4, 2 for fp32, bf16, int8)
  constexpr int LPK = C % 8 == 0 ? 8 : C % 4 == 0 ? 4 : C % 2 == 0 ? 2 : 1;
  constexpr int VPL = C / LPK;          // vectors a lane reads of its key
  constexpr int KPP = 32 / LPK;         // keys a warp scores at once
  constexpr int DPL = (D + 31) / 32;    // output columns a lane, adjacent
                                        // (3 at D 96: loaded one by one)
  // bf16 rows are only 8-byte aligned (the wrapper checks 4 elements)
  constexpr int W = sizeof(KV) == 2 ? 8 : 16;  // bytes a cp.async
  constexpr int EPC = W / static_cast<int>(sizeof(KV));  // elements a copy
  constexpr int CPR = D / EPC;                           // copies a row
  constexpr int STAGES = kPgStages<KV, D, QUANT>;
  constexpr int TD = kPgTile * D;       // elements of a K (or V) tile
  static_assert(C >= 1 && C % LPK == 0 && D % EPC == 0, "row layout");
  static_assert(kPgTile + 1 <= kPgWindow, "a tile's pages fit the window");
  static_assert(PAGED || !QUANT, "int8 K/V come only from paged pools");

  extern __shared__ __align__(16) unsigned char smem_raw[];
  KV* ks = reinterpret_cast<KV*>(smem_raw);  // STAGES x kPgTile x D
  KV* vs = ks + STAGES * TD;                 // STAGES x kPgTile x D
  float* kss = reinterpret_cast<float*>(vs + STAGES * TD);  // K3q scales
  float* vss = kss + STAGES * kPgTile;
  __shared__ int pages[PAGED ? kPgWindow : 1];  // pool block ids, w0...
  __shared__ float sc[kPgWarps][kPgKeys];  // a warp's scores of a tile
  __shared__ float wm[kPgWarps], wl[kPgWarps];
  __shared__ float wacc[kPgWarps][D];
  // every split's partial, written into rank 0's copy by its owner
  __shared__ float part_m[kPgMaxSplits], part_l[kPgMaxSplits];
  __shared__ float part_acc[kPgMaxSplits][D];

  // this block has started: the barrier's first phase, waited for before
  // any block writes into rank 0's shared memory
  cluster_arrive_relaxed();
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int splits = a.splits;
  const int bh = blockIdx.x / splits;
  const int b = bh / a.heads, h = bh % a.heads;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int sub = lane % LPK;  // which vectors of its key row a lane reads
  const int bs = a.block_size;
  const float inv_bs = 1.f / static_cast<float>(bs);

  // rank r takes tiles r, r + S, r + 2S, ... of the visible ones: its
  // first page is known before pos[b], so the table and pos load together
  const int* trow = a.tables + b * a.table_stride;
  int w0 = 0;  // the window's first page
  auto load_window = [&](int first) {
    w0 = first;
    for (int i = tid; i < kPgWindow && w0 + i < a.max_blocks;
         i += kPgThreads)
      pages[i] = min(max(trow[w0 + i], 0), a.num_blocks - 1);
  };
  if constexpr (PAGED) load_window(div_small(rank * kPgTile, bs, inv_bs));
  // positions kpos <= pos[b] are visible
  const int n_vis = max(0, min(a.pos[b] + 1, a.max_blocks * bs));
  const int n_tiles = (n_vis + kPgTile - 1) / kPgTile;
  const int n_mine = rank < n_tiles ? (n_tiles - rank + splits - 1) / splits
                                    : 0;
  // q in registers, scaled so that scores come in log2 units: the
  // elements of this lane's vectors
  float qr[VPL][EPV];
  const T* qb = q + b * a.sqb + h * a.sqh;
  const float qscale = a.scale * kLog2e;
#pragma unroll
  for (int i = 0; i < VPL; ++i)
#pragma unroll
    for (int e = 0; e < EPV; ++e)
      qr[i][e] = to_f32(qb[(sub + LPK * i) * EPV + e]) * qscale;
  if constexpr (PAGED) __syncthreads();  // the window is in place
  // K2: this (b, h) row of the cache
  const KV* krow = k + (PAGED ? 0 : b * a.sk0 + h * a.skh);
  const KV* vrow = v + (PAGED ? 0 : b * a.sv0 + h * a.svh);

  // this rank's i-th tile into stage i % STAGES (zeros past n_vis), the
  // window moved on first where the tile's pages lie past it
  auto issue = [&](int i) {
    const int k0 = (rank + i * splits) * kPgTile;
    if constexpr (PAGED) {
      const int p0 = div_small(k0, bs, inv_bs);
      const int p1 = div_small(min(k0 + kPgTile, n_vis) - 1, bs, inv_bs);
      if (p1 - w0 >= kPgWindow) {  // block-uniform
        __syncthreads();
        load_window(p0);
        __syncthreads();
      }
    }
    const int st = i % STAGES;
    KV* kd = ks + st * TD;
    KV* vd = vs + st * TD;
    for (int x = tid; x < kPgTile * CPR; x += kPgThreads) {
      const int r = x / CPR, c = (x % CPR) * EPC, kp = k0 + r;
      const bool ok = kp < n_vis;
      const KV* kx = k;
      const KV* vx = v;
      if (ok) {
        if constexpr (PAGED) {
          const int pg = div_small(kp, bs, inv_bs);
          const int64_t blk = pages[pg - w0], off = kp - pg * bs;
          kx = k + blk * a.sk0 + off * a.sk1 + h * a.skh + c;
          vx = v + blk * a.sv0 + off * a.sv1 + h * a.svh + c;
        } else {
          kx = krow + kp * a.sk1 + c;
          vx = vrow + kp * a.sv1 + c;
        }
      }
      cp_async<W>(kd + r * D + c, kx, ok);
      cp_async<W>(vd + r * D + c, vx, ok);
    }
    if constexpr (QUANT) {
      for (int r = tid; r < kPgTile; r += kPgThreads) {
        const int kp = k0 + r;
        const bool ok = kp < n_vis;
        const float* kx = a.k_scale;
        const float* vx = a.v_scale;
        if (ok) {
          const int pg = div_small(kp, bs, inv_bs);
          const int64_t blk = pages[pg - w0], off = kp - pg * bs;
          kx += blk * a.sks0 + off * a.sks1 + h * a.sksh;
          vx += blk * a.svs0 + off * a.svs1 + h * a.svsh;
        }
        cp_async<4>(kss + st * kPgTile + r, kx, ok);
        cp_async<4>(vss + st * kPgTile + r, vx, ok);
      }
    }
  };

#pragma unroll 1
  for (int i = 0; i < STAGES - 1; ++i) {
    if (i < n_mine) issue(i);
    cp_async_commit();
  }

  float m = -INFINITY, l = 0.f, acc[DPL];
#pragma unroll
  for (int j = 0; j < DPL; ++j) acc[j] = 0.f;
  const int r0 = warp * kPgKeys;  // the warp's first key in a tile

  for (int i = 0; i < n_mine; ++i) {
    cp_async_wait<STAGES - 2>();
    // tile i has landed; every warp is done with tile i - 1, whose stage
    // the next copies overwrite
    __syncthreads();
    if (i + STAGES - 1 < n_mine) issue(i + STAGES - 1);
    cp_async_commit();

    const int st = i % STAGES, k0 = (rank + i * splits) * kPgTile;
    const KV* kt = ks + st * TD;
    const KV* vt = vs + st * TD;
    // scores of the warp's keys: LPK lanes a key, four partial sums a
    // lane, then xor shuffles
#pragma unroll
    for (int j0 = 0; j0 < kPgKeys; j0 += KPP) {
      const int j = j0 + lane / LPK;
      const bool act = j < kPgKeys;  // false only where KPP > kPgKeys
      float d4[4] = {0.f, 0.f, 0.f, 0.f};
      if (act) {
        const KV* kr = kt + (r0 + j) * D;
#pragma unroll
        for (int u = 0; u < VPL; ++u) {
          float x[EPV];
          V16::load(kr + (sub + LPK * u) * EPV, x);
#pragma unroll
          for (int e = 0; e < EPV; ++e)
            d4[e & 3] = fmaf(qr[u][e], x[e], d4[e & 3]);
        }
      }
      float dot = (d4[0] + d4[1]) + (d4[2] + d4[3]);
#pragma unroll
      for (int off = LPK / 2; off > 0; off >>= 1)
        dot += __shfl_xor_sync(kFull, dot, off);
      if (act && sub == 0) {
        if constexpr (QUANT) dot *= kss[st * kPgTile + r0 + j];
        sc[warp][j] = k0 + r0 + j < n_vis ? dot : -INFINITY;
      }
    }
    __syncwarp();
    float s[kPgKeys], tmax = -INFINITY;
#pragma unroll
    for (int j = 0; j < kPgKeys; ++j) {
      s[j] = sc[warp][j];
      tmax = fmaxf(tmax, s[j]);
    }
    const float new_m = fmaxf(m, tmax);
    const float sm = safe_max(new_m);
    const float corr = rescale2(m, sm);
    m = new_m;
    l *= corr;
#pragma unroll
    for (int jj = 0; jj < DPL; ++jj) acc[jj] *= corr;
    // the V pass over the staged rows, p (times K3q's V scale) per row,
    // each lane its DPL adjacent columns
#pragma unroll
    for (int j = 0; j < kPgKeys; ++j) {
      const float p = exp2f(s[j] - sm);  // 0 for a masked key
      l += p;
      float pv = p;
      if constexpr (QUANT) pv *= vss[st * kPgTile + r0 + j];
      if (lane * DPL < D) {
        float x[DPL];
        load_n<DPL>(vt + (r0 + j) * D + lane * DPL, x);
#pragma unroll
        for (int jj = 0; jj < DPL; ++jj) acc[jj] = fmaf(pv, x[jj], acc[jj]);
      }
    }
  }

  // the warps' partials into the block's, in warp order, written into
  // rank 0's shared memory once every block of the cluster has started
  if (lane == 0) {
    wm[warp] = m;
    wl[warp] = l;
  }
  if (lane * DPL < D) {
#pragma unroll
    for (int jj = 0; jj < DPL; ++jj) wacc[warp][lane * DPL + jj] = acc[jj];
  }
  __syncthreads();
  cluster_wait_acquire();
  if (tid < D) {
    float mg = -INFINITY;
#pragma unroll
    for (int w = 0; w < kPgWarps; ++w) mg = fmaxf(mg, wm[w]);
    const float sm = safe_max(mg);
    float lt = 0.f, at = 0.f;
#pragma unroll
    for (int w = 0; w < kPgWarps; ++w) {
      const float c = rescale2(wm[w], sm);
      lt += wl[w] * c;
      at += wacc[w][tid] * c;
    }
    cluster.map_shared_rank(&part_acc[rank][0], 0)[tid] = at;
    if (tid == 0) {
      *cluster.map_shared_rank(&part_m[rank], 0) = mg;
      *cluster.map_shared_rank(&part_l[rank], 0) = lt;
    }
  }
  cluster_arrive_release();
  if (rank != 0) return;  // its partial is in rank 0's shared memory
  cluster_wait_acquire();
  if (tid < D) {  // the splits' partials in rank order
    float mg = -INFINITY;
#pragma unroll
    for (int r = 0; r < kPgMaxSplits; ++r)
      if (r < splits) mg = fmaxf(mg, part_m[r]);
    const float sm = safe_max(mg);
    float lt = 0.f, at = 0.f;
#pragma unroll
    for (int r = 0; r < kPgMaxSplits; ++r) {
      if (r < splits) {
        const float c = rescale2(part_m[r], sm);
        lt += part_l[r] * c;
        at += part_acc[r][tid] * c;
      }
    }
    o[b * a.sob + h * a.soh + tid] =
        from_f32<DecOut<T, QUANT>>(at / fmaxf(lt, 1e-30f));
  }
}

template <typename T, int D, bool QUANT, bool PAGED>
int launch_paged(const void* q, const void* k, const void* v, void* o,
                 int batch, const PagedArgs& a, cudaStream_t stream) {
  using KV = DecKV<T, QUANT>;
  using O = DecOut<T, QUANT>;
  constexpr int smem =
      kPgStages<KV, D, QUANT> * kPgStageBytes<KV, D, QUANT>;
  auto kernel = paged_decode_kernel<T, D, QUANT, PAGED>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = a.splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(a.splits * batch * a.heads);
  cfg.blockDim = dim3(kPgThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, static_cast<const T*>(q),
                           static_cast<const KV*>(k),
                           static_cast<const KV*>(v), static_cast<O*>(o), a);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, bool QUANT, bool PAGED>
int dispatch_paged(int d, const void* q, const void* k, const void* v,
                   void* o, int batch, const PagedArgs& a,
                   cudaStream_t stream) {
  switch (d) {
    case 16:
      return launch_paged<T, 16, QUANT, PAGED>(q, k, v, o, batch, a, stream);
    case 32:
      return launch_paged<T, 32, QUANT, PAGED>(q, k, v, o, batch, a, stream);
    case 64:
      return launch_paged<T, 64, QUANT, PAGED>(q, k, v, o, batch, a, stream);
    case 96:
      return launch_paged<T, 96, QUANT, PAGED>(q, k, v, o, batch, a, stream);
    case 128:
      return launch_paged<T, 128, QUANT, PAGED>(q, k, v, o, batch, a,
                                                stream);
    default: return -1;
  }
}

// K2 is <QUANT=false, PAGED=false>, K3 <false, true>, K3q <true, true>
template <bool QUANT, bool PAGED>
int paged_entry(int dtype, int d, const void* q, const void* k,
                const void* v, void* o, int batch, const PagedArgs& a,
                cudaStream_t stream) {
  if (a.splits < 1 || a.splits > kPgMaxSplits)
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0)
    return dispatch_paged<float, QUANT, PAGED>(d, q, k, v, o, batch, a,
                                               stream);
  if (dtype == 1)
    return dispatch_paged<__nv_bfloat16, QUANT, PAGED>(d, q, k, v, o, batch,
                                                       a, stream);
  return -1;
}

// the fixed cost of a launch: a kernel that does nothing, in K2's or K3's
// grid
__global__ void empty_kernel() {}

template <typename T, int NW>
int dispatch_attn(int d, const void* q, const void* k, const void* v, void* o,
                  int bh, const AttnArgs& a, cudaStream_t stream) {
  switch (d) {
    case 16: return launch_attn<T, 16, NW>(q, k, v, o, bh, a, stream);
    case 32: return launch_attn<T, 32, NW>(q, k, v, o, bh, a, stream);
    case 64: return launch_attn<T, 64, NW>(q, k, v, o, bh, a, stream);
    case 96: return launch_attn<T, 96, NW>(q, k, v, o, bh, a, stream);
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

// the arguments shared by K2, K3 and K3q
PagedArgs paged_args(const int* tables, const int* pos, int h,
                     int num_blocks, int block_size, int max_blocks,
                     int64_t table_stride, const int64_t* s, float scale,
                     int splits) {
  PagedArgs a{};
  a.pos = pos;
  a.tables = tables;
  a.heads = h;
  a.block_size = block_size;
  a.max_blocks = max_blocks;
  a.num_blocks = num_blocks;
  a.splits = splits;
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
// splits: blocks (one cluster) a (b, h) row, 1 to 8.
int bigdl_flash_decode_attention(const void* q, const void* k, const void* v,
                                 void* o, const int* pos, int dtype, int b,
                                 int h, int d, int t, const int64_t* strides,
                                 float scale, int splits, void* stream) {
  // one block of T positions a row and no tables: see PagedArgs
  const PagedArgs a = paged_args(nullptr, pos, h, b, t, 1, 0, strides, scale,
                                 splits);
  return paged_entry<false, false>(dtype, d, q, k, v, o, b, a,
                                   static_cast<cudaStream_t>(stream));
}

// q, o: (B, 1, H, D); k_pool, v_pool: (NB, bs, H, D); tables: (B, MB)
// int32 with row stride table_stride; pos: (B,) int32.
// strides[10] = q (b, h), k (block, row, h), v (block, row, h), o (b, h).
// splits: blocks (one cluster) a (b, h) row, 1 to 8.
int bigdl_flash_paged_decode_attention(
    const void* q, const void* k_pool, const void* v_pool, void* o,
    const int* tables, const int* pos, int dtype, int b, int h, int d,
    int num_blocks, int block_size, int max_blocks, int64_t table_stride,
    const int64_t* strides, float scale, int splits, void* stream) {
  const PagedArgs a =
      paged_args(tables, pos, h, num_blocks, block_size, max_blocks,
                 table_stride, strides, scale, splits);
  return paged_entry<false, true>(dtype, d, q, k_pool, v_pool, o, b, a,
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
    const int64_t* strides, float scale, int splits, void* stream) {
  PagedArgs a = paged_args(tables, pos, h, num_blocks, block_size,
                           max_blocks, table_stride, strides, scale, splits);
  a.k_scale = k_scale;
  a.v_scale = v_scale;
  a.sks0 = strides[10];
  a.sks1 = strides[11];
  a.sksh = strides[12];
  a.svs0 = strides[13];
  a.svs1 = strides[14];
  a.svsh = strides[15];
  return paged_entry<true, true>(dtype, d, q, k_pool, v_pool, o, b, a,
                                 static_cast<cudaStream_t>(stream));
}

// An empty kernel launched as K2 and K3 are: clusters x splits blocks of
// their width in clusters of splits.  Timing it gives the fixed cost of
// such a launch, the floor under K2's, K3's and K3q's times.
int bigdl_empty_cluster_launch(int clusters, int splits, void* stream) {
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(clusters * splits);
  cfg.blockDim = dim3(kPgThreads);
  cfg.stream = static_cast<cudaStream_t>(stream);
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, empty_kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"

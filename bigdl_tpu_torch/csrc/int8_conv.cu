// K6: int8 convolution as an implicit GEMM on the s8 tensor cores.
//
// Replaces bigdl_tpu/nn/quantized.py:110 int8_conv, which the JAX package
// computes with lax.conv_general_dilated(..., preferred_element_type=
// jnp.int32): an XLA op, not a Pallas kernel.  PyTorch has no int8
// convolution on the card, so the port writes one.
//
// out[m, oc] = (float(acc[m, oc]) * (scale[oc] * x_scale) + bias[oc]), with
// acc the exact int32 sum of x_q (int8 NHWC) against the int8 weight,
// rounded like the plain version's separate tensor ops (__int2float_rn,
// __fmul_rn, __fadd_rn: no contraction to an FMA), then cast to fp32 or
// bf16.  As a GEMM per group: M = N * Ho * Wo output pixels, N = cout / g
// columns, K = kh * kw * cin / g in (ky, kx, c) order.  Out-of-window
// taps, stride, asymmetric pads (lo given, hi implied by Ho and Wo),
// dilation and groups are all in the gather of A.
//
// Two kernels, chosen by shape (never on a failure):
//
// int8_conv_wgmma_kernel (cin / g a multiple of 16: every ResNet-50
// convolution but the stem).  A block computes a 128 x BN tile (BN 64 for
// cout / g <= 64, else 128) with two warpgroups of 64 rows, in k-stages of
// 128 bytes through a ring of 3 stages (72 or 96 KB: 3 or 2 blocks an
// SM, which hide the gather's latency better than a deeper ring):
//   - B comes from the packed weight (ops/int8_conv.py pack_weight: per
//     group a (cout_pad, k_pad) K-contiguous matrix, zero-padded) by TMA,
//     one 128-byte x BN box a stage with the 128-byte swizzle; the tensor
//     map is encoded on the host at each call (cuTensorMapEncodeTiled,
//     reached through cudaGetDriverEntryPoint, so no -lcuda) and passed by
//     value, which a CUDA graph captures.
//   - A is the implicit im2col: a 16-byte run of k lies inside one tap, so
//     every thread gathers 4 runs a stage with cp.async (zeros where the
//     tap falls in the padding or past K), written in the same swizzle;
//     cp.async.mbarrier.arrive.noinc puts their completion on the stage's
//     mbarrier, beside the TMA bytes.
//   - wgmma m64n64k32 s32.s8.s8 (csrc/wgmma.cuh) reads both operands from
//     shared memory; one product group stays in flight while the ring is
//     refilled.  K <= 4608 at ResNet-50, so |acc| < 2^31: exact.
//   - The epilogue stages the tile in shared memory (rows padded by 8
//     floats: conflict-free) and writes 16-byte coalesced rows.
// int8_conv_gather_kernel (any other cin / g: the 7 x 7 stem, cin 3, K
// 147): mma.sync m16n8k32 in 128 x 64 tiles, a thread's A row gathered
// byte by byte through a per-block table of each k's place in the window
// (one shared-memory read and two compares a byte), the HWIO weight
// transposed in registers (__byte_perm).
//
// What bounds it on the H100: at ResNet-50's shapes the fp32 output (4
// bytes a pixel and channel against 1 byte in) is most of the bytes, and
// the bytes set the bound for every layer but the widest 3 x 3s.  The
// wgmma path keeps the tensor cores far from busy and spends its time on
// the gather (each input byte is read kh * kw times, from L2) and the
// output store.

#include "wgmma.cuh"

namespace {

struct ConvArgs {
  const int8_t* x;              // (n, h, w, c) int8
  const int8_t* w;              // (kh, kw, cin_g, cout) int8 (gather path)
  const float* scale;           // (cout,) fp32
  const float* x_scale;         // 0-d fp32, read on the device
  const float* bias;            // (cout,) fp32 or null
  void* out;                    // (n, ho, wo, cout) fp32 or bf16
  int n, h, w_in, c, ho, wo;
  int kh, kw, sh, sw, ph, pw, dh, dw;
  int groups, cin_g, cout, cout_g, k, m;
  int k_pad, cout_pad;          // the packed weight's (wgmma path)
  bool vec_out;                 // 4 consecutive outputs may go as one store
};

__device__ __forceinline__ void store_out(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_out(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}
__device__ __forceinline__ void store_out4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}
__device__ __forceinline__ void store_out4(__nv_bfloat16* p, float4 v) {
  __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y);
  __nv_bfloat162 hi = __floats2bfloat162_rn(v.z, v.w);
  uint2 u;
  u.x = *reinterpret_cast<uint32_t*>(&lo);
  u.y = *reinterpret_cast<uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(p) = u;
}

// the plain version's epilogue roundings, in its order
__device__ __forceinline__ float epilogue(int acc, float sc, const float* bias,
                                          int oc) {
  float v = __fmul_rn(__int2float_rn(acc), sc);
  if (bias != nullptr) v = __fadd_rn(v, bias[oc]);
  return v;
}

// --------------------------------------------------------------------------
// The wgmma path
// --------------------------------------------------------------------------

constexpr int WM = 128;          // block rows: two warpgroups of 64
constexpr int WK = 128;          // bytes of k a stage (one swizzle row)
constexpr int WNT = 256;         // threads
constexpr int A_STAGE = WM * WK;  // 16 KB

template <int BN>
struct WgmmaTile {
  static constexpr int STAGES = 3;
  static constexpr int B_STAGE = BN * WK;
  static constexpr int LDO = BN + 8;  // staged output row, floats
  static constexpr int SMEM = STAGES * (A_STAGE + B_STAGE) +
                              STAGES * 8 + 1024;  // + barriers, alignment
  static_assert(2 * 64 * LDO * 4 <= STAGES * (A_STAGE + B_STAGE),
                "the staged output fits in the ring");
};

template <int BN, typename OutT>
__global__ void __launch_bounds__(WNT, BN == 64 ? 3 : 2)
    int8_conv_wgmma_kernel(const __grid_constant__ CUtensorMap wmap,
                           const ConvArgs a) {
  using Tile = WgmmaTile<BN>;
  constexpr int STAGES = Tile::STAGES;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* As = smem;
  uint8_t* Bs = smem + STAGES * A_STAGE;
  uint64_t* full = reinterpret_cast<uint64_t*>(Bs + STAGES * Tile::B_STAGE);

  const int tid = threadIdx.x, wg = tid >> 7;
  const int m0 = blockIdx.x * WM, n0 = blockIdx.y * BN, grp = blockIdx.z;
  if (tid == 0) {
    // every thread's cp.async arrival, and thread 0's TMA arrival
#pragma unroll
    for (int s = 0; s < STAGES; ++s) mbar_init(&full[s], WNT + 1);
    mbar_init_fence();
  }
  __syncthreads();

  // this thread's gather: 16-byte chunk c of rows (tid >> 3) + 32 i
  const int c = tid & 7;
  const int swz = (c ^ ((tid >> 3) & 7)) << 4;  // the row's swizzled chunk
  int ih0[4], iw0[4];
  int64_t base[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int mg = m0 + (tid >> 3) + 32 * i;
    ih0[i] = -0x40000000;  // out of every window: a row past M
    iw0[i] = 0;
    base[i] = 0;
    if (mg < a.m) {
      const int hw = a.ho * a.wo;
      const int img = mg / hw, r = mg - img * hw;
      const int oh = r / a.wo, ow = r - oh * a.wo;
      ih0[i] = oh * a.sh - a.ph;
      iw0[i] = ow * a.sw - a.pw;
      base[i] = static_cast<int64_t>(img) * a.h * a.w_in * a.c +
                static_cast<int64_t>(grp) * a.cin_g;
    }
  }

  auto load = [&](int kt, int s) {
    if (tid == 0) {
      mbar_arrive_expect_tx(&full[s], Tile::B_STAGE);
      tma_load_2d(Bs + s * Tile::B_STAGE, &wmap, kt * WK,
                  grp * a.cout_pad + n0, &full[s]);
    }
    const int k0 = kt * WK + c * 16;
    const bool k_ok = k0 < a.k;
    const int tap = k0 / a.cin_g, ci = k0 - tap * a.cin_g;
    const int ky = tap / a.kw, kx = tap - ky * a.kw;
    uint8_t* dst = As + s * A_STAGE + (tid >> 3) * WK + swz;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int ih = ih0[i] + ky * a.dh, iw = iw0[i] + kx * a.dw;
      const bool ok = k_ok && ih >= 0 && ih < a.h && iw >= 0 && iw < a.w_in;
      const int8_t* src =
          ok ? a.x + base[i] + (static_cast<int64_t>(ih) * a.w_in + iw) * a.c +
                   ci
             : a.x;
      cp_async<16>(dst + 32 * i * WK, src, ok);
    }
    cp_async_mbar_arrive(&full[s]);
  };

  int acc[BN / 64][32];
#pragma unroll
  for (int j = 0; j < BN / 64; ++j)
#pragma unroll
    for (int e = 0; e < 32; ++e) acc[j][e] = 0;

  const int nk = a.k_pad / WK;
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s)
    if (s < nk) load(s, s);
  for (int kt = 0; kt < nk; ++kt) {
    const int s = kt % STAGES;
    mbar_wait(&full[s], (kt / STAGES) & 1);
    fence_proxy_async();
    const uint64_t da = sw128_desc(As + s * A_STAGE + wg * 64 * WK);
    const uint64_t db = sw128_desc(Bs + s * Tile::B_STAGE);
#pragma unroll
    for (int j = 0; j < BN / 64; ++j) fence_operands(acc[j], 32);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < WK / 32; ++kk)
#pragma unroll
      for (int j = 0; j < BN / 64; ++j)
        // +32 bytes a k32 step, +64 rows of 128 bytes a column half
        wgmma_m64n64k32_s8(acc[j], da + 2 * kk, db + 2 * kk + j * 512);
    wgmma_commit();
    // this thread's products of stage kt - 1 are done; after the barrier
    // everyone's are, so that stage's slot takes stage kt + STAGES - 1
    wgmma_wait<1>();
#pragma unroll
    for (int j = 0; j < BN / 64; ++j) fence_operands(acc[j], 32);
    __syncthreads();
    const int next = kt + STAGES - 1;
    if (next < nk) load(next, next % STAGES);
  }
  wgmma_wait<0>();
#pragma unroll
  for (int j = 0; j < BN / 64; ++j) fence_operands(acc[j], 32);
  __syncthreads();  // the ring is free: stage the output tile in it

  constexpr int LDO = Tile::LDO;
  float* stage = reinterpret_cast<float*>(smem) + wg * 64 * LDO;
  const float xs = *a.x_scale;
  const int lane = tid & 31, warp = (tid >> 5) & 3;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < BN / 64; ++j)
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const int col = j * 64 + q * 8 + 2 * t;
      const int oc0 = grp * a.cout_g + n0 + col;
      const bool ok0 = n0 + col < a.cout_g, ok1 = n0 + col + 1 < a.cout_g;
      const float sc0 = ok0 ? __fmul_rn(a.scale[oc0], xs) : 0.f;
      const float sc1 = ok1 ? __fmul_rn(a.scale[oc0 + 1], xs) : 0.f;
      const float* bias0 = ok0 ? a.bias : nullptr;
      const float* bias1 = ok1 ? a.bias : nullptr;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float2 v;
        v.x = epilogue(acc[j][q * 4 + h * 2], sc0, bias0, oc0);
        v.y = epilogue(acc[j][q * 4 + h * 2 + 1], sc1, bias1, oc0 + 1);
        *reinterpret_cast<float2*>(&stage[(warp * 16 + g + h * 8) * LDO +
                                          col]) = v;
      }
    }
  // the warpgroup's own 64 rows: a named barrier of its 128 threads
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
  OutT* out = static_cast<OutT*>(a.out);
  constexpr int CHUNKS = BN / 4;  // 4 outputs a store
  for (int idx = tid & 127; idx < 64 * CHUNKS; idx += 128) {
    const int row = idx / CHUNKS, col = (idx % CHUNKS) * 4;
    const int mg = m0 + wg * 64 + row;
    if (mg >= a.m || n0 + col >= a.cout_g) continue;
    const float4 v = *reinterpret_cast<const float4*>(&stage[row * LDO + col]);
    OutT* dst = out + static_cast<int64_t>(mg) * a.cout +
                static_cast<int64_t>(grp) * a.cout_g + n0 + col;
    if (a.vec_out && n0 + col + 4 <= a.cout_g) {
      store_out4(dst, v);
    } else {
      const float vs[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (n0 + col + e < a.cout_g) store_out(dst + e, vs[e]);
    }
  }
}

// cuTensorMapEncodeTiled, from the driver the runtime has loaded
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                     cudaEnableDefault, &q);
#else
    cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                            &q);
#endif
    if (q == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

template <int BN, typename OutT>
int launch_wgmma(const ConvArgs& a, const void* w_packed, cudaStream_t st) {
  using Tile = WgmmaTile<BN>;
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return -2;
  CUtensorMap map;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(a.k_pad),
                              static_cast<cuuint64_t>(a.groups) * a.cout_pad};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(a.k_pad)};
  const cuuint32_t box[2] = {WK, BN};
  const cuuint32_t elem[2] = {1, 1};
  if (encode(&map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2,
             const_cast<void*>(w_packed), dims, strides, box, elem,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return -3;
  auto kernel = int8_conv_wgmma_kernel<BN, OutT>;
  // the attribute is per device: set on every launch (a graph replay
  // makes no call)
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Tile::SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((a.m + WM - 1) / WM, a.cout_pad / BN, a.groups);
  kernel<<<grid, WNT, Tile::SMEM, st>>>(map, a);
  return static_cast<int>(cudaGetLastError());
}

// --------------------------------------------------------------------------
// The gather path (cin / g off the 16-byte runs)
// --------------------------------------------------------------------------

constexpr int BM = 128, BN_G = 64, BK = 32;
constexpr int NT = 128;         // 4 warps; BM == NT: a thread owns an A row
constexpr int LDS = BK + 16;    // bytes a shared row: 12 words, conflict-free

template <bool VEC_B, typename OutT>
__global__ void __launch_bounds__(NT)
    int8_conv_gather_kernel(const ConvArgs a) {
  __shared__ __align__(16) int8_t As[2][BM * LDS];
  __shared__ __align__(16) int8_t Bs[2][BN_G * LDS];
  extern __shared__ int4 ktab[];  // k -> (offset, dy, dx, 0)
  const int tid = threadIdx.x, warp = tid >> 5;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN_G, grp = blockIdx.z;
  const int wm = (warp >> 1) * 64, wn = (warp & 1) * 32;
  const int nk = (a.k + BK - 1) / BK;

  // every k's place in the window, shared by the block's rows: the
  // per-byte gather below reads it instead of stepping (ky, kx, c)
  for (int k = tid; k < nk * BK; k += NT) {
    int4 e = make_int4(0, 0x20000000, 0, 0);  // past K: never in bounds
    if (k < a.k) {
      const int tap = k / a.cin_g, ci = k - tap * a.cin_g;
      const int ky = tap / a.kw, kx = tap - ky * a.kw;
      e = make_int4((ky * a.dh * a.w_in + kx * a.dw) * a.c + ci, ky * a.dh,
                    kx * a.dw, 0);
    }
    ktab[k] = e;
  }

  // this thread's output pixel (A row), fixed over the K loop: its
  // window's origin (ih0, iw0) and the byte there
  const int mg = m0 + tid;
  int ih0 = -0x40000000, iw0 = 0;  // a row past M: never in bounds
  const int8_t* xpix = a.x;
  if (mg < a.m) {
    const int hw = a.ho * a.wo;
    const int img = mg / hw, r = mg - img * hw;
    const int oh = r / a.wo, ow = r - oh * a.wo;
    ih0 = oh * a.sh - a.ph;
    iw0 = ow * a.sw - a.pw;
    xpix = a.x + static_cast<int64_t>(img) * a.h * a.w_in * a.c +
           static_cast<int64_t>(grp) * a.cin_g +
           (static_cast<int64_t>(ih0) * a.w_in + iw0) * a.c;
  }
  // this thread's 4 x 4 block of the B tile: k rows 4kq.., columns 4nq..
  const int kq = tid & 7, nq = tid >> 3;
  const int8_t* wcol = a.w + static_cast<int64_t>(grp) * a.cout_g + n0 +
                       nq * 4;

  // the row gathered byte by byte, zeros past K and outside the window
  auto load_a = [&](int stage, int kt) {
    int8_t* dst = &As[stage][tid * LDS];
#pragma unroll 2
    for (int j = 0; j < BK; j += 4) {
      uint32_t word = 0;
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const int4 e = ktab[kt * BK + j + b];
        if (static_cast<unsigned>(ih0 + e.y) < static_cast<unsigned>(a.h) &&
            static_cast<unsigned>(iw0 + e.z) < static_cast<unsigned>(a.w_in))
          word |= static_cast<uint32_t>(static_cast<uint8_t>(xpix[e.x]))
                  << (8 * b);
      }
      *reinterpret_cast<uint32_t*>(dst + j) = word;
    }
  };

  auto load_b = [&](int kt, uint32_t* r) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int k = kt * BK + kq * 4 + i;
      const int8_t* src = wcol + static_cast<int64_t>(k) * a.cout;
      const int col = n0 + nq * 4;
      if constexpr (VEC_B) {
        r[i] = (k < a.k && col < a.cout_g)
                   ? *reinterpret_cast<const uint32_t*>(src)
                   : 0u;
      } else {
        uint32_t word = 0;
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (k < a.k && col + j < a.cout_g)
            word |= static_cast<uint32_t>(static_cast<uint8_t>(src[j]))
                    << (8 * j);
        r[i] = word;
      }
    }
  };

  auto store_b = [&](int stage, uint32_t* r) {
    transpose_bytes_4x4(r);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      *reinterpret_cast<uint32_t*>(&Bs[stage][(nq * 4 + j) * LDS + kq * 4]) =
          r[j];
  };

  int acc[4][4][4];
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0;

  uint32_t breg[4];
  __syncthreads();  // the k table
  load_a(0, 0);
  load_b(0, breg);
  store_b(0, breg);
  for (int kt = 0; kt < nk; ++kt) {
    const int s = kt & 1;
    const bool more = kt + 1 < nk;
    if (more) {
      load_a(s ^ 1, kt + 1);
      load_b(kt + 1, breg);
    }
    __syncthreads();
    uint32_t af[4][4], bf[4][2];
#pragma unroll
    for (int mi = 0; mi < 4; ++mi)
      MmaS8::load_a(af[mi], &As[s][(wm + mi * 16) * LDS], LDS);
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
      MmaS8::load_b_nk(bf[ni], &Bs[s][(wn + ni * 8) * LDS], LDS);
#pragma unroll
    for (int mi = 0; mi < 4; ++mi)
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) mma_s8(acc[mi][ni], af[mi], bf[ni]);
    if (more) store_b(s ^ 1, breg);
    __syncthreads();
  }

  const float xs = *a.x_scale;
  OutT* out = static_cast<OutT*>(a.out);
  const int g = lane_g(), t = lane_t();
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = m0 + wm + mi * 16 + g + half * 8;
      if (r >= a.m) continue;
      OutT* orow = out + static_cast<int64_t>(r) * a.cout +
                   static_cast<int64_t>(grp) * a.cout_g;
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = n0 + wn + ni * 8 + 2 * t + e;
          if (col >= a.cout_g) continue;
          const int oc = grp * a.cout_g + col;
          store_out(orow + col, epilogue(acc[mi][ni][half * 2 + e],
                                         __fmul_rn(a.scale[oc], xs), a.bias,
                                         oc));
        }
    }
}

template <typename OutT>
int launch_gather(const ConvArgs& a, bool vec_b, cudaStream_t st) {
  const dim3 grid((a.m + BM - 1) / BM, (a.cout_g + BN_G - 1) / BN_G,
                  a.groups);
  // the k table: one int4 a k of the padded K, beside the static As and
  // Bs (18 KB), so a table past 30 KB already needs the opt-in; the
  // attribute is per device: set on every launch
  const int table = (a.k + BK - 1) / BK * BK * static_cast<int>(sizeof(int4));
  auto kernel = vec_b ? int8_conv_gather_kernel<true, OutT>
                      : int8_conv_gather_kernel<false, OutT>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, table);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<grid, NT, table, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// the arguments both paths share; false on one the kernels do not take
bool conv_args(ConvArgs* a, const void* x, const float* scale,
               const float* x_scale, const float* bias, void* out, int n,
               int h, int w, int c, int ho, int wo, int kh, int kw, int sh,
               int sw, int ph, int pw, int dh, int dw, int groups, int cout) {
  if (groups < 1 || c % groups || cout % groups) return false;
  a->x = static_cast<const int8_t*>(x);
  a->w = nullptr;
  a->scale = scale;
  a->x_scale = x_scale;
  a->bias = bias;
  a->out = out;
  a->n = n, a->h = h, a->w_in = w, a->c = c, a->ho = ho, a->wo = wo;
  a->kh = kh, a->kw = kw, a->sh = sh, a->sw = sw, a->ph = ph, a->pw = pw;
  a->dh = dh, a->dw = dw, a->groups = groups;
  a->cin_g = c / groups, a->cout = cout, a->cout_g = cout / groups;
  a->k = kh * kw * a->cin_g;
  a->m = n * ho * wo;
  a->k_pad = 0, a->cout_pad = 0;
  a->vec_out = false;
  return true;
}

}  // namespace

extern "C" {

// The wgmma path.  x: (n, h, w, c) int8, contiguous, 16-byte aligned, with
// (c / groups) % 16 == 0; w_packed: (groups * cout_pad, k_pad) int8,
// contiguous, 16-byte aligned (ops/int8_conv.py pack_weight), cout_pad a
// multiple of the tile's 64 (cout / groups <= 64) or 128 columns and
// k_pad of 128; scale: (cout,) fp32; x_scale: 0-d fp32 (device); bias:
// (cout,) fp32 or null; out: (n, ho, wo, cout), out_dtype 0 = float32,
// 1 = bfloat16.  ph, pw: the low pads (the high pads are implied by ho,
// wo).  Returns the CUDA error of the launch (0 when it was taken), -1 on
// an argument the kernel does not take, -2 without the driver's
// cuTensorMapEncodeTiled, -3 when it refuses the weight's tensor map.
int bigdl_int8_conv_wgmma(const void* x, const void* w_packed, int k_pad,
                          int cout_pad, const float* scale,
                          const float* x_scale, const float* bias, void* out,
                          int out_dtype, int n, int h, int w, int c, int ho,
                          int wo, int kh, int kw, int sh, int sw, int ph,
                          int pw, int dh, int dw, int groups, int cout,
                          void* stream) {
  ConvArgs a;
  if (!conv_args(&a, x, scale, x_scale, bias, out, n, h, w, c, ho, wo, kh,
                 kw, sh, sw, ph, pw, dh, dw, groups, cout))
    return -1;
  const int bn = a.cout_g <= 64 ? 64 : 128;
  if (a.cin_g % 16 || reinterpret_cast<uintptr_t>(x) % 16 ||
      reinterpret_cast<uintptr_t>(w_packed) % 16 || k_pad % WK ||
      k_pad < a.k || cout_pad % bn || cout_pad < a.cout_g)
    return -1;
  a.k_pad = k_pad, a.cout_pad = cout_pad;
  if (a.m == 0 || a.cout_g == 0) return 0;
  const int align = out_dtype == 0 ? 16 : 8;
  a.vec_out = a.cout_g % 4 == 0 &&
              reinterpret_cast<uintptr_t>(out) % align == 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (out_dtype == 0)
    return bn == 64 ? launch_wgmma<64, float>(a, w_packed, st)
                    : launch_wgmma<128, float>(a, w_packed, st);
  if (out_dtype == 1)
    return bn == 64 ? launch_wgmma<64, __nv_bfloat16>(a, w_packed, st)
                    : launch_wgmma<128, __nv_bfloat16>(a, w_packed, st);
  return -1;
}

// The gather path.  As above, with wq: (kh, kw, c / groups, cout) int8,
// contiguous (HWIO), and any c / groups.
int bigdl_int8_conv(const void* x, const void* wq, const float* scale,
                    const float* x_scale, const float* bias, void* out,
                    int out_dtype, int n, int h, int w, int c, int ho, int wo,
                    int kh, int kw, int sh, int sw, int ph, int pw, int dh,
                    int dw, int groups, int cout, void* stream) {
  ConvArgs a;
  if (!conv_args(&a, x, scale, x_scale, bias, out, n, h, w, c, ho, wo, kh,
                 kw, sh, sw, ph, pw, dh, dw, groups, cout))
    return -1;
  a.w = static_cast<const int8_t*>(wq);
  if (a.m == 0 || a.cout_g == 0) return 0;
  const bool vec_b = a.cout_g % 4 == 0 && cout % 4 == 0 &&
                     reinterpret_cast<uintptr_t>(wq) % 4 == 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (out_dtype == 0) return launch_gather<float>(a, vec_b, st);
  if (out_dtype == 1) return launch_gather<__nv_bfloat16>(a, vec_b, st);
  return -1;
}

}  // extern "C"

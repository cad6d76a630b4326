// K6: int8 convolution as an implicit GEMM on the s8 tensor cores.
//
// Replaces bigdl_tpu/nn/quantized.py:110 int8_conv, which the JAX package
// computes with lax.conv_general_dilated(..., preferred_element_type=
// jnp.int32): an XLA op, not a Pallas kernel.  PyTorch has no int8
// convolution on the card, so the port writes one.
//
// out[m, oc] = (float(acc[m, oc]) * (scale[oc] * x_scale) + bias[oc]), with
// acc the exact int32 sum of x_q (int8 NHWC) against w_q (int8 HWIO,
// (kh, kw, cin/g, cout)), rounded like the plain version's separate tensor
// ops (__int2float_rn, __fmul_rn, __fadd_rn: no contraction to an FMA),
// then cast to fp32 or bf16.
//
// As a GEMM per group: M = N * Ho * Wo output pixels, N = cout / g columns,
// K = kh * kw * cin / g in (ky, kx, c) order, which is exactly the HWIO
// weight flattened to a K x cout matrix.  A block computes a 128 x 64 tile
// with 4 warps (2 x 2, 64 x 32 each) in k-steps of 32, double-buffered:
//   - A is gathered on the fly from the input window (implicit im2col):
//     each thread owns one output pixel (one row of the tile).  Where
//     cin / g is a multiple of 16, a 16-byte run of k lies inside one tap,
//     so each k-step is two 16-byte cp.async copies a thread, zeros where
//     the tap falls in the padding; otherwise (the 7 x 7 stem, cin 3,
//     K = 147) the row is gathered byte by byte, zeros past K.
//   - B (the weight) has cout contiguous, but the s8 mma wants B's rows
//     K-contiguous and ldmatrix .trans takes no 8-bit elements: each
//     thread loads a 4 (k) x 4 (n) byte block into registers, transposes
//     it with byte permutes and stores four 4-byte words [n][k].
//   - mma.sync m16n8k32 s8.s8.s32 (csrc/mma.cuh, MmaS8); shared rows are
//     48 bytes, so every fragment load is free of bank conflicts.
// Out-of-window taps, stride, asymmetric pads (lo given, hi implied by Ho
// and Wo), dilation and groups are all in the gather.
//
// What bounds it on the H100: at ResNet-50's shapes the fp32 output (4
// bytes a pixel and channel against 1 byte in) is most of the bytes, and
// the bytes set the bound for every layer but the widest 3 x 3s.  A simple
// first kernel: wgmma, TMA and a deeper pipeline wait for a later PR.

#include "mma.cuh"

namespace {

constexpr int BM = 128, BN = 64, BK = 32;
constexpr int NT = 128;         // 4 warps; BM == NT: a thread owns an A row
constexpr int LDS = BK + 16;    // bytes a shared row: 12 words, conflict-free

struct ConvArgs {
  const int8_t* x;              // (n, h, w, c) int8
  const int8_t* w;              // (kh, kw, cin_g, cout) int8
  const float* scale;           // (cout,) fp32
  const float* x_scale;         // 0-d fp32, read on the device
  const float* bias;            // (cout,) fp32 or null
  void* out;                    // (n, ho, wo, cout) fp32 or bf16
  int n, h, w_in, c, ho, wo;
  int kh, kw, sh, sw, ph, pw, dh, dw;
  int groups, cin_g, cout, cout_g, k, m;
};

__device__ __forceinline__ void store_out(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_out(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

template <bool VEC_A, bool VEC_B, typename OutT>
__global__ void __launch_bounds__(NT)
    int8_conv_kernel(const ConvArgs a) {
  __shared__ __align__(16) int8_t As[2][BM * LDS];
  __shared__ __align__(16) int8_t Bs[2][BN * LDS];
  const int tid = threadIdx.x, warp = tid >> 5;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN, grp = blockIdx.z;
  const int wm = (warp >> 1) * 64, wn = (warp & 1) * 32;

  // this thread's output pixel (A row), fixed over the K loop
  const int mg = m0 + tid;
  const bool row_ok = mg < a.m;
  int ih0 = 0, iw0 = 0;
  const int8_t* xrow = a.x;
  if (row_ok) {
    const int hw = a.ho * a.wo;
    const int img = mg / hw, r = mg - img * hw;
    const int oh = r / a.wo, ow = r - oh * a.wo;
    ih0 = oh * a.sh - a.ph;
    iw0 = ow * a.sw - a.pw;
    xrow = a.x + static_cast<int64_t>(img) * a.h * a.w_in * a.c +
           static_cast<int64_t>(grp) * a.cin_g;
  }
  // this thread's 4 x 4 block of the B tile: k rows 4kq.., columns 4nq..
  const int kq = tid & 7, nq = tid >> 3;
  const int8_t* wcol = a.w + static_cast<int64_t>(grp) * a.cout_g + n0 +
                       nq * 4;

  auto load_a = [&](int stage, int kt) {
    int8_t* dst = &As[stage][tid * LDS];
    if constexpr (VEC_A) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int k0 = kt * BK + half * 16;
        const int8_t* src = a.x;
        bool ok = row_ok && k0 < a.k;
        if (ok) {
          const int tap = k0 / a.cin_g, ci = k0 - tap * a.cin_g;
          const int ky = tap / a.kw, kx = tap - ky * a.kw;
          const int ih = ih0 + ky * a.dh, iw = iw0 + kx * a.dw;
          ok = ih >= 0 && ih < a.h && iw >= 0 && iw < a.w_in;
          if (ok)
            src = xrow + (static_cast<int64_t>(ih) * a.w_in + iw) * a.c + ci;
        }
        cp_async<16>(dst + half * 16, src, ok);
      }
    } else {
      int k = kt * BK;
      int tap = k / a.cin_g, ci = k - tap * a.cin_g;
      int ky = tap / a.kw, kx = tap - ky * a.kw;
#pragma unroll 1
      for (int j = 0; j < BK; j += 4) {
        uint32_t word = 0;
#pragma unroll
        for (int b = 0; b < 4; ++b, ++k) {
          if (row_ok && k < a.k) {
            const int ih = ih0 + ky * a.dh, iw = iw0 + kx * a.dw;
            if (ih >= 0 && ih < a.h && iw >= 0 && iw < a.w_in) {
              const int8_t v =
                  xrow[(static_cast<int64_t>(ih) * a.w_in + iw) * a.c + ci];
              word |= static_cast<uint32_t>(static_cast<uint8_t>(v))
                      << (8 * b);
            }
          }
          if (++ci == a.cin_g) {
            ci = 0;
            if (++kx == a.kw) {
              kx = 0;
              ++ky;
            }
          }
        }
        *reinterpret_cast<uint32_t*>(dst + j) = word;
      }
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

  const int nk = (a.k + BK - 1) / BK;
  uint32_t breg[4];
  load_a(0, 0);
  cp_async_commit();
  load_b(0, breg);
  store_b(0, breg);
  for (int kt = 0; kt < nk; ++kt) {
    const int s = kt & 1;
    const bool more = kt + 1 < nk;
    if (more) {
      load_a(s ^ 1, kt + 1);
      load_b(kt + 1, breg);
    }
    cp_async_commit();
    cp_async_wait<1>();
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

  // epilogue: the plain version's three roundings, in its order
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
          float v = __fmul_rn(__int2float_rn(acc[mi][ni][half * 2 + e]),
                              __fmul_rn(a.scale[oc], xs));
          if (a.bias != nullptr) v = __fadd_rn(v, a.bias[oc]);
          store_out(orow + col, v);
        }
    }
}

template <typename OutT>
int launch(const ConvArgs& a, bool vec_a, bool vec_b, cudaStream_t st) {
  const dim3 grid((a.m + BM - 1) / BM, (a.cout_g + BN - 1) / BN, a.groups);
  if (vec_a && vec_b)
    int8_conv_kernel<true, true, OutT><<<grid, NT, 0, st>>>(a);
  else if (vec_a)
    int8_conv_kernel<true, false, OutT><<<grid, NT, 0, st>>>(a);
  else if (vec_b)
    int8_conv_kernel<false, true, OutT><<<grid, NT, 0, st>>>(a);
  else
    int8_conv_kernel<false, false, OutT><<<grid, NT, 0, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// x: (n, h, w, c) int8, contiguous; wq: (kh, kw, c / groups, cout) int8,
// contiguous; scale: (cout,) fp32; x_scale: 0-d fp32 (device); bias: (cout,)
// fp32 or null; out: (n, ho, wo, cout), out_dtype 0 = float32, 1 =
// bfloat16.  ph, pw: the low pads (the high pads are implied by ho, wo).
// Returns the CUDA error of the launch (0 when it was taken), -1 on an
// argument the kernel does not take.
int bigdl_int8_conv(const void* x, const void* wq, const float* scale,
                    const float* x_scale, const float* bias, void* out,
                    int out_dtype, int n, int h, int w, int c, int ho, int wo,
                    int kh, int kw, int sh, int sw, int ph, int pw, int dh,
                    int dw, int groups, int cout, void* stream) {
  if (groups < 1 || c % groups || cout % groups) return -1;
  ConvArgs a;
  a.x = static_cast<const int8_t*>(x);
  a.w = static_cast<const int8_t*>(wq);
  a.scale = scale;
  a.x_scale = x_scale;
  a.bias = bias;
  a.out = out;
  a.n = n, a.h = h, a.w_in = w, a.c = c, a.ho = ho, a.wo = wo;
  a.kh = kh, a.kw = kw, a.sh = sh, a.sw = sw, a.ph = ph, a.pw = pw;
  a.dh = dh, a.dw = dw, a.groups = groups;
  a.cin_g = c / groups, a.cout = cout, a.cout_g = cout / groups;
  a.k = kh * kw * a.cin_g;
  a.m = n * ho * wo;
  if (a.m == 0 || a.cout_g == 0) return 0;
  const bool vec_a = a.cin_g % 16 == 0 &&
                     reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const bool vec_b = a.cout_g % 4 == 0 && cout % 4 == 0 &&
                     reinterpret_cast<uintptr_t>(wq) % 4 == 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (out_dtype == 0) return launch<float>(a, vec_a, vec_b, st);
  if (out_dtype == 1) return launch<__nv_bfloat16>(a, vec_a, vec_b, st);
  return -1;
}

}  // extern "C"

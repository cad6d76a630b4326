// Tensor-core building blocks of K1 and K1-bwd (flash_attention.cu,
// flash_attention_bwd.cu): cp.async tile copies and mma.sync fragments.
//
// fp32 inputs run on the TF32 tensor cores in the 3xTF32 split, which
// keeps fp32-level accuracy: x = hi + lo, each rounded to TF32 (10-bit
// mantissa, round to nearest, ties away: cvt.rna's rounding), and a.b ~ a_lo.b_hi + a_hi.b_lo + a_hi.b_hi
// (the dropped a_lo.b_lo is about 2^-22 of the product), three
// m16n8k8 products accumulated in fp32.  bf16 inputs take one m16n8k16
// product with fp32 accumulation.
//
// Fragment layouts (PTX ISA, per lane: g = lane / 4, t = lane % 4):
//   accumulator m16n8: c0 (g, 2t), c1 (g, 2t+1), c2 (g+8, 2t), c3 (g+8, 2t+1)
//   tf32 A m16k8:      a0 (g, t), a1 (g+8, t), a2 (g, t+4), a3 (g+8, t+4)
//   tf32 B k8n8:       b0 (t, g), b1 (t+4, g)
//   bf16 A m16k16:     a0 (g, 2t:2t+2), a1 (g+8, 2t:2t+2), a2 (g, 2t+8:2t+10),
//                      a3 (g+8, 2t+8:2t+10)
//   bf16 B k16n8:      b0 (2t:2t+2, g), b1 (2t+8:2t+10, g)
// An accumulator holds columns (2t, 2t+1) where a tf32 A fragment wants
// (t, t+4).  Rather than shuffle, a product that takes an accumulator as
// its A operand (P.V, and the backward's P^T.dO, dS^T.Q, dS.K) sums over
// its k in permuted order: k-slot t is column 2t and slot t+4 is column
// 2t+1, and its B fragment loads rows 2t and 2t+1 to match (load_b_kn).
// The sum is the same; only its order differs.
//
// Shared-memory rows are padded by 16 bytes (D + 4 fp32, D + 8 bf16):
// rows stay 16-byte aligned for cp.async, and a row stride of 4 (mod 32)
// banks makes every fragment load below free of bank conflicts.

#pragma once

#include <initializer_list>

#include "common.cuh"

namespace {

template <typename T, int D>
constexpr int kPadded = D + 16 / static_cast<int>(sizeof(T));

constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// ---- cp.async --------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// copy BYTES from global to shared memory, or zeros where !ok
template <int BYTES>
__device__ __forceinline__ void cp_async(void* dst, const void* src, bool ok) {
  const int n = ok ? BYTES : 0;
  if constexpr (BYTES == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                     smem_addr(dst)),
                 "l"(src), "r"(n));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(
                     smem_addr(dst)),
                 "l"(src), "n"(BYTES), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Rows [r0, r0 + ROWS) of one head's (t_len, D) view -- row t at
// src + t * stride, its D elements contiguous -- into dst (row stride LDS
// elements), zeros past t_len; WIDTH bytes a copy.
template <typename T, int D, int LDS, int ROWS, int NT, int WIDTH>
__device__ __forceinline__ void copy_rows_w(T* dst, const T* src,
                                            int64_t stride, int r0,
                                            int t_len) {
  constexpr int E = WIDTH / static_cast<int>(sizeof(T));  // elements a copy
  constexpr int CH = D / E;                               // copies a row
  for (int i = threadIdx.x; i < ROWS * CH; i += NT) {
    const int r = i / CH, c = (i % CH) * E, t = r0 + r;
    const bool ok = t < t_len;
    const T* s = ok ? src + t * stride + c : src;
    if constexpr (WIDTH == 2)
      dst[r * LDS + c] = ok ? *s : from_f32<T>(0.f);
    else
      cp_async<WIDTH>(dst + r * LDS + c, s, ok);
  }
}

// width: 16 (base and strides 16-byte aligned), 4, or 2 (a bf16 view
// that is only 2-byte aligned: plain loads, which cp.async has no size
// for); see copy_width
template <typename T, int D, int LDS, int ROWS, int NT>
__device__ __forceinline__ void copy_rows(T* dst, const T* src,
                                          int64_t stride, int r0, int t_len,
                                          int width) {
  if (width == 16) {
    copy_rows_w<T, D, LDS, ROWS, NT, 16>(dst, src, stride, r0, t_len);
  } else if constexpr (sizeof(T) == 4) {
    copy_rows_w<T, D, LDS, ROWS, NT, 4>(dst, src, stride, r0, t_len);
  } else if (width == 4) {
    copy_rows_w<T, D, LDS, ROWS, NT, 4>(dst, src, stride, r0, t_len);
  } else {
    copy_rows_w<T, D, LDS, ROWS, NT, 2>(dst, src, stride, r0, t_len);
  }
}

// Host side: the widest copy (16, 4 or 2 bytes) that every base address
// and every (b, t, h) stride of the views allows.
inline int copy_width(const void* const* ptrs, int n_ptrs,
                      const int64_t* strides, int n_strides, int elt_bytes) {
  for (int w : {16, 4}) {
    bool ok = true;
    for (int i = 0; i < n_ptrs; ++i)
      ok = ok && reinterpret_cast<uintptr_t>(ptrs[i]) % w == 0;
    for (int i = 0; i < n_strides; ++i)
      ok = ok && (strides[i] * elt_bytes) % w == 0;
    if (ok) return w;
  }
  return 2;
}

// ---- quad reductions (the 4 lanes that share an accumulator row) ----------

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(kFull, v, 1));
  return fmaxf(v, __shfl_xor_sync(kFull, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(kFull, v, 1);
  return v + __shfl_xor_sync(kFull, v, 2);
}

// ---- mma.sync ---------------------------------------------------------------

// x rounded to TF32, bit for bit what cvt.rna.tf32.f32 gives (round to
// nearest, ties away from zero: half an ulp of the 10-bit mantissa added
// to the magnitude bits, the 13 low bits dropped), on the integer pipe:
// the conversion instruction issues at a fraction of the ALU rate, and
// the split runs it twice for every element of every B fragment.
__device__ __forceinline__ uint32_t to_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

__device__ __forceinline__ void mma_tf32(float* c, const uint32_t* a,
                                         const uint32_t* b) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a,
                                         const uint32_t* b) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ int lane_g() { return (threadIdx.x & 31) >> 2; }
__device__ __forceinline__ int lane_t() { return threadIdx.x & 3; }

// One warp's operands for its products, by input type.  Pointers name
// the tile's first row and first k (or n) column in shared memory; ld is
// the row stride in elements.
//   load_a(s, ld):    A[r][k] = s[r * ld + k]          (rows are M)
//   load_b_nk(s, ld): B[k][n] = s[n * ld + k]          (rows are N: K of Q.K^T)
//   load_b_kn(s, ld): B[k][n] = s[k * ld + n]          (rows are K: V of P.V),
//                     k in the order acc_a sums it
//   acc_a(c, kk):     A from accumulator tiles c[][4], k-step kk
template <typename T>
struct Mma;

template <>
struct Mma<float> {
  static constexpr int K = 8;  // depth of one product
  struct A {
    uint32_t hi[4], lo[4];
  };
  struct B {
    uint32_t hi[2], lo[2];
  };

  static __device__ __forceinline__ void split(float x, uint32_t& hi,
                                               uint32_t& lo) {
    hi = to_tf32(x);
    lo = to_tf32(x - __uint_as_float(hi));
  }
  static __device__ __forceinline__ A make_a(float a0, float a1, float a2,
                                             float a3) {
    A a;
    split(a0, a.hi[0], a.lo[0]);
    split(a1, a.hi[1], a.lo[1]);
    split(a2, a.hi[2], a.lo[2]);
    split(a3, a.hi[3], a.lo[3]);
    return a;
  }
  static __device__ __forceinline__ B make_b(float b0, float b1) {
    B b;
    split(b0, b.hi[0], b.lo[0]);
    split(b1, b.hi[1], b.lo[1]);
    return b;
  }
  static __device__ __forceinline__ A load_a(const float* s, int ld) {
    const int g = lane_g(), t = lane_t();
    return make_a(s[g * ld + t], s[(g + 8) * ld + t], s[g * ld + t + 4],
                  s[(g + 8) * ld + t + 4]);
  }
  static __device__ __forceinline__ B load_b_nk(const float* s, int ld) {
    const int g = lane_g(), t = lane_t();
    return make_b(s[g * ld + t], s[g * ld + t + 4]);
  }
  // k-slot t is row 2t, slot t + 4 is row 2t + 1
  static __device__ __forceinline__ B load_b_kn(const float* s, int ld) {
    const int g = lane_g(), t = lane_t();
    return make_b(s[2 * t * ld + g], s[(2 * t + 1) * ld + g]);
  }
  // n-tile kk's columns (2t, 2t+1) as k-slots (t, t+4)
  static __device__ __forceinline__ A acc_a(const float (*c)[4], int kk) {
    return make_a(c[kk][0], c[kk][2], c[kk][1], c[kk][3]);
  }
  static __device__ __forceinline__ void mma(float* c, const A& a,
                                             const B& b) {
    mma_tf32(c, a.lo, b.hi);
    mma_tf32(c, a.hi, b.lo);
    mma_tf32(c, a.hi, b.hi);
  }
};

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t pack_bf16(__nv_bfloat16 lo,
                                              __nv_bfloat16 hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(lo)) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(hi)) << 16);
}

template <>
struct Mma<__nv_bfloat16> {
  using bf = __nv_bfloat16;
  static constexpr int K = 16;
  struct A {
    uint32_t r[4];
  };
  struct B {
    uint32_t r[2];
  };

  static __device__ __forceinline__ uint32_t pair(const bf* p) {
    return *reinterpret_cast<const uint32_t*>(p);
  }
  static __device__ __forceinline__ A load_a(const bf* s, int ld) {
    const int g = lane_g(), t = lane_t();
    return A{{pair(s + g * ld + 2 * t), pair(s + (g + 8) * ld + 2 * t),
              pair(s + g * ld + 2 * t + 8),
              pair(s + (g + 8) * ld + 2 * t + 8)}};
  }
  static __device__ __forceinline__ B load_b_nk(const bf* s, int ld) {
    const int g = lane_g(), t = lane_t();
    return B{{pair(s + g * ld + 2 * t), pair(s + g * ld + 2 * t + 8)}};
  }
  static __device__ __forceinline__ B load_b_kn(const bf* s, int ld) {
    const int g = lane_g(), t = lane_t();
    const bf* p = s + 2 * t * ld + g;
    return B{{pack_bf16(p[0], p[ld]), pack_bf16(p[8 * ld], p[9 * ld])}};
  }
  // n-tiles 2kk and 2kk + 1 as the 16 k of one product
  static __device__ __forceinline__ A acc_a(const float (*c)[4], int kk) {
    const float* x = c[2 * kk];
    const float* y = c[2 * kk + 1];
    return A{{pack_bf16(x[0], x[1]), pack_bf16(x[2], x[3]),
              pack_bf16(y[0], y[1]), pack_bf16(y[2], y[3])}};
  }
  static __device__ __forceinline__ void mma(float* c, const A& a,
                                             const B& b) {
    mma_bf16(c, a.r, b.r);
  }
};

}  // namespace

// Helpers shared by the port's CUDA kernels: dtype conversion and rounding,
// the sigmoid, mma.sync and ldmatrix, the bf16 hi/lo splits of fp32 values, and the
// counter-based Philox4x32-10 generator that dropout draws its bits from.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace port {

__host__ __device__ inline int round_up(int x, int m) { return (x + m - 1) / m * m; }
__host__ __device__ inline int imax(int a, int b) { return a > b ? a : b; }
__host__ __device__ inline int imin(int a, int b) { return a < b ? a : b; }

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// Round an fp32 value to T's precision (round to nearest even), kept fp32.
template <typename T>
__device__ __forceinline__ float rnd(float x) {
  return to_f(from_f<T>(x));
}

__device__ __forceinline__ float sigmoid(float z) {
  return __fdividef(1.f, 1.f + __expf(-z));
}

// a and b rounded to bf16 (round to nearest even), kept fp32: one
// conversion of the pair, and each half back by a shift or a mask.
__device__ __forceinline__ void round_bf16x2(float& a, float& b) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(a, b);
  const uint32_t u = *reinterpret_cast<const uint32_t*>(&v);
  a = __uint_as_float(u << 16);
  b = __uint_as_float(u & 0xffff0000u);
}

// softplus(x) = max(x, 0) + log1p(exp(-|x|))
__device__ __forceinline__ float softplus(float x) {
  return fmaxf(x, 0.f) + log1pf(expf(-fabsf(x)));
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// (x0, x1) as two bf16 pairs packed a word each: hi = x rounded to bf16,
// lo = x - hi (exact in fp32) rounded to bf16. hi + lo carries x to within
// about 2^-17 of |x|; a product of two such pairs in three bf16 products
// (lo hi + hi lo + hi hi, lo lo dropped) to about 2^-16 of |a||b|.
__device__ __forceinline__ void split_bf16x2(float x0, float x1, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h);
  const __nv_bfloat162 l = __floats2bfloat162_rn(x0 - hf.x, x1 - hf.y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

// (x0, x1) as three bf16 pairs, hi + mid + lo = x exactly: hi = x rounded
// to bf16, mid = (x - hi) rounded, lo = x - hi - mid (each difference exact
// in fp32, the last within bf16's 8 bits). A product of such an x with a
// bf16 value in three bf16 products is the fp32 product.
__device__ __forceinline__ void split3_bf16x2(float x0, float x1, uint32_t& hi, uint32_t& mid,
                                              uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h);
  const float r0 = x0 - hf.x, r1 = x1 - hf.y;
  const __nv_bfloat162 m = __floats2bfloat162_rn(r0, r1);
  const float2 mf = __bfloat1622float2(m);
  const __nv_bfloat162 l = __floats2bfloat162_rn(r0 - mf.x, r1 - mf.y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  mid = *reinterpret_cast<const uint32_t*>(&m);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

// Four 8x8 bf16 matrices from shared memory into mma fragments: lane i
// gives the address of row i % 8 of matrix i / 8 (16 bytes, 16-byte
// aligned); r[m] receives matrix m, as (row lane / 4, columns 2 (lane % 4)
// and +1), or with `trans` as (rows 2 (lane % 4) and +1, column lane / 4).
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* row_ptr) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(row_ptr));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* row_ptr) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(row_ptr));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

// Philox4x32-10 (Salmon et al., SC'11; the Random123 constants), first
// output word. Counter (c0, c1, c2, c3), key (k0, k1). Ten rounds, the key
// bumped before every round but the first.
__device__ __forceinline__ uint32_t philox_word0(uint32_t c0, uint32_t c1,
                                                 uint32_t c2, uint32_t c3,
                                                 uint32_t k0, uint32_t k1) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r) {
      k0 += 0x9E3779B9u;
      k1 += 0xBB67AE85u;
    }
    const uint32_t lo0 = 0xD2511F53u * c0, hi0 = __umulhi(0xD2511F53u, c0);
    const uint32_t lo1 = 0xCD9E8D57u * c2, hi1 = __umulhi(0xCD9E8D57u, c2);
    const uint32_t n0 = hi1 ^ c1 ^ k0, n2 = hi0 ^ c3 ^ k1;
    c0 = n0;
    c1 = lo1;
    c2 = n2;
    c3 = lo0;
  }
  return c0;
}

// Dropout of the attention's modulated probs: entry (b, h, i, j) is kept
// where the Philox word of counter (j, i, h, b) under key (seed_lo, seed_hi)
// is below `thresh` = min(floor((1 - p) 2^32), 2^32 - 1), and then scaled by
// 1/(1-p). A pure function of (seed, b, h, i, j): the forward, the backward
// and the plain version regenerate the same mask whatever the launch shape.
struct Dropout {
  uint32_t k0, k1, thresh;
  float scale;
  int on;
  __device__ __forceinline__ float factor(int b, int h, int i, int j) const {
    return philox_word0((uint32_t)j, (uint32_t)i, (uint32_t)h, (uint32_t)b, k0, k1) < thresh
               ? scale : 0.f;
  }
};

__device__ __forceinline__ Dropout make_dropout(const long long* seed, unsigned thresh,
                                                float scale) {
  Dropout d;
  d.on = seed != nullptr;
  const unsigned long long s = d.on ? (unsigned long long)*seed : 0ull;
  d.k0 = (uint32_t)s;
  d.k1 = (uint32_t)(s >> 32);
  d.thresh = thresh;
  d.scale = scale;
  return d;
}

}  // namespace port

// Hopper (sm_90a) building blocks shared by the flash attention, catalog
// NLL and MAU backward kernels: mbarriers, TMA copies and reductions, wgmma with its shared
// memory descriptors, and the lookup of the tensor-map encoder in libcuda.
#pragma once

#include <cuda.h>  // CUtensorMap; the encoder is looked up in libcuda at run time

#include "common.cuh"

namespace port {

constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// 2^x on the special-function unit (2^-inf = 0 exactly).
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ void mbar_arrive_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// Waits until the phase of parity `parity` of the barrier has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done)
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
}

// Makes the barrier inits visible to the async proxy (TMA).
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// Generic-proxy writes to shared memory, visible to wgmma and TMA.
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Named barrier `id` over `count` threads (a multiple of 32).
__device__ __forceinline__ void named_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

// Hands registers between warpgroups: every warp of a warpgroup executes it.
template <int N>
__device__ __forceinline__ void regs_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}
template <int N>
__device__ __forceinline__ void regs_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

// The (rows x cols) box at (c0, r0) of a 2-D map into dst.
__device__ __forceinline__ void tma_2d(void* dst, const CUtensorMap* map, uint64_t* bar, int c0,
                                       int r0) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(r0)
      : "memory");
}

// The box at row t0, column c0 of head (b, h) of a 4-D (cols, T, H, B) map
// into dst.
__device__ __forceinline__ void tma_rows(void* dst, const CUtensorMap* map, uint64_t* bar, int t0,
                                         int h, int b, int c0 = 0) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(t0), "r"(h), "r"(b)
      : "memory");
}

// Adds the (64 rows x 32) fp32 box src to the rows [t0, t0 + 64), columns
// [c0, c0 + 32) of head (b, h) of a map, in the L2 (rows past the map's end
// are dropped); completes as a bulk group of the issuing thread.
__device__ __forceinline__ void tma_reduce_add(const CUtensorMap* map, const void* src, int c0,
                                               int t0, int h, int b) {
  asm volatile(
      "cp.reduce.async.bulk.tensor.4d.global.shared::cta.add.bulk_group"
      " [%0, {%2, %3, %4, %5}], [%1];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(smem_u32(src)), "r"(c0), "r"(t0), "r"(h), "r"(b)
      : "memory");
}

// Adds the fp32 box src to the box at (c0, r0) of a 2-D map, in the L2
// (entries past the map's dims are dropped); completes as a bulk group of
// the issuing thread.
__device__ __forceinline__ void tma_reduce_add_2d(const CUtensorMap* map, const void* src, int c0,
                                                  int r0) {
  asm volatile(
      "cp.reduce.async.bulk.tensor.2d.global.shared::cta.add.bulk_group"
      " [%0, {%2, %3}], [%1];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(smem_u32(src)), "r"(c0), "r"(r0)
      : "memory");
}

// wgmma descriptor of a 1024-byte-aligned (64 x 64) bf16 tile in the
// 128-byte swizzle: 8-row groups 1024 bytes apart. As a K-major operand a
// 16-wide k step adds 32 bytes (2 in the descriptor's units); as an
// MN-major one it adds 16 rows, 2048 bytes (128); the next (64 x 64) tile
// of a wider operand stored tile after tile is 8 KB (512) further.
__device__ __forceinline__ uint64_t sw128_desc(const void* tile) {
  return (uint64_t)((smem_u32(tile) & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// Waits until at most N committed groups of the warpgroup are pending.
template <int N>
__device__ __forceinline__ void wg_wait_n() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving accesses of d across a wgmma wait.
template <int N>
__device__ __forceinline__ void reg_fence(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

#define WG_D16                                                                              \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}"
#define WG_ACC16(d)                                                                          \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),       \
      "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), \
      "+f"(d[14]), "+f"(d[15])
#define WG_D32                                                                              \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, " \
  "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"
#define WG_ACC(d)                                                                            \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),       \
      "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), \
      "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),          \
      "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),          \
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])

// d (64 x 64) (+)= A (64 x 16) B (16 x 64), both from shared memory; TA / TB
// 1 where the operand is MN-major. Accumulates where acc != 0. Accumulator
// layout: the thread (warp w of the warpgroup, lane g * 4 + t4) holds rows
// 16 w + g (+ 8) and columns 8 n + 2 t4 (+ 1) at d[4 n + 2 hr + c].
template <int TA, int TB>
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " WG_D32
      ", %32, %33, p, 1, 1, %35, %36;\n}\n"
      : WG_ACC(d)
      : "l"(da), "l"(db), "r"(acc), "n"(TA), "n"(TB));
}

// d (64 x 32) (+)= A (64 x 16) B (16 x 32), both K-major from shared memory.
__device__ __forceinline__ void wgmma_ss_n32(float (&d)[16], uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 " WG_D16
      ", %16, %17, p, 1, 1, 0, 0;\n}\n"
      : WG_ACC16(d)
      : "l"(da), "l"(db), "r"(acc));
}

#define WG_D64                                                                              \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, " \
  "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "  \
  "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, "  \
  "%53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}"
#define WG_ACC64(d)                                                                          \
  WG_ACC(d), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),   \
      "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),          \
      "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),          \
      "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),          \
      "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]),          \
      "+f"(d[62]), "+f"(d[63])

// d (64 x 128) (+)= A (64 x 16) B (16 x 128), both K-major from shared
// memory (B: 128 rows of 128 bytes in the 128-byte swizzle, 8-row groups
// 1024 bytes apart). Accumulator layout as wgmma_ss, n < 16.
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da, uint64_t db,
                                              int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " WG_D64
      ", %64, %65, p, 1, 1, 0, 0;\n}\n"
      : WG_ACC64(d)
      : "l"(da), "l"(db), "r"(acc));
}

// d (64 x 64) += A (64 x 16) B (16 x 64), A from registers (the mma A
// fragment layout of the warp's 16 rows), B from shared memory, MN-major
// (TB = 1) or K-major (TB = 0).
template <int TB = 1>
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t* a, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " WG_D32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
      : WG_ACC(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1), "n"(TB));
}

// d += A B in three bf16 products of a hi/lo split (split_bf16x2): lo hi +
// hi lo + hi hi, summed in fp32 (about 2^-16 of |a||b| a term; one TF32
// pass keeps 2^-11). A's hi/lo fragments from registers, B's hi/lo tiles by
// descriptor; TB as wgmma_rs.
template <int TB>
__device__ __forceinline__ void wgmma_rs_x3(float (&d)[32], const uint32_t* a_hi,
                                            const uint32_t* a_lo, uint64_t b_hi,
                                            uint64_t b_lo) {
  wgmma_rs<TB>(d, a_lo, b_hi);
  wgmma_rs<TB>(d, a_hi, b_lo);
  wgmma_rs<TB>(d, a_hi, b_hi);
}

// ---------------------------------------------------------------- host

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up in libcuda at run time (the libraries
// link only the CUDA runtime).
inline EncodeTiled tensor_map_encoder() {
  static const EncodeTiled fn = [] {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult found;
    return cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &f, cudaEnableDefault, &found) ==
                       cudaSuccess &&
                   found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(f)
               : nullptr;
  }();
  return fn;
}

// A TMA map of `rank` dims (dims[0] contiguous; strides of dims 1.. in
// bytes), boxes of `box`, 128-byte swizzle, zeros read (and nothing
// written) outside the dims.
inline bool encode_map(CUtensorMap* map, CUtensorMapDataType type, int rank, const void* ptr,
                       const cuuint64_t* dims, const cuuint64_t* strides, const cuuint32_t* box) {
  const EncodeTiled encode = tensor_map_encoder();
  if (!encode) return false;
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return encode(map, type, rank, const_cast<void*>(ptr), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace port

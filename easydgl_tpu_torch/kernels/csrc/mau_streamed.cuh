// What the streamed MAU/BiMAU kernels share, forward (mau_streamed_fwd.cu)
// and backward (mau_streamed_bwd.cu): the tile sizes, the key flags and
// masked logits of the blocked plain version, the causal tile rule and the
// launcher.
#pragma once

#include "common.cuh"

namespace {

using namespace port;

constexpr int kThreads = 256;
constexpr int BQ = 64;                  // queries a tile
constexpr int BK = 64;                  // keys a tile
constexpr int LD = 68;                  // row stride of the 64-wide tiles
constexpr float kNeg = -4294967295.0f;  // -(2^32) + 1, the reference mask
constexpr float kPadNeg = -1.0e38f;     // the running max before any key
constexpr size_t kMaxSmem = 232448;     // 227 KB, opt-in per block

struct Seq {
  const void* p;
  long long bs, rs;  // batch and row strides, in elements
};

template <int N>
__device__ __forceinline__ void lds(const float* p, float (&o)[N]) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int i = 0; i < N; i += 4) {
      const float4 v = *reinterpret_cast<const float4*>(p + i);
      o[i] = v.x; o[i + 1] = v.y; o[i + 2] = v.z; o[i + 3] = v.w;
    }
  } else if constexpr (N == 2) {
    const float2 v = *reinterpret_cast<const float2*>(p);
    o[0] = v.x; o[1] = v.y;
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) o[i] = p[i];
  }
}

// Number of key tiles the query tile [q0, q0 + 64) visits: under causal,
// tiles after the tile's last query are skipped, unless no real key lies at
// or before q0 (then a row of the tile may see no key at all, and such a row
// is uniform over every real key, as in the plain version). Every thread of
// the block must call it.
__device__ __forceinline__ int key_tiles(const float* km_row, int Tq, int Tk, int q0,
                                         int causal) {
  const int all = (Tk + BK - 1) / BK;
  if (!causal) return all;
  int seen = 0;
  for (int j = threadIdx.x; j <= imin(q0, Tk - 1); j += blockDim.x) seen |= km_row[j] > 0.f;
  if (!__syncthreads_or(seen)) return all;
  const int q_last = imin(q0 + BQ, Tq) - 1;
  return imin(all, q_last / BK + 1);
}

// Key j of a tile, from its raw mask entry km: 1 where it is real and not
// masked (mask > 0, as the plain version), 0 where it is real and masked, -1
// past Tk (alignment padding).
__device__ __forceinline__ float flag_of(float km, int j, int Tk) {
  return j < Tk ? (km > 0.f ? 1.f : 0.f) : -1.f;
}

__device__ __forceinline__ float key_flag(const float* km_row, int j, int Tk) {
  return flag_of(j < Tk ? km_row[j] : 0.f, j, Tk);
}

// The logit of entry (i, j) from the raw dot product, as _masked_logits:
// visible -> dot * scale; real masked or causally hidden -> NEG; padding
// (j >= Tk, marked by a negative mask entry) -> padval.
__device__ __forceinline__ float logit(float dot, float km, int i, int j, float scale,
                                       int causal, float padval) {
  if (km < 0.f) return padval;
  if (km == 0.f || (causal && j > i)) return kNeg;
  return dot * scale;
}

// ---------------------------------------------------------------- bf16 on
// the tensor cores: four warps, mma.sync m16n8k16 with fp32 accumulation,
// tiles in shared memory as bf16 rows fetched with cp.async and read with
// ldmatrix.

constexpr int kThreadsMma = 128;
constexpr int KH = 32;  // keys a half tile

using bf16 = __nv_bfloat16;

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src),
               "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

__device__ __forceinline__ void cp_async_wait_prev() {
  asm volatile("cp.async.wait_group 1;\n" ::);  // all groups but the newest
}

__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_group 0;\n" ::); }

// rows [r0, r0 + 64) x n bf16 columns (n % 8 == 0; 16-byte aligned rows)
// into dst (row stride ld) with cp.async; rows >= nrows are zero-filled.
__device__ __forceinline__ void async_bf16(bf16* dst, int ld, const bf16* src, long long rs,
                                           int n, int r0, int nrows) {
  const int n8 = n / 8;
  for (int idx = threadIdx.x; idx < 64 * n8; idx += blockDim.x) {
    const int r = idx / n8, c = (idx - r * n8) * 8;
    const bool ok = r0 + r < nrows;
    cp_async16(dst + r * ld + c, src + (long long)(ok ? r0 + r : 0) * rs + c, ok);
  }
}

// the key mask of keys [j0, j0 + 64) with cp.async (zero past Tk; the key
// index tells padding apart, see flag_of)
__device__ __forceinline__ void async_mask(float* dst, const float* km_row, int j0, int Tk) {
  for (int j = threadIdx.x; j < BK; j += blockDim.x) {
    const bool ok = j0 + j < Tk;
    cp_async4(dst + j, km_row + (ok ? j0 + j : 0), ok);
  }
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// acc[n] += A (16 x 16) @ B^T for the 4 n-tiles (32 rows) of B stored [n][k]
// (row stride ld) from row 0 of bt: B fragments by ldmatrix (non-trans).
__device__ __forceinline__ void mma_rows32(float (&acc)[4][4], const uint32_t (&a)[4],
                                           const bf16* bt, int ld, int k0, int lane) {
#pragma unroll
  for (int np = 0; np < 2; ++np) {
    uint32_t b[4];
    ldmatrix_x4(b, bt + (np * 16 + (lane >> 4) * 8 + (lane & 7)) * ld + k0 + ((lane >> 3) & 1) * 8);
    mma_bf16(acc[2 * np], a, b[0], b[1]);
    mma_bf16(acc[2 * np + 1], a, b[2], b[3]);
  }
}

// o (16 x DH) += P (16 x 32) @ X (32 x DH), P given as the C fragments of
// the half's 4 key n-tiles (rounded to bf16 here), X row-major [key][d]
// from row 0 of xs (row stride ld): B fragments by ldmatrix.trans.
template <int DH>
__device__ __forceinline__ void mma_pv(float (&o)[DH / 8][4], const float (&pr)[4][4],
                                       const bf16* xs, int ld, int lane) {
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const uint32_t a[4] = {pack_bf16(pr[2 * j][0], pr[2 * j][1]),
                           pack_bf16(pr[2 * j][2], pr[2 * j][3]),
                           pack_bf16(pr[2 * j + 1][0], pr[2 * j + 1][1]),
                           pack_bf16(pr[2 * j + 1][2], pr[2 * j + 1][3])};
#pragma unroll
    for (int n2 = 0; n2 < DH / 16; ++n2) {
      uint32_t b[4];
      ldmatrix_x4_trans(b, xs + (16 * j + ((lane >> 3) & 1) * 8 + (lane & 7)) * ld + 16 * n2 +
                               (lane >> 4) * 8);
      mma_bf16(o[2 * n2], a, b[0], b[1]);
      mma_bf16(o[2 * n2 + 1], a, b[2], b[3]);
    }
  }
}

// A fragments of a (16 x 16) block at row r0, column k0 of a row-major
// bf16 tile (row stride ld).
__device__ __forceinline__ void a_frag(uint32_t (&a)[4], const bf16* x, int ld, int r0, int k0,
                                       int lane) {
  ldmatrix_x4(a, x + (r0 + (lane & 15)) * ld + k0 + (lane >> 4) * 8);
}

template <typename K, typename... Args>
cudaError_t go(K kernel, dim3 blocks, int threads, size_t bytes, cudaStream_t stream,
               const Args&... args) {
  if (bytes > kMaxSmem) return cudaErrorInvalidValue;
  if (bytes > 48 * 1024) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (e != cudaSuccess) return e;
  }
  kernel<<<blocks, threads, bytes, stream>>>(args...);
  return cudaGetLastError();
}

}  // namespace

// Flash attention for Hopper (sm_90a): the forward, dQ and dK/dV as three
// kernels.
//
// Replaces the TPU kernels of easydgl_tpu/kernels/flash_attention.py:
//
//   flash_fwd_kernel  _fwd_kernel (pallas_call in _flash_fwd, :318)
//   flash_dq_kernel   _dq_kernel  (pallas_call in _flash_bwd, :366)
//   flash_dkv_kernel  _dkv_kernel (pallas_call in _flash_bwd, :390)
//
// and computes what the plain versions of easydgl_tpu_torch/kernels/
// flash_attention.py compute (flash_fwd_reference, flash_dq_reference,
// flash_dkv_reference), with their rounding points. With s_ij = (q_i . k_j)
// * scale in fp32, visible_ij = key_mask_j > 0 (and j <= i when causal),
// keep_ij the dropout factor:
//
//   forward  m_i = max_visible s_ij, p_ij = visible ? exp(s_ij - m_i) : 0,
//            l_i = sum_j p_ij (undropped), out_i = l_i > 0 ?
//            sum_j rnd(p_ij keep_ij) v_j / l_i : 0, lse_i = m_i + log(max(l_i,
//            1e-37)); a row that sees no key has m_i = -1e38, out 0.
//   dq       p_ij = visible ? exp(s_ij - lse_i) : 0, dp_ij = (dO_i . v_j)
//            keep_ij, ds_ij = p_ij (dp_ij - delta_i), dq_i = scale sum_j
//            rnd(ds_ij) k_j, delta_i = dO_i . out_i (the wrapper's).
//   dkv      dv_j = sum_i rnd(p_ij keep_ij) dO_i, dk_j = scale sum_i
//            rnd(ds_ij) q_i.
//
// rnd() rounds to the compute dtype (bf16) and is the identity in fp32; every
// sum is fp32; the online max of the forward rounds p relative to the running
// max, the plain version relative to the row's. Dropout keeps entry (b, h, i,
// j) by the Philox draw of counter (j, i, h, b) (common.cuh), i the query row
// of the call and j the key: the forward, the query-major dq, the key-major
// dkv and the plain version draw one mask whatever their tiles (the TPU kernel
// seeds its PRNG per block, so its mask depends on the blocking).
//
// Design. One block of four warps takes 64 rows of one (b, h): 64 queries in
// the forward and dq, looping over 64-key tiles; 64 keys in dkv, looping
// over 64-query tiles. The TPU's sequential grid axis becomes the loop, its
// VMEM scratch the registers: each warp owns 16 rows, and its running max,
// sum and (16 x dh) accumulators stay in registers. A 64-wide tile is taken
// in two 32-wide halves: their products come out as mma C fragments, are
// formed in place, and are the A operand of the next product (P @ V,
// dS @ K, P^T @ dO, dS^T @ Q). Tiles stream through shared memory with
// cp.async one tile ahead (double-buffered), q/k/v/dO read in place with
// strides (no head transpose, dh = 64 not padded).
//
// * bf16 (the main path): mma.sync m16n8k16 with fp32 accumulation on the
//   tensor cores, operands by ldmatrix; the resident operand's A fragments
//   stay in registers.
// * fp32: the same schedule on the CUDA cores: the warp's rows read from
//   shared memory with 16-byte loads, the C-fragment operand of the second
//   product passed between the lanes of a quad by shuffles.
//
// Under causal the key tiles strictly after a query tile's last query are
// skipped (dkv: the query tiles strictly before its first key). This is
// exact here: a masked entry contributes exactly 0, and a row that sees no
// key writes 0, whatever is skipped.
//
// What bounds it, at the SASREC-LC shape (B=32, H=8, T=2048, dh=64, causal):
// operations. Each causal T x T x dh product over the 256 (b, h) pairs is
// 68.7 GFLOP: the forward does 2 (0.139 ms at 989 TFLOP/s), dq 3 (0.208),
// dkv 4 (0.278); q, k, v and out are 67 MB each in bf16 (0.02 ms at
// 3.35 TB/s). Besides the products, each visible entry costs an exp (and a
// Philox draw of ten rounds under dropout) on the CUDA cores.
//
// Limits: dh in {16, 32, 64, 128} (forward), {16, 32, 64} (dq, dkv); rows of
// q/k/v/dO/outputs start on 16-byte boundaries (the wrapper copies where
// they do not).

#include <type_traits>

#include "mau_streamed.cuh"

namespace {

using namespace port;

constexpr float kDead = -1.0e38f;  // the running max before a visible key

struct Seq4 {
  const void* p;
  long long bs, hs, rs;  // batch, head and row strides, in elements
};

struct Out4 {
  void* p;
  long long bs, hs, rs;
};

struct FlashParams {
  Seq4 q, k, v, dout;
  const float* key_mask;  // (B, Tk)
  const float* lse;       // (B, H, Tq): the forward writes it, the backward reads it
  const float* delta;     // (B, H, Tq)
  float* lse_out;
  Out4 out, dq, dk, dv;
  const long long* seed;  // dropout seed on the device, or null
  unsigned drop_thresh;
  float drop_scale;
  float scale;
  int B, H, Tq, Tk, causal;
};

enum Which { kFwd = 0, kDq = 1, kDkv = 2 };

template <typename T>
__device__ __forceinline__ const T* head(const Seq4& s, int b, int h) {
  return static_cast<const T*>(s.p) + b * s.bs + h * s.hs;
}

template <typename T>
__device__ __forceinline__ T* head(const Out4& s, int b, int h) {
  return static_cast<T*>(s.p) + b * s.bs + h * s.hs;
}

// Row stride of a (64 x DH) tile in shared memory, in elements: bf16 rows
// padded by 16 bytes (ldmatrix without bank conflicts), fp32 rows by 4
// floats (16-byte loads by 8 rows hit 8 distinct bank groups).
template <typename T, int DH>
__host__ __device__ constexpr int row_stride() {
  return sizeof(T) == 2 ? DH + 8 : DH + 4;
}

template <typename T, int DH>
__host__ __device__ constexpr size_t smem_bytes_of(int which) {
  // forward: q + 2 k + 2 v tiles, 2 x 64 key-mask floats; dq: q, dO + 2 k +
  // 2 v; dkv: k, v + 2 q + 2 dO, 64 key-mask floats + 2 x (lse, delta)
  return which == kFwd  ? sizeof(T) * 5 * 64 * row_stride<T, DH>() + sizeof(float) * 2 * BK
         : which == kDq ? sizeof(T) * 6 * 64 * row_stride<T, DH>() + sizeof(float) * 2 * BK
                        : sizeof(T) * 6 * 64 * row_stride<T, DH>() + sizeof(float) * 5 * BK;
}

// rows [r0, r0 + 64) x DH columns of a row-major source (row stride rs) into
// dst (row stride ld) with cp.async; rows >= nrows are zero-filled.
template <typename T, int DH>
__device__ __forceinline__ void async_rows(T* dst, int ld, const T* src, long long rs, int r0,
                                           int nrows) {
  constexpr int V = 16 / sizeof(T), NV = DH / V;
  for (int idx = threadIdx.x; idx < 64 * NV; idx += blockDim.x) {
    const int r = idx / NV, c = (idx - r * NV) * V;
    const bool ok = r0 + r < nrows;
    cp_async16(dst + r * ld + c, src + (long long)(ok ? r0 + r : 0) * rs + c, ok);
  }
}

// 64 fp32 values [r0, r0 + 64) of a row (zero past n) with cp.async.
__device__ __forceinline__ void async_vec(float* dst, const float* src, int r0, int n) {
  for (int r = threadIdx.x; r < 64; r += blockDim.x) {
    const bool ok = r0 + r < n;
    cp_async4(dst + r, src + (ok ? r0 + r : 0), ok);
  }
}

__device__ __forceinline__ float dot4(float4 a, float4 b, float s) {
  s = fmaf(a.x, b.x, s);
  s = fmaf(a.y, b.y, s);
  s = fmaf(a.z, b.z, s);
  return fmaf(a.w, b.w, s);
}

// The warp's 16 rows of a resident operand A, and acc (16 x 32) += A B^T for
// the 32 rows of B from bt (row stride ldb), B stored [row][d]: entry
// acc[n][c] is row g + 8 (c >> 1), column n * 8 + 2 t4 + (c & 1) (the mma C
// fragment layout). bf16: A fragments in registers, mma.sync; fp32: A read
// from shared memory.
template <typename T, int DH>
struct ARows;

template <int DH>
struct ARows<bf16, DH> {
  uint32_t f[DH / 16][4];
  __device__ __forceinline__ void load(const bf16* s, int ld, int r0, int lane) {
#pragma unroll
    for (int kd = 0; kd < DH / 16; ++kd) a_frag(f[kd], s, ld, r0, kd * 16, lane);
  }
  __device__ __forceinline__ void mul(float (&acc)[4][4], const bf16* bt, int ldb,
                                      int lane) const {
#pragma unroll
    for (int kd = 0; kd < DH / 16; ++kd) mma_rows32(acc, f[kd], bt, ldb, kd * 16, lane);
  }
};

template <int DH>
struct ARows<float, DH> {
  const float* a;
  int lda;
  __device__ __forceinline__ void load(const float* s, int ld, int r0, int lane) {
    a = s + r0 * ld;
    lda = ld;
  }
  __device__ __forceinline__ void mul(float (&acc)[4][4], const float* bt, int ldb,
                                      int lane) const {
    const int g = lane >> 2, t4 = lane & 3;
    const float* a0 = a + g * lda;
    const float* a1 = a0 + 8 * lda;
#pragma unroll 4
    for (int d = 0; d < DH; d += 4) {
      const float4 x0 = *reinterpret_cast<const float4*>(a0 + d);
      const float4 x1 = *reinterpret_cast<const float4*>(a1 + d);
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int cc = 0; cc < 2; ++cc) {
          const float4 y = *reinterpret_cast<const float4*>(bt + (n * 8 + 2 * t4 + cc) * ldb + d);
          acc[n][cc] = dot4(x0, y, acc[n][cc]);
          acc[n][2 + cc] = dot4(x1, y, acc[n][2 + cc]);
        }
    }
  }
};

// o (16 x DH) += P (16 x 32) @ X (32 x DH): P as the C fragments of the
// half's 4 n-tiles (rounded to bf16 on the tensor cores), X row-major
// [row][d] from xs (row stride ld); o in the C fragment layout.
template <int DH>
__device__ __forceinline__ void pv(float (&o)[DH / 8][4], const float (&pr)[4][4],
                                   const bf16* xs, int ld, int lane) {
  mma_pv<DH>(o, pr, xs, ld, lane);
}

template <int DH>
__device__ __forceinline__ void pv(float (&o)[DH / 8][4], const float (&pr)[4][4],
                                   const float* xs, int ld, int lane) {
  const int base = lane & ~3, t4 = lane & 3;
#pragma unroll
  for (int n = 0; n < 4; ++n)
#pragma unroll
    for (int t = 0; t < 4; ++t)
#pragma unroll
      for (int cc = 0; cc < 2; ++cc) {
        // column n * 8 + 2 t + cc of P, rows g and g + 8, from lane (g, t)
        const float p0 = __shfl_sync(0xffffffffu, pr[n][cc], base | t);
        const float p1 = __shfl_sync(0xffffffffu, pr[n][2 + cc], base | t);
        const float* x = xs + (n * 8 + 2 * t + cc) * ld + 2 * t4;
#pragma unroll
        for (int nn = 0; nn < DH / 8; ++nn) {
          const float2 xv = *reinterpret_cast<const float2*>(x + nn * 8);
          o[nn][0] = fmaf(p0, xv.x, o[nn][0]);
          o[nn][1] = fmaf(p0, xv.y, o[nn][1]);
          o[nn][2] = fmaf(p1, xv.x, o[nn][2]);
          o[nn][3] = fmaf(p1, xv.y, o[nn][3]);
        }
      }
}

__device__ __forceinline__ void store2(bf16* dst, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(a, b);
}
__device__ __forceinline__ void store2(float* dst, float a, float b) {
  *reinterpret_cast<float2*>(dst) = make_float2(a, b);
}

// Rows [r0, r0 + 16) of a warp's (16 x DH) C-fragment accumulator, times
// `mul` (per row pair), into dst rows (row stride rs) where row < nrows.
template <typename T, int DH>
__device__ __forceinline__ void store_rows(T* dst, long long rs, const float (&o)[DH / 8][4],
                                           const float (&mul)[2], int r0, int nrows, int lane) {
  const int g = lane >> 2, t4 = lane & 3;
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int r = r0 + g + 8 * hr;
    if (r >= nrows) continue;
#pragma unroll
    for (int n = 0; n < DH / 8; ++n)
      store2(dst + (long long)r * rs + n * 8 + 2 * t4, o[n][2 * hr] * mul[hr],
             o[n][2 * hr + 1] * mul[hr]);
  }
}

// Key tiles a query tile [q0, q0 + 64) visits: under causal, none after its
// last query.
__device__ __forceinline__ int live_key_tiles(const FlashParams& p, int q0) {
  const int all = (p.Tk + BK - 1) / BK;
  if (!p.causal) return all;
  return imin(all, (imin(q0 + BQ, p.Tq) - 1) / BK + 1);
}

__device__ __forceinline__ bool visible(float km, int i, int j, int Tq, int Tk, int causal) {
  return i < Tq && j < Tk && km > 0.f && !(causal && j > i);
}

// ---------------------------------------------------------------- forward

template <typename T, int DH>
__global__ void __launch_bounds__(kThreadsMma) flash_fwd_kernel(const FlashParams p) {
  constexpr int SD = row_stride<T, DH>();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* qs = reinterpret_cast<T*>(smem_raw);  // [64][SD]
  T* ks = qs + 64 * SD;                    // [2][BK][SD]
  T* vs = ks + 2 * BK * SD;                // [2][BK][SD]
  float* kms = reinterpret_cast<float*>(vs + 2 * BK * SD);  // [2][BK] key mask

  const int nqt = (p.Tq + BQ - 1) / BQ;
  const int bh = blockIdx.x / nqt, q0 = (blockIdx.x - bh * nqt) * BQ;
  const int b = bh / p.H, h = bh - b * p.H;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t4 = lane & 3;
  const float* km_row = p.key_mask + (size_t)b * p.Tk;
  const T* kg = head<T>(p.k, b, h);
  const T* vg = head<T>(p.v, b, h);
  auto fetch = [&](int kt) {
    const int buf = kt & 1;
    async_rows<T, DH>(ks + buf * BK * SD, SD, kg, p.k.rs, kt * BK, p.Tk);
    async_rows<T, DH>(vs + buf * BK * SD, SD, vg, p.v.rs, kt * BK, p.Tk);
    async_vec(kms + buf * BK, km_row, kt * BK, p.Tk);
  };

  async_rows<T, DH>(qs, SD, head<T>(p.q, b, h), p.q.rs, q0, p.Tq);
  const int nkt = live_key_tiles(p, q0);
  const Dropout drop = make_dropout(p.seed, p.drop_thresh, p.drop_scale);
  fetch(0);
  cp_async_commit();

  ARows<T, DH> qa;
  float m[2] = {kDead, kDead}, l[2] = {0.f, 0.f};
  float o[DH / 8][4];
#pragma unroll
  for (int n = 0; n < DH / 8; ++n)
#pragma unroll
    for (int c = 0; c < 4; ++c) o[n][c] = 0.f;

  for (int kt = 0; kt < nkt; ++kt) {
    if (kt + 1 < nkt) fetch(kt + 1);
    cp_async_commit();
    cp_async_wait_prev();
    __syncthreads();  // tile kt (and, at kt = 0, q) is in shared memory
    if (kt == 0) qa.load(qs, SD, warp * 16, lane);
    const int j0 = kt * BK;
    const T* kb = ks + (kt & 1) * BK * SD;
    const T* vb = vs + (kt & 1) * BK * SD;
    const float* kmb = kms + (kt & 1) * BK;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      float s[4][4];
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int c = 0; c < 4; ++c) s[n][c] = 0.f;
      qa.mul(s, kb + half * KH * SD, SD, lane);
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int i = q0 + warp * 16 + g + 8 * hr;
        float mx = kDead;
#pragma unroll
        for (int n = 0; n < 4; ++n)
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const int jj = half * KH + n * 8 + 2 * t4 + c;
            float& x = s[n][2 * hr + c];
            x = visible(kmb[jj], i, j0 + jj, p.Tq, p.Tk, p.causal) ? x * p.scale : kDead;
            mx = fmaxf(mx, x);
          }
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float m_new = fmaxf(m[hr], mx);
        const float corr = expf(m[hr] - m_new);
        float sum = 0.f;
#pragma unroll
        for (int n = 0; n < 4; ++n)
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const int jj = half * KH + n * 8 + 2 * t4 + c, j = j0 + jj;
            float& x = s[n][2 * hr + c];
            // exact-zero masked probs: a row with no visible key keeps p = 0
            x = visible(kmb[jj], i, j, p.Tq, p.Tk, p.causal) ? expf(x - m_new) : 0.f;
            sum += x;  // l sums the undropped probs
            if (drop.on && x != 0.f) x *= drop.factor(b, h, i, j);
          }
        sum += __shfl_xor_sync(0xffffffffu, sum, 1);
        sum += __shfl_xor_sync(0xffffffffu, sum, 2);
        l[hr] = l[hr] * corr + sum;
        m[hr] = m_new;
#pragma unroll
        for (int n = 0; n < DH / 8; ++n) {
          o[n][2 * hr] *= corr;
          o[n][2 * hr + 1] *= corr;
        }
      }
      pv<DH>(o, s, vb + half * KH * SD, SD, lane);  // dropped probs @ V
    }
    __syncthreads();  // the buffer is free for tile kt + 2
  }
  asm volatile("cp.async.wait_all;\n" ::);  // q, where no key tile came

  const int r0 = q0 + warp * 16;
  float inv[2];
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    inv[hr] = l[hr] > 0.f ? 1.f / fmaxf(l[hr], 1e-37f) : 0.f;
    const int i = r0 + g + 8 * hr;
    if (t4 == 0 && i < p.Tq)
      p.lse_out[(size_t)bh * p.Tq + i] = m[hr] + logf(fmaxf(l[hr], 1e-37f));
  }
  store_rows<T, DH>(head<T>(p.out, b, h), p.out.rs, o, inv, r0, p.Tq, lane);
}

// ---------------------------------------------------------------- dq

template <typename T, int DH>
__global__ void __launch_bounds__(kThreadsMma) flash_dq_kernel(const FlashParams p) {
  constexpr int SD = row_stride<T, DH>();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* qs = reinterpret_cast<T*>(smem_raw);  // [64][SD]
  T* dos = qs + 64 * SD;                   // [64][SD] dO
  T* ks = dos + 64 * SD;                   // [2][BK][SD]
  T* vs = ks + 2 * BK * SD;                // [2][BK][SD]
  float* kms = reinterpret_cast<float*>(vs + 2 * BK * SD);  // [2][BK] key mask

  const int nqt = (p.Tq + BQ - 1) / BQ;
  const int bh = blockIdx.x / nqt, q0 = (blockIdx.x - bh * nqt) * BQ;
  const int b = bh / p.H, h = bh - b * p.H;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t4 = lane & 3;
  const float* km_row = p.key_mask + (size_t)b * p.Tk;
  const T* kg = head<T>(p.k, b, h);
  const T* vg = head<T>(p.v, b, h);
  auto fetch = [&](int kt) {
    const int buf = kt & 1;
    async_rows<T, DH>(ks + buf * BK * SD, SD, kg, p.k.rs, kt * BK, p.Tk);
    async_rows<T, DH>(vs + buf * BK * SD, SD, vg, p.v.rs, kt * BK, p.Tk);
    async_vec(kms + buf * BK, km_row, kt * BK, p.Tk);
  };

  async_rows<T, DH>(qs, SD, head<T>(p.q, b, h), p.q.rs, q0, p.Tq);
  async_rows<T, DH>(dos, SD, head<T>(p.dout, b, h), p.dout.rs, q0, p.Tq);
  const size_t row0 = (size_t)bh * p.Tq;
  float lse[2], dlt[2];
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int i = q0 + warp * 16 + g + 8 * hr;
    lse[hr] = i < p.Tq ? p.lse[row0 + i] : 0.f;
    dlt[hr] = i < p.Tq ? p.delta[row0 + i] : 0.f;
  }
  const int nkt = live_key_tiles(p, q0);
  const Dropout drop = make_dropout(p.seed, p.drop_thresh, p.drop_scale);
  fetch(0);
  cp_async_commit();

  ARows<T, DH> qa, da;
  float o[DH / 8][4];
#pragma unroll
  for (int n = 0; n < DH / 8; ++n)
#pragma unroll
    for (int c = 0; c < 4; ++c) o[n][c] = 0.f;

  for (int kt = 0; kt < nkt; ++kt) {
    if (kt + 1 < nkt) fetch(kt + 1);
    cp_async_commit();
    cp_async_wait_prev();
    __syncthreads();  // tile kt (and, at kt = 0, q and dO) is in shared memory
    if (kt == 0) {
      qa.load(qs, SD, warp * 16, lane);
      da.load(dos, SD, warp * 16, lane);
    }
    const int j0 = kt * BK;
    const T* kb = ks + (kt & 1) * BK * SD;
    const T* vb = vs + (kt & 1) * BK * SD;
    const float* kmb = kms + (kt & 1) * BK;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      float s[4][4], dp[4][4];
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int c = 0; c < 4; ++c) s[n][c] = dp[n][c] = 0.f;
      qa.mul(s, kb + half * KH * SD, SD, lane);
      da.mul(dp, vb + half * KH * SD, SD, lane);
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int hr = c >> 1, jj = half * KH + n * 8 + 2 * t4 + (c & 1);
          const int i = q0 + warp * 16 + g + 8 * hr, j = j0 + jj;
          float ds = 0.f;
          if (visible(kmb[jj], i, j, p.Tq, p.Tk, p.causal)) {
            const float pr = expf(s[n][c] * p.scale - lse[hr]);
            float d = dp[n][c];
            if (drop.on && pr != 0.f) d *= drop.factor(b, h, i, j);
            ds = pr * (d - dlt[hr]);
          }
          s[n][c] = ds;
        }
      pv<DH>(o, s, kb + half * KH * SD, SD, lane);  // dS @ K
    }
    __syncthreads();  // the buffer is free for tile kt + 2
  }
  asm volatile("cp.async.wait_all;\n" ::);

  const float mul[2] = {p.scale, p.scale};
  store_rows<T, DH>(head<T>(p.dq, b, h), p.dq.rs, o, mul, q0 + warp * 16, p.Tq, lane);
}

// ---------------------------------------------------------------- dkv
// Key-major: a warp owns 16 of the block's 64 keys; the query tiles stream
// through shared memory, and each half's transposed (16 keys x 32 queries)
// tiles are the A operands of dv += P^T @ dO and dk += dS^T @ Q.

template <typename T, int DH>
__global__ void __launch_bounds__(kThreadsMma) flash_dkv_kernel(const FlashParams p) {
  constexpr int SD = row_stride<T, DH>();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* ks = reinterpret_cast<T*>(smem_raw);  // [BK][SD] the block's keys
  T* vs = ks + BK * SD;                    // [BK][SD]
  T* qs = vs + BK * SD;                    // [2][BQ][SD] q of a query tile
  T* dos = qs + 2 * BQ * SD;               // [2][BQ][SD] dO
  float* kms = reinterpret_cast<float*>(dos + 2 * BQ * SD);  // [BK] key mask
  float* st = kms + BK;                    // [2][2][BQ] lse, delta

  const int nkt = (p.Tk + BK - 1) / BK, nqt = (p.Tq + BQ - 1) / BQ;
  const int bh = blockIdx.x / nkt, k0 = (blockIdx.x - bh * nkt) * BK;
  const int b = bh / p.H, h = bh - b * p.H;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t4 = lane & 3;
  const size_t row0 = (size_t)bh * p.Tq;
  const T* qg = head<T>(p.q, b, h);
  const T* dog = head<T>(p.dout, b, h);
  auto fetch = [&](int qt, int buf) {
    const int q0 = qt * BQ;
    async_rows<T, DH>(qs + buf * BQ * SD, SD, qg, p.q.rs, q0, p.Tq);
    async_rows<T, DH>(dos + buf * BQ * SD, SD, dog, p.dout.rs, q0, p.Tq);
    async_vec(st + buf * 2 * BQ, p.lse + row0, q0, p.Tq);
    async_vec(st + buf * 2 * BQ + BQ, p.delta + row0, q0, p.Tq);
  };

  async_rows<T, DH>(ks, SD, head<T>(p.k, b, h), p.k.rs, k0, p.Tk);
  async_rows<T, DH>(vs, SD, head<T>(p.v, b, h), p.v.rs, k0, p.Tk);
  async_vec(kms, p.key_mask + (size_t)b * p.Tk, k0, p.Tk);
  // under causal the first query tile that reaches key k0 (BQ == BK)
  const int qt0 = p.causal ? k0 / BQ : 0;
  if (qt0 < nqt) fetch(qt0, 0);
  cp_async_commit();
  const Dropout drop = make_dropout(p.seed, p.drop_thresh, p.drop_scale);

  ARows<T, DH> ka, va;
  float dk[DH / 8][4], dv[DH / 8][4];
#pragma unroll
  for (int n = 0; n < DH / 8; ++n)
#pragma unroll
    for (int c = 0; c < 4; ++c) dk[n][c] = dv[n][c] = 0.f;

  int buf = 0;
  for (int qt = qt0; qt < nqt; ++qt) {
    if (qt + 1 < nqt) fetch(qt + 1, buf ^ 1);
    cp_async_commit();
    cp_async_wait_prev();
    __syncthreads();  // query tile qt (and, the first time, the key tile) is in shared memory
    if (qt == qt0) {
      ka.load(ks, SD, warp * 16, lane);
      va.load(vs, SD, warp * 16, lane);
    }
    const int q0 = qt * BQ;
    const T* qb = qs + buf * BQ * SD;
    const T* db = dos + buf * BQ * SD;
    const float* lq = st + buf * 2 * BQ;
    const float* dl = lq + BQ;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      // transposed tiles: entry (key warp * 16 + g + 8 hr, query of the half)
      float s[4][4], dp[4][4];
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int c = 0; c < 4; ++c) s[n][c] = dp[n][c] = 0.f;
      ka.mul(s, qb + half * KH * SD, SD, lane);
      va.mul(dp, db + half * KH * SD, SD, lane);
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int jl = warp * 16 + g + 8 * (c >> 1);
          const int il = half * KH + n * 8 + 2 * t4 + (c & 1);
          const int j = k0 + jl, i = q0 + il;
          float pd = 0.f, ds = 0.f;
          if (visible(kms[jl], i, j, p.Tq, p.Tk, p.causal)) {
            const float pr = expf(s[n][c] * p.scale - lq[il]);
            float d = dp[n][c];
            pd = pr;
            if (drop.on && pr != 0.f) {
              const float keep = drop.factor(b, h, i, j);
              pd *= keep;
              d *= keep;
            }
            ds = pr * (d - dl[il]);
          }
          s[n][c] = pd;
          dp[n][c] = ds;
        }
      pv<DH>(dv, s, db + half * KH * SD, SD, lane);   // dropped P^T @ dO
      pv<DH>(dk, dp, qb + half * KH * SD, SD, lane);  // dS^T @ Q
    }
    __syncthreads();  // the buffer is free for the tile after next
    buf ^= 1;
  }
  asm volatile("cp.async.wait_all;\n" ::);  // the key tile, where no query tile came

  const float one[2] = {1.f, 1.f}, scale[2] = {p.scale, p.scale};
  const int r0 = k0 + warp * 16;
  store_rows<T, DH>(head<T>(p.dk, b, h), p.dk.rs, dk, scale, r0, p.Tk, lane);
  store_rows<T, DH>(head<T>(p.dv, b, h), p.dv.rs, dv, one, r0, p.Tk, lane);
}

// ---------------------------------------------------------------- launch

template <typename T, int DH>
cudaError_t launch_one(int which, const FlashParams& p, cudaStream_t s) {
  const size_t bytes = smem_bytes_of<T, DH>(which);
  const int nq = p.B * p.H * ((p.Tq + BQ - 1) / BQ), nk = p.B * p.H * ((p.Tk + BK - 1) / BK);
  if (which == kFwd) return go(flash_fwd_kernel<T, DH>, nq, kThreadsMma, bytes, s, p);
  if constexpr (DH <= 64) {
    if (which == kDq) return go(flash_dq_kernel<T, DH>, nq, kThreadsMma, bytes, s, p);
    return go(flash_dkv_kernel<T, DH>, nk, kThreadsMma, bytes, s, p);
  }
  return cudaErrorInvalidValue;
}

template <typename T>
cudaError_t launch_t(int which, const FlashParams& p, int dh, cudaStream_t s) {
  switch (dh) {
    case 16: return launch_one<T, 16>(which, p, s);
    case 32: return launch_one<T, 32>(which, p, s);
    case 64: return launch_one<T, 64>(which, p, s);
    case 128: return launch_one<T, 128>(which, p, s);
    default: return cudaErrorInvalidValue;
  }
}

int launch(int which, const FlashParams& p, int dh, int dtype, void* stream) {
  if (p.B < 1 || p.H < 1 || p.Tq < 1 || p.Tk < 1 || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(dtype ? launch_t<bf16>(which, p, dh, s) : launch_t<float>(which, p, dh, s));
}

FlashParams base_params(const void* q, long long q_bs, long long q_hs, long long q_rs,
                        const void* k, long long k_bs, long long k_hs, long long k_rs,
                        const void* v, long long v_bs, long long v_hs, long long v_rs,
                        const void* key_mask, const void* seed, unsigned drop_thresh,
                        float drop_scale, int B, int H, int Tq, int Tk, int causal,
                        float scale) {
  FlashParams p = {};
  p.q = {q, q_bs, q_hs, q_rs};
  p.k = {k, k_bs, k_hs, k_rs};
  p.v = {v, v_bs, v_hs, v_rs};
  p.key_mask = static_cast<const float*>(key_mask);
  p.seed = static_cast<const long long*>(seed);
  p.drop_thresh = drop_thresh;
  p.drop_scale = drop_scale;
  p.scale = scale;
  p.B = B; p.H = H; p.Tq = Tq; p.Tk = Tk; p.causal = causal;
  return p;
}

}  // namespace

extern "C" {

// Dynamic shared memory of one block of kernel `which` (0 forward, 1 dq,
// 2 dkv), in bytes; above 232448 a kernel cannot run.
size_t flash_smem_bytes(int which, int dh, int dtype) {
  switch (dh * 2 + (dtype ? 1 : 0)) {
    case 32: return smem_bytes_of<float, 16>(which);
    case 64: return smem_bytes_of<float, 32>(which);
    case 128: return smem_bytes_of<float, 64>(which);
    case 256: return smem_bytes_of<float, 128>(which);
    case 33: return smem_bytes_of<bf16, 16>(which);
    case 65: return smem_bytes_of<bf16, 32>(which);
    case 129: return smem_bytes_of<bf16, 64>(which);
    case 257: return smem_bytes_of<bf16, 128>(which);
    default: return (size_t)-1;
  }
}

// Each launches on `stream` and returns cudaGetLastError() (0 on success).
// dtype: 0 = float32, 1 = bfloat16 (q, k, v, dO and the outputs); strides in
// elements, channels contiguous, rows on 16-byte boundaries. key_mask (B, Tk),
// lse and delta (B, H, Tq) are fp32. `seed` (an int64 on the device, or null
// for no dropout) keys the dropout mask: keep where the Philox word is below
// drop_thresh, scaled by drop_scale.
int flash_fwd(const void* q, long long q_bs, long long q_hs, long long q_rs, const void* k,
              long long k_bs, long long k_hs, long long k_rs, const void* v, long long v_bs,
              long long v_hs, long long v_rs, const void* key_mask, const void* seed,
              unsigned drop_thresh, float drop_scale, void* out, long long o_bs, long long o_hs,
              long long o_rs, void* lse, int B, int H, int Tq, int Tk, int dh, int causal,
              float scale, int dtype, void* stream) {
  FlashParams p = base_params(q, q_bs, q_hs, q_rs, k, k_bs, k_hs, k_rs, v, v_bs, v_hs, v_rs,
                              key_mask, seed, drop_thresh, drop_scale, B, H, Tq, Tk, causal,
                              scale);
  p.out = {out, o_bs, o_hs, o_rs};
  p.lse_out = static_cast<float*>(lse);
  return launch(kFwd, p, dh, dtype, stream);
}

int flash_dq(const void* q, long long q_bs, long long q_hs, long long q_rs, const void* k,
             long long k_bs, long long k_hs, long long k_rs, const void* v, long long v_bs,
             long long v_hs, long long v_rs, const void* dout, long long d_bs, long long d_hs,
             long long d_rs, const void* key_mask, const void* lse, const void* delta,
             const void* seed, unsigned drop_thresh, float drop_scale, void* dq,
             long long dq_bs, long long dq_hs, long long dq_rs, int B, int H, int Tq, int Tk,
             int dh, int causal, float scale, int dtype, void* stream) {
  FlashParams p = base_params(q, q_bs, q_hs, q_rs, k, k_bs, k_hs, k_rs, v, v_bs, v_hs, v_rs,
                              key_mask, seed, drop_thresh, drop_scale, B, H, Tq, Tk, causal,
                              scale);
  p.dout = {dout, d_bs, d_hs, d_rs};
  p.lse = static_cast<const float*>(lse);
  p.delta = static_cast<const float*>(delta);
  p.dq = {dq, dq_bs, dq_hs, dq_rs};
  return launch(kDq, p, dh, dtype, stream);
}

int flash_dkv(const void* q, long long q_bs, long long q_hs, long long q_rs, const void* k,
              long long k_bs, long long k_hs, long long k_rs, const void* v, long long v_bs,
              long long v_hs, long long v_rs, const void* dout, long long d_bs, long long d_hs,
              long long d_rs, const void* key_mask, const void* lse, const void* delta,
              const void* seed, unsigned drop_thresh, float drop_scale, void* dk,
              long long dk_bs, long long dk_hs, long long dk_rs, void* dv, long long dv_bs,
              long long dv_hs, long long dv_rs, int B, int H, int Tq, int Tk, int dh,
              int causal, float scale, int dtype, void* stream) {
  FlashParams p = base_params(q, q_bs, q_hs, q_rs, k, k_bs, k_hs, k_rs, v, v_bs, v_hs, v_rs,
                              key_mask, seed, drop_thresh, drop_scale, B, H, Tq, Tk, causal,
                              scale);
  p.dout = {dout, d_bs, d_hs, d_rs};
  p.lse = static_cast<const float*>(lse);
  p.delta = static_cast<const float*>(delta);
  p.dk = {dk, dk_bs, dk_hs, dk_rs};
  p.dv = {dv, dv_bs, dv_hs, dv_rs};
  return launch(kDkv, p, dh, dtype, stream);
}

const char* flash_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

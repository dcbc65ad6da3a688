// Flash attention for Hopper (sm_90a): the forward, and the backward (dQ,
// dK and dV) as one kernel.
//
// Replaces the TPU kernels of easydgl_tpu/kernels/flash_attention.py:
//
//   flash_fwd_tc_kernel   _fwd_kernel (:121; pallas_call in _flash_fwd, :318)
//   (bf16) and
//   flash_fwd_kernel
//   (fp32)
//   flash_bwd_tc_kernel   _dq_kernel  (:166; pallas_call in _flash_bwd, :366)
//   (bf16), and           _dkv_kernel (:199; pallas_call in _flash_bwd, :390)
//   flash_bwd_kernel
//   (fp32)
//
// and computes what the plain versions of easydgl_tpu_torch/kernels/
// flash_attention.py compute (flash_fwd_reference, flash_bwd_reference =
// flash_dq_reference + flash_dkv_reference), with their rounding points.
// With s_ij = (q_i . k_j) * scale in fp32, visible_ij = key_mask_j > 0 (and
// j <= i when causal), keep_ij the dropout factor:
//
//   forward  m_i = max_visible s_ij, p_ij = visible ? exp(s_ij - m_i) : 0,
//            l_i = sum_j p_ij (undropped), out_i = l_i > 0 ?
//            sum_j rnd(p_ij keep_ij) v_j / l_i : 0, lse_i = m_i + log(max(l_i,
//            1e-37)); a row that sees no key has m_i = -1e38, out 0.
//   backward p_ij = visible ? exp(s_ij - lse_i) : 0, dp_ij = (dO_i . v_j)
//            keep_ij, ds_ij = p_ij (dp_ij - delta_i), delta_i = dO_i . out_i
//            (the wrapper's); dq_i = scale sum_j rnd(ds_ij) k_j, dv_j =
//            sum_i rnd(p_ij keep_ij) dO_i, dk_j = scale sum_i rnd(ds_ij) q_i.
//
// rnd() rounds to the compute dtype (bf16) and is the identity in fp32; every
// sum is fp32; the online max of the forward rounds p relative to the running
// max, the plain version relative to the row's. Dropout keeps entry (b, h, i,
// j) by the Philox draw of counter (j, i, h, b) (common.cuh), i the query row
// of the call and j the key: the query-major forward, the key-major backward
// and the plain version draw one mask whatever their tiles (the TPU kernel
// seeds its PRNG per block, so its mask depends on the blocking).
//
// What both passes share:
//
// * Padding is skipped: the wrapper codes each (batch row, 64-key tile) as
//   dead (every key masked), full or partial (flash_live_tiles). No dead
//   tile is visited; under causal a query tile takes the key tiles up to
//   its last query and a key tile the query tiles from its diagonal on, so
//   the two passes visit the same (query tile, key tile) pairs. This is
//   exact: a masked entry adds exactly 0, and a row that sees no key gets 0
//   (out, dq) and lse = -1e38.
// * Entries are formed without a branch: a hidden entry's exponent is -inf,
//   so p = ds = 0. Only tiles that are partial, on the causal diagonal or on
//   the ragged query edge test entries one by one; under dropout every entry
//   of a visited tile draws. Exponentials are ex2 with the scale folded by
//   log2(e); the forward keeps its running max in log2 units.
//
// Forward, bf16 (flash_fwd_tc_kernel, the FlashAttention-3 forward): a
// block takes 192 queries of one (b, h) at dh = 64 (128 at dh = 128),
// heaviest first under causal, with three (two) consumer warpgroups of 64
// queries and a producer warp (its warpgroup hands its registers to the
// consumers by setmaxnreg). The producer copies the Q tiles once, then the
// live key tiles' K and V by TMA (128-byte swizzle) into a three-stage ring
// and their key mask by plain loads, each stage under a full and an empty
// mbarrier; every warpgroup consumes every stage. S = Q K^T is wgmma
// m64n64k16 with both operands in shared memory; the running max, sum and
// the (64 x dh) output accumulate in registers; the dropped probs, rounded
// to bf16, are fed back from the accumulator registers as the A operand of
// O += P V (V MN-major). A (64 x dh) tile is one or two 64-column
// sub-tiles; the wrapper zero-pads narrower heads.
//
// Forward, fp32 (flash_fwd_kernel): one block of four warps takes 64
// queries and walks the same key tiles on the CUDA cores (no TF32); each
// warp owns 16 rows, a key tile is taken in two 32-wide halves, and tiles
// stream through shared memory by cp.async one tile ahead. (Its bf16 form
// on mma.sync measured slower than the wgmma kernel at dh = 64 and 128,
// and is gone.)
//
// What bounds the forward, at the SASREC-LC shape (B=32, H=8, T=2048, dh=64,
// causal, left-padded keys): bytes. q, k, v in and out are 67 MB each in
// bf16, 0.081 ms at 3.35 TB/s; its two products over the ~30% of the causal
// pairs the mask leaves visible are ~42 GFLOP, 0.042 ms at 989 TFLOP/s. The
// kernel computes whole tiles (~36% of the causal tile pairs there), each
// entry an exp (and under dropout a ten-round Philox draw) on the CUDA
// cores, and within a warpgroup a tile's two products and its entries run in
// order.
//
// Backward: one key-major pass (the FlashAttention-2/3 schedule). A block
// owns a run of 64-key tiles of one (b, h) with K and V resident in shared
// memory, and streams the query tiles that can see them together with their
// lse and delta. For each (query tile, key tile) it forms S^T = K Q^T and
// dP^T = V dO^T once, then p and ds once: one exp and, under dropout, one
// Philox draw an entry. dV += rnd(p keep)^T dO and dK += rnd(ds)^T Q stay in
// registers; rnd(ds)^T goes to shared memory once, as the operand of the
// tile's dQ = rnd(ds) K, which is added (times scale) to a zeroed fp32
// (B, Tq, H, dh) workspace: row i of dq sums over its key tiles in whatever
// order the blocks run. The wrapper casts the workspace into dq.
//
// A dead key tile computes nothing and writes dk = dv = 0.
//
// * bf16 (flash_bwd_tc_kernel): two consumer warpgroups, 64 keys each, and
//   a producer warp a block (its warpgroup hands its registers to the
//   consumers by setmaxnreg). The producer copies K and V once, then each
//   query tile's Q and dO by TMA (128-byte swizzle) into a two-stage ring,
//   and its lse and delta by plain loads, each stage under a full and an
//   empty mbarrier. The five products are wgmma m64n64k16 with fp32
//   accumulators: S^T and dP^T with both operands in shared memory; dV and
//   dK with p and ds fed back from the accumulator registers as the A
//   operand; dQ from the swizzled dS^T tile. Each warpgroup stages its
//   scaled fp32 dQ tile in shared memory and adds it to the workspace with
//   one TMA reduction (cp.reduce.async.bulk.tensor). dh = 64; the wrapper
//   zero-pads narrower heads.
// * fp32 (flash_bwd_kernel): the same schedule on the CUDA cores, 64 keys
//   and four warps a block, tiles by cp.async, dQ by float2 atomics; no TF32.
//
// What bounds the backward, at the SASREC-LC shape (B=32, H=8, T=2048,
// dh=64, causal, left-padded keys): bytes. q, k, v, dO in and dq, dk, dv out
// are 67 MB each in bf16, 0.14 ms at 3.35 TB/s; the five products over the
// ~30% of the causal pairs that the mask leaves visible are ~105 GFLOP,
// 0.106 ms at 989 TFLOP/s. The kernel computes whole tiles (~36% of the
// causal tile pairs there), and each entry costs an exp and, under dropout,
// a ten-round Philox draw on the CUDA cores, which no tensor core takes.
//
// Limits: dh in {16, 32, 64, 128} (forward), {16, 32, 64} (backward); rows of
// q/k/v/dO/outputs start on 16-byte boundaries (the wrapper copies where
// they do not).

#include <type_traits>

#include "hopper.cuh"
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
  const int* live;        // (B, ceil(Tk / 64)) flash_live_tiles: 0 dead, 1 partial, 2 full
  float* lse_out;
  Out4 out, dk, dv;
  float* dq_ws;  // (B, Tq, H, dh) fp32, zeroed: the backward adds scale * dS @ K
  const long long* seed;  // dropout seed on the device, or null
  unsigned drop_thresh;
  float drop_scale;
  float scale;
  int B, H, Tq, Tk, causal;
};

enum Which { kFwd = 0, kBwd = 1 };

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

// The bf16 backward (flash_bwd_tc_kernel): a warpgroup's (64 x 64) K, V and
// dS^T tiles and fp32 dQ tile, a Q and a dO tile a stage, the stages' lse and
// delta, the mbarriers, and slack to align the tiles to 1024 bytes.
constexpr int kTcStages = 2;
constexpr int kTcGroups = 2;                      // consumer warpgroups, 64 keys each
constexpr int kTcKeys = 64 * kTcGroups;           // keys a block
constexpr int kTcThreads = 128 * (kTcGroups + 1);  // and a producer warpgroup
// Registers a thread after setmaxnreg: the producer warpgroup gives up most
// of its share so that each consumer thread holds its five (64 x 64) fp32
// accumulators' worth (dk, dv, S^T or dQ, dP^T, and the bf16 fragments)
// without spilling; 128 (24 + 2 x 240) fits the 65,536 of an SM.
constexpr int kTcProducerRegs = 24, kTcConsumerRegs = 240;
constexpr int kTcTile = 64 * 64;                  // bf16 values of a (64 x 64) tile, 8 KB
constexpr size_t kTcSmem = 1024 + sizeof(bf16) * (3 * kTcGroups + 2 * kTcStages) * kTcTile +
                           sizeof(float) * kTcGroups * kTcTile +
                           sizeof(float) * kTcStages * 2 * BQ + 8 * (1 + 2 * kTcStages);

// The bf16 forward (flash_fwd_tc_kernel<DH>): a warpgroup's (64 x DH) Q
// tile, a K and a V tile and 64 key-mask floats a stage, the mbarriers, and
// slack; each (64 x DH) tile is DH / 64 swizzled (64 x 64) sub-tiles.
// Consumer warpgroups of 64 queries a block: three at dh = 64 (more warps
// to interleave, 160 registers a consumer thread: 24 + 3 x 160 of a
// warpgroup thread fit the 65,536 of an SM), two at dh = 128, whose (64 x
// 128) output accumulator would spill at 160.
constexpr int kFwdStages = 3;  // K/V stages
__host__ __device__ constexpr int fwd_groups(int dh) { return dh == 64 ? 3 : 2; }
__host__ __device__ constexpr int fwd_threads(int dh) { return 128 * (fwd_groups(dh) + 1); }
__host__ __device__ constexpr size_t fwd_tc_smem(int dh) {
  return 1024 + sizeof(bf16) * (fwd_groups(dh) + 2 * kFwdStages) * (dh / 64) * kTcTile +
         sizeof(float) * kFwdStages * BK + 8 * (1 + 2 * kFwdStages);
}

template <typename T, int DH>
__host__ __device__ constexpr size_t smem_bytes_of(int which) {
  // forward: fwd_tc_smem in bf16, else q + 2 k + 2 v tiles and 2 x 64
  // key-mask floats; backward: kTcSmem in bf16, else k, v + 2 q + 2
  // dO tiles, the (64 x 64) dS^T tile, 64 key-mask floats + 2 x (lse,
  // delta)
  return which == kFwd ? (sizeof(T) == 2
                              ? fwd_tc_smem(DH < 64 ? 64 : DH)
                              : sizeof(T) * 5 * 64 * row_stride<T, DH>() + sizeof(float) * 2 * BK)
         : sizeof(T) == 2 ? kTcSmem
                          : sizeof(T) * (6 * 64 * row_stride<T, DH>() + 64 * row_stride<T, BQ>()) +
                                sizeof(float) * 5 * BK;
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
// fragment layout); fp32, A read from shared memory.
template <typename T, int DH>
struct ARows;

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
// half's 4 n-tiles, X row-major [row][d] from xs (row stride ld); o in the
// C fragment layout.
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
  return (i < Tq) & (j < Tk) & (km > 0.f) & !(causal & (j > i));
}

// Whether entries of the tile (query tile q0, key tile k0, key-tile code)
// must be tested one by one: a tile with masked or missing keys, the
// causal diagonal, and the ragged query edge.
__device__ __forceinline__ bool test_entries(const FlashParams& p, int code, int q0, int k0) {
  return code != 2 || (p.causal && k0 + BK - 1 > q0) || q0 + BQ > p.Tq;
}

// ---------------------------------------------------------------- forward

template <int DH>
__global__ void __launch_bounds__(kThreadsMma) flash_fwd_kernel(const FlashParams p) {
  using T = float;
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
  const int* live_row = p.live + (size_t)b * ((p.Tk + BK - 1) / BK);
  const T* kg = head<T>(p.k, b, h);
  const T* vg = head<T>(p.v, b, h);
  auto fetch = [&](int kt, int buf) {
    async_rows<T, DH>(ks + buf * BK * SD, SD, kg, p.k.rs, kt * BK, p.Tk);
    async_rows<T, DH>(vs + buf * BK * SD, SD, vg, p.v.rs, kt * BK, p.Tk);
    async_vec(kms + buf * BK, km_row, kt * BK, p.Tk);
  };

  // the key tiles visited: live ones (flash_live_tiles) within the causal range
  const int nkt = live_key_tiles(p, q0);
  auto next_live = [&](int t) {
    while (t < nkt && live_row[t] == 0) ++t;
    return t;
  };
  async_rows<T, DH>(qs, SD, head<T>(p.q, b, h), p.q.rs, q0, p.Tq);
  const Dropout drop = make_dropout(p.seed, p.drop_thresh, p.drop_scale);
  const float sl2 = p.scale * kLog2e;
  int kt = next_live(0);
  if (kt < nkt) fetch(kt, 0);
  cp_async_commit();

  ARows<T, DH> qa;
  float m[2] = {kDead, kDead}, l[2] = {0.f, 0.f};
  float o[DH / 8][4];
#pragma unroll
  for (int n = 0; n < DH / 8; ++n)
#pragma unroll
    for (int c = 0; c < 4; ++c) o[n][c] = 0.f;

  for (int buf = 0, first = 1; kt < nkt; buf ^= 1, first = 0) {
    const int kn = next_live(kt + 1);
    if (kn < nkt) fetch(kn, buf ^ 1);
    cp_async_commit();
    cp_async_wait_prev();
    __syncthreads();  // tile kt (and, the first time, q) is in shared memory
    if (first) qa.load(qs, SD, warp * 16, lane);
    const int j0 = kt * BK;
    const T* kb = ks + buf * BK * SD;
    const T* vb = vs + buf * BK * SD;
    const float* kmb = kms + buf * BK;
    const bool test = test_entries(p, live_row[kt], q0, j0);
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      float s[4][4];
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int c = 0; c < 4; ++c) s[n][c] = 0.f;
      qa.mul(s, kb + half * KH * SD, SD, lane);
      // without a branch: a hidden entry's exponent is -inf, so p = 0; the
      // max runs in log2 units, m = max_j s_ij scale log2(e)
      auto form = [&](auto dropped) {
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          const int i = q0 + warp * 16 + g + 8 * hr;
          float mx = kDead;
#pragma unroll
          for (int n = 0; n < 4; ++n)
#pragma unroll
            for (int c = 0; c < 2; ++c) {
              const int jj = half * KH + n * 8 + 2 * t4 + c;
              const bool vis = !test || visible(kmb[jj], i, j0 + jj, p.Tq, p.Tk, p.causal);
              float& x = s[n][2 * hr + c];
              x = vis ? x * sl2 : -INFINITY;
              mx = fmaxf(mx, x);
            }
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
          const float m_new = fmaxf(m[hr], mx);
          const float corr = fast_exp2(m[hr] - m_new);
          float sum = 0.f;
#pragma unroll
          for (int n = 0; n < 4; ++n)
#pragma unroll
            for (int c = 0; c < 2; ++c) {
              float& x = s[n][2 * hr + c];
              x = fast_exp2(x - m_new);
              sum += x;  // l sums the undropped probs
              if constexpr (decltype(dropped)::value)
                x *= drop.factor(b, h, i, j0 + half * KH + n * 8 + 2 * t4 + c);
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
      };
      if (drop.on)
        form(std::true_type());
      else
        form(std::false_type());
      pv<DH>(o, s, vb + half * KH * SD, SD, lane);  // dropped probs @ V
    }
    __syncthreads();  // the buffer is free for the tile after next
    kt = kn;
  }
  asm volatile("cp.async.wait_all;\n" ::);  // q, where no key tile came

  const int r0 = q0 + warp * 16;
  float inv[2];
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    inv[hr] = l[hr] > 0.f ? 1.f / fmaxf(l[hr], 1e-37f) : 0.f;
    const int i = r0 + g + 8 * hr;
    // a row that saw no key keeps m = -1e38 in natural units
    const float mn = l[hr] > 0.f ? m[hr] * kLn2 : kDead;
    if (t4 == 0 && i < p.Tq) p.lse_out[(size_t)bh * p.Tq + i] = mn + logf(fmaxf(l[hr], 1e-37f));
  }
  store_rows<T, DH>(head<T>(p.out, b, h), p.out.rs, o, inv, r0, p.Tq, lane);
}

// ---------------------------------------------------------------- backward
// fp32 (flash_bwd_kernel) on the CUDA cores; the schedule of the header: a
// block owns 64 keys, each warp 16 of them, and its transposed (16 keys x 32
// queries) tiles of a query tile's half are the A operands of dv += rnd(p
// keep)^T @ dO and dk += rnd(ds)^T @ Q.

// The 8-byte-aligned pair (a, b) added to dst[0], dst[1] in device memory.
__device__ __forceinline__ void atomic_add2(float* dst, float a, float b) {
  atomicAdd(reinterpret_cast<float2*>(dst), make_float2(a, b));
}

// dq_tile (64 queries x DH) = rnd(ds) @ K from dS^T in shared memory ([key]
// [query], row stride ld) and the key tile ks, scaled and added to the
// workspace rows [q0, q0 + 64) of this (b, h) (row stride wrs): each thread
// 4 query rows x DH / 8 columns on the CUDA cores.
template <int DH>
__device__ __forceinline__ void dq_tile(float* ws, int wrs, const float* dss, int ld, const float* ks,
                                        int SD, int q0, int Tq, float scale, int warp,
                                        int lane) {
  constexpr int NC = DH / 8;
  const int tid = warp * 32 + lane, r0 = (tid >> 3) * 4, c0 = (tid & 7) * NC;
  float o[4][NC];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < NC; ++c) o[r][c] = 0.f;
#pragma unroll 4
  for (int j = 0; j < BK; ++j) {
    float d[4], kv[NC];
    lds<4>(dss + j * ld + r0, d);
    lds<NC>(ks + j * SD + c0, kv);
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < NC; ++c) o[r][c] = fmaf(d[r], kv[c], o[r][c]);
  }
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int i = q0 + r0 + r;
    if (i >= Tq) continue;
#pragma unroll
    for (int c = 0; c < NC; c += 2)
      atomic_add2(ws + (size_t)i * wrs + c0 + c, o[r][c] * scale, o[r][c + 1] * scale);
  }
}

template <int DH>
__global__ void __launch_bounds__(kThreadsMma) flash_bwd_kernel(const FlashParams p) {
  using T = float;
  constexpr int SD = row_stride<T, DH>(), SS = row_stride<T, BQ>();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* ks = reinterpret_cast<T*>(smem_raw);  // [BK][SD] the block's keys
  T* vs = ks + BK * SD;                    // [BK][SD]
  T* qs = vs + BK * SD;                    // [2][BQ][SD] q of a query tile
  T* dos = qs + 2 * BQ * SD;               // [2][BQ][SD] dO
  T* dss = dos + 2 * BQ * SD;              // [BK][SS] rnd(ds)^T of the tile
  float* kms = reinterpret_cast<float*>(dss + BK * SS);  // [BK] key mask
  float* st = kms + BK;                                  // [2][2][BQ] lse, delta

  // heaviest first: under causal key tile 0 sees every query tile
  const int nkt = (p.Tk + BK - 1) / BK, nqt = (p.Tq + BQ - 1) / BQ, BH = p.B * p.H;
  const int kt = blockIdx.x / BH, bh = blockIdx.x - kt * BH, k0 = kt * BK;
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

  // a dead key tile visits no query tile and writes dk = dv = 0
  const int code = p.live[(size_t)b * nkt + kt];
  const int qt0 = code == 0 ? nqt : p.causal ? k0 / BQ : 0;
  if (qt0 < nqt) {
    async_rows<T, DH>(ks, SD, head<T>(p.k, b, h), p.k.rs, k0, p.Tk);
    async_rows<T, DH>(vs, SD, head<T>(p.v, b, h), p.v.rs, k0, p.Tk);
    async_vec(kms, p.key_mask + (size_t)b * p.Tk, k0, p.Tk);
    fetch(qt0, 0);
  }
  cp_async_commit();
  const Dropout drop = make_dropout(p.seed, p.drop_thresh, p.drop_scale);
  float* ws = p.dq_ws + ((size_t)b * p.Tq * p.H + h) * DH;

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
    const bool test = test_entries(p, code, q0, k0);
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
      // without a branch: a hidden entry's exponent is -inf, so p = ds = 0
      auto form = [&](auto dropped) {
#pragma unroll
        for (int n = 0; n < 4; ++n)
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const int jl = warp * 16 + g + 8 * (c >> 1);
            const int il = half * KH + n * 8 + 2 * t4 + (c & 1);
            const int j = k0 + jl, i = q0 + il;
            const bool vis = !test || visible(kms[jl], i, j, p.Tq, p.Tk, p.causal);
            const float pr = expf(vis ? s[n][c] * p.scale - lq[il] : -INFINITY);
            float d = dp[n][c], pd = pr;
            if constexpr (decltype(dropped)::value) {
              const float keep = drop.factor(b, h, i, j);
              pd *= keep;
              d *= keep;
            }
            s[n][c] = pd;
            dp[n][c] = pr * (d - dl[il]);
          }
      };
      if (drop.on)
        form(std::true_type());
      else
        form(std::false_type());
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int hr = 0; hr < 2; ++hr)
          store2(dss + (warp * 16 + g + 8 * hr) * SS + half * KH + n * 8 + 2 * t4,
                 dp[n][2 * hr], dp[n][2 * hr + 1]);
      pv<DH>(dv, s, db + half * KH * SD, SD, lane);   // dropped P^T @ dO
      pv<DH>(dk, dp, qb + half * KH * SD, SD, lane);  // dS^T @ Q
    }
    __syncthreads();  // rnd(ds)^T of the tile is in shared memory
    dq_tile<DH>(ws, p.H * DH, dss, SS, ks, SD, q0, p.Tq, p.scale, warp, lane);
    __syncthreads();  // dss and the buffer are free for the tile after next
    buf ^= 1;
  }
  asm volatile("cp.async.wait_all;\n" ::);

  const float one[2] = {1.f, 1.f}, scale[2] = {p.scale, p.scale};
  const int r0 = k0 + warp * 16;
  store_rows<T, DH>(head<T>(p.dk, b, h), p.dk.rs, dk, scale, r0, p.Tk, lane);
  store_rows<T, DH>(head<T>(p.dv, b, h), p.dv.rs, dv, one, r0, p.Tk, lane);
}

// ---------------------------------------------------------------- backward, bf16
// wgmma and TMA (see the header): warpgroups 0 and 1 consume, the first
// warp of warpgroup 2 produces.

struct TcMaps {
  CUtensorMap q, k, v, dout;  // (64, T, H, B) bf16, boxes of 64 rows x 64
  CUtensorMap dq;             // (64, Tq, H, B) fp32 workspace, boxes of 64 rows x 32
};

// Rows of a warpgroup accumulator (64 x 64: the thread's rows r0 + g and
// r0 + g + 8, columns 8 n + 2 t4 + c at d[4 n + 2 hr + c]) times mul[hr]
// into bf16 rows [.., r < nrows) of dst.
__device__ __forceinline__ void store_acc(bf16* dst, long long rs, const float (&d)[32],
                                          const float (&mul)[2], int r0, int nrows, int lane) {
  const int g = lane >> 2, t4 = lane & 3;
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int r = r0 + g + 8 * hr;
    if (r >= nrows) continue;
#pragma unroll
    for (int n = 0; n < 8; ++n)
      store2(dst + (long long)r * rs + 8 * n + 2 * t4, d[4 * n + 2 * hr] * mul[hr],
             d[4 * n + 2 * hr + 1] * mul[hr]);
  }
}

__global__ void __launch_bounds__(kTcThreads, 1)
    flash_bwd_tc_kernel(const FlashParams p, const __grid_constant__ TcMaps maps) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* base = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  bf16* ks = reinterpret_cast<bf16*>(base);  // [group][64 keys][64], swizzled
  bf16* vs = ks + kTcGroups * kTcTile;
  bf16* qs = vs + kTcGroups * kTcTile;        // [stage][64 queries][64]
  bf16* dos = qs + kTcStages * kTcTile;       // [stage][64 queries][64]
  bf16* dss = dos + kTcStages * kTcTile;      // [group][64 keys][64 queries] rnd(ds)^T
  float* dqs = reinterpret_cast<float*>(dss + kTcGroups * kTcTile);  // [group][2][64][32]
  float* stats = dqs + kTcGroups * kTcTile;   // [stage][lse, delta][64]
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(stats + kTcStages * 2 * BQ);
  uint64_t* full = kv_full + 1;                             // [stage]
  uint64_t* empty = full + kTcStages;                       // [stage]

  // heaviest first: under causal key block 0 sees every query tile
  const int nkt = (p.Tk + BK - 1) / BK, nqt = (p.Tq + BQ - 1) / BQ, BH = p.B * p.H;
  const int kb = blockIdx.x / BH, bh = blockIdx.x - kb * BH, k0 = kb * kTcKeys;
  const int b = bh / p.H, h = bh - b * p.H;
  const int lane = threadIdx.x & 31;
  int warp = threadIdx.x >> 5;  // within its warpgroup, for the consumers
  bool any_live = false;
  for (int w = 0; w < kTcGroups; ++w)
    any_live |= kb * kTcGroups + w < nkt && p.live[(size_t)b * nkt + kb * kTcGroups + w] != 0;
  const int qt0 = !any_live ? nqt : p.causal ? k0 / BQ : 0;
  const int ntiles = nqt - qt0;
  if (ntiles <= 0) {  // dead key tiles, or ones no query reaches: dk = dv = 0
    bf16* dkg = head<bf16>(p.dk, b, h);
    bf16* dvg = head<bf16>(p.dv, b, h);
    for (int e = threadIdx.x; e < kTcKeys * 32; e += blockDim.x) {
      const int r = k0 + e / 32, c = 2 * (e % 32);
      if (r >= p.Tk) break;
      store2(dkg + (long long)r * p.dk.rs + c, 0.f, 0.f);
      store2(dvg + (long long)r * p.dv.rs + c, 0.f, 0.f);
    }
    return;
  }
  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < kTcStages; ++s) {
      mbar_init(full + s, 32);
      mbar_init(empty + s, 128 * kTcGroups);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= 4 * kTcGroups) {  // ---- producer: its first warp works
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kTcProducerRegs));
    if (warp > 4 * kTcGroups) return;
    if (lane == 0) {
      mbar_arrive_tx(kv_full, 2 * kTcGroups * kTcTile * sizeof(bf16));
      for (int w = 0; w < kTcGroups; ++w) {
        tma_rows(ks + w * kTcTile, &maps.k, kv_full, k0 + 64 * w, h, b);
        tma_rows(vs + w * kTcTile, &maps.v, kv_full, k0 + 64 * w, h, b);
      }
    }
    const size_t row0 = (size_t)bh * p.Tq;
    for (int it = 0; it < ntiles; ++it) {
      const int s = it % kTcStages, q0 = (qt0 + it) * BQ;
      mbar_wait(empty + s, ((it / kTcStages) & 1) ^ 1);
      float* st = stats + s * 2 * BQ;
      for (int r = lane; r < BQ; r += 32) {
        const bool ok = q0 + r < p.Tq;
        st[r] = ok ? p.lse[row0 + q0 + r] : 0.f;
        st[BQ + r] = ok ? p.delta[row0 + q0 + r] : 0.f;
      }
      if (lane == 0) {
        mbar_arrive_tx(full + s, 2 * kTcTile * sizeof(bf16));
        tma_rows(qs + s * kTcTile, &maps.q, full + s, q0, h, b);
        tma_rows(dos + s * kTcTile, &maps.dout, full + s, q0, h, b);
      } else {
        mbar_arrive(full + s);
      }
    }
    return;
  }

  // ---- consumers: warpgroup wg owns key tile kt = kb * groups + wg, keys
  // kw = k0 + 64 wg ..; thread (warp, g, t4) holds keys kw + 16 warp + g (+8)
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kTcConsumerRegs));
  const int wg = warp >> 2, kt = kb * kTcGroups + wg, kw = k0 + 64 * wg;
  const int code = kt < nkt ? p.live[(size_t)b * nkt + kt] : 0;
  const int bar_id = 1 + wg;  // the warpgroup's named barrier
  warp &= 3;
  const int g = lane >> 2, t4 = lane & 3;
  float kmr[2];
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int j = kw + 16 * warp + g + 8 * hr;
    kmr[hr] = j < p.Tk ? p.key_mask[(size_t)b * p.Tk + j] : 0.f;
  }
  const Dropout drop = make_dropout(p.seed, p.drop_thresh, p.drop_scale);
  const float sl2 = p.scale * kLog2e;
  const bool issuer = (threadIdx.x & 127) == 0;  // of the warpgroup's dQ reductions
  float* dqw = dqs + wg * kTcTile;               // two (64 x 32) swizzled halves
  bf16* dsw = dss + wg * kTcTile;
  const uint64_t kd = sw128_desc(ks + wg * kTcTile), vd = sw128_desc(vs + wg * kTcTile),
                 sd = sw128_desc(dsw);
  float dk[32], dv[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) dk[i] = dv[i] = 0.f;
  mbar_wait(kv_full, 0);

  for (int it = 0; it < ntiles; ++it) {
    const int s = it % kTcStages, q0 = (qt0 + it) * BQ;
    mbar_wait(full + s, (it / kTcStages) & 1);
    if (code == 0 || (p.causal && q0 + BQ <= kw)) {  // no visible entry for these keys
      mbar_arrive(empty + s);
      continue;
    }
    const uint64_t qd = sw128_desc(qs + s * kTcTile), dd = sw128_desc(dos + s * kTcTile);
    float sa[32], pa[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) sa[i] = pa[i] = 0.f;
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_ss<0, 0>(sa, kd + 2 * kk, qd + 2 * kk, 1);  // K Q^T
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_ss<0, 0>(pa, vd + 2 * kk, dd + 2 * kk, 1);  // V dO^T
    wg_commit();
    wg_wait();
    reg_fence(sa);
    reg_fence(pa);

    // p and ds of entry (key 16 warp + g + 8 hr, query 8 n + 2 t4 + c),
    // without a branch: a hidden entry's exponent is -inf, so p = ds = 0
    const bool test = test_entries(p, code, q0, kw);
    const float* lq = stats + s * 2 * BQ;
    auto form = [&](auto dropped) {
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int il = 8 * n + 2 * t4 + c, i = q0 + il;
          const float lse2 = lq[il] * kLog2e, dlt = lq[BQ + il];
#pragma unroll
          for (int hr = 0; hr < 2; ++hr) {
            const int x = 4 * n + 2 * hr + c, j = kw + 16 * warp + g + 8 * hr;
            const bool vis = !test || visible(kmr[hr], i, j, p.Tq, p.Tk, p.causal);
            const float pr = fast_exp2(vis ? fmaf(sa[x], sl2, -lse2) : -INFINITY);
            float d = pa[x], pd = pr;
            if constexpr (decltype(dropped)::value) {
              const float keep = drop.factor(b, h, i, j);
              pd *= keep;
              d *= keep;
            }
            sa[x] = pd;
            pa[x] = pr * (d - dlt);
          }
        }
    };
    if (drop.on)
      form(std::true_type());
    else
      form(std::false_type());
    // rounded to bf16: the A fragments of P^T and dS^T (k step kk: queries
    // 16 kk ..), and dS^T into shared memory in the 128-byte swizzle
    uint32_t pf[16], df[16];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        pf[4 * kk + e] = pack_bf16(sa[8 * kk + 2 * e], sa[8 * kk + 2 * e + 1]);
        df[4 * kk + e] = pack_bf16(pa[8 * kk + 2 * e], pa[8 * kk + 2 * e + 1]);
      }
    if (issuer) asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
    // the last tile's dQ product has read dsw, its reduction dqw
    asm volatile("bar.sync %0, 128;\n" ::"r"(bar_id) : "memory");
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int r = 16 * warp + g + 8 * hr;
        *reinterpret_cast<uint32_t*>(reinterpret_cast<unsigned char*>(dsw) + r * 128 +
                                     ((n ^ g) << 4) + 4 * t4) =
            df[4 * (n >> 1) + 2 * (n & 1) + hr];
      }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    asm volatile("bar.sync %0, 128;\n" ::"r"(bar_id) : "memory");  // dS^T is in shared memory

    float qa[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) qa[i] = 0.f;
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_rs(dv, pf + 4 * kk, dd + 128 * kk);  // P^T dO
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_rs(dk, df + 4 * kk, qd + 128 * kk);  // dS^T Q
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_ss<1, 1>(qa, sd + 128 * kk, kd + 128 * kk, 1);  // dS K
    wg_commit();
    wg_wait();
    reg_fence(dv);
    reg_fence(dk);
    reg_fence(qa);
    mbar_arrive(empty + s);  // the stage's Q, dO, lse and delta are free
    // scale * dQ into two (64 x 32) fp32 halves in the 128-byte swizzle
    // (column 8 m + 2 t4 of a half is 16-byte chunk 2 m + t4 / 2), then
    // added to the workspace by TMA
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int r = 16 * warp + g + 8 * hr, chunk = (2 * (n & 3) + (t4 >> 1)) ^ g;
        *reinterpret_cast<float2*>(reinterpret_cast<unsigned char*>(dqw) + (n >> 2) * 8192 +
                                   r * 128 + (chunk << 4) + 8 * (t4 & 1)) =
            make_float2(qa[4 * n + 2 * hr] * p.scale, qa[4 * n + 2 * hr + 1] * p.scale);
      }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    asm volatile("bar.sync %0, 128;\n" ::"r"(bar_id) : "memory");
    if (issuer) {
      tma_reduce_add(&maps.dq, dqw, 0, q0, h, b);
      tma_reduce_add(&maps.dq, dqw + 2048, 32, q0, h, b);
      asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
    }
  }
  if (issuer) asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
  const float one[2] = {1.f, 1.f}, scale[2] = {p.scale, p.scale};
  store_acc(head<bf16>(p.dk, b, h), p.dk.rs, dk, scale, kw + 16 * warp, p.Tk, lane);
  store_acc(head<bf16>(p.dv, b, h), p.dv.rs, dv, one, kw + 16 * warp, p.Tk, lane);
}

// ---------------------------------------------------------------- forward, bf16
// wgmma and TMA (see the header): warpgroups 0 and 1 consume, 64 queries
// each, the first warp of warpgroup 2 produces. DH = 64 or 128.

template <int DH>
__global__ void __launch_bounds__(fwd_threads(DH), 1)
    flash_fwd_tc_kernel(const FlashParams p, const __grid_constant__ TcMaps maps) {
  constexpr int NS = DH / 64;  // 64-column sub-tiles of a (64 x DH) tile
  constexpr int kTile = NS * kTcTile;
  constexpr int kFwdGroups = fwd_groups(DH), kFwdQueries = 64 * kFwdGroups;
  constexpr int kConsumerRegs = kFwdGroups == 3 ? 160 : kTcConsumerRegs;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* base = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  bf16* qs = reinterpret_cast<bf16*>(base);  // [group][sub][64 queries][64], swizzled
  bf16* ks = qs + kFwdGroups * kTile;         // [stage][sub][64 keys][64]
  bf16* vs = ks + kFwdStages * kTile;         // [stage][sub][64 keys][64]
  float* kms = reinterpret_cast<float*>(vs + kFwdStages * kTile);  // [stage][64] key mask
  uint64_t* q_full = reinterpret_cast<uint64_t*>(kms + kFwdStages * BK);
  uint64_t* full = q_full + 1;                // [stage]
  uint64_t* empty = full + kFwdStages;        // [stage]

  // heaviest first: under causal the last query block sees every key tile
  const int BH = p.B * p.H, nqb = (p.Tq + kFwdQueries - 1) / kFwdQueries;
  const int qb = nqb - 1 - (int)blockIdx.x / BH, bh = blockIdx.x % BH, q0 = qb * kFwdQueries;
  const int b = bh / p.H, h = bh - b * p.H;
  const int lane = threadIdx.x & 31;
  int warp = threadIdx.x >> 5;
  // the key tiles visited: live ones (flash_live_tiles) within the causal range
  const int nkt_all = (p.Tk + BK - 1) / BK;
  const int nkt = p.causal ? imin(nkt_all, (imin(q0 + kFwdQueries, p.Tq) - 1) / BK + 1) : nkt_all;
  const int* live_row = p.live + (size_t)b * nkt_all;
  auto next_live = [&](int t) {
    while (t < nkt && live_row[t] == 0) ++t;
    return t;
  };
  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kFwdStages; ++s) {
      mbar_init(full + s, 32);
      mbar_init(empty + s, 128 * kFwdGroups);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (warp >= 4 * kFwdGroups) {  // ---- producer: its first warp works
    regs_dec<kTcProducerRegs>();
    if (warp > 4 * kFwdGroups) return;
    if (lane == 0) {
      mbar_arrive_tx(q_full, kFwdGroups * kTile * sizeof(bf16));
      for (int w = 0; w < kFwdGroups; ++w)
        for (int c = 0; c < NS; ++c)
          tma_rows(qs + w * kTile + c * kTcTile, &maps.q, q_full, q0 + 64 * w, h, b, 64 * c);
    }
    const float* km_row = p.key_mask + (size_t)b * p.Tk;
    int it = 0;
    for (int kt = next_live(0); kt < nkt; kt = next_live(kt + 1), ++it) {
      const int s = it % kFwdStages, j0 = kt * BK;
      mbar_wait(empty + s, ((it / kFwdStages) & 1) ^ 1);
      for (int r = lane; r < BK; r += 32) kms[s * BK + r] = j0 + r < p.Tk ? km_row[j0 + r] : 0.f;
      if (lane == 0) {
        mbar_arrive_tx(full + s, 2 * kTile * sizeof(bf16));
        for (int c = 0; c < NS; ++c) {
          tma_rows(ks + s * kTile + c * kTcTile, &maps.k, full + s, j0, h, b, 64 * c);
          tma_rows(vs + s * kTile + c * kTcTile, &maps.v, full + s, j0, h, b, 64 * c);
        }
      } else {
        mbar_arrive(full + s);
      }
    }
    return;
  }

  // ---- consumers: warpgroup wg owns queries qw = q0 + 64 wg ..; thread
  // (warp, g, t4) holds queries qw + 16 warp + g (+8) and, of a key tile,
  // keys 8 n + 2 t4 (+1)
  regs_inc<kConsumerRegs>();
  const int wg = warp >> 2, qw = q0 + 64 * wg;
  warp &= 3;
  const int g = lane >> 2, t4 = lane & 3;
  const Dropout drop = make_dropout(p.seed, p.drop_thresh, p.drop_scale);
  const float sl2 = p.scale * kLog2e;
  const uint64_t qd = sw128_desc(qs + wg * kTile);
  float o[NS][32], m[2] = {kDead, kDead}, l[2] = {0.f, 0.f};
#pragma unroll
  for (int c = 0; c < NS; ++c)
#pragma unroll
    for (int i = 0; i < 32; ++i) o[c][i] = 0.f;
  mbar_wait(q_full, 0);

  int it = 0;
  for (int kt = next_live(0); kt < nkt; kt = next_live(kt + 1), ++it) {
    const int s = it % kFwdStages, j0 = kt * BK;
    mbar_wait(full + s, (it / kFwdStages) & 1);
    if (qw >= p.Tq || (p.causal && j0 > qw + 63)) {  // no query of the warpgroup sees these keys
      mbar_arrive(empty + s);
      continue;
    }
    float sa[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) sa[i] = 0.f;
    // a sub-tile is 8 KB, 512 in the descriptors' units
    const uint64_t kd = sw128_desc(ks + s * kTile), vd = sw128_desc(vs + s * kTile);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < 4 * NS; ++kk) {  // Q K^T
      const int step = 512 * (kk >> 2) + 2 * (kk & 3);
      wgmma_ss<0, 0>(sa, qd + step, kd + step, 1);
    }
    wg_commit();
    wg_wait();
    reg_fence(sa);

    // p of entry (query 16 warp + g + 8 hr, key 8 n + 2 t4 + c) at sa[4 n + 2 hr + c],
    // without a branch: a hidden entry's exponent is -inf, so p = 0; the
    // max runs in log2 units, m = max_j s_ij scale log2(e)
    const bool test = test_entries(p, live_row[kt], qw, j0);
    const float* kmb = kms + s * BK;
    auto form = [&](auto dropped) {
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int i = qw + 16 * warp + g + 8 * hr;
        float mx = kDead;
#pragma unroll
        for (int n = 0; n < 8; ++n)
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const int jl = 8 * n + 2 * t4 + c;
            const bool vis = !test || visible(kmb[jl], i, j0 + jl, p.Tq, p.Tk, p.causal);
            float& x = sa[4 * n + 2 * hr + c];
            x = vis ? x * sl2 : -INFINITY;
            mx = fmaxf(mx, x);
          }
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float m_new = fmaxf(m[hr], mx);
        const float corr = fast_exp2(m[hr] - m_new);
        float sum = 0.f;
#pragma unroll
        for (int n = 0; n < 8; ++n)
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            float& x = sa[4 * n + 2 * hr + c];
            x = fast_exp2(x - m_new);
            sum += x;  // l sums the undropped probs
            if constexpr (decltype(dropped)::value)
              x *= drop.factor(b, h, i, j0 + 8 * n + 2 * t4 + c);
          }
        sum += __shfl_xor_sync(0xffffffffu, sum, 1);
        sum += __shfl_xor_sync(0xffffffffu, sum, 2);
        l[hr] = l[hr] * corr + sum;
        m[hr] = m_new;
#pragma unroll
        for (int c = 0; c < NS; ++c)
#pragma unroll
          for (int n = 0; n < 8; ++n) {
            o[c][4 * n + 2 * hr] *= corr;
            o[c][4 * n + 2 * hr + 1] *= corr;
          }
      }
    };
    if (drop.on)
      form(std::true_type());
    else
      form(std::false_type());
    // the dropped probs rounded to bf16: the A fragments of P (k step kk:
    // keys 16 kk ..), then O += P V with V MN-major
    uint32_t pf[16];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        pf[4 * kk + e] = pack_bf16(sa[8 * kk + 2 * e], sa[8 * kk + 2 * e + 1]);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int c = 0; c < NS; ++c) wgmma_rs(o[c], pf + 4 * kk, vd + 512 * c + 128 * kk);
    wg_commit();
    wg_wait();
#pragma unroll
    for (int c = 0; c < NS; ++c) reg_fence(o[c]);
    mbar_arrive(empty + s);  // the stage's K, V and mask are free
  }

  float inv[2];
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    inv[hr] = l[hr] > 0.f ? 1.f / fmaxf(l[hr], 1e-37f) : 0.f;
    const int i = qw + 16 * warp + g + 8 * hr;
    // a row that saw no key keeps m = -1e38 in natural units
    const float mn = l[hr] > 0.f ? m[hr] * kLn2 : kDead;
    if (t4 == 0 && i < p.Tq) p.lse_out[(size_t)bh * p.Tq + i] = mn + logf(fmaxf(l[hr], 1e-37f));
  }
#pragma unroll
  for (int c = 0; c < NS; ++c)
    store_acc(head<bf16>(p.out, b, h) + 64 * c, p.out.rs, o[c], inv, qw + 16 * warp, p.Tq, lane);
}

// ---------------------------------------------------------------- launch

// The TMA map of a (B, H, T, width) operand with element strides (bs, hs,
// rs): boxes of 64 rows x `cols` columns, 128-byte swizzle, zeros read (and
// nothing written) past row T.
bool rows_map(CUtensorMap* map, CUtensorMapDataType type, size_t item, const void* ptr,
              long long bs, long long hs, long long rs, int T, int H, int B, int cols,
              int width = 64) {
  const cuuint64_t dims[4] = {(cuuint64_t)width, (cuuint64_t)T, (cuuint64_t)H, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)rs * item, (cuuint64_t)hs * item,
                                 (cuuint64_t)bs * item};
  const cuuint32_t box[4] = {(cuuint32_t)cols, 64, 1, 1};
  return encode_map(map, type, 4, ptr, dims, strides, box);
}

bool seq_map(CUtensorMap* map, const Seq4& x, int T, int H, int B, int width = 64) {
  return rows_map(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, sizeof(bf16), x.p, x.bs, x.hs, x.rs, T,
                  H, B, 64, width);
}

template <typename T, int DH>
cudaError_t launch_one(int which, const FlashParams& p, cudaStream_t s) {
  const size_t bytes = smem_bytes_of<T, DH>(which);
  if constexpr (std::is_same<T, bf16>::value && DH >= 64) {
    if (which == kFwd) {
      TcMaps maps;
      if (!seq_map(&maps.q, p.q, p.Tq, p.H, p.B, DH) ||
          !seq_map(&maps.k, p.k, p.Tk, p.H, p.B, DH) || !seq_map(&maps.v, p.v, p.Tk, p.H, p.B, DH))
        return cudaErrorInvalidValue;
      constexpr int queries = 64 * fwd_groups(DH);
      return go(flash_fwd_tc_kernel<DH>, p.B * p.H * ((p.Tq + queries - 1) / queries),
                fwd_threads(DH), bytes, s, p, maps);
    }
  }
  if (which == kFwd) {
    if constexpr (std::is_same<T, float>::value)
      return go(flash_fwd_kernel<DH>, p.B * p.H * ((p.Tq + BQ - 1) / BQ), kThreadsMma, bytes, s,
                p);
    else
      return cudaErrorInvalidValue;  // bf16 heads narrower than 64 come padded
  }
  if constexpr (std::is_same<T, bf16>::value && DH == 64) {
    TcMaps maps;
    // the workspace is (B, Tq, H, 64) fp32
    if (!seq_map(&maps.q, p.q, p.Tq, p.H, p.B) || !seq_map(&maps.k, p.k, p.Tk, p.H, p.B) ||
        !seq_map(&maps.v, p.v, p.Tk, p.H, p.B) || !seq_map(&maps.dout, p.dout, p.Tq, p.H, p.B) ||
        !rows_map(&maps.dq, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, sizeof(float), p.dq_ws,
                  (long long)p.Tq * p.H * 64, 64, (long long)p.H * 64, p.Tq, p.H, p.B, 32))
      return cudaErrorInvalidValue;
    return go(flash_bwd_tc_kernel, p.B * p.H * ((p.Tk + kTcKeys - 1) / kTcKeys), kTcThreads,
              bytes, s, p, maps);
  } else if constexpr (std::is_same<T, float>::value && DH <= 64) {
    return go(flash_bwd_kernel<DH>, p.B * p.H * ((p.Tk + BK - 1) / BK), kThreadsMma, bytes, s,
              p);
  }
  return cudaErrorInvalidValue;  // bf16 heads narrower than 64 come padded
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

// Dynamic shared memory of one block of kernel `which` (0 forward, 1
// backward), in bytes; above 232448 a kernel cannot run.
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
              long long v_hs, long long v_rs, const void* key_mask, const void* live,
              const void* seed, unsigned drop_thresh, float drop_scale, void* out,
              long long o_bs, long long o_hs, long long o_rs, void* lse, int B, int H, int Tq,
              int Tk, int dh, int causal, float scale, int dtype, void* stream) {
  FlashParams p = base_params(q, q_bs, q_hs, q_rs, k, k_bs, k_hs, k_rs, v, v_bs, v_hs, v_rs,
                              key_mask, seed, drop_thresh, drop_scale, B, H, Tq, Tk, causal,
                              scale);
  p.live = static_cast<const int*>(live);
  p.out = {out, o_bs, o_hs, o_rs};
  p.lse_out = static_cast<float*>(lse);
  return launch(kFwd, p, dh, dtype, stream);
}

int flash_bwd(const void* q, long long q_bs, long long q_hs, long long q_rs, const void* k,
              long long k_bs, long long k_hs, long long k_rs, const void* v, long long v_bs,
              long long v_hs, long long v_rs, const void* dout, long long d_bs, long long d_hs,
              long long d_rs, const void* key_mask, const void* live, const void* lse,
              const void* delta, const void* seed, unsigned drop_thresh, float drop_scale,
              void* dq_ws, void* dk, long long dk_bs, long long dk_hs, long long dk_rs, void* dv,
              long long dv_bs, long long dv_hs, long long dv_rs, int B, int H, int Tq, int Tk,
              int dh, int causal, float scale, int dtype, void* stream) {
  FlashParams p = base_params(q, q_bs, q_hs, q_rs, k, k_bs, k_hs, k_rs, v, v_bs, v_hs, v_rs,
                              key_mask, seed, drop_thresh, drop_scale, B, H, Tq, Tk, causal,
                              scale);
  p.dout = {dout, d_bs, d_hs, d_rs};
  p.live = static_cast<const int*>(live);
  p.lse = static_cast<const float*>(lse);
  p.delta = static_cast<const float*>(delta);
  p.dq_ws = static_cast<float*>(dq_ws);
  p.dk = {dk, dk_bs, dk_hs, dk_rs};
  p.dv = {dv, dv_bs, dv_hs, dv_rs};
  return launch(kBwd, p, dh, dtype, stream);
}

const char* flash_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

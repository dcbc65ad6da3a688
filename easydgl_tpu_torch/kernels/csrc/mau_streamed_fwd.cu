// Streamed MAU/BiMAU forward for Hopper (sm_90a): the two-sweep long-context
// schedule as three kernels.
//
// Replaces the TPU kernels of easydgl_tpu/kernels/mau_streamed.py:
//
//   mau_stats_kernel      _stats_kernel   (pallas_call in _fwd_impl, :607)
//   mau_int_split_kernel, mau_int_fwd_tc_kernel
//                         _int_fwd_kernel (pallas_call in _int_fwd, :239)
//   mau_out_tc_kernel (bf16), mau_out_kernel (fp32)
//                         _out_kernel     (pallas_call in _fwd_impl, :634)
//
// and computes what easydgl_tpu_torch/kernels/mau_blocked.py computes, with
// its rounding points. q/k/v/t are read on the natural (B, T, C) layout, head
// h in channels [h*dh, (h+1)*dh); the key mask and the one-hot per batch row.
// With NEG = -(2^32)+1 for a real key that is masked or causally hidden:
//
//   stats      m = max_j s_ij, l = sum_j exp(s_ij - m),
//              su = sum_j rnd(exp(s_ij - m)) t_j / l,  s = q k^T / sqrt(dh)
//   intensity  lam[e] = s_e softplus(raw[e] / s_e), s_e = exp(scaling[e]),
//              raw[e] = sum_d sigmoid([su | iv] Wd + bd)[e*dh + d] w[e, d]
//   out        out_i = sum_j rnd(drop(iqk_ij exp(s_ij - m) / l)) v_j,
//              iqk_ij = rnd(lam_i) . onehot_j  (BiMAU: 1 where j == i)
//
// rnd() rounds to the compute dtype (bf16) and is the identity in fp32; every
// sum is fp32. m, l, su and lam are fp32 (JAX's streamed path rounds lam to
// the compute dtype; the blocked path and this one do not). A row with no
// visible key is uniform over the real keys (m = NEG). Dropout keeps entry
// (b, h, i, j) by the Philox draw of common.cuh, j the global key index, as
// the fused kernel and the plain versions draw it.
//
// The intensity head is fp32 in both compute dtypes (the TPU kernel's x is
// fp32, _int_prep :194): its product runs on the tensor cores in three bf16
// products of a hi/lo split of each fp32 operand (about 2^-16 of |a||b| a
// term), the interval entering as an fp32 rank-1 term for every dh (the TPU
// kernel drops it when dh % 128 == 0, ROADMAP C2).
//
// Design. The stats kernel and the fp32 out kernel give one block to 64
// queries of one (b, h) and loop over 64-key tiles: the TPU's sequential
// grid axis becomes the loop, its VMEM scratch the block's registers. Per
// tile the (64 x 64) logits, probs and modulation never leave the SM; the
// online (m, l) and the output accumulators stay in registers. Under
// causal, key tiles wholly after a query tile's last query are skipped,
// unless no real key lies at or before its first query: then a row of the
// tile may see no key at all, and such a row must be uniform over every
// real key, as in the plain version (the TPU kernel skips there too and so
// differs from its own blocked path on such rows).
//
// * stats, bf16 (the main path): four warps of 16 queries each, the
//   flash-attention schedule on the tensor cores (mma.sync m16n8k16, fp32
//   accumulate), each key tile in two 32-key halves.
// * out, bf16 (the main path; mau_out_tc_kernel, on flash_fwd_tc_kernel's
//   pattern, the machinery of mau_streamed.cuh): a block owns 192 queries
//   of one (b, h), three consumer warpgroups of 64 and a producer warp
//   whose warpgroup hands its registers to them by setmaxnreg (24 / 160).
//   Each warpgroup's Q and lam tiles stay resident; the producer streams
//   the visited key tiles' K, V and one-hot by TMA (128-byte swizzle) into
//   a ring of two stages under full and empty mbarriers, with their key
//   mask by plain loads. Per key tile, on wgmma m64n64k16 with fp32
//   accumulators: S = Q K^T and IQK = lam one-hot^T (both operands in
//   shared memory, the events as IQK's reduction), then u = rnd(iqk p
//   keep) formed in the accumulators (BiMAU: iqk = 1 on the diagonal) and
//   fed back as the A operand of O += U V (V MN-major). Only the live key
//   tiles are visited (the rule of mau_streamed.cuh, from the plan each
//   block makes of its batch row's key mask: a tile with no real key only
//   where a row of the query tile sees no key); p = exp2(s scale log2 e -
//   m log2 e) / l with 1 / l once a row and no branch (a hidden key's
//   exponent is (NEG - m) log2 e, 0 in a row that sees no key), and only
//   partial tiles and the diagonals test entries one by one (at dropout 0
//   the other tiles run a form without the tests). dh = 128 takes two
//   64-column sub-tiles a head and two consumer warpgroups (a (64 x 128)
//   output accumulator needs 240 registers); narrower heads come
//   zero-padded to 64, lam and the one-hot to 64-event tiles. The events
//   of a tile set the shared memory (mau_out_smem_bytes): three
//   warpgroups (two at dh = 128) up to E = 256, else one warpgroup, with
//   one stage where two do not fit (E up to 768 at dh = 64, 704 at dh =
//   128). At E = 64, T = 2048: 100,012 bytes of shared memory; ptxas gives
//   a consumer thread 160 registers (84 bytes spilled).
// * fp32: 256 threads on the CUDA cores; a thread owns a 4 x 4 tile of each
//   (64 x 64) product and 4 rows x dh/16 columns of the outputs; operands
//   sit in shared memory as fp32 (q, k, lam and the one-hot transposed, so
//   each step is two 16-byte loads and 16 FMA).
//
// The intensity head (mau_int_fwd_tc_kernel, on the output kernel's
// pattern): mau_int_split_kernel first splits Wd's seq_units lanes into bf16
// hi and lo (dh, E*dh) once a launch. A block owns 192 rows (128 at dh =
// 128), three consumer warpgroups of 64 (two) and a producer warp
// (setmaxnreg 24 / 160, 24 / 240). Each consumer keeps its rows' seq_units
// as hi/lo A fragments in registers; the producer streams Wd's 64-column
// tiles, hi and lo, by TMA (128-byte swizzle, B MN-major) into a ring of
// four stages, with the tile's interval lane, bd and w by plain loads. Per
// tile, on wgmma m64n64k16 with fp32 accumulators: z = su Wd_tile as lo hi +
// hi lo + hi hi, then the interval's rank-1 term and bd in fp32, the exact
// sigmoid (ex2 and a reciprocal), the weight w, and each event's dh columns
// summed in the accumulator layout (in-thread sums, then the quad); an
// event's sum goes through the scaled softplus and out as lam as soon as its
// last tile is done (dh = 128: two tiles). Two accumulators: the next
// tile's products run while this tile's sigmoids are formed. The (rows,
// E*dh) activation and raw never leave the SM, and any E fits.
//
// What bounds it, at the EasyDGL-LC eval shape (B=8, H=8, T=2048, dh=64,
// E=64): operations. stats 68.7 GFLOP, out 103.1 GFLOP over every pair
// (bf16 tensor-core bounds 0.069 and 0.104 ms; chip_smoke.py's bounds count
// only the visible pairs), intensity one product of 131,072 x 65 x 4,096
// (70 GFLOP: 1.05 ms in fp32 at 67 TFLOP/s, 0.21 ms as three bf16 passes at
// 989) plus 537 M sigmoids, two special-function ops each (ex2 and a
// reciprocal: at least 0.26 ms at 16 a clock an SM). The first two also
// evaluate one exp per (query, key) entry they visit, and under dropout the
// output kernel a ten-round Philox draw, on the CUDA cores: these, not the
// products, set its time. In bf16 the next key tile is fetched (cp.async, TMA) while this
// one is computed; in fp32 the loads wait.
//
// Limits: dh in {16, 32, 64, 128}; the out kernel's shared memory
// (mau_out_smem_bytes) within 227 KB: in fp32 E up to ~180 at dh = 64. The
// intensity head takes any E.

#include <initializer_list>
#include <type_traits>

#include "mau_streamed.cuh"

namespace {

using namespace port;

struct StatsParams {
  Seq q, k, t;
  const float* key_mask;  // (B, Tk)
  float* m;               // (B, H, Tq)
  float* l;               // (B, H, Tq)
  float* su;              // (B, H, Tq, dh)
  float scale;
  int B, Tq, Tk, H, causal;
};

struct OutParams {
  Seq q, k, v;
  const float* key_mask;  // (B, Tk)
  const float* onehot;    // (B, Tk, E)
  const float* lam;       // (B, H, Tq, E)
  const float* m;         // (B, H, Tq)
  const float* l;         // (B, H, Tq)
  const long long* seed;  // dropout seed on the device, or null
  unsigned drop_thresh;
  float drop_scale;
  void* out;              // (B, Tq, H*dh), the compute dtype
  float scale;
  int B, Tq, Tk, H, E, causal, diag_reset;
  int EP, stages;         // bf16: lam / one-hot width (a multiple of 64), ring stages
};

struct IntParams {
  const float* su;         // (rows, dh), rows = B*H*Tq
  const float* intervals;  // (B, Tq)
  const float* wd;         // (dh+1, E*dh)
  const float* bd;         // (E*dh,)
  const float* w;          // (E*dh,)
  const float* scaling;    // (E,)
  bf16* wd_hi;             // (dh, E*dh) scratch: Wd's seq_units lanes split, hi
  bf16* wd_lo;             // lo
  float* lam;              // (rows, E)
  int rows, H, Tq, E;
};

// Shared memory, in floats.
__host__ __device__ inline int stats_smem_floats(int dh) {
  return 2 * dh * LD + BK * (dh + 4) + BQ * LD + BK;
}
__host__ __device__ inline int out_smem_floats(int dh, int E) {
  return 2 * dh * LD + BK * (dh + 4) + 2 * E * LD + BQ * LD + BK + 2 * BQ;
}

// rows [r0, r0 + 64) x n columns of a row-major source (row stride rs) into
// dst[c][r] (row stride LD), rounded to R; rows >= nrows are zero. Each
// thread reads 4 rows of one column and stores them as one float4.
template <typename R, typename S>
__device__ __forceinline__ void load_t(float* dst, const S* src, long long rs,
                                       int n, int r0, int nrows) {
  for (int idx = threadIdx.x; idx < n * 16; idx += kThreads) {
    const int c = idx % n, r4 = idx / n;
    float x[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int row = r0 + r4 * 4 + r;
      x[r] = row < nrows ? rnd<R>(to_f(src[(long long)row * rs + c])) : 0.f;
    }
    *reinterpret_cast<float4*>(dst + c * LD + r4 * 4) = make_float4(x[0], x[1], x[2], x[3]);
  }
}

// rows [r0, r0 + 64) x DH columns into dst[r][c] (row stride DH + 4).
template <typename T, int DH>
__device__ __forceinline__ void load_rows(float* dst, const T* src, long long rs, int r0,
                                          int nrows) {
  for (int idx = threadIdx.x; idx < BK * DH; idx += kThreads) {
    const int r = idx / DH, c = idx - r * DH;
    const int row = r0 + r;
    dst[r * (DH + 4) + c] = row < nrows ? to_f(src[(long long)row * rs + c]) : 0.f;
  }
}

// acc[a][c] += sum_k A[k][ra + a] * B[k][cb + c] for k < n: the 4 x 4 tile of
// a (64 x n) @ (n x 64) product whose operands are stored transposed.
__device__ __forceinline__ void tile_4x4(float (&acc)[4][4], const float* A, const float* Bm,
                                         int n, int ra, int cb) {
#pragma unroll 4
  for (int k = 0; k < n; ++k) {
    const float4 a = *reinterpret_cast<const float4*>(A + k * LD + ra);
    const float4 b = *reinterpret_cast<const float4*>(Bm + k * LD + cb);
    const float av[4] = {a.x, a.y, a.z, a.w}, bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
  }
}

// acc[a][c] += sum_j P[ra + a][j] * V[j][cb + c]: rows ra..ra+3 of a
// (64 x 64) @ (64 x DH) product, P row-major (stride LD), V row-major
// (stride DH + 4), NC = DH / 16 columns a thread.
template <int DH>
__device__ __forceinline__ void pv(float (&acc)[4][DH / 16], const float* P, const float* V,
                                   int ra, int cb) {
  constexpr int NC = DH / 16;
#pragma unroll 2
  for (int j = 0; j < BK; j += 4) {
    float p[4][4];
#pragma unroll
    for (int a = 0; a < 4; ++a) lds<4>(P + (ra + a) * LD + j, p[a]);
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      float v[NC];
      lds<NC>(V + (j + jj) * (DH + 4) + cb, v);
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int c = 0; c < NC; ++c) acc[a][c] = fmaf(p[a][jj], v[c], acc[a][c]);
    }
  }
}

template <typename T, int DH>
__global__ void __launch_bounds__(kThreads) mau_stats_kernel(const StatsParams p) {
  constexpr int NC = DH / 16;
  extern __shared__ __align__(16) float smem[];
  float* qT = smem;              // [DH][LD]  q transposed
  float* kT = qT + DH * LD;      // [DH][LD]  k tile transposed
  float* ts = kT + DH * LD;      // [BK][DH + 4]  t tile
  float* ps = ts + BK * (DH + 4);  // [BQ][LD]  probs, rounded
  float* kms = ps + BQ * LD;     // [BK] key flags (key_flag)

  const int nqt = (p.Tq + BQ - 1) / BQ;
  const int bh = blockIdx.x / nqt, q0 = (blockIdx.x - bh * nqt) * BQ;
  const int b = bh / p.H, h = bh - b * p.H;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int ra = ty * 4, cb = tx * 4, co = tx * NC;
  const float* km_row = p.key_mask + (size_t)b * p.Tk;
  const T* qg = static_cast<const T*>(p.q.p) + b * p.q.bs + h * DH;
  const T* kg = static_cast<const T*>(p.k.p) + b * p.k.bs + h * DH;
  const T* tg = static_cast<const T*>(p.t.p) + b * p.t.bs + h * DH;

  load_t<float>(qT, qg, p.q.rs, DH, q0, p.Tq);
  const int nkt = key_tiles(km_row, p.Tq, p.Tk, q0, p.causal);

  float m[4], l[4], acc[4][NC];
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    m[a] = kPadNeg;
    l[a] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[a][c] = 0.f;
  }

  for (int kt = 0; kt < nkt; ++kt) {
    const int j0 = kt * BK;
    __syncthreads();  // the previous tile's reads are done
    load_t<float>(kT, kg, p.k.rs, DH, j0, p.Tk);
    load_rows<T, DH>(ts, tg, p.t.rs, j0, p.Tk);
    for (int j = tid; j < BK; j += kThreads) kms[j] = key_flag(km_row, j0 + j, p.Tk);
    __syncthreads();

    float s[4][4] = {};
    tile_4x4(s, qT, kT, DH, ra, cb);
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int i = q0 + ra + a;
      float mx = kPadNeg;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        s[a][c] = logit(s[a][c], kms[cb + c], i, j0 + cb + c, p.scale, p.causal, kPadNeg);
        mx = fmaxf(mx, s[a][c]);
      }
#pragma unroll
      for (int o = 8; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_new = fmaxf(m[a], mx);
      const float corr = expf(m[a] - m_new);
      float e[4], sum = 0.f;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        e[c] = expf(s[a][c] - m_new);
        sum += e[c];
      }
#pragma unroll
      for (int o = 8; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
      l[a] = l[a] * corr + sum;
      m[a] = m_new;
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[a][c] *= corr;
      *reinterpret_cast<float4*>(ps + (ra + a) * LD + cb) =
          make_float4(rnd<T>(e[0]), rnd<T>(e[1]), rnd<T>(e[2]), rnd<T>(e[3]));
    }
    __syncthreads();
    pv<DH>(acc, ps, ts, ra, co);
  }

  const size_t row0 = (size_t)bh * p.Tq;
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int i = q0 + ra + a;
    if (i >= p.Tq) continue;
    if (tx == 0) {
      p.m[row0 + i] = m[a];
      p.l[row0 + i] = l[a];
    }
#pragma unroll
    for (int c = 0; c < NC; ++c) p.su[(row0 + i) * DH + co + c] = acc[a][c] / l[a];
  }
}

template <typename T, int DH>
__global__ void __launch_bounds__(kThreads) mau_out_kernel(const OutParams p) {
  constexpr int NC = DH / 16;
  extern __shared__ __align__(16) float smem[];
  const int E = p.E;
  float* qT = smem;                // [DH][LD]
  float* kT = qT + DH * LD;        // [DH][LD]
  float* vs = kT + DH * LD;        // [BK][DH + 4]
  float* lamT = vs + BK * (DH + 4);  // [E][LD]  lam of the block's rows, rounded
  float* ohT = lamT + E * LD;      // [E][LD]  one-hot tile transposed
  float* ps = ohT + E * LD;        // [BQ][LD] modulated probs, rounded
  float* kms = ps + BQ * LD;       // [BK] key flags (key_flag)
  float* ms = kms + BK;            // [BQ]
  float* ls = ms + BQ;             // [BQ]

  const int nqt = (p.Tq + BQ - 1) / BQ;
  const int bh = blockIdx.x / nqt, q0 = (blockIdx.x - bh * nqt) * BQ;
  const int b = bh / p.H, h = bh - b * p.H;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int ra = ty * 4, cb = tx * 4, co = tx * NC;
  const float* km_row = p.key_mask + (size_t)b * p.Tk;
  const float* oh_b = p.onehot + (size_t)b * p.Tk * E;
  const T* qg = static_cast<const T*>(p.q.p) + b * p.q.bs + h * DH;
  const T* kg = static_cast<const T*>(p.k.p) + b * p.k.bs + h * DH;
  const T* vg = static_cast<const T*>(p.v.p) + b * p.v.bs + h * DH;
  const size_t row0 = (size_t)bh * p.Tq;

  load_t<float>(qT, qg, p.q.rs, DH, q0, p.Tq);
  load_t<T>(lamT, p.lam + row0 * E, E, E, q0, p.Tq);
  for (int i = tid; i < BQ; i += kThreads) {
    const bool ok = q0 + i < p.Tq;
    ms[i] = ok ? p.m[row0 + q0 + i] : 0.f;
    ls[i] = ok ? p.l[row0 + q0 + i] : 1.f;
  }
  const int nkt = key_tiles(km_row, p.Tq, p.Tk, q0, p.causal);
  const Dropout drop = make_dropout(p.seed, p.drop_thresh, p.drop_scale);

  float acc[4][NC];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[a][c] = 0.f;

  for (int kt = 0; kt < nkt; ++kt) {
    const int j0 = kt * BK;
    __syncthreads();
    load_t<float>(kT, kg, p.k.rs, DH, j0, p.Tk);
    load_rows<T, DH>(vs, vg, p.v.rs, j0, p.Tk);
    load_t<T>(ohT, oh_b, E, E, j0, p.Tk);
    for (int j = tid; j < BK; j += kThreads) kms[j] = key_flag(km_row, j0 + j, p.Tk);
    __syncthreads();

    float s[4][4] = {}, iqk[4][4] = {};
    tile_4x4(s, qT, kT, DH, ra, cb);
    tile_4x4(iqk, lamT, ohT, E, ra, cb);
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int i = q0 + ra + a;
      const float mi = ms[ra + a], li = ls[ra + a];
      float o[4];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int j = j0 + cb + c;
        const float km = kms[cb + c];
        float x = 0.f;
        if (km >= 0.f) {  // padding keys stay 0
          const float pr = expf(logit(s[a][c], km, i, j, p.scale, p.causal, 0.f) - mi) / li;
          const float iq = (p.diag_reset && j == i) ? 1.f : iqk[a][c];
          x = iq * pr;
          if (drop.on) x *= drop.factor(b, h, i, j);
        }
        o[c] = rnd<T>(x);
      }
      *reinterpret_cast<float4*>(ps + (ra + a) * LD + cb) = make_float4(o[0], o[1], o[2], o[3]);
    }
    __syncthreads();
    pv<DH>(acc, ps, vs, ra, co);
  }

  const int C = p.H * DH;
  T* out = static_cast<T*>(p.out) + (size_t)b * p.Tq * C + h * DH;
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int i = q0 + ra + a;
    if (i >= p.Tq) continue;
#pragma unroll
    for (int c = 0; c < NC; ++c) out[(size_t)i * C + co + c] = from_f<T>(acc[a][c]);
  }
}

// ---------------------------------------------------------------- bf16 on
// the tensor cores: the stats kernel for a bf16 compute dtype. Four warps,
// each 16 of the block's 64 queries (the flash-attention schedule): q's A
// fragments stay in registers for the whole key loop. Each 64-key tile is
// taken in two 32-key halves, so that only a half's logits are live: they
// come out of mma.sync m16n8k16 (fp32 accumulate) as C fragments, the probs
// are formed in place, rounded to bf16 and re-used as the A fragments of
// the @T product, whose accumulators stay in registers. Tiles sit in shared
// memory as bf16 rows, fetched with cp.async one tile ahead
// (double-buffered) and read with ldmatrix.

__host__ __device__ inline size_t stats_mma_smem_bytes(int dh) {
  return sizeof(bf16) * (size_t)(5 * 64 * (dh + 8)) + sizeof(float) * 2 * BK;
}

template <int DH>
__global__ void __launch_bounds__(kThreadsMma) mau_stats_mma_kernel(const StatsParams p) {
  constexpr int SD = DH + 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);  // [64][SD]
  bf16* ks = qs + 64 * SD;                       // [2][BK][SD]
  bf16* ts = ks + 2 * BK * SD;                   // [2][BK][SD]
  float* kms = reinterpret_cast<float*>(ts + 2 * BK * SD);  // [2][BK] key mask

  const int nqt = (p.Tq + BQ - 1) / BQ;
  const int bh = blockIdx.x / nqt, q0 = (blockIdx.x - bh * nqt) * BQ;
  const int b = bh / p.H, h = bh - b * p.H;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t4 = lane & 3;
  const float* km_row = p.key_mask + (size_t)b * p.Tk;
  const bf16* kg = static_cast<const bf16*>(p.k.p) + b * p.k.bs + h * DH;
  const bf16* tg = static_cast<const bf16*>(p.t.p) + b * p.t.bs + h * DH;
  auto fetch = [&](int kt) {
    const int buf = kt & 1;
    async_bf16(ks + buf * BK * SD, SD, kg, p.k.rs, DH, kt * BK, p.Tk);
    async_bf16(ts + buf * BK * SD, SD, tg, p.t.rs, DH, kt * BK, p.Tk);
    async_mask(kms + buf * BK, km_row, kt * BK, p.Tk);
  };

  async_bf16(qs, SD, static_cast<const bf16*>(p.q.p) + b * p.q.bs + h * DH, p.q.rs, DH, q0,
             p.Tq);
  const int nkt = key_tiles(km_row, p.Tq, p.Tk, q0, p.causal);
  fetch(0);
  cp_async_commit();

  uint32_t qf[DH / 16][4];
  float m[2] = {kPadNeg, kPadNeg}, l[2] = {0.f, 0.f};
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
    if (kt == 0) {
#pragma unroll
      for (int kd = 0; kd < DH / 16; ++kd) a_frag(qf[kd], qs, SD, warp * 16, kd * 16, lane);
    }
    const int j0 = kt * BK;
    const bf16* kb = ks + (kt & 1) * BK * SD;
    const bf16* tb = ts + (kt & 1) * BK * SD;
    const float* kmb = kms + (kt & 1) * BK;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      float s[4][4];
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int c = 0; c < 4; ++c) s[n][c] = 0.f;
#pragma unroll
      for (int kd = 0; kd < DH / 16; ++kd)
        mma_rows32(s, qf[kd], kb + half * KH * SD, SD, kd * 16, lane);
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int i = q0 + warp * 16 + g + 8 * hr;
        float mx = kPadNeg;
#pragma unroll
        for (int n = 0; n < 4; ++n)
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const int jj = half * KH + n * 8 + 2 * t4 + c;
            float& x = s[n][2 * hr + c];
            x = logit(x, flag_of(kmb[jj], j0 + jj, p.Tk), i, j0 + jj, p.scale, p.causal,
                      kPadNeg);
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
            float& x = s[n][2 * hr + c];
            x = expf(x - m_new);
            sum += x;
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
      mma_pv<DH>(o, s, tb + half * KH * SD, SD, lane);  // probs rounded to bf16
    }
    __syncthreads();  // the buffer is free for tile kt + 2
  }

  const size_t row0 = (size_t)bh * p.Tq;
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int i = q0 + warp * 16 + g + 8 * hr;
    if (i >= p.Tq) continue;
    if (t4 == 0) {
      p.m[row0 + i] = m[hr];
      p.l[row0 + i] = l[hr];
    }
    float* su = p.su + (row0 + i) * DH;
#pragma unroll
    for (int n = 0; n < DH / 8; ++n)
      *reinterpret_cast<float2*>(su + n * 8 + 2 * t4) =
          make_float2(o[n][2 * hr] / l[hr], o[n][2 * hr + 1] / l[hr]);
  }
}

// ---------------------------------------------------------------- output,
// bf16 on wgmma and TMA (see the header): NS 64-column sub-tiles a head
// (dh = 64 or 128; narrower heads come zero-padded to 64), G consumer
// warpgroups of 64 queries; OutParams.lam / .onehot here are bf16, (B, H,
// Tq, EP) / (B, Tk, EP), rounded and zero-padded to EP = a multiple of 64
// events by the wrapper.

// Warpgroups and ring stages of a block for NS sub-tiles and ept event
// tiles: the first whose shared memory fits of three consumer warpgroups
// at dh = 64 and two at dh = 128 (a consumer's (64 x 128) output
// accumulator needs 240 registers), else one; kQmStages stages, else one.
struct QmConfig {
  int groups, stages;
};

__host__ inline QmConfig out_tc_config(int ns, int ept, int Tk) {
  const int rt = ns + ept, st = 2 * ns + ept;
  for (const int groups : {ns == 1 ? 3 : 2, 1})
    for (const int stages : {kQmStages, 1})
      if (qm_smem_bytes(groups, rt, stages, st, Tk) <= kMaxSmem) return {groups, stages};
  return {1, 1};  // does not fit: the launch refuses it
}

__host__ inline size_t out_tc_smem_bytes(int ns, int ept, int Tk) {
  const QmConfig c = out_tc_config(ns, ept, Tk);
  return qm_smem_bytes(c.groups, ns + ept, c.stages, 2 * ns + ept, Tk);
}

template <int NS, int G>
__global__ void __launch_bounds__(128 * (G + 1), 1)
    mau_out_tc_kernel(const OutParams p, const __grid_constant__ QmMaps maps) {
  constexpr int kQueries = 64 * G;
  const int ept = p.EP / 64, S = p.stages, rt = NS + ept, stn = 2 * NS + ept;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* base = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  bf16* res = reinterpret_cast<bf16*>(base);  // [group][Q NS, lam ept][64 queries][64]
  bf16* ring = res + G * rt * kQmTile;         // [stage][K NS, V NS, one-hot ept][64 keys][64]
  float* kms = reinterpret_cast<float*>(ring + S * stn * kQmTile);  // [stage][64] key mask
  uint64_t* res_full = reinterpret_cast<uint64_t*>(kms + S * BK);
  uint64_t* full = res_full + 1;  // [stage]
  uint64_t* empty = full + S;     // [stage]
  int* plan = reinterpret_cast<int*>(empty + S);  // key_plan of the batch row

  // heaviest first: under causal the last query block visits the most tiles
  const int BH = p.B * p.H, nqb = (p.Tq + kQueries - 1) / kQueries;
  const int qb = nqb - 1 - (int)blockIdx.x / BH, bh = blockIdx.x % BH, q0 = qb * kQueries;
  const int b = bh / p.H, h = bh - b * p.H;
  const int lane = threadIdx.x & 31;
  int warp = threadIdx.x >> 5;
  if (threadIdx.x == 0) {
    mbar_init(res_full, 1);
    for (int s = 0; s < S; ++s) {
      mbar_init(full + s, 32);
      mbar_init(empty + s, 128 * G);
    }
    mbar_fence_init();
  }
  key_plan(p.key_mask + (size_t)b * p.Tk, p.Tk, plan);  // ends with a barrier
  const QmBlock<G> blk{tile_rule(plan, p.Tk), b, h, q0, false};
  const int nkt = key_tile_count(p.Tk);

  if (warp >= 4 * G) {  // ---- producer: its first warp works
    if constexpr (G > 1) regs_dec<kQmProducerRegs>();
    if (warp == 4 * G)
      qm_produce(p, blk, maps, S, res, ring, kms, res_full, full, empty, lane);
    return;
  }

  // ---- consumers: warpgroup wg owns queries qw = q0 + 64 wg ..; thread
  // (warp, g, t4) holds queries i0 = qw + 16 warp + g (+8) and, of a key
  // tile, keys 8 n + 2 t4 (+1): entry (query hr, key n, c) at x[4 n + 2 hr + c]
  if constexpr (G > 1) regs_inc<qm_consumer_regs(G)>();
  const int wg = warp >> 2, qw = q0 + 64 * wg;
  warp &= 3;
  const int g = lane >> 2, t4 = lane & 3, i0 = qw + 16 * warp + g;
  const RowStats rs = row_stats(p.m, p.l, (size_t)bh * p.Tq, i0, p.Tq);
  const Dropout drop = make_dropout(p.seed, p.drop_thresh, p.drop_scale);
  const float sl2 = p.scale * kLog2e;
  const bf16* rw = res + wg * rt * kQmTile;
  const uint64_t qd = sw128_desc(rw), ld = sw128_desc(rw + NS * kQmTile);
  float o[NS][32];
#pragma unroll
  for (int c = 0; c < NS; ++c) zero32(o[c]);
  mbar_wait(res_full, 0);

  int it = 0;
  for (int kt = blk.next(p, 0); kt < nkt; kt = blk.next(p, kt + 1), ++it) {
    const int s = it % S;
    mbar_wait(full + s, (it / S) & 1);
    if (!blk.wg_visits(p, kt, wg)) {  // another warpgroup's tile
      mbar_arrive(empty + s);
      continue;
    }
    // a sub-tile is 8 KB, 512 in the descriptors' units
    const bf16* st = ring + s * stn * kQmTile;
    const uint64_t kd = sw128_desc(st), vd = sw128_desc(st + NS * kQmTile),
                   od = sw128_desc(st + 2 * NS * kQmTile);
    float sa[32], ia[32];
    zero32(sa);
    zero32(ia);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < 4 * NS; ++kk) {  // S = Q K^T
      const int step = 512 * (kk >> 2) + 2 * (kk & 3);
      wgmma_ss<0, 0>(sa, qd + step, kd + step, 1);
    }
    for (int c = 0; c < ept; ++c)  // IQK = lam one-hot^T, events the reduction
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_ss<0, 0>(ia, ld + 512 * c + 2 * kk, od + 512 * c + 2 * kk, 1);
    wg_commit();
    wg_wait();
    reg_fence(sa);
    reg_fence(ia);

    // u = iqk p keep (BiMAU: iqk = 1 on the diagonal), p without a branch;
    // `tested` (a constant where it can be) false only where no entry needs
    // a test: every key visible and no diagonal entry
    const int j0 = kt * BK;
    const bool diag = p.diag_reset && j0 == qw, slow = diag || blk.rule.test(p, kt, qw);
    const float* kmb = kms + s * BK;
    auto form = [&](auto tested_flag, auto dropped) {
      const bool tested = flag(tested_flag);
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int jl = 8 * n + 2 * t4 + c, j = j0 + jl;
          const float km = kmb[jl];
#pragma unroll
          for (int hr = 0; hr < 2; ++hr) {
            const int x = 4 * n + 2 * hr + c, i = i0 + 8 * hr;
            const float pr =
                fast_exp2(entry_exp2(sa[x], tested, km, i, j, sl2, rs, hr, p.Tk, p.causal)) *
                rs.rl[hr];
            float u = ((tested && diag && i == j) ? 1.f : ia[x]) * pr;
            if constexpr (decltype(dropped)::value) u *= drop.factor(b, h, i, j);
            sa[x] = u;
          }
        }
    };
    if (drop.on)  // the Philox draw costs more than the tests
      form(slow, std::true_type());
    else if (slow)
      form(std::true_type(), std::false_type());
    else
      form(std::false_type(), std::false_type());
    uint32_t pf[16];
    a_frags(pf, sa);  // rnd(u)
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int c = 0; c < NS; ++c) wgmma_rs(o[c], pf + 4 * kk, vd + 512 * c + 128 * kk);  // O += U V
    wg_commit();
    wg_wait();
#pragma unroll
    for (int c = 0; c < NS; ++c) reg_fence(o[c]);
    mbar_arrive(empty + s);  // the stage's K, V, one-hot and mask are free
  }

  const int C = p.H * 64 * NS;
  bf16* out = static_cast<bf16*>(p.out) + (size_t)b * p.Tq * C + (size_t)h * 64 * NS;
#pragma unroll
  for (int c = 0; c < NS; ++c) store_acc_bf16(out + 64 * c, C, o[c], qw + 16 * warp, p.Tq, lane);
}

// ---------------------------------------------------------------- the
// intensity head on wgmma in split bf16 (see the header): G consumer
// warpgroups of 64 rows and a producer warp; Wd's seq_units lanes split once
// a launch (mau_int_split_kernel) into bf16 hi and lo (dh, E*dh).

constexpr int kIntStages = 4;  // ring stages of (64-column) hi / lo tiles

// Consumer warpgroups a block: three at dh <= 64, two at dh = 128 (whose
// rows' hi/lo A fragments alone take 64 registers).
__host__ __device__ constexpr int int_groups(int dh) { return dh == 128 ? 2 : 3; }

// Dynamic shared memory: per stage the hi and lo tiles (dh rows of 64
// columns, 128 bytes a row) and the tile's interval lane, bd and w (3 x 64
// fp32); the mbarriers; 1 KB of slack to align the tiles to 1024 bytes.
__host__ __device__ inline size_t int_tc_smem_bytes(int dh) {
  return 1024 + (size_t)kIntStages * (2 * dh * 64 * sizeof(bf16) + 3 * 64 * sizeof(float)) +
         8 * 2 * kIntStages;
}

struct IntMaps {
  CUtensorMap hi, lo;  // (E*dh columns, dh rows), boxes of 64 columns x dh rows
};

// Wd's seq_units lanes (its first dh rows: n2 pairs of values) into bf16
// hi and lo (split_bf16x2), a pair a thread and step.
__global__ void mau_int_split_kernel(const float2* wd, uint32_t* hi, uint32_t* lo, int n2) {
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n2; i += gridDim.x * blockDim.x)
    split_bf16x2(wd[i].x, wd[i].y, hi[i], lo[i]);
}

// z = su Wd_tile for column tile t once its stage has landed (the ring's
// hi tile, then its lo tile), three bf16 passes each of KK k steps (B
// MN-major: 16 lanes a k step), committed as one group.
template <int KK>
__device__ __forceinline__ void int_products(float (&z)[32], const uint32_t (&xh)[KK][4],
                                             const uint32_t (&xl)[KK][4], const bf16* ring,
                                             uint64_t* full, int t) {
  constexpr int kTile = KK * 16 * 64;
  const int s = t % kIntStages;
  mbar_wait(full + s, (t / kIntStages) & 1);
  const uint64_t dhi = sw128_desc(ring + s * 2 * kTile), dlo = sw128_desc(ring + s * 2 * kTile + kTile);
  zero32(z);
  wg_fence();
#pragma unroll
  for (int kk = 0; kk < KK; ++kk) wgmma_rs_x3<1>(z, xh[kk], xl[kk], dhi + 128 * kk, dlo + 128 * kk);
  wg_commit();
}

// Thread (warp, g, t4) of warpgroup wg holds rows r0 + g (+8), r0 = the
// block's first row + 64 wg + 16 warp, and, of a column tile, columns 8 n +
// 2 t4 (+1) at z[4 n + 2 hr + c]. An event's dh columns lie in one tile
// (dh <= 64: 64 / dh events a tile) or two (dh = 128: the first tile's sum
// is carried). The products of the next tile run while the sigmoids of
// this one are formed: two accumulators in turn, four tiles an iteration
// (no group in flight across the loop, which would have ptxas serialize
// the products), the count rounded up to four with tiles past E*dh (zeros,
// their events not stored).
template <int DH>
__global__ void __launch_bounds__(128 * (int_groups(DH) + 1), 1)
    mau_int_fwd_tc_kernel(const IntParams p, const __grid_constant__ IntMaps maps) {
  constexpr int G = int_groups(DH), KK = DH / 16;
  constexpr int EL = DH >= 64 ? 1 : 64 / DH;  // events a tile holds
  constexpr int kTile = DH * 64;              // bf16 values of a hi or lo tile
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* base = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  bf16* ring = reinterpret_cast<bf16*>(base);  // [stage][hi, lo][DH lanes][64 columns]
  float* side = reinterpret_cast<float*>(ring + kIntStages * 2 * kTile);  // [stage][iv lane, bd, w][64]
  uint64_t* full = reinterpret_cast<uint64_t*>(side + kIntStages * 3 * 64);  // [stage]
  uint64_t* empty = full + kIntStages;                                        // [stage]
  const int edh = p.E * DH, nt = (edh + 255) / 256 * 4;  // column tiles, rounded up to 4
  const int lane = threadIdx.x & 31;
  int warp = threadIdx.x >> 5;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kIntStages; ++s) {
      mbar_init(full + s, 32);
      mbar_init(empty + s, 128 * G);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (warp >= 4 * G) {  // ---- producer: its first warp streams the column tiles
    regs_dec<kQmProducerRegs>();
    if (warp > 4 * G) return;
    for (int t = 0; t < nt; ++t) {
      const int s = t % kIntStages, c0 = 64 * t;
      mbar_wait(empty + s, ((t / kIntStages) & 1) ^ 1);
      float* sd = side + s * 3 * 64;
      for (int c = lane; c < 64; c += 32) {
        const bool ok = c0 + c < edh;
        sd[c] = ok ? p.wd[(size_t)DH * edh + c0 + c] : 0.f;
        sd[64 + c] = ok ? p.bd[c0 + c] : 0.f;
        sd[128 + c] = ok ? p.w[c0 + c] : 0.f;
      }
      if (lane == 0) {
        bf16* d = ring + s * 2 * kTile;
        mbar_arrive_tx(full + s, (uint32_t)(2 * kTile * sizeof(bf16)));
        tma_2d(d, &maps.hi, full + s, c0, 0);
        tma_2d(d + kTile, &maps.lo, full + s, c0, 0);
      } else {
        mbar_arrive(full + s);
      }
    }
    return;
  }

  // ---- consumers
  regs_inc<qm_consumer_regs(G)>();
  const int wg = warp >> 2;
  warp &= 3;
  const int g = lane >> 2, t4 = lane & 3;
  const int r0 = (blockIdx.x * G + wg) * 64 + 16 * warp;  // the warp's first row
  // the rows' seq_units as hi/lo A fragments: k step kk, entry i at row
  // r0 + g + 8 (i & 1), lanes 16 kk + 8 (i >> 1) + 2 t4 (+1)
  uint32_t xh[KK][4], xl[KK][4];
  float iv[2], carry[2] = {0.f, 0.f};
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int row = r0 + g + 8 * hr;
    iv[hr] = row < p.rows ? p.intervals[(size_t)(row / (p.Tq * p.H)) * p.Tq + row % p.Tq] : 0.f;
  }
#pragma unroll
  for (int kk = 0; kk < KK; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = r0 + g + 8 * (i & 1), c = 16 * kk + 8 * (i >> 1) + 2 * t4;
      const float2 v = row < p.rows ? *reinterpret_cast<const float2*>(p.su + (size_t)row * DH + c)
                                    : make_float2(0.f, 0.f);
      split_bf16x2(v.x, v.y, xh[kk][i], xl[kk][i]);
    }

  // tile t's products in z, on the ring: sigmoid(z + iv Wd[dh] + bd) w
  // summed over the thread's columns of each event, the quad's columns,
  // then lam = s softplus(raw / s) by one lane an event
  auto finish = [&](int t, const float (&z)[32]) {
    const int s = t % kIntStages;
    const float* sd = side + s * 3 * 64;
    float raw[2][EL];
#pragma unroll
    for (int hr = 0; hr < 2; ++hr)
#pragma unroll
      for (int el = 0; el < EL; ++el) raw[hr][el] = 0.f;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const int el = DH >= 64 ? 0 : 8 * n / DH;
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int col = 8 * n + 2 * t4 + c;
        const float wiv = sd[col], bdc = sd[64 + col], wc = sd[128 + col];
#pragma unroll
        for (int hr = 0; hr < 2; ++hr)
          raw[hr][el] = fmaf(sigmoid(fmaf(iv[hr], wiv, z[4 * n + 2 * hr + c] + bdc)), wc, raw[hr][el]);
      }
    }
    mbar_arrive(empty + s);  // the stage's tiles and side lanes are read
#pragma unroll
    for (int hr = 0; hr < 2; ++hr)
#pragma unroll
      for (int el = 0; el < EL; ++el) {
        float x = raw[hr][el];
        x += __shfl_xor_sync(0xffffffffu, x, 1);
        x += __shfl_xor_sync(0xffffffffu, x, 2);
        raw[hr][el] = x;
      }
    if constexpr (DH == 128) {
      if (!(t & 1)) {  // the event's first half
        carry[0] = raw[0][0];
        carry[1] = raw[1][0];
        return;
      }
      raw[0][0] += carry[0];
      raw[1][0] += carry[1];
    }
#pragma unroll
    for (int el = 0; el < EL; ++el) {
      const int e = DH == 128 ? t / 2 : 64 * t / DH + el;
      if (t4 != el || e >= p.E) continue;
      const float sc = expf(p.scaling[e]);
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int row = r0 + g + 8 * hr;
        if (row < p.rows) p.lam[(size_t)row * p.E + e] = sc * softplus(raw[hr][el] / sc);
      }
    }
  };

  float z0[32], z1[32];
  for (int t = 0; t < nt; t += 4) {
    int_products(z0, xh, xl, ring, full, t);
    int_products(z1, xh, xl, ring, full, t + 1);
    wg_wait_n<1>();
    reg_fence(z0);
    finish(t, z0);
    int_products(z0, xh, xl, ring, full, t + 2);
    wg_wait_n<1>();
    reg_fence(z1);
    finish(t + 1, z1);
    int_products(z1, xh, xl, ring, full, t + 3);
    wg_wait_n<1>();
    reg_fence(z0);
    finish(t + 2, z0);
    wg_wait();
    reg_fence(z1);
    finish(t + 3, z1);
  }
}

// fp32 on the CUDA cores, bf16 on the tensor cores.
cudaError_t stats_launch(const StatsParams& p, int dh, int dtype, int blocks, cudaStream_t s) {
  const size_t fb = sizeof(float) * (size_t)stats_smem_floats(dh), mb = stats_mma_smem_bytes(dh);
  const int ft = kThreads, mt = kThreadsMma;
  switch (dh * 2 + dtype) {
    case 32: return go(mau_stats_kernel<float, 16>, blocks, ft, fb, s, p);
    case 64: return go(mau_stats_kernel<float, 32>, blocks, ft, fb, s, p);
    case 128: return go(mau_stats_kernel<float, 64>, blocks, ft, fb, s, p);
    case 256: return go(mau_stats_kernel<float, 128>, blocks, ft, fb, s, p);
    case 33: return go(mau_stats_mma_kernel<16>, blocks, mt, mb, s, p);
    case 65: return go(mau_stats_mma_kernel<32>, blocks, mt, mb, s, p);
    case 129: return go(mau_stats_mma_kernel<64>, blocks, mt, mb, s, p);
    case 257: return go(mau_stats_mma_kernel<128>, blocks, mt, mb, s, p);
    default: return cudaErrorInvalidValue;
  }
}

cudaError_t out_launch(const OutParams& p, int dh, int blocks, cudaStream_t s) {
  const size_t fb = sizeof(float) * (size_t)out_smem_floats(dh, p.E);
  switch (dh) {
    case 16: return go(mau_out_kernel<float, 16>, blocks, kThreads, fb, s, p);
    case 32: return go(mau_out_kernel<float, 32>, blocks, kThreads, fb, s, p);
    case 64: return go(mau_out_kernel<float, 64>, blocks, kThreads, fb, s, p);
    case 128: return go(mau_out_kernel<float, 128>, blocks, kThreads, fb, s, p);
    default: return cudaErrorInvalidValue;
  }
}

// bf16: heads of 64 or 128 channels, lam / one-hot EP = a multiple of 64
// events wide (the wrapper zero-pads), rows of q, k, v on 16-byte boundaries.
cudaError_t out_tc_launch(OutParams p, const void* onehot, const void* lam, int dh,
                          cudaStream_t s) {
  if ((dh != 64 && dh != 128) || p.EP % 64) return cudaErrorInvalidValue;
  const int ns = dh / 64, ept = p.EP / 64;
  const QmConfig cfg = out_tc_config(ns, ept, p.Tk);
  p.stages = cfg.stages;
  QmMaps maps{};
  if (!heads_seq_map(&maps.res[0], p.q, p.Tq, p.H, p.B, dh) ||
      !heads_map(&maps.res[1], lam, p.EP, p.Tq, p.H, p.B) ||
      !heads_seq_map(&maps.ring[0], p.k, p.Tk, p.H, p.B, dh) ||
      !heads_seq_map(&maps.ring[1], p.v, p.Tk, p.H, p.B, dh) ||
      !onehot_map(&maps.ring[kQmOnehot], onehot, p.EP, p.Tk, p.B))
    return cudaErrorInvalidValue;
  maps.nres[0] = ns;
  maps.nres[1] = ept;
  maps.nring[0] = maps.nring[1] = ns;
  maps.nring[kQmOnehot] = ept;
  const size_t bytes = qm_smem_bytes(cfg.groups, ns + ept, cfg.stages, 2 * ns + ept, p.Tk);
  const int blocks = p.B * p.H * ((p.Tq + 64 * cfg.groups - 1) / (64 * cfg.groups));
  const int threads = 128 * (cfg.groups + 1);
  switch (ns * 4 + cfg.groups) {
    case 7: return go(mau_out_tc_kernel<1, 3>, blocks, threads, bytes, s, p, maps);
    case 5: return go(mau_out_tc_kernel<1, 1>, blocks, threads, bytes, s, p, maps);
    case 10: return go(mau_out_tc_kernel<2, 2>, blocks, threads, bytes, s, p, maps);
    case 9: return go(mau_out_tc_kernel<2, 1>, blocks, threads, bytes, s, p, maps);
    default: return cudaErrorInvalidValue;
  }
}

// Splits Wd's seq_units lanes, then runs the head; any (dh, E) with dh in
// {16, 32, 64, 128}.
cudaError_t int_tc_launch(const IntParams& p, int dh, cudaStream_t s) {
  const int edh = p.E * dh, n2 = dh * edh / 2;
  cudaError_t e = go(mau_int_split_kernel, imin((n2 + 255) / 256, 1024), 256, 0, s,
                     reinterpret_cast<const float2*>(p.wd), reinterpret_cast<uint32_t*>(p.wd_hi),
                     reinterpret_cast<uint32_t*>(p.wd_lo), n2);
  if (e != cudaSuccess) return e;
  IntMaps maps;
  const cuuint64_t dims[2] = {(cuuint64_t)edh, (cuuint64_t)dh};
  const cuuint64_t strides[1] = {(cuuint64_t)edh * sizeof(bf16)};
  const cuuint32_t box[2] = {64, (cuuint32_t)dh};
  if (!encode_map(&maps.hi, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, p.wd_hi, dims, strides, box) ||
      !encode_map(&maps.lo, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, p.wd_lo, dims, strides, box))
    return cudaErrorInvalidValue;
  const int groups = int_groups(dh), rows_a_block = 64 * groups;
  const int blocks = (p.rows + rows_a_block - 1) / rows_a_block, threads = 128 * (groups + 1);
  const size_t bytes = int_tc_smem_bytes(dh);
  switch (dh) {
    case 16: return go(mau_int_fwd_tc_kernel<16>, blocks, threads, bytes, s, p, maps);
    case 32: return go(mau_int_fwd_tc_kernel<32>, blocks, threads, bytes, s, p, maps);
    case 64: return go(mau_int_fwd_tc_kernel<64>, blocks, threads, bytes, s, p, maps);
    case 128: return go(mau_int_fwd_tc_kernel<128>, blocks, threads, bytes, s, p, maps);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// Dynamic shared memory of one block, in bytes; above 232448 a kernel
// cannot run.
size_t mau_stats_smem_bytes(int dh, int dtype) {
  return dtype ? stats_mma_smem_bytes(dh) : sizeof(float) * (size_t)stats_smem_floats(dh);
}
size_t mau_out_smem_bytes(int dh, int E, int Tk, int dtype) {
  return dtype ? out_tc_smem_bytes(dh == 128 ? 2 : 1, round_up(E, 64) / 64, Tk)
               : sizeof(float) * (size_t)out_smem_floats(dh, E);
}
size_t mau_intensity_smem_bytes(int dh) { return int_tc_smem_bytes(dh); }

// Each launches on `stream` and returns cudaGetLastError() (0 on success).
// dtype: 0 = float32, 1 = bfloat16 (q, k, v, t and out). Strides are in
// elements; channels are contiguous; in bf16, q/k/v/t rows start on 16-byte
// boundaries. Everything else is fp32, except that in bf16 mau_out_fwd takes
// lam (B, H, Tq, EP) and onehot (B, Tk, EP) as bf16, rounded and zero-padded
// to EP = E rounded up to 16.
int mau_stats_fwd(const void* q, long long q_bs, long long q_rs, const void* k,
                  long long k_bs, long long k_rs, const void* t, long long t_bs,
                  long long t_rs, const void* key_mask, void* m, void* l, void* su,
                  int B, int Tq, int Tk, int H, int dh, int causal, float scale, int dtype,
                  void* stream) {
  if (B < 1 || H < 1 || Tq < 1 || Tk < 1 || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  StatsParams p;
  p.q = {q, q_bs, q_rs};
  p.k = {k, k_bs, k_rs};
  p.t = {t, t_bs, t_rs};
  p.key_mask = static_cast<const float*>(key_mask);
  p.m = static_cast<float*>(m);
  p.l = static_cast<float*>(l);
  p.su = static_cast<float*>(su);
  p.scale = scale;
  p.B = B; p.Tq = Tq; p.Tk = Tk; p.H = H; p.causal = causal;
  const int blocks = B * H * ((Tq + BQ - 1) / BQ);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)stats_launch(p, dh, dtype, blocks, s);
}

// wd_split: scratch of 2 x dh x E*dh bf16 (Wd's seq_units lanes split, hi
// then lo), 16-byte aligned, as are su, wd, bd and w.
int mau_intensity_fwd(const void* su, const void* intervals, const void* wd, const void* bd,
                      const void* w, const void* scaling, void* wd_split, void* lam, int B, int H,
                      int Tq, int dh, int E, void* stream) {
  if (B < 1 || H < 1 || Tq < 1 || E < 1) return (int)cudaErrorInvalidValue;
  IntParams p;
  p.su = static_cast<const float*>(su);
  p.intervals = static_cast<const float*>(intervals);
  p.wd = static_cast<const float*>(wd);
  p.bd = static_cast<const float*>(bd);
  p.w = static_cast<const float*>(w);
  p.scaling = static_cast<const float*>(scaling);
  p.wd_hi = static_cast<bf16*>(wd_split);
  p.wd_lo = p.wd_hi + (size_t)dh * E * dh;
  p.lam = static_cast<float*>(lam);
  p.rows = B * H * Tq; p.H = H; p.Tq = Tq; p.E = E;
  return (int)int_tc_launch(p, dh, static_cast<cudaStream_t>(stream));
}

// `seed` (an int64 on the device, or null for no dropout) keys the dropout
// mask; keep where the Philox word is below drop_thresh, scaled by
// drop_scale. In bf16 the heads are 64 or 128 channels wide (the wrapper
// zero-pads narrower ones) and lam and the one-hot EP = E rounded up to 64
// wide.
int mau_out_fwd(const void* q, long long q_bs, long long q_rs, const void* k, long long k_bs,
                long long k_rs, const void* v, long long v_bs, long long v_rs,
                const void* key_mask, const void* onehot, const void* lam, const void* m,
                const void* l, const void* seed, unsigned drop_thresh, float drop_scale,
                void* out, int B, int Tq, int Tk, int H, int dh, int E, int causal,
                int diag_reset, float scale, int dtype, void* stream) {
  if (B < 1 || H < 1 || Tq < 1 || Tk < 1 || E < 1 || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  OutParams p;
  p.q = {q, q_bs, q_rs};
  p.k = {k, k_bs, k_rs};
  p.v = {v, v_bs, v_rs};
  p.key_mask = static_cast<const float*>(key_mask);
  p.onehot = static_cast<const float*>(onehot);
  p.lam = static_cast<const float*>(lam);
  p.m = static_cast<const float*>(m);
  p.l = static_cast<const float*>(l);
  p.seed = static_cast<const long long*>(seed);
  p.drop_thresh = drop_thresh;
  p.drop_scale = drop_scale;
  p.out = out;
  p.scale = scale;
  p.B = B; p.Tq = Tq; p.Tk = Tk; p.H = H; p.E = E;
  p.causal = causal; p.diag_reset = diag_reset;
  p.EP = round_up(E, 64);
  p.stages = 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype) return (int)out_tc_launch(p, onehot, lam, dh, s);
  return (int)out_launch(p, dh, B * H * ((Tq + BQ - 1) / BQ), s);
}

const char* mau_streamed_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

// Streamed MAU/BiMAU forward for Hopper (sm_90a): the two-sweep long-context
// schedule as three kernels.
//
// Replaces the TPU kernels of easydgl_tpu/kernels/mau_streamed.py:
//
//   mau_stats_tc_kernel (bf16), mau_stats_kernel (fp32)
//                         _stats_kernel   (pallas_call in _fwd_impl, :607)
//   mau_int_split_kernel, mau_int_fwd_tc_kernel (intensity_head.cuh)
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
// Design. The fp32 stats and out kernels give one block to 64
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
// * stats, bf16 (the main path; mau_stats_tc_kernel, on the output
//   kernel's template below): a block owns 192 queries of one (b, h), Q
//   resident, the visited key tiles' K and T streamed by TMA with their
//   key mask. Per key tile, on wgmma m64n64k16: S = Q K^T; the tile's row
//   max in the accumulator layout (a tile without tests takes max(dot)
//   scale); the online rescale of l and su by exp2 of the change in m log2
//   e (exactly 1 where the max holds); p formed as the output kernel forms
//   it (entry_exp2: scale log2 e folded into one FMA, a hidden real key's
//   exponent (NEG - m) log2 e, exactly 0 in a row that sees no key), so
//   that l sums the p's the later kernels form; p rounded to bf16 in the
//   registers and fed back as the A operand of su += P T (T MN-major). l
//   is kept a thread's 16 keys of a tile at a time and summed over the quad
//   once at the end. The same live tiles as the output kernel.
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
// The intensity head (mau_int_fwd_tc_kernel in its split form,
// intensity_head.cuh, which the fused forward shares): mau_int_split_kernel
// splits Wd's seq_units lanes into bf16 hi and lo once a launch; z = su
// Wd_tile as lo hi + hi lo + hi hi on wgmma, the interval's rank-1 term in
// fp32, the exact sigmoid, each event's sum through the scaled softplus.
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
// products, set its time. In bf16 the next key tile is fetched (TMA) while
// this one is computed; in fp32 the loads wait.
//
// Limits: dh in {16, 32, 64, 128}; the out kernel's shared memory
// (mau_out_smem_bytes) within 227 KB: in fp32 E up to ~180 at dh = 64. The
// intensity head takes any E.

#include <initializer_list>
#include <type_traits>

#include "intensity_head.cuh"
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

// ---------------------------------------------------------------- stats,
// bf16 on wgmma and TMA (see the header): NS 64-column sub-tiles a head
// (dh = 64 or 128; narrower heads come zero-padded to 64), G consumer
// warpgroups of 64 queries; seq_units comes out (B, H, Tq, 64 NS).

// Consumer warpgroups a block: three at dh = 64, two at dh = 128 (a (64 x
// 128) seq_units accumulator and the logits take 96 of a thread's
// registers).
__host__ __device__ constexpr int stats_groups(int ns) { return ns == 1 ? 3 : 2; }

__host__ __device__ inline size_t stats_tc_smem_bytes(int ns, int Tk) {
  return qm_smem_bytes(stats_groups(ns), ns, kQmStages, 2 * ns, Tk);
}

template <int NS, int G>
__global__ void __launch_bounds__(128 * (G + 1), 1)
    mau_stats_tc_kernel(const StatsParams p, const __grid_constant__ QmMaps maps) {
  constexpr int kQueries = 64 * G, S = kQmStages;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* base = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  bf16* res = reinterpret_cast<bf16*>(base);  // [group][Q NS][64 queries][64]
  bf16* ring = res + G * NS * kQmTile;         // [stage][K NS, T NS][64 keys][64]
  float* kms = reinterpret_cast<float*>(ring + S * 2 * NS * kQmTile);  // [stage][64] key mask
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
  const QmBlock<G> blk{tile_rule(plan, p.Tk), b, h, q0, false};  // the output kernel's rule
  const int nkt = key_tile_count(p.Tk);

  if (warp >= 4 * G) {  // ---- producer: its first warp works
    regs_dec<kQmProducerRegs>();
    if (warp == 4 * G) qm_produce(p, blk, maps, S, res, ring, kms, res_full, full, empty, lane);
    return;
  }

  // ---- consumers: warpgroup wg owns queries qw = q0 + 64 wg ..; thread
  // (warp, g, t4) holds queries i0 = qw + 16 warp + g (+8) and, of a key
  // tile, keys 8 n + 2 t4 (+1): entry (query hr, key n, c) at x[4 n + 2 hr + c]
  regs_inc<qm_consumer_regs(G)>();
  const int wg = warp >> 2, qw = q0 + 64 * wg;
  warp &= 3;
  const int g = lane >> 2, t4 = lane & 3, i0 = qw + 16 * warp + g;
  const float sl2 = p.scale * kLog2e;
  const uint64_t qd = sw128_desc(res + wg * NS * kQmTile);
  // m: the running row max of the logits; l: the thread's own part of the
  // row's sum (its 16 keys of each tile), summed over the quad at the end
  float o[NS][32], m[2] = {kPadNeg, kPadNeg}, l[2] = {0.f, 0.f};
#pragma unroll
  for (int c = 0; c < NS; ++c) zero32(o[c]);
  mbar_wait(res_full, 0);

  int it = 0;
  for (int kt = blk.next(p, 0); kt < nkt; kt = blk.next(p, kt + 1), ++it) {
    const int s = it % S;
    mbar_wait(full + s, (it / S) & 1);
    if (!blk.wg_visits(p, kt, wg)) {  // a tile of another warpgroup's queries
      mbar_arrive(empty + s);
      continue;
    }
    const bf16* st = ring + s * 2 * NS * kQmTile;
    const uint64_t kd = sw128_desc(st), td = sw128_desc(st + NS * kQmTile);
    float sa[32];
    zero32(sa);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < 4 * NS; ++kk)  // S = Q K^T, 512 a 64-column sub-tile
      wgmma_ss<0, 0>(sa, qd + 512 * (kk >> 2) + 2 * (kk & 3), kd + 512 * (kk >> 2) + 2 * (kk & 3), 1);
    wg_commit();
    wg_wait();
    reg_fence(sa);

    // the tile's row max, then p without a branch, its exponent formed as
    // the output, d-lambda and dq kernels form it (entry_exp2) from the new
    // row max: the l written is the sum of the p's they form
    const int j0 = kt * BK;
    const float* kmb = kms + s * BK;
    auto form = [&](auto tested_flag) {
      const bool tested = flag(tested_flag);
      RowStats rs;
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        // the logits' max: a visible key's dot scale, a real key that is
        // masked or causally hidden NEG, padding -inf; in a tile without
        // tests every key is visible, and max(dot) scale = max(dot scale)
        float mx = -INFINITY;
#pragma unroll
        for (int n = 0; n < 8; ++n)
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const int jl = 8 * n + 2 * t4 + c, j = j0 + jl, x = 4 * n + 2 * hr + c;
            mx = fmaxf(mx, !tested ? sa[x]
                           : entry_visible(true, kmb[jl], i0 + 8 * hr, j, p.causal)
                               ? sa[x] * p.scale
                               : (j < p.Tk ? kNeg : -INFINITY));
          }
        if (!tested) mx *= p.scale;
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float m_new = fmaxf(m[hr], mx);
        rs.m2[hr] = __fmul_rn(m_new, kLog2e);
        rs.hid2[hr] = (kNeg - m_new) * kLog2e;
        // the online rescale, exactly 1 where the max holds (no fma: m log2
        // e is rounded once, as in m2)
        const float corr = fast_exp2(__fmul_rn(m[hr], kLog2e) - rs.m2[hr]);
        m[hr] = m_new;
        l[hr] *= corr;
#pragma unroll
        for (int c = 0; c < NS; ++c)
#pragma unroll
          for (int n = 0; n < 8; ++n) {
            o[c][4 * n + 2 * hr] *= corr;
            o[c][4 * n + 2 * hr + 1] *= corr;
          }
      }
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int jl = 8 * n + 2 * t4 + c, j = j0 + jl;
#pragma unroll
          for (int hr = 0; hr < 2; ++hr) {
            const int x = 4 * n + 2 * hr + c;
            sa[x] = fast_exp2(entry_exp2(sa[x], tested, kmb[jl], i0 + 8 * hr, j, sl2, rs, hr,
                                         p.Tk, p.causal));
            l[hr] += sa[x];
          }
        }
    };
    if (blk.rule.test(p, kt, qw))
      form(std::true_type());
    else
      form(std::false_type());
    uint32_t pf[16];
    a_frags(pf, sa);  // rnd(p)
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int c = 0; c < NS; ++c) wgmma_rs(o[c], pf + 4 * kk, td + 512 * c + 128 * kk);  // su += P T
    wg_commit();
    wg_wait();
#pragma unroll
    for (int c = 0; c < NS; ++c) reg_fence(o[c]);
    mbar_arrive(empty + s);  // the stage's K, T and mask are free
  }

  const size_t row0 = (size_t)bh * p.Tq;
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    l[hr] += __shfl_xor_sync(0xffffffffu, l[hr], 1);
    l[hr] += __shfl_xor_sync(0xffffffffu, l[hr], 2);
    const int i = i0 + 8 * hr;
    if (i >= p.Tq) continue;
    if (t4 == 0) {
      p.m[row0 + i] = m[hr];
      p.l[row0 + i] = l[hr];
    }
    float* su = p.su + (row0 + i) * 64 * NS + 2 * t4;
#pragma unroll
    for (int c = 0; c < NS; ++c)
#pragma unroll
      for (int n = 0; n < 8; ++n)
        *reinterpret_cast<float2*>(su + 64 * c + 8 * n) =
            make_float2(o[c][4 * n + 2 * hr] / l[hr], o[c][4 * n + 2 * hr + 1] / l[hr]);
  }
}

// fp32 on the CUDA cores.
cudaError_t stats_launch(const StatsParams& p, int dh, int blocks, cudaStream_t s) {
  const size_t fb = sizeof(float) * (size_t)stats_smem_floats(dh);
  switch (dh) {
    case 16: return go(mau_stats_kernel<float, 16>, blocks, kThreads, fb, s, p);
    case 32: return go(mau_stats_kernel<float, 32>, blocks, kThreads, fb, s, p);
    case 64: return go(mau_stats_kernel<float, 64>, blocks, kThreads, fb, s, p);
    case 128: return go(mau_stats_kernel<float, 128>, blocks, kThreads, fb, s, p);
    default: return cudaErrorInvalidValue;
  }
}

// bf16: heads of 64 or 128 channels (the wrapper zero-pads), rows of q, k, t
// on 16-byte boundaries.
cudaError_t stats_tc_launch(const StatsParams& p, int dh, cudaStream_t s) {
  if (dh != 64 && dh != 128) return cudaErrorInvalidValue;
  const int ns = dh / 64, groups = stats_groups(ns);
  QmMaps maps{};
  if (!heads_seq_map(&maps.res[0], p.q, p.Tq, p.H, p.B, dh) ||
      !heads_seq_map(&maps.ring[0], p.k, p.Tk, p.H, p.B, dh) ||
      !heads_seq_map(&maps.ring[2], p.t, p.Tk, p.H, p.B, dh))
    return cudaErrorInvalidValue;
  maps.nres[0] = maps.nring[0] = maps.nring[2] = ns;
  const size_t bytes = stats_tc_smem_bytes(ns, p.Tk);
  const int blocks = p.B * p.H * ((p.Tq + 64 * groups - 1) / (64 * groups));
  const int threads = 128 * (groups + 1);
  return ns == 1 ? go(mau_stats_tc_kernel<1, 3>, blocks, threads, bytes, s, p, maps)
                 : go(mau_stats_tc_kernel<2, 2>, blocks, threads, bytes, s, p, maps);
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

}  // namespace

extern "C" {

// Dynamic shared memory of one block, in bytes; above 232448 a kernel
// cannot run.
size_t mau_stats_smem_bytes(int dh, int Tk, int dtype) {
  return dtype ? stats_tc_smem_bytes(dh == 128 ? 2 : 1, Tk)
               : sizeof(float) * (size_t)stats_smem_floats(dh);
}
size_t mau_out_smem_bytes(int dh, int E, int Tk, int dtype) {
  return dtype ? out_tc_smem_bytes(dh == 128 ? 2 : 1, round_up(E, 64) / 64, Tk)
               : sizeof(float) * (size_t)out_smem_floats(dh, E);
}
size_t mau_intensity_smem_bytes(int dh) { return int_tc_smem_bytes(dh, false); }

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
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype) return (int)stats_tc_launch(p, dh, s);
  return (int)stats_launch(p, dh, B * H * ((Tq + BQ - 1) / BQ), s);
}

// wd_split: scratch of 2 x dh x E*dh bf16 (Wd's seq_units lanes split, hi
// then lo), 16-byte aligned, as are su, wd, bd and w.
int mau_intensity_fwd(const void* su, const void* intervals, const void* wd, const void* bd,
                      const void* w, const void* scaling, void* wd_split, void* lam, int B, int H,
                      int Tq, int dh, int E, void* stream) {
  if (B < 1 || H < 1 || Tq < 1 || E < 1) return (int)cudaErrorInvalidValue;
  IntParams p{};
  p.su = static_cast<const float*>(su);
  p.intervals = static_cast<const float*>(intervals);
  p.bd = static_cast<const float*>(bd);
  p.w = static_cast<const float*>(w);
  p.scaling = static_cast<const float*>(scaling);
  p.lam = static_cast<float*>(lam);
  p.rows = B * H * Tq; p.H = H; p.Tq = Tq; p.E = E;
  return (int)int_launch<false>(p, static_cast<const float*>(wd), static_cast<bf16*>(wd_split),
                                nullptr, dh, static_cast<cudaStream_t>(stream));
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

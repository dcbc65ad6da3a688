// Streamed MAU/BiMAU backward for Hopper (sm_90a): the two-pass custom VJP
// of the long-context schedule as four kernels (five launches).
//
// Replaces the TPU kernels of easydgl_tpu/kernels/mau_streamed.py:
//
//   mau_int_bwd_rows_kernel, mau_int_bwd_cols_kernel
//                   _int_bwd_kernel (pallas_call in _int_streamed_bwd, :274)
//   mau_glam_kernel _glam_kernel    (pallas_call in _mau_streamed_bwd, :692)
//   mau_dq_kernel   _dq_kernel      (pallas_call in _mau_streamed_bwd, :739)
//   mau_dkvt_kernel _dkvt_kernel    (pallas_call in _mau_streamed_bwd, :768)
//
// and computes what the plain pieces of easydgl_tpu_torch/kernels/
// mau_blocked.py compute (glam_reference, intensity_vjp_reference,
// dq_reference, dkvt_reference), with their rounding points. With
// p_ij = exp(s_ij - m_i) / l_i recomputed from the forward's stats, keep_ij
// the dropout factor, iqk_ij = rnd(lam_i) . onehot_j (BiMAU: 1 where j == i)
// and g_mod_ij = dO_i . v_j:
//
//   glam   g_lam_i = sum_j rnd(g_mod_ij p_ij keep_ij) onehot_j, the entries
//          on BiMAU's diagonal zeroed (there iqk is the constant 1);
//   dq     g_s_ij = visible_ij ? p_ij (g_mod_ij keep_ij iqk_ij
//                   + rnd(g_su_i) . t_j - rho_i) / sqrt(dh) : 0,
//          dq_i = sum_j rnd(g_s_ij) k_j;
//   dkvt   dk_j = sum_i rnd(g_s_ij) q_i, dv_j = sum_i rnd(iqk p keep) dO_i,
//          dt_j = sum_i rnd(p_ij) rnd(g_su_i);
//   intensity  the fp32 VJP of lam = s softplus(raw / s), s = exp(scaling),
//          raw[e] = sum_d sigmoid(z)[e*dh + d] w[e, d], z = [su | iv] Wd + bd:
//          g_raw = g_lam sigmoid(raw / s), g_z = g_raw w sig (1 - sig),
//          g_su = (g_z Wd^T)[:dh], gWd = x^T g_z, gbd, gw, gscaling.
//
// rnd() rounds to the compute dtype (bf16) and is the identity in fp32; every
// sum is fp32. The scale 1/sqrt(dh) is applied to g_s before its rounding,
// as the blocked path does (the TPU streamed kernels scale after the
// product). dO and g_su enter in the compute dtype, lam, m, l, rho and the
// intensity head in fp32. Dropout draws the forward's mask: entry (b, h, i, j)
// by the Philox draw of counter (j, i, h, b), j the global key index, in
// the query-major and the key-major kernels alike. Causal key tiles follow
// the forward's key_tiles rule (mau_streamed.cuh); the key-major dkvt
// kernel visits exactly the query tiles whose key_tiles reach its key tile.
//
// Design. The attention-side kernels (glam, dq, dkvt) come in two forms:
//
// * bf16 (the main path): the forward's flash schedule on the tensor cores
//   (mma.sync m16n8k16, fp32 accumulate), four warps of 16 rows, each
//   64-wide tile in two 32-wide halves; a half's products come out as C
//   fragments, are formed in place and, rounded to bf16, are the A
//   fragments of the next product. Tiles are bf16 rows in shared memory,
//   fetched with cp.async one tile ahead and read with ldmatrix.
// * fp32: 256 threads on the CUDA cores, tiles of 64 x 64 held as fp32 in
//   shared memory, rows padded to a stride of 4 mod 32 floats so that
//   16-byte loads are free of bank conflicts. A thread owns the entries
//   (ty + 16a, tx + 16c), a, c < 4, of a (64 x 64) tile, computed with
//   16-byte loads of both operands (tile_nt); a (64 x 64) @ (64 x dh)
//   product gives it 4 rows x dh/16 columns (pv_acc).
//
// The TPU's sequential grid axis becomes the loop inside the block, its VMEM
// accumulators the registers.
//
// * glam, dq: one block per 64 queries of one (b, h), looping over key
//   tiles; q and dO (dq: also g_su, lam) stay resident.
// * dkvt: one block per 64 keys of one (b, h), looping over query tiles;
//   dk, dv and dt accumulate in registers.
// * intensity: the parameter gradients are sums over B*H*Tq rows, the
//   d(seq_units) a sum over E*dh columns, so two kernels. The row kernel
//   (64 rows a block, looping over 64-column tiles, each one to four whole
//   events) recomputes z, raw and g_raw and accumulates g_x = g_z Wd^T in
//   registers; it stores g_raw (rows, E) and adds gscaling by one atomic
//   per event and block. The column kernel (64 columns x 2048 rows a
//   block) reads g_raw, recomputes z and accumulates gWd (dh+1 x 64), gbd
//   and gw in registers over its rows, then adds them with one atomic per
//   entry: ~17 M atomics at the EasyDGL-LC train shape, not one per row.
//   z is computed twice (JAX's kernel: once), for 4 products of rows x
//   (dh+1) x E*dh instead of 3; g_x skips the interval lane, whose gradient
//   is dropped.
//
// What bounds it, at the EasyDGL-LC train shape (B=8, H=8, T=2048, dh=64,
// E=64, BiMAU): operations. glam 3 products of 34.36 GFLOP each, dq 5, dkvt
// 7 (bf16 tensor-core bounds 0.104, 0.174 and 0.243 ms), the intensity VJP
// ~209 GFLOP of fp32 (3.1 ms at 67 TFLOP/s), which stays on the CUDA cores
// in both dtypes, as the TPU kernel is fp32.
//
// Limits: dh in {16, 32, 64}; E up to 128 within the shared memory of
// mau_streamed_bwd_smem_bytes (227 KB).

#include "mau_streamed.cuh"

namespace {

using namespace port;

constexpr int kRowChunk = 2048;  // rows of each column-kernel block

struct BwdParams {
  Seq q, k, v, t, dout;   // dout: (B, Tq, C), the compute dtype
  const void* gsu;        // (B, H, Tq, dh), the compute dtype
  const float* key_mask;  // (B, Tk)
  const float* onehot;    // (B, Tk, E); bf16 (B, Tk, EP) on the tensor cores
  const float* lam;       // (B, H, Tq, E); bf16 (B, H, Tq, EP) on the tensor cores
  const float* m;         // (B, H, Tq)
  const float* l;         // (B, H, Tq)
  const float* rho;       // (B, H, Tq)
  const long long* seed;  // dropout seed on the device, or null
  unsigned drop_thresh;
  float drop_scale;
  float* glam;            // (B, H, Tq, E)
  void* dq;               // (B, Tq, H*dh), the compute dtype
  void* dk;               // (B, Tk, H*dh)
  void* dv;
  void* dt;
  float scale;
  int B, Tq, Tk, H, E, EP, causal, diag_reset;
};

struct IntBwdParams {
  const float* su;         // (rows, dh), rows = B*H*Tq
  const float* intervals;  // (B, Tq)
  const float* wd;         // (dh+1, E*dh)
  const float* bd;         // (E*dh,)
  const float* w;          // (E*dh,)
  const float* scaling;    // (E,)
  const float* g_lam;      // (rows, E)
  float* g_raw;            // (rows, E) scratch: the row kernel's, for the column kernel
  float* g_su;             // (rows, dh)
  float* g_wd;             // (dh+1, E*dh), zeroed by the caller
  float* g_bd;             // (E*dh,), zeroed
  float* g_w;              // (E*dh,), zeroed
  float* g_sc;             // (E,), zeroed
  int rows, H, Tq, E;
};

// Shared memory, in floats. EP = E rounded up to 16.
__host__ __device__ inline int glam_smem_floats(int dh, int ep) {
  return 4 * 64 * (dh + 4) + 64 * (ep + 4) + 64 * LD + 64;
}
__host__ __device__ inline int dq_smem_floats(int dh, int ep) {
  return 6 * 64 * (dh + 4) + 2 * 64 * (ep + 4) + 64 * LD + 64;
}
__host__ __device__ inline int dkvt_smem_floats(int dh, int ep) {
  return 6 * 64 * (dh + 4) + 2 * 64 * (ep + 4) + 3 * 64 * LD + 4 * 64;
}
__host__ __device__ inline int int_rows_smem_floats(int dh, int E) {
  return 2 * 64 * (dh + 4) + dh * LD + 64 * LD + E;
}
__host__ __device__ inline int int_cols_smem_floats(int dh) {
  return 2 * 64 * (dh + 4) + dh * LD + 64 * LD + 64 * 4 + 3 * 16 * 64;
}

// rows [r0, r0 + 64) of a row-major source (row stride rs) into dst[r][c]
// (row stride ld): columns < ns from the source, columns in [ns, nd) zero;
// rows >= nrows zero.
__device__ __forceinline__ void load_tile(float* dst, int ld, const float* src, long long rs,
                                          int ns, int nd, int r0, int nrows) {
  for (int idx = threadIdx.x; idx < 64 * nd; idx += kThreads) {
    const int r = idx / nd, c = idx - r * nd;
    const int row = r0 + r;
    dst[r * ld + c] = (row < nrows && c < ns) ? src[(long long)row * rs + c] : 0.f;
  }
}

// acc[a][c] += sum_{x < n} A[ra + 16a][x] * B[cb + 16c][x] (n % 4 == 0):
// the entries (ra + 16a, cb + 16c) of A B^T, both operands row-major in
// shared memory (row strides lda, ldb, multiples of 4).
template <int NA, int NB>
__device__ __forceinline__ void tile_nt(float (&acc)[NA][NB], const float* A, int lda,
                                        const float* Bm, int ldb, int n, int ra, int cb) {
#pragma unroll 2
  for (int x = 0; x < n; x += 4) {
    float4 a[NA], b[NB];
#pragma unroll
    for (int i = 0; i < NA; ++i) a[i] = *reinterpret_cast<const float4*>(A + (ra + 16 * i) * lda + x);
#pragma unroll
    for (int j = 0; j < NB; ++j) b[j] = *reinterpret_cast<const float4*>(Bm + (cb + 16 * j) * ldb + x);
#pragma unroll
    for (int i = 0; i < NA; ++i)
#pragma unroll
      for (int j = 0; j < NB; ++j) {
        float s = acc[i][j];
        s = fmaf(a[i].x, b[j].x, s);
        s = fmaf(a[i].y, b[j].y, s);
        s = fmaf(a[i].z, b[j].z, s);
        acc[i][j] = fmaf(a[i].w, b[j].w, s);
      }
  }
}

// acc[a][c] += sum_{j < 64} P[ra + 16a][j] * X[j][co + c]: rows ra + 16a of
// a (64 x 64) @ (64 x 16 NC) product, P row-major (stride LD), X row-major
// (stride ldx); NC contiguous columns a thread.
template <int NC>
__device__ __forceinline__ void pv_acc(float (&acc)[4][NC], const float* P, const float* X,
                                       int ldx, int ra, int co) {
#pragma unroll 2
  for (int j = 0; j < 64; j += 4) {
    float pr[4][4];
#pragma unroll
    for (int a = 0; a < 4; ++a) lds<4>(P + (ra + 16 * a) * LD + j, pr[a]);
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      float x[NC];
      lds<NC>(X + (j + jj) * ldx + co, x);
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int c = 0; c < NC; ++c) acc[a][c] = fmaf(pr[a][jj], x[c], acc[a][c]);
    }
  }
}

// The same with the columns strided: acc[a][c] += sum_j P[ra + 16a][j] *
// X[j][cb + 16c] for the first ng of the NMAX column groups.
template <int NMAX>
__device__ __forceinline__ void pv_strided(float (&acc)[4][NMAX], const float* P,
                                           const float* X, int ldx, int ra, int cb, int ng) {
#pragma unroll 2
  for (int j = 0; j < 64; j += 4) {
    float pr[4][4];
#pragma unroll
    for (int a = 0; a < 4; ++a) lds<4>(P + (ra + 16 * a) * LD + j, pr[a]);
#pragma unroll
    for (int jj = 0; jj < 4; ++jj)
#pragma unroll
      for (int c = 0; c < NMAX; ++c) {
        if (c >= ng) break;
        const float x = X[(j + jj) * ldx + cb + 16 * c];
#pragma unroll
        for (int a = 0; a < 4; ++a) acc[a][c] = fmaf(pr[a][jj], x, acc[a][c]);
      }
  }
}

template <typename T = float>
__device__ __forceinline__ const T* head_ptr(const Seq& s, int b, int h, int dh) {
  return static_cast<const T*>(s.p) + b * s.bs + (long long)h * dh;
}

// ---------------------------------------------------------------- glam

template <int DH>
__global__ void __launch_bounds__(kThreads) mau_glam_kernel(const BwdParams p) {
  constexpr int SD = DH + 4;
  const int EP = p.EP, SE = EP + 4;
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;             // [64][SD] q
  float* dos = qs + 64 * SD;    // [64][SD] dO
  float* ks = dos + 64 * SD;    // [64][SD] k tile
  float* vs = ks + 64 * SD;     // [64][SD] v tile
  float* ohs = vs + 64 * SD;    // [64][SE] one-hot tile
  float* ps = ohs + 64 * SE;    // [64][LD] g_iqk, rounded
  float* kms = ps + 64 * LD;    // [64] key flags

  const int nqt = (p.Tq + BQ - 1) / BQ;
  const int bh = blockIdx.x / nqt, q0 = (blockIdx.x - bh * nqt) * BQ;
  const int b = bh / p.H, h = bh - b * p.H;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const float* km_row = p.key_mask + (size_t)b * p.Tk;
  const float* oh_b = p.onehot + (size_t)b * p.Tk * p.E;
  const size_t row0 = (size_t)bh * p.Tq;
  const float* kg = head_ptr(p.k, b, h, DH);
  const float* vg = head_ptr(p.v, b, h, DH);

  load_tile(qs, SD, head_ptr(p.q, b, h, DH), p.q.rs, DH, DH, q0, p.Tq);
  load_tile(dos, SD, head_ptr(p.dout, b, h, DH), p.dout.rs, DH, DH, q0, p.Tq);
  float mi[4], li[4];
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int i = q0 + ty + 16 * a;
    mi[a] = i < p.Tq ? p.m[row0 + i] : 0.f;
    li[a] = i < p.Tq ? p.l[row0 + i] : 1.f;
  }
  const int nkt = key_tiles(km_row, p.Tq, p.Tk, q0, p.causal);
  const Dropout drop = make_dropout(p.seed, p.drop_thresh, p.drop_scale);
  const int ng = EP / 16;

  float acc[4][8];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int c = 0; c < 8; ++c) acc[a][c] = 0.f;

  for (int kt = 0; kt < nkt; ++kt) {
    const int j0 = kt * BK;
    __syncthreads();  // the previous tile's reads are done
    load_tile(ks, SD, kg, p.k.rs, DH, DH, j0, p.Tk);
    load_tile(vs, SD, vg, p.v.rs, DH, DH, j0, p.Tk);
    load_tile(ohs, SE, oh_b, p.E, p.E, EP, j0, p.Tk);
    for (int j = tid; j < BK; j += kThreads) kms[j] = key_flag(km_row, j0 + j, p.Tk);
    __syncthreads();

    float s[4][4] = {}, gm[4][4] = {};
    tile_nt<4, 4>(s, qs, SD, ks, SD, DH, ty, tx);
    tile_nt<4, 4>(gm, dos, SD, vs, SD, DH, ty, tx);
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int i = q0 + ty + 16 * a, jl = tx + 16 * c, j = j0 + jl;
        const float km = kms[jl];
        float x = 0.f;
        if (km >= 0.f && !(p.diag_reset && i == j)) {
          const float pr = expf(logit(s[a][c], km, i, j, p.scale, p.causal, 0.f) - mi[a]) / li[a];
          x = gm[a][c] * pr;
          if (drop.on) x *= drop.factor(b, h, i, j);
        }
        ps[(ty + 16 * a) * LD + jl] = x;
      }
    __syncthreads();
    pv_strided<8>(acc, ps, ohs, SE, ty, tx, ng);
  }

#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int i = q0 + ty + 16 * a;
    if (i >= p.Tq) continue;
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const int e = tx + 16 * c;
      if (c < ng && e < p.E) p.glam[(row0 + i) * p.E + e] = acc[a][c];
    }
  }
}

// ---------------------------------------------------------------- dq

template <int DH>
__global__ void __launch_bounds__(kThreads) mau_dq_kernel(const BwdParams p) {
  constexpr int SD = DH + 4, NC = DH / 16;
  const int EP = p.EP, SE = EP + 4;
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;              // [64][SD] q
  float* dos = qs + 64 * SD;     // [64][SD] dO
  float* gss = dos + 64 * SD;    // [64][SD] g_su
  float* lams = gss + 64 * SD;   // [64][SE] lam, rounded
  float* ks = lams + 64 * SE;    // [64][SD] k tile
  float* vs = ks + 64 * SD;      // [64][SD] v tile
  float* ts = vs + 64 * SD;      // [64][SD] t tile
  float* ohs = ts + 64 * SD;     // [64][SE] one-hot tile
  float* ps = ohs + 64 * SE;     // [64][LD] g_s, rounded
  float* kms = ps + 64 * LD;     // [64] key flags

  const int nqt = (p.Tq + BQ - 1) / BQ;
  const int bh = blockIdx.x / nqt, q0 = (blockIdx.x - bh * nqt) * BQ;
  const int b = bh / p.H, h = bh - b * p.H;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15, co = tx * NC;
  const float* km_row = p.key_mask + (size_t)b * p.Tk;
  const float* oh_b = p.onehot + (size_t)b * p.Tk * p.E;
  const size_t row0 = (size_t)bh * p.Tq;
  const float* kg = head_ptr(p.k, b, h, DH);
  const float* vg = head_ptr(p.v, b, h, DH);
  const float* tg = head_ptr(p.t, b, h, DH);

  load_tile(qs, SD, head_ptr(p.q, b, h, DH), p.q.rs, DH, DH, q0, p.Tq);
  load_tile(dos, SD, head_ptr(p.dout, b, h, DH), p.dout.rs, DH, DH, q0, p.Tq);
  load_tile(gss, SD, static_cast<const float*>(p.gsu) + row0 * DH, DH, DH, DH, q0, p.Tq);
  load_tile(lams, SE, p.lam + row0 * p.E, p.E, p.E, EP, q0, p.Tq);
  float mi[4], li[4], ri[4];
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int i = q0 + ty + 16 * a;
    mi[a] = i < p.Tq ? p.m[row0 + i] : 0.f;
    li[a] = i < p.Tq ? p.l[row0 + i] : 1.f;
    ri[a] = i < p.Tq ? p.rho[row0 + i] : 0.f;
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
    load_tile(ks, SD, kg, p.k.rs, DH, DH, j0, p.Tk);
    load_tile(vs, SD, vg, p.v.rs, DH, DH, j0, p.Tk);
    load_tile(ts, SD, tg, p.t.rs, DH, DH, j0, p.Tk);
    load_tile(ohs, SE, oh_b, p.E, p.E, EP, j0, p.Tk);
    for (int j = tid; j < BK; j += kThreads) kms[j] = key_flag(km_row, j0 + j, p.Tk);
    __syncthreads();

    float s[4][4] = {}, gm[4][4] = {}, gt[4][4] = {}, iq[4][4] = {};
    tile_nt<4, 4>(s, qs, SD, ks, SD, DH, ty, tx);
    tile_nt<4, 4>(gm, dos, SD, vs, SD, DH, ty, tx);
    tile_nt<4, 4>(gt, gss, SD, ts, SD, DH, ty, tx);
    tile_nt<4, 4>(iq, lams, SE, ohs, SE, EP, ty, tx);
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int i = q0 + ty + 16 * a, jl = tx + 16 * c, j = j0 + jl;
        float x = 0.f;
        if (kms[jl] > 0.f && !(p.causal && j > i)) {  // visible
          const float pr = expf(s[a][c] * p.scale - mi[a]) / li[a];
          const float iqv = (p.diag_reset && i == j) ? 1.f : iq[a][c];
          float g = gm[a][c];
          if (drop.on) g *= drop.factor(b, h, i, j);
          x = pr * (g * iqv + gt[a][c] - ri[a]) * p.scale;
        }
        ps[(ty + 16 * a) * LD + jl] = x;
      }
    __syncthreads();
    pv_acc<NC>(acc, ps, ks, SD, ty, co);
  }

  const int C = p.H * DH;
  float* dq = static_cast<float*>(p.dq) + (size_t)b * p.Tq * C + h * DH;
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int i = q0 + ty + 16 * a;
    if (i >= p.Tq) continue;
#pragma unroll
    for (int c = 0; c < NC; ++c) dq[(size_t)i * C + co + c] = acc[a][c];
  }
}

// ---------------------------------------------------------------- dkvt

template <int DH>
__global__ void __launch_bounds__(kThreads) mau_dkvt_kernel(const BwdParams p) {
  constexpr int SD = DH + 4, NC = DH / 16;
  const int EP = p.EP, SE = EP + 4;
  extern __shared__ __align__(16) float smem[];
  float* ks = smem;              // [64][SD] k tile (the block's keys)
  float* vs = ks + 64 * SD;      // [64][SD] v tile
  float* ts = vs + 64 * SD;      // [64][SD] t tile
  float* ohs = ts + 64 * SD;     // [64][SE] one-hot tile
  float* qs = ohs + 64 * SE;     // [64][SD] q of a query tile
  float* dos = qs + 64 * SD;     // [64][SD] dO
  float* gss = dos + 64 * SD;    // [64][SD] g_su
  float* lams = gss + 64 * SD;   // [64][SE] lam, rounded
  float* mt = lams + 64 * SE;    // [64 keys][LD] modulated probs, rounded
  float* gt = mt + 64 * LD;      // [64 keys][LD] g_s, rounded
  float* pt = gt + 64 * LD;      // [64 keys][LD] probs, rounded
  float* kms = pt + 64 * LD;     // [64] key flags
  float* ms = kms + 64;          // [64] m, l, rho of the query tile
  float* ls = ms + 64;
  float* rhos = ls + 64;
  __shared__ int first_real;

  const int nkt = (p.Tk + BK - 1) / BK, nqt = (p.Tq + BQ - 1) / BQ;
  const int bh = blockIdx.x / nkt, kt = blockIdx.x - bh * nkt, k0 = kt * BK;
  const int b = bh / p.H, h = bh - b * p.H;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15, co = tx * NC;
  const float* km_row = p.key_mask + (size_t)b * p.Tk;
  const size_t row0 = (size_t)bh * p.Tq;
  const float* qg = head_ptr(p.q, b, h, DH);
  const float* dog = head_ptr(p.dout, b, h, DH);

  if (tid == 0) first_real = p.Tk;
  __syncthreads();
  for (int j = tid; j < p.Tk; j += kThreads)
    if (km_row[j] > 0.f) atomicMin(&first_real, j);
  load_tile(ks, SD, head_ptr(p.k, b, h, DH), p.k.rs, DH, DH, k0, p.Tk);
  load_tile(vs, SD, head_ptr(p.v, b, h, DH), p.v.rs, DH, DH, k0, p.Tk);
  load_tile(ts, SD, head_ptr(p.t, b, h, DH), p.t.rs, DH, DH, k0, p.Tk);
  load_tile(ohs, SE, p.onehot + (size_t)b * p.Tk * p.E, p.E, p.E, EP, k0, p.Tk);
  for (int j = tid; j < BK; j += kThreads) kms[j] = key_flag(km_row, k0 + j, p.Tk);
  __syncthreads();
  const int first = first_real;
  const Dropout drop = make_dropout(p.seed, p.drop_thresh, p.drop_scale);

  float dk[4][NC], dv[4][NC], dt[4][NC];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int c = 0; c < NC; ++c) dk[a][c] = dv[a][c] = dt[a][c] = 0.f;

  for (int qt = 0; qt < nqt; ++qt) {
    const int q0 = qt * BQ;
    // the mirror of key_tiles: query tile qt reaches key tile kt
    if (p.causal && first <= imin(q0, p.Tk - 1) && k0 > imin(q0 + BQ, p.Tq) - 1) continue;
    __syncthreads();
    load_tile(qs, SD, qg, p.q.rs, DH, DH, q0, p.Tq);
    load_tile(dos, SD, dog, p.dout.rs, DH, DH, q0, p.Tq);
    load_tile(gss, SD, static_cast<const float*>(p.gsu) + row0 * DH, DH, DH, DH, q0, p.Tq);
    load_tile(lams, SE, p.lam + row0 * p.E, p.E, p.E, EP, q0, p.Tq);
    for (int r = tid; r < BQ; r += kThreads) {
      const bool ok = q0 + r < p.Tq;
      ms[r] = ok ? p.m[row0 + q0 + r] : 0.f;
      ls[r] = ok ? p.l[row0 + q0 + r] : 1.f;
      rhos[r] = ok ? p.rho[row0 + q0 + r] : 0.f;
    }
    __syncthreads();

    // transposed tiles: entry (key ty + 16a, query tx + 16c)
    float s[4][4] = {}, gm[4][4] = {}, gs[4][4] = {}, iq[4][4] = {};
    tile_nt<4, 4>(s, ks, SD, qs, SD, DH, ty, tx);
    tile_nt<4, 4>(gm, vs, SD, dos, SD, DH, ty, tx);
    tile_nt<4, 4>(gs, ts, SD, gss, SD, DH, ty, tx);
    tile_nt<4, 4>(iq, ohs, SE, lams, SE, EP, ty, tx);
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int jl = ty + 16 * a, il = tx + 16 * c, j = k0 + jl, i = q0 + il;
        const float km = kms[jl];
        float md = 0.f, g = 0.f, pr = 0.f;
        if (km >= 0.f && i < p.Tq) {  // padding keys and rows past Tq stay 0
          pr = expf(logit(s[a][c], km, i, j, p.scale, p.causal, 0.f) - ms[il]) / ls[il];
          const float iqv = (p.diag_reset && i == j) ? 1.f : iq[a][c];
          const float keep = drop.on ? drop.factor(b, h, i, j) : 1.f;
          md = iqv * pr;
          float gmk = gm[a][c];
          if (drop.on) {
            md *= keep;
            gmk *= keep;
          }
          if (km > 0.f && !(p.causal && j > i))  // visible
            g = pr * (gmk * iqv + gs[a][c] - rhos[il]) * p.scale;
        }
        mt[jl * LD + il] = md;
        gt[jl * LD + il] = g;
        pt[jl * LD + il] = pr;
      }
    __syncthreads();
    pv_acc<NC>(dv, mt, dos, SD, ty, co);
    pv_acc<NC>(dk, gt, qs, SD, ty, co);
    pv_acc<NC>(dt, pt, gss, SD, ty, co);
  }

  const int C = p.H * DH;
  const size_t base = (size_t)b * p.Tk * C + h * DH;
  float* dkg = static_cast<float*>(p.dk) + base;
  float* dvg = static_cast<float*>(p.dv) + base;
  float* dtg = static_cast<float*>(p.dt) + base;
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int j = k0 + ty + 16 * a;
    if (j >= p.Tk) continue;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const size_t o = (size_t)j * C + co + c;
      dkg[o] = dk[a][c];
      dvg[o] = dv[a][c];
      dtg[o] = dt[a][c];
    }
  }
}

// ---------------------------------------------------------------- bf16 on
// the tensor cores: the same three functions for a bf16 compute dtype, in
// the forward's flash schedule (mau_streamed_fwd.cu): four warps of 16 rows
// each, mma.sync m16n8k16 with fp32 accumulation, each 64-wide tile taken in
// two 32-wide halves whose products come out as C fragments, are formed in
// place and, rounded to bf16, are re-used as the A fragments of the next
// product. Tiles sit in shared memory as bf16 rows fetched with cp.async
// one tile ahead (double-buffered) and read with ldmatrix. lam and the
// one-hot arrive from the wrapper rounded to bf16 and zero-padded to EP.

// o (16 x 8 ne) += P (16 x 32) @ X (32 x 8 ne): mma_pv for the first ne
// (even) of NMAX 8-column n-tiles.
template <int NMAX>
__device__ __forceinline__ void mma_pv_n(float (&o)[NMAX][4], const float (&pr)[4][4],
                                         const bf16* xs, int ld, int lane, int ne) {
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const uint32_t a[4] = {pack_bf16(pr[2 * j][0], pr[2 * j][1]),
                           pack_bf16(pr[2 * j][2], pr[2 * j][3]),
                           pack_bf16(pr[2 * j + 1][0], pr[2 * j + 1][1]),
                           pack_bf16(pr[2 * j + 1][2], pr[2 * j + 1][3])};
#pragma unroll
    for (int n2 = 0; n2 < NMAX / 2; ++n2) {
      if (2 * n2 >= ne) break;
      uint32_t b[4];
      ldmatrix_x4_trans(b, xs + (16 * j + ((lane >> 3) & 1) * 8 + (lane & 7)) * ld + 16 * n2 +
                               (lane >> 4) * 8);
      mma_bf16(o[2 * n2], a, b[0], b[1]);
      mma_bf16(o[2 * n2 + 1], a, b[2], b[3]);
    }
  }
}

__host__ __device__ inline size_t glam_mma_smem_bytes(int dh, int ep) {
  return sizeof(bf16) * (size_t)(6 * 64 * (dh + 8) + 2 * 64 * (ep + 8)) + sizeof(float) * 2 * BK;
}
__host__ __device__ inline size_t dq_mma_smem_bytes(int dh, int ep) {
  return sizeof(bf16) * (size_t)(9 * 64 * (dh + 8) + 3 * 64 * (ep + 8)) + sizeof(float) * 2 * BK;
}
__host__ __device__ inline size_t dkvt_mma_smem_bytes(int dh, int ep) {
  return sizeof(bf16) * (size_t)(9 * 64 * (dh + 8) + 3 * 64 * (ep + 8)) +
         sizeof(float) * (BK + 2 * 3 * BQ);
}

template <int DH>
__global__ void __launch_bounds__(kThreadsMma) mau_glam_mma_kernel(const BwdParams p) {
  constexpr int SD = DH + 8;
  const int EP = p.EP, SE = EP + 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);  // [64][SD] q
  bf16* dos = qs + 64 * SD;                      // [64][SD] dO
  bf16* ks = dos + 64 * SD;                      // [2][BK][SD]
  bf16* vs = ks + 2 * BK * SD;                   // [2][BK][SD]
  bf16* os = vs + 2 * BK * SD;                   // [2][BK][SE] one-hot
  float* kms = reinterpret_cast<float*>(os + 2 * BK * SE);  // [2][BK] key mask

  const int nqt = (p.Tq + BQ - 1) / BQ;
  const int bh = blockIdx.x / nqt, q0 = (blockIdx.x - bh * nqt) * BQ;
  const int b = bh / p.H, h = bh - b * p.H;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t4 = lane & 3;
  const float* km_row = p.key_mask + (size_t)b * p.Tk;
  const bf16* kg = head_ptr<bf16>(p.k, b, h, DH);
  const bf16* vg = head_ptr<bf16>(p.v, b, h, DH);
  const bf16* ohg = reinterpret_cast<const bf16*>(p.onehot) + (size_t)b * p.Tk * EP;
  const size_t row0 = (size_t)bh * p.Tq;
  auto fetch = [&](int kt) {
    const int buf = kt & 1;
    async_bf16(ks + buf * BK * SD, SD, kg, p.k.rs, DH, kt * BK, p.Tk);
    async_bf16(vs + buf * BK * SD, SD, vg, p.v.rs, DH, kt * BK, p.Tk);
    async_bf16(os + buf * BK * SE, SE, ohg, EP, EP, kt * BK, p.Tk);
    async_mask(kms + buf * BK, km_row, kt * BK, p.Tk);
  };

  async_bf16(qs, SD, head_ptr<bf16>(p.q, b, h, DH), p.q.rs, DH, q0, p.Tq);
  async_bf16(dos, SD, head_ptr<bf16>(p.dout, b, h, DH), p.dout.rs, DH, q0, p.Tq);
  float mi[2], li[2];
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int i = q0 + warp * 16 + g + 8 * hr;
    mi[hr] = i < p.Tq ? p.m[row0 + i] : 0.f;
    li[hr] = i < p.Tq ? p.l[row0 + i] : 1.f;
  }
  const int nkt = key_tiles(km_row, p.Tq, p.Tk, q0, p.causal);
  const Dropout drop = make_dropout(p.seed, p.drop_thresh, p.drop_scale);
  const int ne = EP / 8;
  fetch(0);
  cp_async_commit();

  uint32_t qf[DH / 16][4], df[DH / 16][4];
  float o[16][4];
#pragma unroll
  for (int n = 0; n < 16; ++n)
#pragma unroll
    for (int c = 0; c < 4; ++c) o[n][c] = 0.f;

  for (int kt = 0; kt < nkt; ++kt) {
    if (kt + 1 < nkt) fetch(kt + 1);
    cp_async_commit();
    cp_async_wait_prev();
    __syncthreads();  // tile kt (and, at kt = 0, q and dO) is in shared memory
    if (kt == 0) {
#pragma unroll
      for (int kd = 0; kd < DH / 16; ++kd) {
        a_frag(qf[kd], qs, SD, warp * 16, kd * 16, lane);
        a_frag(df[kd], dos, SD, warp * 16, kd * 16, lane);
      }
    }
    const int j0 = kt * BK;
    const bf16* kb = ks + (kt & 1) * BK * SD;
    const bf16* vb = vs + (kt & 1) * BK * SD;
    const bf16* ob = os + (kt & 1) * BK * SE;
    const float* kmb = kms + (kt & 1) * BK;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      float s[4][4], gm[4][4];
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int c = 0; c < 4; ++c) s[n][c] = gm[n][c] = 0.f;
#pragma unroll
      for (int kd = 0; kd < DH / 16; ++kd) {
        mma_rows32(s, qf[kd], kb + half * KH * SD, SD, kd * 16, lane);
        mma_rows32(gm, df[kd], vb + half * KH * SD, SD, kd * 16, lane);
      }
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int hr = c >> 1, jj = half * KH + n * 8 + 2 * t4 + (c & 1);
          const int i = q0 + warp * 16 + g + 8 * hr, j = j0 + jj;
          const float km = flag_of(kmb[jj], j, p.Tk);
          float x = 0.f;
          if (km >= 0.f && !(p.diag_reset && i == j)) {
            const float pr =
                expf(logit(s[n][c], km, i, j, p.scale, p.causal, 0.f) - mi[hr]) / li[hr];
            x = gm[n][c] * pr;
            if (drop.on) x *= drop.factor(b, h, i, j);
          }
          s[n][c] = x;
        }
      mma_pv_n<16>(o, s, ob + half * KH * SE, SE, lane, ne);  // g_iqk rounded to bf16
    }
    __syncthreads();  // the buffer is free for tile kt + 2
  }

#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int i = q0 + warp * 16 + g + 8 * hr;
    if (i >= p.Tq) continue;
    float* gl = p.glam + (row0 + i) * p.E;
#pragma unroll
    for (int n = 0; n < 16; ++n) {
      const int e = n * 8 + 2 * t4;
      if (n < ne && e < p.E) gl[e] = o[n][2 * hr];
      if (n < ne && e + 1 < p.E) gl[e + 1] = o[n][2 * hr + 1];
    }
  }
}

template <int DH>
__global__ void __launch_bounds__(kThreadsMma) mau_dq_mma_kernel(const BwdParams p) {
  constexpr int SD = DH + 8;
  const int EP = p.EP, SE = EP + 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);  // [64][SD] q
  bf16* dos = qs + 64 * SD;                      // [64][SD] dO
  bf16* gss = dos + 64 * SD;                     // [64][SD] g_su
  bf16* ls = gss + 64 * SD;                      // [64][SE] lam
  bf16* ks = ls + 64 * SE;                       // [2][BK][SD]
  bf16* vs = ks + 2 * BK * SD;                   // [2][BK][SD]
  bf16* ts = vs + 2 * BK * SD;                   // [2][BK][SD]
  bf16* os = ts + 2 * BK * SD;                   // [2][BK][SE] one-hot
  float* kms = reinterpret_cast<float*>(os + 2 * BK * SE);  // [2][BK] key mask

  const int nqt = (p.Tq + BQ - 1) / BQ;
  const int bh = blockIdx.x / nqt, q0 = (blockIdx.x - bh * nqt) * BQ;
  const int b = bh / p.H, h = bh - b * p.H;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t4 = lane & 3;
  const float* km_row = p.key_mask + (size_t)b * p.Tk;
  const bf16* kg = head_ptr<bf16>(p.k, b, h, DH);
  const bf16* vg = head_ptr<bf16>(p.v, b, h, DH);
  const bf16* tg = head_ptr<bf16>(p.t, b, h, DH);
  const bf16* ohg = reinterpret_cast<const bf16*>(p.onehot) + (size_t)b * p.Tk * EP;
  const size_t row0 = (size_t)bh * p.Tq;
  auto fetch = [&](int kt) {
    const int buf = kt & 1;
    async_bf16(ks + buf * BK * SD, SD, kg, p.k.rs, DH, kt * BK, p.Tk);
    async_bf16(vs + buf * BK * SD, SD, vg, p.v.rs, DH, kt * BK, p.Tk);
    async_bf16(ts + buf * BK * SD, SD, tg, p.t.rs, DH, kt * BK, p.Tk);
    async_bf16(os + buf * BK * SE, SE, ohg, EP, EP, kt * BK, p.Tk);
    async_mask(kms + buf * BK, km_row, kt * BK, p.Tk);
  };

  async_bf16(qs, SD, head_ptr<bf16>(p.q, b, h, DH), p.q.rs, DH, q0, p.Tq);
  async_bf16(dos, SD, head_ptr<bf16>(p.dout, b, h, DH), p.dout.rs, DH, q0, p.Tq);
  async_bf16(gss, SD, static_cast<const bf16*>(p.gsu) + row0 * DH, DH, DH, q0, p.Tq);
  async_bf16(ls, SE, reinterpret_cast<const bf16*>(p.lam) + row0 * EP, EP, EP, q0, p.Tq);
  float mi[2], li[2], ri[2];
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int i = q0 + warp * 16 + g + 8 * hr;
    mi[hr] = i < p.Tq ? p.m[row0 + i] : 0.f;
    li[hr] = i < p.Tq ? p.l[row0 + i] : 1.f;
    ri[hr] = i < p.Tq ? p.rho[row0 + i] : 0.f;
  }
  const int nkt = key_tiles(km_row, p.Tq, p.Tk, q0, p.causal);
  const Dropout drop = make_dropout(p.seed, p.drop_thresh, p.drop_scale);
  fetch(0);
  cp_async_commit();

  uint32_t qf[DH / 16][4], df[DH / 16][4], gf[DH / 16][4];
  float o[DH / 8][4];
#pragma unroll
  for (int n = 0; n < DH / 8; ++n)
#pragma unroll
    for (int c = 0; c < 4; ++c) o[n][c] = 0.f;

  for (int kt = 0; kt < nkt; ++kt) {
    if (kt + 1 < nkt) fetch(kt + 1);
    cp_async_commit();
    cp_async_wait_prev();
    __syncthreads();  // tile kt (and, at kt = 0, q, dO, g_su and lam) is in shared memory
    if (kt == 0) {
#pragma unroll
      for (int kd = 0; kd < DH / 16; ++kd) {
        a_frag(qf[kd], qs, SD, warp * 16, kd * 16, lane);
        a_frag(df[kd], dos, SD, warp * 16, kd * 16, lane);
        a_frag(gf[kd], gss, SD, warp * 16, kd * 16, lane);
      }
    }
    const int j0 = kt * BK;
    const bf16* kb = ks + (kt & 1) * BK * SD;
    const bf16* vb = vs + (kt & 1) * BK * SD;
    const bf16* tb = ts + (kt & 1) * BK * SD;
    const bf16* ob = os + (kt & 1) * BK * SE;
    const float* kmb = kms + (kt & 1) * BK;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      float s[4][4], gm[4][4], gt[4][4], iq[4][4];
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int c = 0; c < 4; ++c) s[n][c] = gm[n][c] = gt[n][c] = iq[n][c] = 0.f;
#pragma unroll
      for (int kd = 0; kd < DH / 16; ++kd) {
        mma_rows32(s, qf[kd], kb + half * KH * SD, SD, kd * 16, lane);
        mma_rows32(gm, df[kd], vb + half * KH * SD, SD, kd * 16, lane);
        mma_rows32(gt, gf[kd], tb + half * KH * SD, SD, kd * 16, lane);
      }
      for (int ke = 0; ke < EP; ke += 16) {
        uint32_t la[4];
        a_frag(la, ls, SE, warp * 16, ke, lane);
        mma_rows32(iq, la, ob + half * KH * SE, SE, ke, lane);
      }
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int hr = c >> 1, jj = half * KH + n * 8 + 2 * t4 + (c & 1);
          const int i = q0 + warp * 16 + g + 8 * hr, j = j0 + jj;
          float x = 0.f;
          if (j < p.Tk && kmb[jj] > 0.f && !(p.causal && j > i)) {  // visible
            const float pr = expf(s[n][c] * p.scale - mi[hr]) / li[hr];
            const float iqv = (p.diag_reset && i == j) ? 1.f : iq[n][c];
            float gv = gm[n][c];
            if (drop.on) gv *= drop.factor(b, h, i, j);
            x = pr * (gv * iqv + gt[n][c] - ri[hr]) * p.scale;
          }
          s[n][c] = x;
        }
      mma_pv<DH>(o, s, kb + half * KH * SD, SD, lane);  // g_s rounded to bf16, @ K
    }
    __syncthreads();  // the buffer is free for tile kt + 2
  }

  const int C = p.H * DH;
  bf16* dq = static_cast<bf16*>(p.dq) + (size_t)b * p.Tq * C + h * DH;
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int i = q0 + warp * 16 + g + 8 * hr;
    if (i >= p.Tq) continue;
#pragma unroll
    for (int n = 0; n < DH / 8; ++n)
      *reinterpret_cast<__nv_bfloat162*>(dq + (size_t)i * C + n * 8 + 2 * t4) =
          __floats2bfloat162_rn(o[n][2 * hr], o[n][2 * hr + 1]);
  }
}

// Key-major: a warp owns 16 keys; the query tiles stream through shared
// memory and each half's (16 keys x 32 queries) products are the A
// fragments of dv += md @ dO, dk += g_s @ Q and dt += p @ g_su.
template <int DH>
__global__ void __launch_bounds__(kThreadsMma) mau_dkvt_mma_kernel(const BwdParams p) {
  constexpr int SD = DH + 8;
  const int EP = p.EP, SE = EP + 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* ks = reinterpret_cast<bf16*>(smem_raw);  // [BK][SD] the block's keys
  bf16* vs = ks + BK * SD;                       // [BK][SD]
  bf16* ts = vs + BK * SD;                       // [BK][SD]
  bf16* os = ts + BK * SD;                       // [BK][SE] one-hot
  bf16* qs = os + BK * SE;                       // [2][BQ][SD] q of a query tile
  bf16* dos = qs + 2 * BQ * SD;                  // [2][BQ][SD] dO
  bf16* gss = dos + 2 * BQ * SD;                 // [2][BQ][SD] g_su
  bf16* ls = gss + 2 * BQ * SD;                  // [2][BQ][SE] lam
  float* kms = reinterpret_cast<float*>(ls + 2 * BQ * SE);  // [BK] key flags
  float* st = kms + BK;                          // [2][3][BQ] m, l, rho
  __shared__ int first_real;

  const int nkt = (p.Tk + BK - 1) / BK, nqt = (p.Tq + BQ - 1) / BQ;
  const int bh = blockIdx.x / nkt, kt = blockIdx.x - bh * nkt, k0 = kt * BK;
  const int b = bh / p.H, h = bh - b * p.H;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t4 = lane & 3;
  const float* km_row = p.key_mask + (size_t)b * p.Tk;
  const size_t row0 = (size_t)bh * p.Tq;
  const bf16* qg = head_ptr<bf16>(p.q, b, h, DH);
  const bf16* dog = head_ptr<bf16>(p.dout, b, h, DH);
  const bf16* gsg = static_cast<const bf16*>(p.gsu) + row0 * DH;
  const bf16* lg = reinterpret_cast<const bf16*>(p.lam) + row0 * EP;
  auto fetch = [&](int qt, int buf) {
    const int q0 = qt * BQ;
    async_bf16(qs + buf * BQ * SD, SD, qg, p.q.rs, DH, q0, p.Tq);
    async_bf16(dos + buf * BQ * SD, SD, dog, p.dout.rs, DH, q0, p.Tq);
    async_bf16(gss + buf * BQ * SD, SD, gsg, DH, DH, q0, p.Tq);
    async_bf16(ls + buf * BQ * SE, SE, lg, EP, EP, q0, p.Tq);
    for (int idx = tid; idx < 3 * BQ; idx += kThreadsMma) {
      const int which = idx / BQ, r = idx - which * BQ;
      const bool ok = q0 + r < p.Tq;
      const float* src = which == 0 ? p.m : which == 1 ? p.l : p.rho;
      cp_async4(st + (buf * 3 + which) * BQ + r, src + row0 + (ok ? q0 + r : 0), ok);
    }
  };

  if (tid == 0) first_real = p.Tk;
  __syncthreads();
  for (int j = tid; j < p.Tk; j += kThreadsMma)
    if (km_row[j] > 0.f) atomicMin(&first_real, j);
  async_bf16(ks, SD, head_ptr<bf16>(p.k, b, h, DH), p.k.rs, DH, k0, p.Tk);
  async_bf16(vs, SD, head_ptr<bf16>(p.v, b, h, DH), p.v.rs, DH, k0, p.Tk);
  async_bf16(ts, SD, head_ptr<bf16>(p.t, b, h, DH), p.t.rs, DH, k0, p.Tk);
  async_bf16(os, SE, reinterpret_cast<const bf16*>(p.onehot) + (size_t)b * p.Tk * EP, EP, EP,
             k0, p.Tk);
  for (int j = tid; j < BK; j += kThreadsMma) kms[j] = key_flag(km_row, k0 + j, p.Tk);
  __syncthreads();
  const int first = first_real;
  // the mirror of key_tiles: the next query tile from qt on that reaches
  // this key tile
  auto next_live = [&](int qt) {
    for (; qt < nqt; ++qt) {
      const int q0 = qt * BQ;
      if (!(p.causal && first <= imin(q0, p.Tk - 1) && k0 > imin(q0 + BQ, p.Tq) - 1)) break;
    }
    return qt;
  };
  const Dropout drop = make_dropout(p.seed, p.drop_thresh, p.drop_scale);

  float dk[DH / 8][4], dv[DH / 8][4], dt[DH / 8][4];
#pragma unroll
  for (int n = 0; n < DH / 8; ++n)
#pragma unroll
    for (int c = 0; c < 4; ++c) dk[n][c] = dv[n][c] = dt[n][c] = 0.f;

  int qt = next_live(0), buf = 0;
  if (qt < nqt) fetch(qt, 0);
  cp_async_commit();
  while (qt < nqt) {
    const int nxt = next_live(qt + 1);
    if (nxt < nqt) fetch(nxt, buf ^ 1);
    cp_async_commit();
    cp_async_wait_prev();
    __syncthreads();  // query tile qt (and the key tiles) are in shared memory
    const int q0 = qt * BQ;
    const bf16* qb = qs + buf * BQ * SD;
    const bf16* db = dos + buf * BQ * SD;
    const bf16* gb = gss + buf * BQ * SD;
    const bf16* lb = ls + buf * BQ * SE;
    const float* mq = st + buf * 3 * BQ;
    const float* lq = mq + BQ;
    const float* rq = lq + BQ;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      // transposed tiles: entry (key warp*16 + g + 8 hr, query of the half)
      float s[4][4], gm[4][4], gt[4][4], iq[4][4];
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int c = 0; c < 4; ++c) s[n][c] = gm[n][c] = gt[n][c] = iq[n][c] = 0.f;
#pragma unroll
      for (int kd = 0; kd < DH / 16; ++kd) {
        uint32_t a[4];
        a_frag(a, ks, SD, warp * 16, kd * 16, lane);
        mma_rows32(s, a, qb + half * KH * SD, SD, kd * 16, lane);
        a_frag(a, vs, SD, warp * 16, kd * 16, lane);
        mma_rows32(gm, a, db + half * KH * SD, SD, kd * 16, lane);
        a_frag(a, ts, SD, warp * 16, kd * 16, lane);
        mma_rows32(gt, a, gb + half * KH * SD, SD, kd * 16, lane);
      }
      for (int ke = 0; ke < EP; ke += 16) {
        uint32_t a[4];
        a_frag(a, os, SE, warp * 16, ke, lane);
        mma_rows32(iq, a, lb + half * KH * SE, SE, ke, lane);
      }
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int hr = c >> 1, jl = warp * 16 + g + 8 * hr;
          const int il = half * KH + n * 8 + 2 * t4 + (c & 1);
          const int j = k0 + jl, i = q0 + il;
          const float km = kms[jl];
          float md = 0.f, gv = 0.f, pr = 0.f;
          if (km >= 0.f && i < p.Tq) {  // padding keys and rows past Tq stay 0
            pr = expf(logit(s[n][c], km, i, j, p.scale, p.causal, 0.f) - mq[il]) / lq[il];
            const float iqv = (p.diag_reset && i == j) ? 1.f : iq[n][c];
            float gmk = gm[n][c];
            md = iqv * pr;
            if (drop.on) {
              const float keep = drop.factor(b, h, i, j);
              md *= keep;
              gmk *= keep;
            }
            if (km > 0.f && !(p.causal && j > i))  // visible
              gv = pr * (gmk * iqv + gt[n][c] - rq[il]) * p.scale;
          }
          s[n][c] = pr;
          gm[n][c] = md;
          gt[n][c] = gv;
        }
      mma_pv<DH>(dv, gm, db + half * KH * SD, SD, lane);  // modulated probs @ dO
      mma_pv<DH>(dk, gt, qb + half * KH * SD, SD, lane);  // g_s @ Q
      mma_pv<DH>(dt, s, gb + half * KH * SD, SD, lane);   // probs @ g_su
    }
    __syncthreads();  // the buffer is free for the tile after next
    buf ^= 1;
    qt = nxt;
  }
  asm volatile("cp.async.wait_all;\n" ::);  // the key tiles, where no query tile came

  const int C = p.H * DH;
  const size_t base = (size_t)b * p.Tk * C + h * DH;
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int j = k0 + warp * 16 + g + 8 * hr;
    if (j >= p.Tk) continue;
#pragma unroll
    for (int n = 0; n < DH / 8; ++n) {
      const size_t o = (size_t)j * C + n * 8 + 2 * t4;
      *reinterpret_cast<__nv_bfloat162*>(static_cast<bf16*>(p.dk) + base + o) =
          __floats2bfloat162_rn(dk[n][2 * hr], dk[n][2 * hr + 1]);
      *reinterpret_cast<__nv_bfloat162*>(static_cast<bf16*>(p.dv) + base + o) =
          __floats2bfloat162_rn(dv[n][2 * hr], dv[n][2 * hr + 1]);
      *reinterpret_cast<__nv_bfloat162*>(static_cast<bf16*>(p.dt) + base + o) =
          __floats2bfloat162_rn(dt[n][2 * hr], dt[n][2 * hr + 1]);
    }
  }
}

// ---------------------------------------------------------------- intensity

// x = [su | iv] of rows [r0, r0 + 64) into xs[r][c] (stride DH + 4; lanes
// past DH zero); rows >= nrows zero. With xt, seq_units also transposed
// into xt[c][r] (stride LD, DH rows).
template <int DH>
__device__ __forceinline__ void load_x(float* xs, float* xt, const IntBwdParams& p, int r0,
                                       int nrows) {
  constexpr int SX = DH + 4;
  for (int idx = threadIdx.x; idx < 64 * SX; idx += kThreads) {
    const int r = idx / SX, c = idx - r * SX;
    const int row = r0 + r;
    float x = 0.f;
    if (row < nrows) {
      if (c < DH) {
        x = p.su[(size_t)row * DH + c];
      } else if (c == DH) {
        const int i = row % p.Tq, b = row / (p.Tq * p.H);
        x = p.intervals[(size_t)b * p.Tq + i];
      }
    }
    xs[r * SX + c] = x;
    if (xt && c < DH) xt[c * LD + r] = x;
  }
}

// Columns [n0, n0 + 64) of Wd: wt[n][c] = Wd[c][n0 + n] (stride DH + 4, lanes
// past DH zero) and, with wc, the seq_units rows wc[c][n], c < DH (stride
// LD); columns past E*dh zero.
template <int DH>
__device__ __forceinline__ void load_wd(float* wt, float* wc, const float* wd, int edh, int n0) {
  constexpr int SX = DH + 4;
  for (int idx = threadIdx.x; idx < SX * 64; idx += kThreads) {
    const int c = idx / 64, n = idx - c * 64;
    const float x = (c <= DH && n0 + n < edh) ? wd[(size_t)c * edh + n0 + n] : 0.f;
    wt[n * SX + c] = x;
    if (wc && c < DH) wc[c * LD + n] = x;
  }
}

template <int DH>
__global__ void __launch_bounds__(kThreads) mau_int_bwd_rows_kernel(const IntBwdParams p) {
  constexpr int SX = DH + 4, NC = DH / 16;
  extern __shared__ __align__(16) float smem[];
  float* xs = smem;                  // [64][SX] x = [su | iv]
  float* wt = xs + 64 * SX;          // [64][SX] Wd column tile, transposed
  float* wc = wt + 64 * SX;          // [DH][LD] its seq_units rows, row-major
  float* gz = wc + DH * LD;          // [64][LD] g_z tile
  float* gsc = gz + 64 * LD;         // [E] gscaling of the block
  const int E = p.E, edh = E * DH;
  const int r0 = blockIdx.x * 64;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;

  load_x<DH>(xs, nullptr, p, r0, p.rows);
  for (int e = tid; e < E; e += kThreads) gsc[e] = 0.f;

  float gx[4][NC];  // g_x of the seq_units lanes (the interval's is dropped)
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int c = 0; c < NC; ++c) gx[a][c] = 0.f;

  for (int n0 = 0; n0 < edh; n0 += 64) {
    __syncthreads();
    load_wd<DH>(wt, wc, p.wd, edh, n0);
    __syncthreads();
    float z[4][4] = {};
    tile_nt<4, 4>(z, xs, SX, wt, SX, SX, ty, tx);
    float sg[4][4], part[4][4], wn[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int n = n0 + tx + 16 * c;
      const float bn = n < edh ? p.bd[n] : 0.f;
      wn[c] = n < edh ? p.w[n] : 0.f;
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        sg[a][c] = sigmoid(z[a][c] + bn);
        part[a][c] = sg[a][c] * wn[c];
      }
    }
    // raw of (row, event): the event of column tx + 16c is 16c / DH, so
    // sum the thread's column groups of an event, then the 16 lanes of the
    // row group
    constexpr int G = DH / 16;  // column groups an event
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int c0 = 0; c0 < 4; c0 += G) {
#pragma unroll
        for (int cc = 1; cc < G; ++cc) part[a][c0] += part[a][c0 + cc];
#pragma unroll
        for (int o = 8; o > 0; o >>= 1) part[a][c0] += __shfl_xor_sync(0xffffffffu, part[a][c0], o);
      }
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int row = r0 + ty + 16 * a;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int c0 = (c / G) * G;
        const float raw = part[a][c0];
        const int e = (n0 + 16 * c) / DH;
        float graw = 0.f;
        if (e < E && row < p.rows) {
          const float gl = p.g_lam[(size_t)row * E + e];
          const float s = expf(p.scaling[e]);
          const float rr = raw / s, sr = sigmoid(rr);
          graw = gl * sr;
          if (tx == 0 && c == c0) {
            atomicAdd(&gsc[e], gl * (s * softplus(rr) - sr * raw));
            p.g_raw[(size_t)row * E + e] = graw;
          }
        }
        gz[(ty + 16 * a) * LD + tx + 16 * c] = graw * wn[c] * sg[a][c] * (1.f - sg[a][c]);
      }
    }
    __syncthreads();
    tile_nt<4, NC>(gx, gz, LD, wc, LD, 64, ty, tx);
  }

#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int row = r0 + ty + 16 * a;
    if (row >= p.rows) continue;
#pragma unroll
    for (int c = 0; c < NC; ++c) p.g_su[(size_t)row * DH + tx + 16 * c] = gx[a][c];
  }
  __syncthreads();
  for (int e = tid; e < E; e += kThreads) atomicAdd(&p.g_sc[e], gsc[e]);
}

template <int DH>
__global__ void __launch_bounds__(kThreads) mau_int_bwd_cols_kernel(const IntBwdParams p) {
  constexpr int SX = DH + 4, NC = DH / 16, EPT = 64 / DH;  // events a tile
  extern __shared__ __align__(16) float smem[];
  float* wt = smem;                  // [64][SX] Wd column tile, transposed
  float* xs = wt + 64 * SX;          // [64][SX] x of a row sub-tile
  float* xt = xs + 64 * SX;          // [DH][LD] its seq_units, transposed
  float* gzt = xt + DH * LD;         // [64 columns][LD] g_z transposed
  float* grs = gzt + 64 * LD;        // [64][4] g_raw of the tile's events
  float* red = grs + 64 * 4;         // [3][16][64] column sums to reduce
  const int E = p.E, edh = E * DH;
  const int n0 = blockIdx.x * 64, e0 = n0 / DH;
  const int rbeg = blockIdx.y * kRowChunk, rend = imin(rbeg + kRowChunk, p.rows);
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;

  load_wd<DH>(wt, nullptr, p.wd, edh, n0);
  float bn[4], wn[4];
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const int n = n0 + tx + 16 * c;
    bn[c] = n < edh ? p.bd[n] : 0.f;
    wn[c] = n < edh ? p.w[n] : 0.f;
  }
  // gwd: Wd's seq_units rows ty + 16a; giv: its interval row
  float gwd[NC][4], giv[4], gbd[4], gw[4];
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    giv[c] = gbd[c] = gw[c] = 0.f;
#pragma unroll
    for (int a = 0; a < NC; ++a) gwd[a][c] = 0.f;
  }

  for (int r0 = rbeg; r0 < rend; r0 += 64) {
    __syncthreads();
    load_x<DH>(xs, xt, p, r0, rend);
    for (int idx = tid; idx < 64 * 4; idx += kThreads) {
      const int r = idx / 4, el = idx - r * 4;
      const int row = r0 + r;
      grs[idx] = (row < rend && el < EPT && e0 + el < E) ? p.g_raw[(size_t)row * E + e0 + el] : 0.f;
    }
    __syncthreads();
    float z[4][4] = {};
    tile_nt<4, 4>(z, xs, SX, wt, SX, SX, ty, tx);
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int r = ty + 16 * a;
        const float sg = sigmoid(z[a][c] + bn[c]);
        const float gr = grs[r * 4 + (16 * c) / DH];
        const float g = gr * wn[c] * sg * (1.f - sg);
        gw[c] = fmaf(gr, sg, gw[c]);
        gbd[c] += g;
        giv[c] = fmaf(xs[r * SX + DH], g, giv[c]);
        gzt[(tx + 16 * c) * LD + r] = g;
      }
    __syncthreads();
    tile_nt<NC, 4>(gwd, xt, LD, gzt, LD, 64, ty, tx);
  }

#pragma unroll
  for (int a = 0; a < NC; ++a) {
    const int c = ty + 16 * a;
#pragma unroll
    for (int cc = 0; cc < 4; ++cc) {
      const int n = n0 + tx + 16 * cc;
      if (n < edh) atomicAdd(&p.g_wd[(size_t)c * edh + n], gwd[a][cc]);
    }
  }
  // gbd, gw and the interval row of gWd: sums over the 16 row groups
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    red[ty * 64 + tx + 16 * c] = gbd[c];
    red[16 * 64 + ty * 64 + tx + 16 * c] = gw[c];
    red[32 * 64 + ty * 64 + tx + 16 * c] = giv[c];
  }
  __syncthreads();
  if (tid < 192) {
    const int col = tid & 63, which = tid >> 6;
    float sum = 0.f;
    for (int y = 0; y < 16; ++y) sum += red[which * 16 * 64 + y * 64 + col];
    float* dst = which == 0 ? p.g_bd : which == 1 ? p.g_w : p.g_wd + (size_t)DH * edh;
    if (n0 + col < edh) atomicAdd(dst + n0 + col, sum);
  }
}

// ---------------------------------------------------------------- launch

BwdParams make_params(const Seq& q, const Seq& k, const Seq& v, const Seq& t, const Seq& dout,
                      const void* gsu, const void* key_mask, const void* onehot, const void* lam,
                      const void* m, const void* l, const void* rho, const void* seed,
                      unsigned drop_thresh, float drop_scale, int B, int Tq, int Tk, int H,
                      int E, int causal, int diag_reset, float scale) {
  BwdParams p{};
  p.q = q; p.k = k; p.v = v; p.t = t; p.dout = dout;
  p.gsu = gsu;
  p.key_mask = static_cast<const float*>(key_mask);
  p.onehot = static_cast<const float*>(onehot);
  p.lam = static_cast<const float*>(lam);
  p.m = static_cast<const float*>(m);
  p.l = static_cast<const float*>(l);
  p.rho = static_cast<const float*>(rho);
  p.seed = static_cast<const long long*>(seed);
  p.drop_thresh = drop_thresh;
  p.drop_scale = drop_scale;
  p.scale = scale;
  p.B = B; p.Tq = Tq; p.Tk = Tk; p.H = H; p.E = E; p.EP = round_up(E, 16);
  p.causal = causal; p.diag_reset = diag_reset;
  return p;
}

enum Which { kGlam = 0, kDq = 1, kDkvt = 2, kIntRows = 3, kIntCols = 4 };

size_t smem_bytes(int which, int dh, int E, int dtype) {
  const int ep = round_up(E, 16);
  switch (which) {
    case kGlam:
      return dtype ? glam_mma_smem_bytes(dh, ep) : sizeof(float) * (size_t)glam_smem_floats(dh, ep);
    case kDq:
      return dtype ? dq_mma_smem_bytes(dh, ep) : sizeof(float) * (size_t)dq_smem_floats(dh, ep);
    case kDkvt:
      return dtype ? dkvt_mma_smem_bytes(dh, ep) : sizeof(float) * (size_t)dkvt_smem_floats(dh, ep);
    case kIntRows: return sizeof(float) * (size_t)int_rows_smem_floats(dh, E);
    default: return sizeof(float) * (size_t)int_cols_smem_floats(dh);
  }
}

// The attention-side kernels by dtype and dh: fp32 on the CUDA cores
// (256 threads), bf16 on the tensor cores (128 threads).
using Kernel = void (*)(const BwdParams);
const Kernel kGlamKernels[6] = {mau_glam_kernel<16>,     mau_glam_kernel<32>,
                                mau_glam_kernel<64>,     mau_glam_mma_kernel<16>,
                                mau_glam_mma_kernel<32>, mau_glam_mma_kernel<64>};
const Kernel kDqKernels[6] = {mau_dq_kernel<16>,     mau_dq_kernel<32>,
                              mau_dq_kernel<64>,     mau_dq_mma_kernel<16>,
                              mau_dq_mma_kernel<32>, mau_dq_mma_kernel<64>};
const Kernel kDkvtKernels[6] = {mau_dkvt_kernel<16>,     mau_dkvt_kernel<32>,
                                mau_dkvt_kernel<64>,     mau_dkvt_mma_kernel<16>,
                                mau_dkvt_mma_kernel<32>, mau_dkvt_mma_kernel<64>};

cudaError_t launch(const Kernel (&kernels)[6], int which, const BwdParams& p, int dh, int dtype,
                   int blocks, cudaStream_t s) {
  const int slot = dh == 16 ? 0 : dh == 32 ? 1 : dh == 64 ? 2 : -1;
  if (slot < 0) return cudaErrorInvalidValue;
  return go(kernels[slot + 3 * dtype], blocks, dtype ? kThreadsMma : kThreads,
            smem_bytes(which, dh, p.E, dtype), s, p);
}

bool bad_shape(int B, int Tq, int Tk, int H, int E, int dtype) {
  return B < 1 || H < 1 || Tq < 1 || Tk < 1 || E < 1 || E > 128 || (dtype != 0 && dtype != 1);
}

}  // namespace

extern "C" {

// Dynamic shared memory of one block of kernel `which` (0 glam, 1 dq,
// 2 dkvt, 3 intensity rows, 4 intensity columns) for a compute dtype, in
// bytes; above 232448 it cannot run.
size_t mau_streamed_bwd_smem_bytes(int which, int dh, int E, int dtype) {
  return smem_bytes(which, dh, E, dtype);
}

// Each launches on `stream` and returns cudaGetLastError() (0 on success).
// dtype: 0 = float32, 1 = bfloat16, of q, k, v, t, dout, g_su and the
// outputs dq, dk, dv, dt. Strides are in elements; channels are contiguous;
// g_su is (B, H, Tq, dh) contiguous; everything else is fp32 and contiguous,
// except that in bf16 lam (B, H, Tq, EP) and onehot (B, Tk, EP) are bf16,
// rounded and zero-padded to EP = E rounded up to 16, and the rows of q, k,
// v, t and dout start on 16-byte boundaries.
// `seed` (an int64 on the device, or null for no dropout) keys the dropout
// mask; keep where the Philox word is below drop_thresh, scaled by
// drop_scale.
int mau_glam_bwd(const void* q, long long q_bs, long long q_rs, const void* k, long long k_bs,
                 long long k_rs, const void* v, long long v_bs, long long v_rs, const void* dout,
                 long long do_bs, long long do_rs, const void* key_mask, const void* onehot,
                 const void* m, const void* l, const void* seed, unsigned drop_thresh,
                 float drop_scale, void* glam, int B, int Tq, int Tk, int H, int dh, int E,
                 int causal, int diag_reset, float scale, int dtype, void* stream) {
  if (bad_shape(B, Tq, Tk, H, E, dtype)) return (int)cudaErrorInvalidValue;
  BwdParams p = make_params({q, q_bs, q_rs}, {k, k_bs, k_rs}, {v, v_bs, v_rs}, {nullptr, 0, 0},
                            {dout, do_bs, do_rs}, nullptr, key_mask, onehot, nullptr, m, l,
                            nullptr, seed, drop_thresh, drop_scale, B, Tq, Tk, H, E, causal,
                            diag_reset, scale);
  p.glam = static_cast<float*>(glam);
  const int blocks = B * H * ((Tq + BQ - 1) / BQ);
  return (int)launch(kGlamKernels, kGlam, p, dh, dtype, blocks, static_cast<cudaStream_t>(stream));
}

int mau_dq_bwd(const void* q, long long q_bs, long long q_rs, const void* k, long long k_bs,
               long long k_rs, const void* v, long long v_bs, long long v_rs, const void* t,
               long long t_bs, long long t_rs, const void* dout, long long do_bs,
               long long do_rs, const void* gsu, const void* key_mask, const void* onehot,
               const void* lam, const void* m, const void* l, const void* rho, const void* seed,
               unsigned drop_thresh, float drop_scale, void* dq, int B, int Tq, int Tk, int H,
               int dh, int E, int causal, int diag_reset, float scale, int dtype, void* stream) {
  if (bad_shape(B, Tq, Tk, H, E, dtype)) return (int)cudaErrorInvalidValue;
  BwdParams p = make_params({q, q_bs, q_rs}, {k, k_bs, k_rs}, {v, v_bs, v_rs}, {t, t_bs, t_rs},
                            {dout, do_bs, do_rs}, gsu, key_mask, onehot, lam, m, l, rho, seed,
                            drop_thresh, drop_scale, B, Tq, Tk, H, E, causal, diag_reset, scale);
  p.dq = dq;
  const int blocks = B * H * ((Tq + BQ - 1) / BQ);
  return (int)launch(kDqKernels, kDq, p, dh, dtype, blocks, static_cast<cudaStream_t>(stream));
}

int mau_dkvt_bwd(const void* q, long long q_bs, long long q_rs, const void* k, long long k_bs,
                 long long k_rs, const void* v, long long v_bs, long long v_rs, const void* t,
                 long long t_bs, long long t_rs, const void* dout, long long do_bs,
                 long long do_rs, const void* gsu, const void* key_mask, const void* onehot,
                 const void* lam, const void* m, const void* l, const void* rho,
                 const void* seed, unsigned drop_thresh, float drop_scale, void* dk, void* dv,
                 void* dt, int B, int Tq, int Tk, int H, int dh, int E, int causal,
                 int diag_reset, float scale, int dtype, void* stream) {
  if (bad_shape(B, Tq, Tk, H, E, dtype)) return (int)cudaErrorInvalidValue;
  BwdParams p = make_params({q, q_bs, q_rs}, {k, k_bs, k_rs}, {v, v_bs, v_rs}, {t, t_bs, t_rs},
                            {dout, do_bs, do_rs}, gsu, key_mask, onehot, lam, m, l, rho, seed,
                            drop_thresh, drop_scale, B, Tq, Tk, H, E, causal, diag_reset, scale);
  p.dk = dk;
  p.dv = dv;
  p.dt = dt;
  const int blocks = B * H * ((Tk + BK - 1) / BK);
  return (int)launch(kDkvtKernels, kDkvt, p, dh, dtype, blocks, static_cast<cudaStream_t>(stream));
}

// The intensity head's VJP, fp32 throughout: the row kernel, then the
// column kernel (it reads the row kernel's g_raw). g_wd, g_bd, g_w and g_sc
// must be zero on entry; g_raw is scratch (rows, E).
int mau_intensity_bwd(const void* su, const void* intervals, const void* wd, const void* bd,
                      const void* w, const void* scaling, const void* g_lam, void* g_raw,
                      void* g_su, void* g_wd, void* g_bd, void* g_w, void* g_sc, int B, int H,
                      int Tq, int dh, int E, void* stream) {
  if (B < 1 || H < 1 || Tq < 1 || E < 1) return (int)cudaErrorInvalidValue;
  IntBwdParams p;
  p.su = static_cast<const float*>(su);
  p.intervals = static_cast<const float*>(intervals);
  p.wd = static_cast<const float*>(wd);
  p.bd = static_cast<const float*>(bd);
  p.w = static_cast<const float*>(w);
  p.scaling = static_cast<const float*>(scaling);
  p.g_lam = static_cast<const float*>(g_lam);
  p.g_raw = static_cast<float*>(g_raw);
  p.g_su = static_cast<float*>(g_su);
  p.g_wd = static_cast<float*>(g_wd);
  p.g_bd = static_cast<float*>(g_bd);
  p.g_w = static_cast<float*>(g_w);
  p.g_sc = static_cast<float*>(g_sc);
  p.rows = B * H * Tq; p.H = H; p.Tq = Tq; p.E = E;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 rows_grid((p.rows + 63) / 64);
  const dim3 cols_grid((E * dh + 63) / 64, (p.rows + kRowChunk - 1) / kRowChunk);
  const size_t rb = smem_bytes(kIntRows, dh, E, 0), cb = smem_bytes(kIntCols, dh, E, 0);
  cudaError_t e;
  switch (dh) {
    case 16:
      e = go(mau_int_bwd_rows_kernel<16>, rows_grid, kThreads, rb, s, p);
      return (int)(e != cudaSuccess ? e : go(mau_int_bwd_cols_kernel<16>, cols_grid, kThreads, cb, s, p));
    case 32:
      e = go(mau_int_bwd_rows_kernel<32>, rows_grid, kThreads, rb, s, p);
      return (int)(e != cudaSuccess ? e : go(mau_int_bwd_cols_kernel<32>, cols_grid, kThreads, cb, s, p));
    case 64:
      e = go(mau_int_bwd_rows_kernel<64>, rows_grid, kThreads, rb, s, p);
      return (int)(e != cudaSuccess ? e : go(mau_int_bwd_cols_kernel<64>, cols_grid, kThreads, cb, s, p));
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"

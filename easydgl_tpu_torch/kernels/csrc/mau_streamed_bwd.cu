// Streamed MAU/BiMAU backward for Hopper (sm_90a): the two-pass custom VJP
// of the long-context schedule as four kernels (five launches).
//
// Replaces the TPU kernels of easydgl_tpu/kernels/mau_streamed.py:
//
//   mau_int_bwd_rows_tc_kernel, mau_int_bwd_cols_tc_kernel
//                   _int_bwd_kernel (pallas_call in _int_streamed_bwd, :274)
//   mau_glam_tc_kernel (bf16), mau_glam_kernel (fp32)
//                   _glam_kernel    (pallas_call in _mau_streamed_bwd, :692)
//   mau_dq_tc_kernel (bf16), mau_dq_kernel (fp32)
//                   _dq_kernel      (pallas_call in _mau_streamed_bwd, :739)
//   mau_dkvt_tc_kernel (bf16), mau_dkvt_kernel (fp32)
//                   _dkvt_kernel    (pallas_call in _mau_streamed_bwd, :768)
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
// the forward's key_tiles rule (mau_streamed.cuh); the bf16 glam and dkvt
// kernels visit, within it, only the pairs of the live-tile rule there (a
// key tile with no real key only where a row of the query tile sees no
// key), the query-major glam from the query tile's side, the key-major
// dkvt from the key tile's. The bf16 dq visits only the key tiles that hold
// a real key, blind query tile or not (the rule's visible-only form): its
// g_s is 0 wherever an entry is not visible, so a row that sees no key
// adds exactly 0 to dq.
//
// Design. The attention-side kernels come in two forms:
//
// * dq, bf16 (the main path; mau_dq_tc_kernel): glam's query-major
//   wgmma/TMA schedule, two consumer warpgroups of 64 queries and a
//   producer warp (setmaxnreg 24 / 240). Each warpgroup's Q, dO, g_su and
//   lam tiles stay resident; the visited key tiles' K, V, T and one-hot
//   come by TMA into a ring of two stages. Per key tile, on wgmma m64n64k16
//   with fp32 accumulators, the products in sequence to bound the live
//   accumulators: S = Q K^T, GT = g_su T^T and IQK = lam one-hot^T; then p
//   where the entry is visible (else 0, without a branch), xa = p (gt -
//   rho) and u = p keep iqk (BiMAU: iqk = 1 on the diagonal), after which S
//   is dead; then GM = dO V^T into S's registers; g_s = (u gm + xa) /
//   sqrt(dh), rounded to bf16 in the accumulators and fed back as the A
//   operand of dQ += G_s K (K MN-major). Live a thread: dq and three tile
//   accumulators (128 fp32) and g_s's 16 bf16 fragments. A block whose
//   queries see no key writes zeros. Shared memory at E = 64, T = 2048:
//   132,780 bytes.
// * glam, bf16 (the main path; mau_glam_tc_kernel): the output kernel's
//   query-major wgmma/TMA schedule (mau_streamed_fwd.cu, the machinery of
//   mau_streamed.cuh): a block owns 192 queries of one (b, h) at E <= 64,
//   three consumer warpgroups and a producer warp (setmaxnreg 24 / 160),
//   128 at E <= 128 (two warpgroups, 24 / 240). Each warpgroup's Q and dO
//   tiles stay resident; the visited key tiles' K, V and one-hot come by
//   TMA into a ring of two stages. Per key tile, on wgmma m64n64k16: S =
//   Q K^T and GM = dO V^T (both operands in shared memory), then g = gm p keep
//   without a branch (0 on BiMAU's diagonal), rounded to bf16 in the
//   accumulators and fed back as the A operand of G_lam += G one-hot (one-
//   hot MN-major). Registers a consumer thread: S, GM and g_lam 32 fp32
//   each at E = 64, g_lam 64 at E = 128 (hence two warpgroups there), the
//   16 bf16 fragments of G; ptxas: 44 bytes spilled at E = 64, none at
//   128. Shared memory at T = 2048: 100,012 bytes at E = 64 and 128.
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
// * glam, dq (fp32): one block per 64 queries of one (b, h), looping over
//   key tiles; q and dO (dq: also g_su, lam) stay resident.
// * dkvt, fp32 (mau_dkvt_kernel): one block per 64 keys of one (b, h),
//   looping over query tiles; dk, dv and dt accumulate in registers.
// * dkvt, bf16 (mau_dkvt_tc_kernel), on flash_bwd_tc_kernel's pattern
//   (flash_attention.cu): key-major, a block owns 128 keys of one (b, h),
//   two consumer warpgroups of 64 keys and a producer warp (its warpgroup
//   hands its registers over by setmaxnreg, 24 / 240). The block's K, V, T
//   and one-hot tiles stay resident; each query tile's Q, dO, g_su and lam
//   tiles come by TMA (128-byte swizzle) into a two-stage ring under full
//   and empty mbarriers, its m, l and rho rows by the producer warp's
//   plain loads, as flash's lse and delta. The block visits only the query
//   tiles whose pairs with its key tiles the live-tile rule of
//   mau_streamed.cuh keeps; a block with nothing to visit writes zeros. Per (query
//   tile, key tile), on wgmma m64n64k16 with fp32 accumulators: S^T = K Q^T
//   and G^T = T g_su^T (both operands in shared memory); p and p (g_su . t
//   - rho) without a branch (a hidden entry's exponent is NEG, so p = 0
//   unless the row sees no key); dT += rnd(p)^T g_su (A: p from the
//   accumulators); iqk^T = one-hot lam^T; u = iqk p keep with one Philox
//   draw an entry under dropout; dV += rnd(u)^T dO; gm^T = V dO^T; g_s =
//   (u gm + p (g_su . t - rho)) / sqrt(dh) where visible; dK += rnd(g_s)^T Q.
//   dk, dv and dt stay in registers (96 fp32 a thread, ~208 at the peak).
//   The wrapper zero-pads heads to 64 channels and lam / one-hot to 64
//   events. Shared memory at dh = 64, E = 64: 64 KB resident (two
//   warpgroups' K, V, T, one-hot tiles of 8 KB), 2 x 32 KB of query stages,
//   1.5 KB of stats, the plan, 1 KB of alignment slack: 133,804 bytes at
//   T = 2048.
// * intensity: the parameter gradients are sums over B*H*Tq rows, the
//   d(seq_units) a sum over E*dh columns, so two kernels, one warpgroup
//   each. Every product runs on wgmma m64n64k16 in three bf16 products of
//   a hi/lo split of its fp32 operands (hi = bf16(x), lo = bf16(x - hi);
//   lo hi + hi lo + hi hi, summed in fp32: about 2^-16 of |a||b| a term,
//   where one TF32 pass keeps 2^-11; the TPU kernel is fp32), over the dh
//   seq_units lanes; the interval lane's terms are fp32 FMAs on the CUDA
//   cores. The row kernel (64 rows a block, looping over 64-column tiles,
//   each one to four whole events) keeps its rows' seq_units as hi/lo A
//   fragments in registers, splits each Wd tile into two swizzled bf16
//   tiles, forms z = x Wd_tile (B MN-major), then sig, raw, g_raw and g_z
//   in the accumulators, and accumulates g_x = g_z Wd_tile^T (A: g_z's
//   accumulators split; B: the same tiles, K-major); it stores g_raw
//   (rows, E) and adds gscaling by one atomic per event and block. The
//   column kernel (64 columns x 2048 rows a block) keeps its columns of Wd
//   as A fragments, splits each 64-row sub-tile of x into two swizzled
//   tiles, forms z^T = Wd_tile^T x^T (B K-major), g_z^T from g_raw, gw,
//   gbd and the interval lane's gWd in registers, and gWd^T += g_z^T x (B
//   MN-major); one atomic per entry and block: ~17 M at the EasyDGL-LC
//   train shape, not one per row. z is formed twice (JAX's kernel: once),
//   for 4 products of rows x dh x E*dh instead of 3; g_x skips the
//   interval lane, whose gradient is dropped. Each kernel copies its next
//   tile into one of two fp32 buffers by cp.async while it works on the
//   current one. Shared memory at dh = 64, E = 64: 51,968 bytes (rows) and
//   52,736 (columns): the hi/lo tiles, the two buffers, 1 KB of alignment
//   slack. ptxas at dh = 64: rows 128 registers (its bound of four blocks
//   an SM; 12 bytes spilled), columns 168, no spill.
//
// What bounds it, at the EasyDGL-LC train shape (B=8, H=8, T=2048, dh=64,
// E=64, BiMAU): operations. Over every (query, key) pair glam forms 3
// products of 34.36 GFLOP each, dq 5, dkvt 7 (bf16 tensor-core bounds 0.104,
// 0.174 and 0.243 ms); chip_smoke.py's bounds, which PERF.md's table
// gives, count only the pairs the key mask leaves visible (mau_keys; dkvt
// 0.1072 ms at phase 4d's inputs). The intensity
// VJP's three products of 131,072 x 65 x 4,096 (~209 GFLOP with the
// elementwise terms) would take 3.1 ms in fp32 on the CUDA cores (67
// TFLOP/s); in three bf16 passes each at 989 TFLOP/s they take 0.64 ms,
// its bound here. The two kernels form z twice (4 products x 3 passes) and
// run the sigmoids of 537 M entries twice.
//
// Limits: dh in {16, 32, 64}; E up to 128 within the shared memory of
// mau_streamed_bwd_smem_bytes (227 KB).

#include <type_traits>

#include "hopper.cuh"
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
  int stages;             // ring stages of mau_glam_tc_kernel
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
// The intensity kernels: two (64 x 64) bf16 tiles (hi, lo), 1,024 bytes of
// alignment slack and two fp32 buffers of their next tile: the row kernel's
// Wd tile with its interval lane, bd and w, and gscaling; the column
// kernel's x sub-tile with its intervals and g_raw.
__host__ __device__ inline int int_rows_smem_floats(int dh, int E) {
  return 2 * 64 * 64 / 2 + 256 + 2 * (dh * 64 + 192) + E;
}
__host__ __device__ inline int int_cols_smem_floats(int dh) {
  return 2 * 64 * 64 / 2 + 256 + 2 * (64 * dh + 64 + 256);
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

// ---------------------------------------------------------------- dkvt, bf16
// wgmma and TMA (see the header): warpgroups 0 and 1 consume, one 64-key
// tile each; the first warp of warpgroup 2 produces.

constexpr int kKvStages = 2;
constexpr int kKvGroups = 2;                        // consumer warpgroups, 64 keys each
constexpr int kKvKeys = 64 * kKvGroups;             // keys a block
constexpr int kKvThreads = 128 * (kKvGroups + 1);   // and a producer warpgroup
// Registers a thread after setmaxnreg: a consumer thread holds dk, dv and dt
// (96 fp32) and up to three (64 x 64) tile accumulators and a set of bf16
// fragments (~208 at the peak); 24 + 2 x 240 of a warpgroup thread fit the
// 65,536 of an SM.
constexpr int kKvProducerRegs = 24, kKvConsumerRegs = 240;
constexpr int kTile = 64 * 64;                      // bf16 values of a (64 x 64) tile, 8 KB

// Dynamic shared memory of mau_dkvt_tc_kernel with the one-hot and lam
// `ept` 64-event tiles wide: per consumer warpgroup its K, V, T and one-hot
// tiles; per stage a Q, dO, g_su and lam tile set and the m, l, rho rows;
// the mbarriers; 1 KB of slack to align the tiles to 1024 bytes.
__host__ __device__ inline size_t dkvt_tc_smem_bytes(int ept, int Tk) {
  return 1024 + sizeof(bf16) * kTile * (size_t)(kKvGroups + kKvStages) * (3 + ept) +
         sizeof(float) * kKvStages * 3 * BQ + 8 * (1 + 2 * kKvStages) + plan_bytes(Tk);
}

struct DkvtMaps {
  CUtensorMap q, dout, gsu, lam;  // (64 or EPP columns, Tq, H, B), boxes of 64 rows x 64
  CUtensorMap k, v, t, onehot;    // (64 or EPP columns, Tk, H or 1, B)
};

__global__ void __launch_bounds__(kKvThreads, 1)
    mau_dkvt_tc_kernel(const BwdParams p, const __grid_constant__ DkvtMaps maps) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* base = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const int ept = p.EP / 64, set = 3 + ept;  // tiles of a key or query set
  bf16* res = reinterpret_cast<bf16*>(base);  // [group][K, V, T, one-hot..][64 keys][64]
  bf16* stg = res + kKvGroups * set * kTile;  // [stage][Q, dO, g_su, lam..][64 queries][64]
  float* stats = reinterpret_cast<float*>(stg + kKvStages * set * kTile);  // [stage][m, l, rho][64]
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(stats + kKvStages * 3 * BQ);
  uint64_t* full = kv_full + 1;      // [stage]
  uint64_t* empty = full + kKvStages;  // [stage]
  int* plan = reinterpret_cast<int*>(empty + kKvStages);  // key_plan of the batch row
  // heaviest first: under causal key block 0 sees every query tile
  const int nqt = (p.Tq + BQ - 1) / BQ, BH = p.B * p.H;
  const int kb = blockIdx.x / BH, bh = blockIdx.x - kb * BH, k0 = kb * kKvKeys;
  const int b = bh / p.H, h = bh - b * p.H;
  const int lane = threadIdx.x & 31;
  int warp = threadIdx.x >> 5;  // within its warpgroup, for the consumers
  const float* km_row = p.key_mask + (size_t)b * p.Tk;
  key_plan(km_row, p.Tk, plan);  // ends with a barrier
  const TileRule rule = tile_rule(plan, p.Tk);
  // the codes of the block's two key tiles, -1 past the last
  const int kt0 = kb * kKvGroups, nkt = key_tile_count(p.Tk);
  const int code0 = kt0 < nkt ? plan[kt0] : -1, code1 = kt0 + 1 < nkt ? plan[kt0 + 1] : -1;
  // Whether query tile qt visits the key tile of warpgroup w (the rule of
  // mau_streamed.cuh, from the key tile's side)
  auto visits = [&](int qt, int w) {
    const int code = w ? code1 : code0;
    return code >= 0 && rule.visits_code(p, kt0 + w, code, qt * BQ);
  };
  auto next = [&](int qt) {  // the first query tile from qt on that the block visits
    while (qt < nqt && !visits(qt, 0) && !visits(qt, 1)) ++qt;
    return qt;
  };
  const int C = p.H * 64;
  const size_t kbase = (size_t)b * p.Tk * C + (size_t)h * 64;
  bf16* dkg = static_cast<bf16*>(p.dk) + kbase;
  bf16* dvg = static_cast<bf16*>(p.dv) + kbase;
  bf16* dtg = static_cast<bf16*>(p.dt) + kbase;
  const int qt_first = next(0);
  if (qt_first >= nqt) {  // no query reaches these keys: dk = dv = dt = 0
    const __nv_bfloat162 z2 = __floats2bfloat162_rn(0.f, 0.f);
    for (int e = threadIdx.x; e < kKvKeys * 32; e += blockDim.x) {
      const int r = k0 + e / 32, c = 2 * (e % 32);
      if (r >= p.Tk) break;
      const size_t o = (size_t)r * C + c;
      *reinterpret_cast<__nv_bfloat162*>(dkg + o) = z2;
      *reinterpret_cast<__nv_bfloat162*>(dvg + o) = z2;
      *reinterpret_cast<__nv_bfloat162*>(dtg + o) = z2;
    }
    return;
  }
  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < kKvStages; ++s) {
      mbar_init(full + s, 32);
      mbar_init(empty + s, 128 * kKvGroups);
    }
    mbar_fence_init();
  }
  __syncthreads();
  const size_t row0 = (size_t)bh * p.Tq;

  if (warp >= 4 * kKvGroups) {  // ---- producer: its first warp works
    regs_dec<kKvProducerRegs>();
    if (warp > 4 * kKvGroups) return;
    if (lane == 0) {
      mbar_arrive_tx(kv_full, kKvGroups * set * kTile * sizeof(bf16));
      for (int w = 0; w < kKvGroups; ++w) {
        bf16* r = res + w * set * kTile;
        const int j0 = k0 + 64 * w;
        tma_rows(r, &maps.k, kv_full, j0, h, b);
        tma_rows(r + kTile, &maps.v, kv_full, j0, h, b);
        tma_rows(r + 2 * kTile, &maps.t, kv_full, j0, h, b);
        for (int c = 0; c < ept; ++c)
          tma_rows(r + (3 + c) * kTile, &maps.onehot, kv_full, j0, 0, b, 64 * c);
      }
    }
    int it = 0;
    for (int qt = qt_first; qt < nqt; qt = next(qt + 1), ++it) {
      const int s = it % kKvStages, q0 = qt * BQ;
      mbar_wait(empty + s, ((it / kKvStages) & 1) ^ 1);
      float* st = stats + s * 3 * BQ;
      for (int r = lane; r < BQ; r += 32) {
        const bool ok = q0 + r < p.Tq;
        st[r] = ok ? p.m[row0 + q0 + r] : 0.f;
        st[BQ + r] = ok ? p.l[row0 + q0 + r] : 1.f;
        st[2 * BQ + r] = ok ? p.rho[row0 + q0 + r] : 0.f;
      }
      if (lane == 0) {
        bf16* gs = stg + s * set * kTile;
        mbar_arrive_tx(full + s, set * kTile * sizeof(bf16));
        tma_rows(gs, &maps.q, full + s, q0, h, b);
        tma_rows(gs + kTile, &maps.dout, full + s, q0, h, b);
        tma_rows(gs + 2 * kTile, &maps.gsu, full + s, q0, h, b);
        for (int c = 0; c < ept; ++c)
          tma_rows(gs + (3 + c) * kTile, &maps.lam, full + s, q0, h, b, 64 * c);
      } else {
        mbar_arrive(full + s);
      }
    }
    return;
  }

  // ---- consumers: warpgroup wg owns keys kw = k0 + 64 wg ..; thread
  // (warp, g, t4) holds keys kw + 16 warp + g (+8) and, of a query tile,
  // queries 8 n + 2 t4 (+1): entry (key hr, query n, c) at d[4 n + 2 hr + c]
  regs_inc<kKvConsumerRegs>();
  const int wg = warp >> 2, kw = k0 + 64 * wg;
  warp &= 3;
  const int g = lane >> 2, t4 = lane & 3;
  float kmr[2];  // 1 real, 0 masked, -1 past Tk
  int jk[2];
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    jk[hr] = kw + 16 * warp + g + 8 * hr;
    kmr[hr] = key_flag(km_row, jk[hr], p.Tk);
  }
  const Dropout drop = make_dropout(p.seed, p.drop_thresh, p.drop_scale);
  const bf16* rw = res + wg * set * kTile;
  const uint64_t kd = sw128_desc(rw), vd = sw128_desc(rw + kTile), td = sw128_desc(rw + 2 * kTile),
                 od = sw128_desc(rw + 3 * kTile);
  float dk[32], dv[32], dt[32];
  zero32(dk);
  zero32(dv);
  zero32(dt);
  mbar_wait(kv_full, 0);

  int it = 0;
  for (int qt = qt_first; qt < nqt; qt = next(qt + 1), ++it) {
    const int s = it % kKvStages, q0 = qt * BQ;
    mbar_wait(full + s, (it / kKvStages) & 1);
    if (!visits(qt, wg)) {  // the other warpgroup's tile
      mbar_arrive(empty + s);
      continue;
    }
    const bf16* gs = stg + s * set * kTile;
    const uint64_t qd = sw128_desc(gs), dd = sw128_desc(gs + kTile), gd = sw128_desc(gs + 2 * kTile),
                   ld = sw128_desc(gs + 3 * kTile);
    const float* st = stats + s * 3 * BQ;
    float sa[32], xa[32], ia[32];
    zero32(sa);
    zero32(xa);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_ss<0, 0>(sa, kd + 2 * kk, qd + 2 * kk, 1);  // K Q^T
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_ss<0, 0>(xa, td + 2 * kk, gd + 2 * kk, 1);  // T g_su^T
    wg_commit();
    wg_wait();
    reg_fence(sa);
    reg_fence(xa);

    // p = exp(s - m) / l without a branch (0 for padding keys and rows past
    // Tq; a masked key's logit is NEG, which a row that sees no key has for
    // its max as well); xa := p (g_su . t - rho)
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int il = 8 * n + 2 * t4 + c, i = q0 + il;
        const float mi = st[il], rl = 1.f / st[BQ + il], ri = st[2 * BQ + il];
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          const int x = 4 * n + 2 * hr + c;
          const bool shown = kmr[hr] > 0.f && !(p.causal && jk[hr] > i);
          const float lg = shown ? sa[x] * p.scale : kNeg;
          const float pr = (kmr[hr] >= 0.f && i < p.Tq) ? fast_exp2((lg - mi) * kLog2e) * rl : 0.f;
          xa[x] = shown ? pr * (xa[x] - ri) : 0.f;
          sa[x] = pr;
        }
      }
    uint32_t f[16];
    a_frags(f, sa);  // rnd(p)
    zero32(ia);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_rs(dt, f + 4 * kk, gd + 128 * kk);  // dT += P^T g_su
#pragma unroll
    for (int c = 0; c < ept; ++c)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_ss<0, 0>(ia, od + 512 * c + 2 * kk, ld + 512 * c + 2 * kk, 1);  // one-hot lam^T
    wg_commit();
    wg_wait();
    reg_fence(dt);
    reg_fence(ia);

    // the modulated probs u = iqk p keep (BiMAU: iqk = 1 on the diagonal);
    // ia := u where the entry is visible, else 0
    auto modulate = [&](auto dropped) {
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int i = q0 + 8 * n + 2 * t4 + c;
#pragma unroll
          for (int hr = 0; hr < 2; ++hr) {
            const int x = 4 * n + 2 * hr + c;
            const float iqv = (p.diag_reset && i == jk[hr]) ? 1.f : ia[x];
            float u = iqv * sa[x];
            if constexpr (decltype(dropped)::value) u *= drop.factor(b, h, i, jk[hr]);
            sa[x] = u;
            const bool shown = kmr[hr] > 0.f && !(p.causal && jk[hr] > i) && i < p.Tq;
            ia[x] = shown ? u : 0.f;
          }
        }
    };
    if (drop.on)
      modulate(std::true_type());
    else
      modulate(std::false_type());
    a_frags(f, sa);  // rnd(u)
    zero32(sa);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_rs(dv, f + 4 * kk, dd + 128 * kk);  // dV += U^T dO
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_ss<0, 0>(sa, vd + 2 * kk, dd + 2 * kk, 1);  // V dO^T
    wg_commit();
    wg_wait();
    reg_fence(dv);
    reg_fence(sa);

    // g_s = p (g_mod keep iqk + g_su . t - rho) / sqrt(dh) where visible:
    // u g_mod + xa, both already 0 elsewhere
#pragma unroll
    for (int x = 0; x < 32; ++x) sa[x] = fmaf(ia[x], sa[x], xa[x]) * p.scale;
    a_frags(f, sa);  // rnd(g_s)
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_rs(dk, f + 4 * kk, qd + 128 * kk);  // dK += G_s^T Q
    wg_commit();
    wg_wait();
    reg_fence(dk);
    mbar_arrive(empty + s);  // the stage's tiles and stats are free
  }
  const int r0 = kw + 16 * warp;
  store_acc_bf16(dkg, C, dk, r0, p.Tk, lane);
  store_acc_bf16(dvg, C, dv, r0, p.Tk, lane);
  store_acc_bf16(dtg, C, dt, r0, p.Tk, lane);
}

// ---------------------------------------------------------------- d-lambda,
// bf16 on wgmma and TMA (see the header): G consumer warpgroups of 64
// queries; q, k, v and dout 64 channels a head (the wrapper zero-pads
// narrower ones), the one-hot EPT 64-event tiles wide, bf16.

// The d-lambda kernel's warpgroups: three at one event tile (its g_lam
// accumulator, S, GM and the bf16 fragments of G: ~112 fp32 a thread in
// 160 registers), two at two (g_lam 64 fp32: 240).
__host__ __device__ constexpr int glam_groups(int ept) { return ept == 1 ? 3 : 2; }

__host__ __device__ inline size_t glam_tc_smem_bytes(int ept, int Tk) {
  return qm_smem_bytes(glam_groups(ept), 2, kQmStages, 2 + ept, Tk);
}

template <int EPT>
__global__ void __launch_bounds__(128 * (glam_groups(EPT) + 1), 1)
    mau_glam_tc_kernel(const BwdParams p, const __grid_constant__ QmMaps maps) {
  constexpr int G = glam_groups(EPT), kQueries = 64 * G, RT = 2, STN = 2 + EPT;
  const int S = p.stages;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* base = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  bf16* res = reinterpret_cast<bf16*>(base);  // [group][Q, dO][64 queries][64]
  bf16* ring = res + G * RT * kQmTile;         // [stage][K, V, one-hot EPT][64 keys][64]
  float* kms = reinterpret_cast<float*>(ring + S * STN * kQmTile);  // [stage][64] key mask
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
    regs_dec<kQmProducerRegs>();
    if (warp == 4 * G)
      qm_produce(p, blk, maps, S, res, ring, kms, res_full, full, empty, lane);
    return;
  }

  // ---- consumers: warpgroup wg owns queries qw = q0 + 64 wg ..; thread
  // (warp, g, t4) holds queries i0 = qw + 16 warp + g (+8) and, of a key
  // tile, keys 8 n + 2 t4 (+1): entry (query hr, key n, c) at x[4 n + 2 hr + c]
  regs_inc<qm_consumer_regs(G)>();
  const int wg = warp >> 2, qw = q0 + 64 * wg;
  warp &= 3;
  const int g = lane >> 2, t4 = lane & 3, i0 = qw + 16 * warp + g;
  const size_t row0 = (size_t)bh * p.Tq;
  const RowStats rs = row_stats(p.m, p.l, row0, i0, p.Tq);
  const Dropout drop = make_dropout(p.seed, p.drop_thresh, p.drop_scale);
  const float sl2 = p.scale * kLog2e;
  const bf16* rw = res + wg * RT * kQmTile;
  const uint64_t qd = sw128_desc(rw), dd = sw128_desc(rw + kQmTile);
  float gl[EPT][32];
#pragma unroll
  for (int c = 0; c < EPT; ++c) zero32(gl[c]);
  mbar_wait(res_full, 0);

  int it = 0;
  for (int kt = blk.next(p, 0); kt < nkt; kt = blk.next(p, kt + 1), ++it) {
    const int s = it % S;
    mbar_wait(full + s, (it / S) & 1);
    if (!blk.wg_visits(p, kt, wg)) {  // another warpgroup's tile
      mbar_arrive(empty + s);
      continue;
    }
    const bf16* st = ring + s * STN * kQmTile;
    const uint64_t kd = sw128_desc(st), vd = sw128_desc(st + kQmTile),
                   od = sw128_desc(st + 2 * kQmTile);
    float sa[32], ga[32];
    zero32(sa);
    zero32(ga);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_ss<0, 0>(sa, qd + 2 * kk, kd + 2 * kk, 1);  // S = Q K^T
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_ss<0, 0>(ga, dd + 2 * kk, vd + 2 * kk, 1);  // GM = dO V^T
    wg_commit();
    wg_wait();
    reg_fence(sa);
    reg_fence(ga);

    // g = gm p keep, 0 on BiMAU's diagonal (iqk is the constant 1 there),
    // p without a branch; `tested` as in mau_out_tc_kernel
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
            float u = (tested && diag && i == j) ? 0.f : ga[x] * pr;
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
    uint32_t f[16];
    a_frags(f, sa);  // rnd(g)
    wg_fence();
#pragma unroll
    for (int c = 0; c < EPT; ++c)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_rs(gl[c], f + 4 * kk, od + 512 * c + 128 * kk);  // G_lam += G one-hot
    wg_commit();
    wg_wait();
#pragma unroll
    for (int c = 0; c < EPT; ++c) reg_fence(gl[c]);
    mbar_arrive(empty + s);  // the stage's K, V, one-hot and mask are free
  }

  // g_lam (B, H, Tq, E) fp32: the thread's rows, events 64 c + 8 n + 2 t4 (+1)
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int i = i0 + 8 * hr;
    if (i >= p.Tq) continue;
    float* dst = p.glam + (row0 + i) * p.E;
#pragma unroll
    for (int c = 0; c < EPT; ++c)
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int cc = 0; cc < 2; ++cc) {
          const int e = 64 * c + 8 * n + 2 * t4 + cc;
          if (e < p.E) dst[e] = gl[c][4 * n + 2 * hr + cc];
        }
  }
}

// ---------------------------------------------------------------- dq, bf16
// on wgmma and TMA (see the header): two consumer warpgroups of 64
// queries; q, k, v, t, dout and g_su 64 channels a head (the wrapper
// zero-pads narrower ones), lam and the one-hot EPT 64-event tiles wide,
// bf16.

// dq's warpgroups: two (dq and three tile accumulators live, 128 fp32 a
// thread, and the bf16 fragments of g_s: 240 registers).
constexpr int kDqGroups = 2;

__host__ __device__ inline size_t dq_tc_smem_bytes(int ept, int Tk) {
  return qm_smem_bytes(kDqGroups, 3 + ept, kQmStages, 3 + ept, Tk);
}

template <int EPT>
__global__ void __launch_bounds__(128 * (kDqGroups + 1), 1)
    mau_dq_tc_kernel(const BwdParams p, const __grid_constant__ QmMaps maps) {
  constexpr int G = kDqGroups, kQueries = 64 * G, RT = 3 + EPT, STN = 3 + EPT, S = kQmStages;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* base = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  bf16* res = reinterpret_cast<bf16*>(base);  // [group][Q, dO, g_su, lam EPT][64 queries][64]
  bf16* ring = res + G * RT * kQmTile;         // [stage][K, V, T, one-hot EPT][64 keys][64]
  float* kms = reinterpret_cast<float*>(ring + S * STN * kQmTile);  // [stage][64] key mask
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
  // the visible-only rule: g_s is 0 wherever an entry is not visible
  const QmBlock<G> blk{tile_rule(plan, p.Tk), b, h, q0, true};
  const int nkt = key_tile_count(p.Tk), C = p.H * 64;
  bf16* dqg = static_cast<bf16*>(p.dq) + (size_t)b * p.Tq * C + (size_t)h * 64;
  if (blk.next(p, 0) >= nkt) {  // no query of the block sees a key: dq = 0
    const __nv_bfloat162 z2 = __floats2bfloat162_rn(0.f, 0.f);
    for (int e = threadIdx.x; e < kQueries * 32; e += blockDim.x) {
      const int r = q0 + e / 32;
      if (r >= p.Tq) break;
      *reinterpret_cast<__nv_bfloat162*>(dqg + (size_t)r * C + 2 * (e % 32)) = z2;
    }
    return;
  }

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
  const size_t row0 = (size_t)bh * p.Tq;
  const RowStats rs = row_stats(p.m, p.l, row0, i0, p.Tq);
  float rho[2];
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) rho[hr] = i0 + 8 * hr < p.Tq ? p.rho[row0 + i0 + 8 * hr] : 0.f;
  const Dropout drop = make_dropout(p.seed, p.drop_thresh, p.drop_scale);
  const float sl2 = p.scale * kLog2e;
  const bf16* rw = res + wg * RT * kQmTile;
  const uint64_t qd = sw128_desc(rw), dd = sw128_desc(rw + kQmTile),
                 gd = sw128_desc(rw + 2 * kQmTile), ld = sw128_desc(rw + 3 * kQmTile);
  float dq[32];
  zero32(dq);
  mbar_wait(res_full, 0);

  int it = 0;
  for (int kt = blk.next(p, 0); kt < nkt; kt = blk.next(p, kt + 1), ++it) {
    const int s = it % S;
    mbar_wait(full + s, (it / S) & 1);
    if (!blk.wg_visits(p, kt, wg)) {  // another warpgroup's tile
      mbar_arrive(empty + s);
      continue;
    }
    const bf16* st = ring + s * STN * kQmTile;
    const uint64_t kd = sw128_desc(st), vd = sw128_desc(st + kQmTile),
                   td = sw128_desc(st + 2 * kQmTile), od = sw128_desc(st + 3 * kQmTile);
    float sa[32], xa[32], ia[32];
    zero32(sa);
    zero32(xa);
    zero32(ia);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_ss<0, 0>(sa, qd + 2 * kk, kd + 2 * kk, 1);  // S, for p
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_ss<0, 0>(xa, gd + 2 * kk, td + 2 * kk, 1);  // GT = g_su T^T
    for (int c = 0; c < EPT; ++c)  // IQK = lam one-hot^T, events the reduction
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_ss<0, 0>(ia, ld + 512 * c + 2 * kk, od + 512 * c + 2 * kk, 1);
    wg_commit();
    wg_wait();
    reg_fence(sa);
    reg_fence(xa);
    reg_fence(ia);

    // p where the entry is visible, else 0 (so a row that sees no key adds
    // nothing); xa := p (gt - rho); ia := u = p keep iqk (BiMAU: iqk = 1 on
    // the diagonal); `tested` as in mau_out_tc_kernel
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
            const float pr = entry_visible(tested, km, i, j, p.causal)
                                 ? fast_exp2(fmaf(sa[x], sl2, -rs.m2[hr])) * rs.rl[hr]
                                 : 0.f;
            xa[x] = pr * (xa[x] - rho[hr]);
            const float iq = (tested && diag && i == j) ? 1.f : ia[x];
            float u = iq * pr;
            if constexpr (decltype(dropped)::value) u *= drop.factor(b, h, i, j);  // gm's keep
            ia[x] = u;
          }
        }
    };
    if (drop.on)  // the Philox draw costs more than the tests
      form(slow, std::true_type());
    else if (!slow)
      form(std::false_type(), std::false_type());
    else
      form(std::true_type(), std::false_type());
    zero32(sa);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_ss<0, 0>(sa, dd + 2 * kk, vd + 2 * kk, 1);  // GM = dO V^T
    wg_commit();
    wg_wait();
    reg_fence(sa);

    // g_s = p (gm keep iqk + gt - rho) / sqrt(dh) = (u gm + xa) / sqrt(dh),
    // rounded to bf16 as the A operand of dQ += G_s K (K MN-major)
#pragma unroll
    for (int x = 0; x < 32; ++x) sa[x] = fmaf(ia[x], sa[x], xa[x]) * p.scale;
    uint32_t f[16];
    a_frags(f, sa);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_rs(dq, f + 4 * kk, kd + 128 * kk);
    wg_commit();
    wg_wait();
    reg_fence(dq);
    mbar_arrive(empty + s);  // the stage's K, V, T, one-hot and mask are free
  }
  store_acc_bf16(dqg, C, dq, qw + 16 * warp, p.Tq, lane);
}

// ---------------------------------------------------------------- intensity
// Both kernels: one warpgroup a block; every product on wgmma m64n64k16
// (A from registers, B from shared memory in the 128-byte swizzle) in
// three bf16 products of a hi/lo split (split_bf16x2): lo hi + hi lo +
// hi hi. The products run over the dh seq_units lanes (padded to 64 with
// zeros); the interval lane's terms are fp32 FMAs on the CUDA cores.

constexpr int kIntThreads = 128;
constexpr int kIntTile = 64 * 64;  // a (64 x 64) bf16 tile, 8 KB

// Element offset of (row r, column col) in a (64 x 64) bf16 tile stored in
// the 128-byte swizzle: rows of 128 bytes, 16-byte chunk (col / 8) ^ (r % 8).
__device__ __forceinline__ int sw128_at(int r, int col) {
  return r * 64 + ((((col >> 3) ^ (r & 7)) << 3) | (col & 7));
}

// v (four fp32 values at row r, columns col .. col + 3; col % 4 == 0) into
// the hi and lo tiles.
__device__ __forceinline__ void store_split4(bf16* hi, bf16* lo, int r, int col, float4 v) {
  uint32_t h0, l0, h1, l1;
  split_bf16x2(v.x, v.y, h0, l0);
  split_bf16x2(v.z, v.w, h1, l1);
  const int o = sw128_at(r, col);
  *reinterpret_cast<uint2*>(hi + o) = make_uint2(h0, h1);
  *reinterpret_cast<uint2*>(lo + o) = make_uint2(l0, l1);
}

// The index in intervals (B, Tq) of row (b, h, i) of the (B*H*Tq) rows.
__device__ __forceinline__ size_t interval_index(const IntBwdParams& p, int row) {
  return (size_t)(row / (p.Tq * p.H)) * p.Tq + row % p.Tq;
}

// The row kernel: 64 rows a block (16 a warp), looping over 64-column tiles
// of Wd (one to four whole events). Per tile: z = x Wd_tile (A: the rows'
// seq_units lanes, hi/lo fragments in registers for the whole loop; B: the
// tile's lanes split into hi/lo tiles, MN-major) plus iv Wd[dh] and bd in
// fp32, then sig, raw, g_raw and g_z in the accumulators (raw: the thread's
// columns of an event, then the quad); then g_x += g_z Wd_tile^T (A: g_z's
// accumulators split into hi/lo fragments; B: the same tiles, K-major).
// Stores g_raw (rows, E) and g_su, adds gscaling by one atomic per event
// and block. Thread (warp, g, t4) holds rows 16 warp + g (+8) and, of a
// tile, columns 8 n + 2 t4 (+1) at z[4 n + 2 hr + c]. Four blocks an SM
// (at most 128 registers a thread) measured faster than three; the column
// kernel measured slower so.
template <int DH>
__global__ void __launch_bounds__(kIntThreads, 4)
    mau_int_bwd_rows_tc_kernel(const IntBwdParams p) {
  constexpr int KK = DH / 16, EPT = 64 / DH;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* base = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  bf16* whi = reinterpret_cast<bf16*>(base);  // [64 lanes][64 columns] Wd tile, hi
  bf16* wlo = whi + kIntTile;                 // lo
  // [2][DH lanes][64 columns] the raw tiles and [2][3][64] their interval
  // lane, bd and w, filled a tile ahead by cp.async
  float* wraw = reinterpret_cast<float*>(wlo + kIntTile);
  float* side = wraw + 2 * DH * 64;
  float* gsc = side + 2 * 192;                // [E] gscaling of the block
  const int E = p.E, edh = E * DH;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int r0 = blockIdx.x * 64 + 16 * warp;  // the warp's first row
  for (int e = tid; e < E; e += kIntThreads) gsc[e] = 0.f;
  // lanes dh .. 63 of the hi/lo tiles stay zero
  for (int idx = DH * 16 + tid; idx < 64 * 16; idx += kIntThreads)
    store_split4(whi, wlo, idx >> 4, (idx & 15) * 4, make_float4(0.f, 0.f, 0.f, 0.f));
  auto fetch = [&](int n0, int b) {  // tile n0 into buffer b
    float* dst = wraw + b * DH * 64;
    for (int idx = tid; idx < DH * 16; idx += kIntThreads) {
      const int c = idx >> 4, q = (idx & 15) * 4;
      const bool ok = n0 + q < edh;
      cp_async16(dst + c * 64 + q, p.wd + (size_t)c * edh + (ok ? n0 + q : 0), ok);
    }
    for (int idx = tid; idx < 48; idx += kIntThreads) {
      const int which = idx >> 4, q = (idx & 15) * 4;
      const bool ok = n0 + q < edh;
      const float* src = which == 0 ? p.wd + (size_t)DH * edh : which == 1 ? p.bd : p.w;
      cp_async16(side + b * 192 + which * 64 + q, src + (ok ? n0 + q : 0), ok);
    }
    cp_async_commit();
  };
  fetch(0, 0);

  // the rows' seq_units as A fragments: k step kk, entry i at row
  // r0 + g + 8 (i & 1), lanes 16 kk + 8 (i >> 1) + 2 t4 (+1)
  uint32_t xh[KK][4], xl[KK][4];
  float iv[2];
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int row = r0 + g + 8 * hr;
    iv[hr] = row < p.rows ? p.intervals[interval_index(p, row)] : 0.f;
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
  const uint64_t dwh = sw128_desc(whi), dwl = sw128_desc(wlo);
  float gx[32];  // g_x at (row, lane 8 n + 2 t4 + c), n < DH / 8
#pragma unroll
  for (int i = 0; i < 32; ++i) gx[i] = 0.f;

  for (int n0 = 0, t = 0; n0 < edh; n0 += 64, ++t) {
    cp_async_wait_all();
    __syncthreads();  // tile t has landed, tile t - 1 is consumed
    if (n0 + 64 < edh) fetch(n0 + 64, (t + 1) & 1);
    const float* rt = wraw + (t & 1) * DH * 64;
    for (int idx = tid; idx < DH * 16; idx += kIntThreads) {
      const int c = idx >> 4, q = (idx & 15) * 4;
      store_split4(whi, wlo, c, q, *reinterpret_cast<const float4*>(rt + c * 64 + q));
    }
    const float* wiv = side + (t & 1) * 192;  // the interval lane, then bd, w
    const float* bdw = wiv + 64;
    fence_async_smem();
    __syncthreads();

    float z[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) z[i] = 0.f;
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < KK; ++kk)
      wgmma_rs_x3<1>(z, xh[kk], xl[kk], dwh + 128 * kk, dwl + 128 * kk);
    wg_commit();
    wg_wait();
    reg_fence(z);

    // sig in place; raw of (row, event): column 8 n + .. is in event 8 n / DH
    float raw[2][EPT];
#pragma unroll
    for (int hr = 0; hr < 2; ++hr)
#pragma unroll
      for (int el = 0; el < EPT; ++el) raw[hr][el] = 0.f;
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int hr = 0; hr < 2; ++hr)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int col = 8 * n + 2 * t4 + c;
          float& x = z[4 * n + 2 * hr + c];
          x = sigmoid(fmaf(iv[hr], wiv[col], x + bdw[col]));
          raw[hr][8 * n / DH] = fmaf(x, bdw[64 + col], raw[hr][8 * n / DH]);
        }
    float graw[2][EPT];
#pragma unroll
    for (int el = 0; el < EPT; ++el) {
      float part = 0.f;
      const int e = n0 / DH + el;
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        float x = raw[hr][el];
        x += __shfl_xor_sync(0xffffffffu, x, 1);
        x += __shfl_xor_sync(0xffffffffu, x, 2);
        const int row = r0 + g + 8 * hr;
        graw[hr][el] = 0.f;
        if (e < E && row < p.rows) {
          const float gl = p.g_lam[(size_t)row * E + e];
          const float s = expf(p.scaling[e]);
          const float rr = x / s, sr = sigmoid(rr);
          graw[hr][el] = gl * sr;
          if (t4 == 0) {
            p.g_raw[(size_t)row * E + e] = gl * sr;
            part += gl * (s * softplus(rr) - sr * x);
          }
        }
      }
#pragma unroll
      for (int o = 4; o < 32; o <<= 1) part += __shfl_xor_sync(0xffffffffu, part, o);
      if (lane == 0 && e < E) atomicAdd(&gsc[e], part);
    }
    // g_z = g_raw w sig (1 - sig), split into the A fragments of g_x's
    // product (k step kk: columns 16 kk ..; entry i the pair z[8 kk + 2 i], +1)
    uint32_t ah[4][4], al[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float gz[2];
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int j = 8 * kk + 2 * i + c, n = j >> 2, hr = (j >> 1) & 1;
          const float sg = z[j];
          gz[c] = graw[hr][8 * n / DH] * bdw[64 + 8 * n + 2 * t4 + c] * sg * (1.f - sg);
        }
        split_bf16x2(gz[0], gz[1], ah[kk][i], al[kk][i]);
      }
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_rs_x3<0>(gx, ah[kk], al[kk], dwh + 2 * kk, dwl + 2 * kk);
    wg_commit();
    wg_wait();
    reg_fence(gx);
  }

#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int row = r0 + g + 8 * hr;
    if (row >= p.rows) continue;
#pragma unroll
    for (int n = 0; n < DH / 8; ++n)
      *reinterpret_cast<float2*>(p.g_su + (size_t)row * DH + 8 * n + 2 * t4) =
          make_float2(gx[4 * n + 2 * hr], gx[4 * n + 2 * hr + 1]);
  }
  __syncthreads();
  for (int e = tid; e < E; e += kIntThreads) atomicAdd(&p.g_sc[e], gsc[e]);
}

// The column kernel: 64 columns of Wd (blockIdx.x) over kRowChunk rows
// (blockIdx.y), 16 columns a warp, looping over 64-row sub-tiles. Per
// sub-tile: z^T = Wd_tile^T x^T (A: the columns' seq_units lanes of Wd,
// hi/lo fragments in registers for the whole loop; B: the sub-tile's x
// split into hi/lo tiles, K-major) plus Wd[dh] iv and bd in fp32; g_z^T in
// place from the row kernel's g_raw, gw, gbd and the interval lane's gWd in
// registers; then gWd^T += g_z^T x (A: g_z^T split; B: the same tiles,
// MN-major). gWd, gbd and gw are added by one atomic per entry and block.
// Thread (warp, g, t4) holds columns 16 warp + g (+8) and, of a sub-tile,
// rows 8 n + 2 t4 (+1) at zt[4 n + 2 hm + c].
template <int DH>
__global__ void __launch_bounds__(kIntThreads) mau_int_bwd_cols_tc_kernel(const IntBwdParams p) {
  constexpr int KK = DH / 16;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* base = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  bf16* xhi = reinterpret_cast<bf16*>(base);  // [64 rows][64 lanes] x sub-tile, hi
  bf16* xlo = xhi + kIntTile;                 // lo
  // [2][64 rows][DH] the raw sub-tiles, [2][64] their intervals and
  // [2][64 rows][4] g_raw of the tile's events, filled a sub-tile ahead by
  // cp.async
  float* xraw = reinterpret_cast<float*>(xlo + kIntTile);
  float* ivr = xraw + 2 * 64 * DH;
  float* grr = ivr + 2 * 64;
  const int E = p.E, edh = E * DH;
  const int n0 = blockIdx.x * 64, e0 = n0 / DH;
  const int rbeg = blockIdx.y * kRowChunk, rend = imin(rbeg + kRowChunk, p.rows);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int m0 = 16 * warp;  // the warp's first column of the tile
  // lanes dh .. 63 of the hi/lo tiles stay zero
  for (int idx = tid; idx < 64 * 16; idx += kIntThreads)
    if ((idx & 15) * 4 >= DH)
      store_split4(xhi, xlo, idx >> 4, (idx & 15) * 4, make_float4(0.f, 0.f, 0.f, 0.f));
  auto fetch = [&](int r0, int b) {  // the sub-tile at row r0 into buffer b
    for (int idx = tid; idx < 64 * DH / 4; idx += kIntThreads) {
      const int r = idx / (DH / 4), q = (idx - r * (DH / 4)) * 4, row = r0 + r;
      const bool ok = row < rend;
      cp_async16(xraw + (b * 64 + r) * DH + q, p.su + (size_t)(ok ? row : 0) * DH + q, ok);
    }
    for (int idx = tid; idx < 64 * 4; idx += kIntThreads) {
      const int r = idx >> 2, e = idx & 3, row = r0 + r;
      const bool ok = row < rend && e < 64 / DH && e0 + e < E;
      cp_async4(grr + b * 256 + idx, p.g_raw + (ok ? (size_t)row * E + e0 + e : 0), ok);
      if (e == 0)
        cp_async4(ivr + b * 64 + r, p.intervals + (row < rend ? interval_index(p, row) : 0),
                  row < rend);
    }
    cp_async_commit();
  };
  fetch(rbeg, 0);

  // Wd^T of the warp's columns as A fragments: k step kk, entry i at
  // column n0 + m0 + g + 8 (i & 1), lanes 16 kk + 8 (i >> 1) + 2 t4 (+1)
  uint32_t ah[KK][4], al[KK][4];
#pragma unroll
  for (int kk = 0; kk < KK; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int n = n0 + m0 + g + 8 * (i & 1), c = 16 * kk + 8 * (i >> 1) + 2 * t4;
      const bool ok = n < edh;
      split_bf16x2(ok ? p.wd[(size_t)c * edh + n] : 0.f, ok ? p.wd[(size_t)(c + 1) * edh + n] : 0.f,
                   ah[kk][i], al[kk][i]);
    }
  // the thread's columns n0 + m0 + g + 8 hm
  float bn[2], wn[2], wi[2], gw[2] = {0.f, 0.f}, gbd[2] = {0.f, 0.f}, giv[2] = {0.f, 0.f};
  int el[2];
#pragma unroll
  for (int hm = 0; hm < 2; ++hm) {
    const int n = n0 + m0 + g + 8 * hm;
    const bool ok = n < edh;
    bn[hm] = ok ? p.bd[n] : 0.f;
    wn[hm] = ok ? p.w[n] : 0.f;
    wi[hm] = ok ? p.wd[(size_t)DH * edh + n] : 0.f;
    el[hm] = (m0 + g + 8 * hm) / DH;
  }
  const uint64_t dxh = sw128_desc(xhi), dxl = sw128_desc(xlo);
  float gwd[32];  // gWd^T at (column, lane 8 n + 2 t4 + c), n < DH / 8
#pragma unroll
  for (int i = 0; i < 32; ++i) gwd[i] = 0.f;

  for (int r0 = rbeg, t = 0; r0 < rend; r0 += 64, ++t) {
    cp_async_wait_all();
    __syncthreads();  // sub-tile t has landed, sub-tile t - 1 is consumed
    if (r0 + 64 < rend) fetch(r0 + 64, (t + 1) & 1);
    const float* rt = xraw + (t & 1) * 64 * DH;
    for (int idx = tid; idx < 64 * DH / 4; idx += kIntThreads) {
      const int r = idx / (DH / 4), q = (idx - r * (DH / 4)) * 4;
      store_split4(xhi, xlo, r, q, *reinterpret_cast<const float4*>(rt + r * DH + q));
    }
    const float* ivs = ivr + (t & 1) * 64;
    const float* grs = grr + (t & 1) * 256;
    fence_async_smem();
    __syncthreads();

    float zt[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) zt[i] = 0.f;
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < KK; ++kk) wgmma_rs_x3<0>(zt, ah[kk], al[kk], dxh + 2 * kk, dxl + 2 * kk);
    wg_commit();
    wg_wait();
    reg_fence(zt);

#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int hm = 0; hm < 2; ++hm)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int r = 8 * n + 2 * t4 + c;
          float& x = zt[4 * n + 2 * hm + c];
          const float sg = sigmoid(fmaf(wi[hm], ivs[r], x + bn[hm]));
          const float gr = grs[r * 4 + el[hm]];
          const float gz = gr * wn[hm] * sg * (1.f - sg);
          gw[hm] = fmaf(gr, sg, gw[hm]);
          gbd[hm] += gz;
          giv[hm] = fmaf(ivs[r], gz, giv[hm]);
          x = gz;
        }
    // g_z^T as A fragments: k step kk = rows 16 kk ..; entry i the pair
    // zt[8 kk + 2 i], +1
    uint32_t gh[4][4], gl[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        split_bf16x2(zt[8 * kk + 2 * i], zt[8 * kk + 2 * i + 1], gh[kk][i], gl[kk][i]);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_rs_x3<1>(gwd, gh[kk], gl[kk], dxh + 128 * kk, dxl + 128 * kk);
    wg_commit();
    wg_wait();
    reg_fence(gwd);
  }

#pragma unroll
  for (int hm = 0; hm < 2; ++hm) {
    const int n = n0 + m0 + g + 8 * hm;
    float a = gw[hm], b = gbd[hm], v = giv[hm];
#pragma unroll
    for (int o = 1; o <= 2; o <<= 1) {
      a += __shfl_xor_sync(0xffffffffu, a, o);
      b += __shfl_xor_sync(0xffffffffu, b, o);
      v += __shfl_xor_sync(0xffffffffu, v, o);
    }
    if (n >= edh) continue;
    if (t4 == 0) {
      atomicAdd(p.g_w + n, a);
      atomicAdd(p.g_bd + n, b);
      atomicAdd(p.g_wd + (size_t)DH * edh + n, v);
    }
#pragma unroll
    for (int j = 0; j < DH / 8; ++j)
#pragma unroll
      for (int c = 0; c < 2; ++c)
        atomicAdd(p.g_wd + (size_t)(8 * j + 2 * t4 + c) * edh + n, gwd[4 * j + 2 * hm + c]);
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

size_t smem_bytes(int which, int dh, int E, int Tk, int dtype) {
  const int ep = round_up(E, 16);
  switch (which) {
    case kGlam:
      return dtype ? glam_tc_smem_bytes(round_up(E, 64) / 64, Tk)
                   : sizeof(float) * (size_t)glam_smem_floats(dh, ep);
    case kDq:
      return dtype ? dq_tc_smem_bytes(round_up(E, 64) / 64, Tk)
                   : sizeof(float) * (size_t)dq_smem_floats(dh, ep);
    case kDkvt:
      return dtype ? dkvt_tc_smem_bytes(round_up(E, 64) / 64, Tk)
                   : sizeof(float) * (size_t)dkvt_smem_floats(dh, ep);
    case kIntRows: return sizeof(float) * (size_t)int_rows_smem_floats(dh, E);
    default: return sizeof(float) * (size_t)int_cols_smem_floats(dh);
  }
}

// The attention-side kernels in fp32, by dh: on the CUDA cores, 256 threads
// (bf16 glam and dq are glam_tc_launch's and dq_tc_launch's).
using Kernel = void (*)(const BwdParams);
const Kernel kGlamKernels[3] = {mau_glam_kernel<16>, mau_glam_kernel<32>, mau_glam_kernel<64>};
const Kernel kDqKernels[3] = {mau_dq_kernel<16>, mau_dq_kernel<32>, mau_dq_kernel<64>};

cudaError_t launch(const Kernel* kernels, int which, const BwdParams& p, int dh, int blocks,
                   cudaStream_t s) {
  const int slot = dh == 16 ? 0 : dh == 32 ? 1 : dh == 64 ? 2 : -1;
  if (slot < 0) return cudaErrorInvalidValue;
  return go(kernels[slot], blocks, kThreads, smem_bytes(which, dh, p.E, p.Tk, 0), s, p);
}

// bf16 glam: heads 64 channels wide and the one-hot EP = E rounded up to 64
// events wide (the wrapper zero-pads), rows of q, k, v, dout on 16-byte
// boundaries.
cudaError_t glam_tc_launch(BwdParams p, const void* onehot, int dh, cudaStream_t s) {
  if (dh != 64) return cudaErrorInvalidValue;
  p.EP = round_up(p.E, 64);
  p.stages = kQmStages;
  const int ept = p.EP / 64;
  QmMaps maps{};
  if (!heads_seq_map(&maps.res[0], p.q, p.Tq, p.H, p.B) ||
      !heads_seq_map(&maps.res[1], p.dout, p.Tq, p.H, p.B) ||
      !heads_seq_map(&maps.ring[0], p.k, p.Tk, p.H, p.B) ||
      !heads_seq_map(&maps.ring[1], p.v, p.Tk, p.H, p.B) ||
      !onehot_map(&maps.ring[kQmOnehot], onehot, p.EP, p.Tk, p.B))
    return cudaErrorInvalidValue;
  maps.nres[0] = maps.nres[1] = maps.nring[0] = maps.nring[1] = 1;
  maps.nring[kQmOnehot] = ept;
  const int groups = glam_groups(ept);
  const int blocks = p.B * p.H * ((p.Tq + 64 * groups - 1) / (64 * groups));
  const size_t bytes = glam_tc_smem_bytes(ept, p.Tk);
  switch (ept) {
    case 1: return go(mau_glam_tc_kernel<1>, blocks, 128 * (groups + 1), bytes, s, p, maps);
    case 2: return go(mau_glam_tc_kernel<2>, blocks, 128 * (groups + 1), bytes, s, p, maps);
    default: return cudaErrorInvalidValue;
  }
}

// bf16 dq: heads 64 channels wide and lam / one-hot EP = E rounded up to 64
// events wide (the wrapper zero-pads), g_su (B, H, Tq, 64) and lam (B, H,
// Tq, EP) contiguous, rows of q, k, v, t, dout on 16-byte boundaries.
cudaError_t dq_tc_launch(BwdParams p, const void* onehot, const void* lam, int dh,
                         cudaStream_t s) {
  if (dh != 64) return cudaErrorInvalidValue;
  p.EP = round_up(p.E, 64);
  const int ept = p.EP / 64;
  QmMaps maps{};
  if (!heads_seq_map(&maps.res[0], p.q, p.Tq, p.H, p.B) ||
      !heads_seq_map(&maps.res[1], p.dout, p.Tq, p.H, p.B) ||
      !heads_map(&maps.res[2], p.gsu, 64, p.Tq, p.H, p.B) ||
      !heads_map(&maps.res[3], lam, p.EP, p.Tq, p.H, p.B) ||
      !heads_seq_map(&maps.ring[0], p.k, p.Tk, p.H, p.B) ||
      !heads_seq_map(&maps.ring[1], p.v, p.Tk, p.H, p.B) ||
      !heads_seq_map(&maps.ring[2], p.t, p.Tk, p.H, p.B) ||
      !onehot_map(&maps.ring[kQmOnehot], onehot, p.EP, p.Tk, p.B))
    return cudaErrorInvalidValue;
  for (int m = 0; m < 3; ++m) maps.nres[m] = maps.nring[m] = 1;
  maps.nres[3] = maps.nring[kQmOnehot] = ept;
  const int blocks = p.B * p.H * ((p.Tq + 64 * kDqGroups - 1) / (64 * kDqGroups));
  const size_t bytes = dq_tc_smem_bytes(ept, p.Tk);
  switch (ept) {
    case 1: return go(mau_dq_tc_kernel<1>, blocks, 128 * (kDqGroups + 1), bytes, s, p, maps);
    case 2: return go(mau_dq_tc_kernel<2>, blocks, 128 * (kDqGroups + 1), bytes, s, p, maps);
    default: return cudaErrorInvalidValue;
  }
}

bool bad_shape(int B, int Tq, int Tk, int H, int E, int dtype) {
  return B < 1 || H < 1 || Tq < 1 || Tk < 1 || E < 1 || E > 128 || (dtype != 0 && dtype != 1);
}

}  // namespace

extern "C" {

// Dynamic shared memory of one block of kernel `which` (0 glam, 1 dq,
// 2 dkvt, 3 intensity rows, 4 intensity columns) for a compute dtype, in
// bytes; above 232448 it cannot run.
size_t mau_streamed_bwd_smem_bytes(int which, int dh, int E, int Tk, int dtype) {
  return smem_bytes(which, dh, E, Tk, dtype);
}

// Each launches on `stream` and returns cudaGetLastError() (0 on success).
// dtype: 0 = float32, 1 = bfloat16, of q, k, v, t, dout, g_su and the
// outputs dq, dk, dv, dt. Strides are in elements; channels are contiguous;
// g_su is (B, H, Tq, dh) contiguous; everything else is fp32 and contiguous,
// except that in bf16 lam (B, H, Tq, EP) and onehot (B, Tk, EP) are bf16,
// rounded and zero-padded to EP = E rounded up to 64, and in bf16 the heads
// are 64 channels wide (the wrapper zero-pads narrower ones, g_su too), and
// the rows of q, k, v, t and dout start on 16-byte boundaries.
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
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype) return (int)glam_tc_launch(p, onehot, dh, s);
  return (int)launch(kGlamKernels, kGlam, p, dh, B * H * ((Tq + BQ - 1) / BQ), s);
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
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype) return (int)dq_tc_launch(p, onehot, lam, dh, s);
  return (int)launch(kDqKernels, kDq, p, dh, B * H * ((Tq + BQ - 1) / BQ), s);
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
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    const int blocks = B * H * ((Tk + BK - 1) / BK);
    switch (dh) {
      case 16: return (int)go(mau_dkvt_kernel<16>, blocks, kThreads, smem_bytes(kDkvt, 16, E, Tk, 0), s, p);
      case 32: return (int)go(mau_dkvt_kernel<32>, blocks, kThreads, smem_bytes(kDkvt, 32, E, Tk, 0), s, p);
      case 64: return (int)go(mau_dkvt_kernel<64>, blocks, kThreads, smem_bytes(kDkvt, 64, E, Tk, 0), s, p);
      default: return (int)cudaErrorInvalidValue;
    }
  }
  // bf16: heads 64 wide and lam / one-hot 64-event tiles wide (the wrapper
  // zero-pads narrower ones), rows of every operand on 16-byte boundaries
  if (dh != 64) return (int)cudaErrorInvalidValue;
  p.EP = round_up(E, 64);
  DkvtMaps maps;
  const long long ep = p.EP;
  if (!bf16_rows_map(&maps.q, p.q.p, 64, Tq, H, B, p.q.rs, 64, p.q.bs) ||
      !bf16_rows_map(&maps.dout, p.dout.p, 64, Tq, H, B, p.dout.rs, 64, p.dout.bs) ||
      !bf16_rows_map(&maps.gsu, gsu, 64, Tq, H, B, 64, (long long)Tq * 64, (long long)H * Tq * 64) ||
      !bf16_rows_map(&maps.lam, lam, ep, Tq, H, B, ep, Tq * ep, H * Tq * ep) ||
      !bf16_rows_map(&maps.k, p.k.p, 64, Tk, H, B, p.k.rs, 64, p.k.bs) ||
      !bf16_rows_map(&maps.v, p.v.p, 64, Tk, H, B, p.v.rs, 64, p.v.bs) ||
      !bf16_rows_map(&maps.t, p.t.p, 64, Tk, H, B, p.t.rs, 64, p.t.bs) ||
      !bf16_rows_map(&maps.onehot, onehot, ep, Tk, 1, B, ep, Tk * ep, Tk * ep))
    return (int)cudaErrorInvalidValue;
  return (int)go(mau_dkvt_tc_kernel, B * H * ((Tk + kKvKeys - 1) / kKvKeys), kKvThreads,
                 dkvt_tc_smem_bytes(p.EP / 64, Tk), s, p, maps);
}

// The intensity head's VJP to fp32 accuracy (3xTF32 products on the tensor
// cores, fp32 elsewhere): the row kernel, then the column kernel (it reads
// the row kernel's g_raw). g_wd, g_bd, g_w and g_sc
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
  const size_t rb = smem_bytes(kIntRows, dh, E, 0, 0), cb = smem_bytes(kIntCols, dh, E, 0, 0);
  auto both = [&](auto rows_kernel, auto cols_kernel) {
    const cudaError_t e = go(rows_kernel, rows_grid, kIntThreads, rb, s, p);
    return (int)(e != cudaSuccess ? e : go(cols_kernel, cols_grid, kIntThreads, cb, s, p));
  };
  switch (dh) {
    case 16: return both(mau_int_bwd_rows_tc_kernel<16>, mau_int_bwd_cols_tc_kernel<16>);
    case 32: return both(mau_int_bwd_rows_tc_kernel<32>, mau_int_bwd_cols_tc_kernel<32>);
    case 64: return both(mau_int_bwd_rows_tc_kernel<64>, mau_int_bwd_cols_tc_kernel<64>);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"

// Fused MAU/BiMAU self-modulating attention, forward, for Hopper (sm_90a).
//
// Replaces the TPU kernel easydgl_tpu/kernels/mau_attention.py::_fwd_kernel
// (pallas_call in _mau_fwd). Per (batch row b, head h), on the natural
// (B, T, C) layout with head h in channels [h*dh, (h+1)*dh):
//
//   s      = q k^T * scale; key-masked / causal entries := -(2^32)+1
//   probs  = softmax(s)                       (fully masked row -> uniform)
//   su     = probs @ t
//   z      = [su | interval] @ Wd + bd        ((dh+1) x E*dh, shared by heads)
//   raw[e] = sum_j sigmoid(z)[e*dh+j] * w[e, j]
//   lam    = s_e * softplus(raw / s_e),  s_e = exp(scaling[e])
//   iqk    = lam @ onehot^T; BiMAU: iqk[i, qpos[i]] := 1
//   out    = dropout(iqk * probs) @ v
//
// Outputs: out (B, Tq, C) in the input dtype, lam (B, H, Tq, E) in fp32, and
// for training the residual raw (B, H, Tq, E) fp32 that the backward
// (mau_attention_bwd.cu) reads for sigmoid(raw/s) and d scaling; probs are
// cheap to recompute there and are not stored. Dropout (training) keeps an
// entry by a Philox draw that is a pure function of (seed, b, h, i, j)
// (common.cuh), so the backward regenerates the mask bit for bit. With no
// seed and no raw pointer (eval) both cost one uniform branch each.
//
// What bounds it: the intensity head. z is a (Tq x (dh+1)) @ ((dh+1) x E*dh)
// product per (b, h) — 67.6 GFLOP at the flagship eval shape against ~2 GFLOP
// for everything else — followed by E*dh sigmoids per query row (520 M at the
// flagship shape, two special-function-unit operations each). Wd is shared
// by every head and batch row, so the head is best run over the rows of many
// (b, h) at once, Wd read from L2 once for many rows.
//
// * bf16 (the main path): three kernels and a small one, as the backward
//   (mau_attention_bwd.cu) is split.
//   1. mau_fwd_pre_kernel: one block a (b, h): the logits, the softmax and
//      su = rnd(probs) @ t, the two products on mma.sync from bf16 tiles in
//      shared memory; writes probs (fp32, 16 MB at the flagship shape) and
//      x = rnd(su) (bf16 rows of dh lanes, (B*H*Tq, dh), 16 MB).
//   2. mau_int_round_kernel rounds Wd, its interval lane and w to bf16 once
//      a launch, and mau_int_fwd_tc_kernel<dh, fused> (intensity_head.cuh)
//      runs the head over the B*H*Tq rows, 192 a block (about six (b, h)):
//      z = x Wd on wgmma in one bf16 pass, the interval rounded to bf16 and
//      added as an fp32 rank-1 term, the exact sigmoid rounded to bf16,
//      times the bf16 w, summed in fp32; lam and, in training, raw. At the
//      flagship shape its 662 blocks read 0.35 GB of Wd from L2, where one
//      block a (b, h) read 2.68 GB (80 x 4,096 bf16 each).
//   3. mau_fwd_post_kernel: one block a (b, h): iqk = lam one-hot^T on
//      mma.sync, lam in fp32 as three bf16 parts by the exact 0/1 one-hot;
//      the diagonal reset, dropout, rounding, and @v on mma.sync.
//   The round trip of probs and x through device memory (~66 MB) costs
//   ~0.02 ms at 3.35 TB/s. The attention kernels' products are tiny (31 x
//   31 x 64 at the flagship shape): on the CUDA cores, one dot product an
//   entry, they were bound by shared-memory reads (~0.8 MB a block).
// * fp32: mau_fwd_kernel, one block a (b, h): the z product on CUDA
//   cores, an 8x4 register tile per thread, Wd row-major streamed from L2
//   with 16-byte loads; the (rows, E*dh) sigmoid activation never leaves
//   registers, and the per-event reduction over an event's dh columns is a
//   register sum plus a shuffle across lanes.
//
// Precision contract (mirrors the TPU kernel): in bf16 mode the operands of
// every product are rounded to bf16 (probs before @t, [su | interval] before
// @Wd, Wd and w themselves, the modulated probs before @v) and the sigmoid is
// evaluated in fp32 and rounded to bf16 once; all sums accumulate in fp32.
// In fp32 mode nothing is rounded.
//
// Limits: 1 <= Tq <= Tk <= 128, dh in {16, 32, 64, 128}, and the blocks'
// shared memory (mau_attention_fwd_smem_bytes) within 227 KB.

#include "intensity_head.cuh"

namespace {

using namespace port;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr float kNeg = -4294967295.0f;  // -(2^32) + 1, the reference mask


struct Params {
  const void* q;
  const void* k;
  const void* v;
  const void* t;
  long long q_bs, q_rs, k_bs, k_rs, v_bs, v_rs, t_bs, t_rs;  // elements
  const float* key_mask;   // (B, Tk)
  const float* intervals;  // (B, Tq)
  const int* qpos;         // (B, Tq)
  const float* onehot;     // (B, Tk, E)
  const float* wd;         // (dh+1, E*dh)
  const float* bd;         // (E*dh,)
  const float* w;          // (E, dh)
  const float* scaling;    // (E,)
  void* out;               // (B, Tq, H*dh), input dtype
  float* lam;              // (B, H, Tq, E)
  float* raw;              // (B, H, Tq, E) or null (eval)
  float* probs;            // bf16: (B*H, Tq*Tk rounded up to 4), pre -> post
  bf16* x;                 // bf16: (B*H*Tq, dh) rnd(su), pre -> the head
  const long long* seed;   // dropout seed (device scalar) or null (no dropout)
  unsigned drop_thresh;
  float drop_scale;
  float scale;
  int B, Tq, Tk, H, E, causal, diag_reset;
};

// Row strides of the q/k/t/v rows and of the lam/one-hot rows in shared
// memory: multiples of 4 floats for 16-byte loads, 4 (mod 32) words apart so
// that 8 lanes reading 8 consecutive rows hit distinct banks.
__host__ __device__ inline int row_stride(int dh) { return dh + 4; }
__host__ __device__ inline int event_stride(int E) { return round_up(E, 4) + 4; }

// Shared-memory regions, in floats, each a multiple of 4 (16-byte aligned).
struct Layout {
  int x, a, v, p, small;
};

__host__ __device__ inline Layout layout(int Tq, int Tk, int dh, int E) {
  const int ldh = row_stride(dh), lde = event_stride(E), tqp = round_up(Tq, 32);
  Layout l;
  // the z product's A operand xT[(dh+1)][tqp] (fp32), aliasing the q rows
  // of the logits phase
  l.x = round_up(imax((dh + 1) * tqp, Tq * ldh), 4);
  // k and t rows; after seq_units: raw/lam rows and the one-hot rows
  l.a = round_up(imax(2 * Tk * ldh, Tq * lde + Tk * lde), 4);
  l.v = round_up(Tk * ldh, 4);
  l.p = round_up(Tq * Tk, 4);
  l.small = round_up(Tk + 2 * Tq, 4);  // key mask, intervals, qpos
  return l;
}

__host__ __device__ inline size_t smem_bytes(int Tq, int Tk, int dh, int E) {
  const Layout l = layout(Tq, Tk, dh, E);
  return sizeof(float) * (size_t)(l.x + l.a + l.v + l.p + l.small);
}

__device__ __forceinline__ void load4(const float* p, float (&o)[4]) {
  const float4 v = __ldg(reinterpret_cast<const float4*>(p));
  o[0] = v.x; o[1] = v.y; o[2] = v.z; o[3] = v.w;
}

template <typename T, int DH>
__device__ __forceinline__ void load_rows(float* dst, const T* src, long long rs,
                                          int rows) {
  for (int i = threadIdx.x; i < rows * DH; i += kThreads) {
    const int r = i / DH, d = i - r * DH;
    dst[r * row_stride(DH) + d] = to_f(src[r * rs + d]);
  }
}

__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  return fmaf(a.w, b.w, fmaf(a.z, b.z, fmaf(a.y, b.y, fmaf(a.x, b.x, acc))));
}

__device__ __forceinline__ void axpy4(float a, float4 x, float4& y) {
  y.x = fmaf(a, x.x, y.x); y.y = fmaf(a, x.y, y.y);
  y.z = fmaf(a, x.z, y.z); y.w = fmaf(a, x.w, y.w);
}

// raw[r][e] for r < Tq into lam_s: fp32 on CUDA cores. Each pass covers 32
// query rows x 256 columns of z: thread (rg, cg) owns rows rg*8..+7 and
// columns cg*4..+3. One event's DH columns sit on DH/4 adjacent lanes of one
// warp, so the per-event sum over columns is a shuffle within those lanes.
template <int DH>
__device__ void intensity_head_fp32(const Params& p, const float* xs, int tqp,
                                    float* lam_s, int lde) {
  const int edh = p.E * DH;
  const int cg = threadIdx.x & 63, rg = threadIdx.x >> 6;
  constexpr int kLanesPerEvent = DH / 4;
  const float* wd = p.wd;
  const float* wf = p.w;
  for (int r0 = 0; r0 < p.Tq; r0 += 32) {
    for (int col0 = 0; col0 < edh; col0 += 4 * 64) {
      const int c0 = col0 + cg * 4;
      const bool valid = c0 < edh;
      float part[8];
      if (valid) {
        float acc[8][4];
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int jj = 0; jj < 4; ++jj) acc[i][jj] = 0.f;
        const float* xp = xs + r0 + rg * 8;
#pragma unroll 5
        for (int c = 0; c <= DH; ++c) {
          float wv[4];
          load4(wd + (size_t)c * edh + c0, wv);
          const float4 xa = *reinterpret_cast<const float4*>(xp + c * tqp);
          const float4 xb = *reinterpret_cast<const float4*>(xp + c * tqp + 4);
          const float xv[8] = {xa.x, xa.y, xa.z, xa.w, xb.x, xb.y, xb.z, xb.w};
#pragma unroll
          for (int i = 0; i < 8; ++i)
#pragma unroll
            for (int jj = 0; jj < 4; ++jj) acc[i][jj] = fmaf(xv[i], wv[jj], acc[i][jj]);
        }
        float bdv[4], wfv[4];
        load4(p.bd + c0, bdv);
        load4(wf + c0, wfv);
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          float s = 0.f;
#pragma unroll
          for (int jj = 0; jj < 4; ++jj) s = fmaf(sigmoid(acc[i][jj] + bdv[jj]), wfv[jj], s);
          part[i] = s;
        }
      } else {
#pragma unroll
        for (int i = 0; i < 8; ++i) part[i] = 0.f;
      }
#pragma unroll
      for (int o = kLanesPerEvent / 2; o > 0; o >>= 1)
#pragma unroll
        for (int i = 0; i < 8; ++i) part[i] += __shfl_xor_sync(0xffffffffu, part[i], o);
      if (valid && (cg % kLanesPerEvent) == 0) {
        const int e = c0 / DH;
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const int r = r0 + rg * 8 + i;
          if (r < p.Tq) lam_s[r * lde + e] = part[i];
        }
      }
    }
  }
}

// Three blocks per SM (<= 85 registers a thread) hide more of each block's
// global-load and barrier latency.
template <int DH>
__global__ void __launch_bounds__(kThreads, 3) mau_fwd_kernel(const Params p) {
  constexpr int ldh = DH + 4;  // row_stride(DH)
  constexpr int D4 = DH / 4;
  extern __shared__ __align__(16) float smem[];
  const int b = blockIdx.x / p.H, h = blockIdx.x - b * p.H;
  const int Tq = p.Tq, Tk = p.Tk, E = p.E;
  const int lde = event_stride(E), E4 = round_up(E, 4) / 4, tqp = round_up(Tq, 32);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const Layout l = layout(Tq, Tk, DH, E);

  float* xs = smem;              // A operand of z (phase 2)
  float* qs = smem;              // q rows (logits only)
  float* as = smem + l.x;
  float* ks = as;                // k rows (phase 1)
  float* ts = as + Tk * ldh;     // t rows (phase 1)
  float* lam_s = as;             // raw, then lam (Tq, E) (phases 2-3)
  float* oh_s = as + Tq * lde;   // one-hot (Tk, E) (phase 3)
  float* vs = as + l.a;
  float* ps = vs + l.v;          // probs, then modulated probs (Tq, Tk)
  float* kms = ps + l.p;
  float* ivs = kms + Tk;
  int* qps = reinterpret_cast<int*>(ivs + Tq);

  // ---- phase 1: attention probabilities and seq_units
  load_rows<float, DH>(qs, static_cast<const float*>(p.q) + b * p.q_bs + h * DH, p.q_rs, Tq);
  load_rows<float, DH>(ks, static_cast<const float*>(p.k) + b * p.k_bs + h * DH, p.k_rs, Tk);
  load_rows<float, DH>(ts, static_cast<const float*>(p.t) + b * p.t_bs + h * DH, p.t_rs, Tk);
  load_rows<float, DH>(vs, static_cast<const float*>(p.v) + b * p.v_bs + h * DH, p.v_rs, Tk);
  for (int j = tid; j < Tk; j += kThreads) kms[j] = p.key_mask[(size_t)b * Tk + j];
  for (int i = tid; i < Tq; i += kThreads) {
    ivs[i] = p.intervals[(size_t)b * Tq + i];
    qps[i] = p.qpos[(size_t)b * Tq + i];
  }
  __syncthreads();

  for (int idx = tid; idx < Tq * Tk; idx += kThreads) {
    const int i = idx / Tk, j = idx - i * Tk;
    const float4* qa = reinterpret_cast<const float4*>(qs + i * ldh);
    const float4* ka = reinterpret_cast<const float4*>(ks + j * ldh);
    float acc = 0.f;
#pragma unroll
    for (int d = 0; d < D4; ++d) acc = dot4(qa[d], ka[d], acc);
    float s = acc * p.scale;
    if (kms[j] == 0.f) s = kNeg;
    if (p.causal && j > qps[i]) s = kNeg;
    ps[idx] = s;
  }
  __syncthreads();

  // softmax, one warp per query row. A fully masked row holds kNeg in every
  // column and so comes out uniform over the Tk real keys.
  for (int i = warp; i < Tq; i += kWarps) {
    float* row = ps + i * Tk;
    float m = -INFINITY;
    for (int j = lane; j < Tk; j += 32) m = fmaxf(m, row[j]);
    for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
    float sum = 0.f;
    for (int j = lane; j < Tk; j += 32) {
      const float e = expf(row[j] - m);
      row[j] = e;
      sum += e;
    }
    for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
    for (int j = lane; j < Tk; j += 32) row[j] = row[j] / sum;
  }
  __syncthreads();

  // A operand of z = [su | interval]; rows past Tq are zero so the z tile
  // may run over them. The q rows it overwrites are dead here. su = probs @
  // t, each thread a row i and 4 adjacent channels.
  for (int idx = tid; idx < (DH + 1) * tqp; idx += kThreads) {
    const int d = idx / tqp, i = idx - d * tqp;
    if (i >= Tq || d == DH) xs[idx] = i < Tq ? ivs[i] : 0.f;
  }
  for (int idx = tid; idx < Tq * D4; idx += kThreads) {
    const int i = idx / D4, d0 = (idx - i * D4) * 4;
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int j = 0; j < Tk; ++j)
      axpy4(ps[i * Tk + j], *reinterpret_cast<const float4*>(ts + j * ldh + d0), acc);
    xs[(d0 + 0) * tqp + i] = acc.x; xs[(d0 + 1) * tqp + i] = acc.y;
    xs[(d0 + 2) * tqp + i] = acc.z; xs[(d0 + 3) * tqp + i] = acc.w;
  }
  __syncthreads();

  // ---- phase 2: intensity head -> raw (Tq, E) in lam_s
  intensity_head_fp32<DH>(p, xs, tqp, lam_s, lde);
  __syncthreads();

  // lam = s * softplus(raw / s); the padding columns of the lam and one-hot
  // rows are zero
  float* lam_out = p.lam + ((size_t)b * p.H + h) * Tq * E;
  float* raw_out = p.raw ? p.raw + ((size_t)b * p.H + h) * Tq * E : nullptr;
  for (int idx = tid; idx < Tq * E4 * 4; idx += kThreads) {
    const int i = idx / (E4 * 4), e = idx - i * E4 * 4;
    float v = 0.f;
    if (e < E) {
      const float s = expf(p.scaling[e]);
      const float r = lam_s[i * lde + e];
      v = s * softplus(r / s);
      lam_out[i * E + e] = v;
      if (raw_out) raw_out[i * E + e] = r;
    }
    lam_s[i * lde + e] = v;
  }
  for (int idx = tid; idx < Tk * E4 * 4; idx += kThreads) {
    const int j = idx / (E4 * 4), e = idx - j * E4 * 4;
    oh_s[j * lde + e] = e < E ? p.onehot[((size_t)b * Tk + j) * E + e] : 0.f;
  }
  __syncthreads();

  // ---- phase 3: modulation (diagonal reset at qpos), dropout and @v
  const Dropout drop = make_dropout(p.seed, p.drop_thresh, p.drop_scale);
  for (int idx = tid; idx < Tq * Tk; idx += kThreads) {
    const int i = idx / Tk, j = idx - i * Tk;
    float iqk = 1.f;
    if (!(p.diag_reset && j == qps[i])) {
      const float4* la = reinterpret_cast<const float4*>(lam_s + i * lde);
      const float4* oa = reinterpret_cast<const float4*>(oh_s + j * lde);
      iqk = 0.f;
      for (int e = 0; e < E4; ++e) iqk = dot4(la[e], oa[e], iqk);
    }
    float m = iqk * ps[idx];
    if (drop.on) m *= drop.factor(b, h, i, j);
    ps[idx] = m;
  }
  __syncthreads();

  const int C = p.H * DH;
  float* out = static_cast<float*>(p.out) + (size_t)b * Tq * C + h * DH;
  for (int idx = tid; idx < Tq * D4; idx += kThreads) {
    const int i = idx / D4, d0 = (idx - i * D4) * 4;
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int j = 0; j < Tk; ++j)
      axpy4(ps[i * Tk + j], *reinterpret_cast<const float4*>(vs + j * ldh + d0), acc);
    float* o = out + (size_t)i * C + d0;
    o[0] = acc.x; o[1] = acc.y; o[2] = acc.z; o[3] = acc.w;
  }
}

// ---------------------------------------------------------------- bf16: the
// attention side, before the intensity head (mau_fwd_pre_kernel) and after
// it (mau_fwd_post_kernel), one block a (b, h). Their four small products
// run on the tensor cores (mma.sync m16n8k16, fp32 accumulate) from bf16
// tiles in shared memory (ldmatrix); a warp takes (16 rows x 16 columns)
// output units in turn. Rows are padded to Tqp / Tkp (multiples of 16) with
// zeros, bf16 rows by 16 bytes (ldmatrix without bank conflicts). Blocks of
// four warps, eight an SM: the work of a block is small and mostly waits
// on its loads and barriers, which other blocks fill.

constexpr int kTcThreads = 128, kTcWarps = kTcThreads / 32;

__host__ __device__ inline int pad16(int n) { return round_up(n, 16); }

// The bf16 kernels' shared memory, in bytes from the block's base: the
// regions of each kernel (16-byte aligned).
struct TcLayout {
  int rows, oh, ps, pb, small, bytes;
};

// pre: q, k and t rows (bf16, dh + 8 a row); post: v rows and the one-hot
// rows (bf16, E padded to 16 and 8 more a row). Both: the logits, then the
// probs (fp32, Tk padded to 16 and 4 more a row), rnd(probs) or the
// modulated probs (bf16, 8 more a row), the key mask and qpos.
__host__ __device__ inline TcLayout tc_layout(int Tq, int Tk, int dh, int E, bool post) {
  const int tqp = pad16(Tq), tkp = pad16(Tk), sd = (dh + 8) * 2;
  TcLayout l;
  l.rows = 0;
  l.oh = round_up((post ? tkp : tqp + 2 * tkp) * sd, 16);
  l.ps = l.oh + (post ? round_up(tkp * (pad16(E) + 8) * 2, 16) : 0);
  l.pb = l.ps + round_up(tqp * (tkp + 4) * 4, 16);
  l.small = l.pb + round_up(tqp * (tkp + 8) * 2, 16);
  l.bytes = l.small + round_up((tkp + tqp) * 4, 16);
  return l;
}

// rows [0, n) of a bf16 (n x cols) source (row stride rs, 16-byte aligned
// rows) into dst (row stride ld bf16), 16 bytes a thread and step; rows
// [n, np) zero.
__device__ __forceinline__ void copy_rows_bf16(bf16* dst, int ld, const bf16* src, long long rs,
                                               int n, int np, int cols) {
  const int c8 = cols / 8;
  for (int i = threadIdx.x; i < np * c8; i += kTcThreads) {
    const int r = i / c8, c = (i - r * c8) * 8;
    *reinterpret_cast<uint4*>(dst + r * ld + c) =
        r < n ? __ldg(reinterpret_cast<const uint4*>(src + r * rs + c)) : make_uint4(0, 0, 0, 0);
  }
}

// acc (two n8 tiles: columns n0 .. n0 + 15) = A (16 rows at m0, row-major
// bf16, stride lda) B over K columns, B given as its rows [n][k] (stride
// ldb, `trans_b` false) or [k][n] (`trans_b` true).
template <bool kTransB>
__device__ __forceinline__ void mma_unit(float (&acc)[2][4], const bf16* A, int lda, int m0,
                                         const bf16* Bm, int ldb, int n0, int K, int lane) {
#pragma unroll
  for (int s = 0; s < 2; ++s)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[s][c] = 0.f;
  for (int k0 = 0; k0 < K; k0 += 16) {
    uint32_t a[4], bq[4];
    ldmatrix_x4(a, A + (m0 + (lane & 15)) * lda + k0 + (lane >> 4) * 8);
    if constexpr (kTransB)
      ldmatrix_x4_trans(bq, Bm + (k0 + ((lane >> 3) & 1) * 8 + (lane & 7)) * ldb + n0 +
                                (lane >> 4) * 8);
    else
      ldmatrix_x4(bq, Bm + (n0 + (lane >> 4) * 8 + (lane & 7)) * ldb + k0 + ((lane >> 3) & 1) * 8);
    mma_bf16(acc[0], a, bq[0], bq[1]);
    mma_bf16(acc[1], a, bq[2], bq[3]);
  }
}

// probs (fp32, to the scratch) and x = rnd(rnd(probs) @ t) (bf16 rows, to
// the scratch) of one (b, h).
template <int DH>
__global__ void __launch_bounds__(kTcThreads, 8) mau_fwd_pre_kernel(const Params p) {
  constexpr int SD = DH + 8;
  extern __shared__ __align__(16) unsigned char tc_smem[];
  const int b = blockIdx.x / p.H, h = blockIdx.x - b * p.H;
  const int Tq = p.Tq, Tk = p.Tk, tqp = pad16(Tq), tkp = pad16(Tk);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, g = lane >> 2, t4 = lane & 3;
  const int LP = tkp + 4, SP = tkp + 8;
  const TcLayout l = tc_layout(Tq, Tk, DH, p.E, false);
  bf16* qb = reinterpret_cast<bf16*>(tc_smem + l.rows);
  bf16* kb = qb + tqp * SD;
  bf16* tb = kb + tkp * SD;
  float* ps = reinterpret_cast<float*>(tc_smem + l.ps);
  bf16* pb = reinterpret_cast<bf16*>(tc_smem + l.pb);
  float* kms = reinterpret_cast<float*>(tc_smem + l.small);
  int* qps = reinterpret_cast<int*>(kms + tkp);
  const size_t row0 = ((size_t)b * p.H + h) * Tq;
  float* probs = p.probs + ((size_t)b * p.H + h) * round_up(Tq * Tk, 4);

  copy_rows_bf16(qb, SD, static_cast<const bf16*>(p.q) + b * p.q_bs + h * DH, p.q_rs, Tq, tqp, DH);
  copy_rows_bf16(kb, SD, static_cast<const bf16*>(p.k) + b * p.k_bs + h * DH, p.k_rs, Tk, tkp, DH);
  copy_rows_bf16(tb, SD, static_cast<const bf16*>(p.t) + b * p.t_bs + h * DH, p.t_rs, Tk, tkp, DH);
  for (int j = tid; j < Tk; j += kTcThreads) kms[j] = p.key_mask[(size_t)b * Tk + j];
  for (int i = tid; i < Tq; i += kTcThreads) qps[i] = p.qpos[(size_t)b * Tq + i];
  __syncthreads();

  // logits, masked: a hidden key NEG
  const int nu = tkp / 16;
  for (int u = warp; u < (tqp / 16) * nu; u += kTcWarps) {
    const int m0 = (u / nu) * 16, n0 = (u % nu) * 16;
    float acc[2][4];
    mma_unit<false>(acc, qb, SD, m0, kb, SD, n0, DH, lane);
#pragma unroll
    for (int s = 0; s < 2; ++s)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int i = m0 + g + 8 * (c >> 1), j = n0 + 8 * s + 2 * t4 + (c & 1);
        if (i < Tq && j < Tk)
          ps[i * LP + j] = (kms[j] == 0.f || (p.causal && j > qps[i])) ? kNeg : acc[s][c] * p.scale;
      }
  }
  __syncthreads();

  // softmax, one warp a row (a fully masked row is uniform over the Tk real
  // keys); probs out, rounded to bf16 for @t here (zero past Tk)
  for (int i = warp; i < tqp; i += kTcWarps) {
    const float* row = ps + i * LP;
    bf16* prow = pb + i * SP;
    if (i >= Tq) {
      for (int j = lane; j < tkp; j += 32) prow[j] = __float2bfloat16(0.f);
      continue;
    }
    float m = -INFINITY;
    for (int j = lane; j < Tk; j += 32) m = fmaxf(m, row[j]);
    for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
    float sum = 0.f;
    for (int j = lane; j < Tk; j += 32) sum += expf(row[j] - m);
    for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
    for (int j = lane; j < tkp; j += 32) {
      float pr = 0.f;
      if (j < Tk) {
        pr = expf(row[j] - m) / sum;
        probs[i * Tk + j] = pr;
      }
      prow[j] = __float2bfloat16(pr);
    }
  }
  __syncthreads();

  // x = rnd(rnd(probs) @ t)
  constexpr int NU = DH / 16;
  for (int u = warp; u < (tqp / 16) * NU; u += kTcWarps) {
    const int m0 = (u / NU) * 16, n0 = (u % NU) * 16;
    float acc[2][4];
    mma_unit<true>(acc, pb, SP, m0, tb, SD, n0, tkp, lane);
#pragma unroll
    for (int s = 0; s < 2; ++s)
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int i = m0 + g + 8 * hr, d = n0 + 8 * s + 2 * t4;
        if (i < Tq)
          *reinterpret_cast<__nv_bfloat162*>(p.x + (row0 + i) * DH + d) =
              __floats2bfloat162_rn(acc[s][2 * hr], acc[s][2 * hr + 1]);
      }
  }
}

// out = rnd(drop(iqk probs)) @ v of one (b, h), iqk = lam one-hot^T (BiMAU:
// 1 at qpos) with lam in fp32: three bf16 parts of it (split3_bf16x2) by
// the exact 0/1 one-hot.
template <int DH>
__global__ void __launch_bounds__(kTcThreads, 8) mau_fwd_post_kernel(const Params p) {
  constexpr int SD = DH + 8;
  extern __shared__ __align__(16) unsigned char tc_smem[];
  const int b = blockIdx.x / p.H, h = blockIdx.x - b * p.H;
  const int Tq = p.Tq, Tk = p.Tk, E = p.E, tqp = pad16(Tq), tkp = pad16(Tk), ep = pad16(E);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, g = lane >> 2, t4 = lane & 3;
  const int LP = tkp + 4, SP = tkp + 8, SE = ep + 8;
  const TcLayout l = tc_layout(Tq, Tk, DH, E, true);
  bf16* vb = reinterpret_cast<bf16*>(tc_smem + l.rows);
  bf16* ohb = reinterpret_cast<bf16*>(tc_smem + l.oh);
  float* ps = reinterpret_cast<float*>(tc_smem + l.ps);
  bf16* ub = reinterpret_cast<bf16*>(tc_smem + l.pb);
  int* qps = reinterpret_cast<int*>(tc_smem + l.small);
  const size_t row0 = ((size_t)b * p.H + h) * Tq;
  const float* probs = p.probs + ((size_t)b * p.H + h) * round_up(Tq * Tk, 4);

  copy_rows_bf16(vb, SD, static_cast<const bf16*>(p.v) + b * p.v_bs + h * DH, p.v_rs, Tk, tkp, DH);
  for (int idx = tid; idx < tkp * ep; idx += kTcThreads) {
    const int j = idx / ep, e = idx - j * ep;
    ohb[j * SE + e] =
        __float2bfloat16(j < Tk && e < E ? p.onehot[((size_t)b * Tk + j) * E + e] : 0.f);
  }
  for (int idx = tid; idx < Tq * Tk; idx += kTcThreads) {
    const int i = idx / Tk, j = idx - i * Tk;
    ps[i * LP + j] = probs[idx];
  }
  for (int i = tid; i < Tq; i += kTcThreads) qps[i] = p.qpos[(size_t)b * Tq + i];
  __syncthreads();

  // the modulated probs u = rnd(drop(iqk probs)), zero past Tq and Tk
  const Dropout drop = make_dropout(p.seed, p.drop_thresh, p.drop_scale);
  const int nu = tkp / 16;
  for (int u = warp; u < (tqp / 16) * nu; u += kTcWarps) {
    const int m0 = (u / nu) * 16, n0 = (u % nu) * 16;
    float acc[2][4];
#pragma unroll
    for (int s = 0; s < 2; ++s)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[s][c] = 0.f;
    for (int k0 = 0; k0 < ep; k0 += 16) {
      uint32_t a[3][4], bq[4];
#pragma unroll
      for (int f = 0; f < 4; ++f) {  // lam's A fragment, as three bf16 parts
        const int i = m0 + g + 8 * (f & 1), e = k0 + 8 * (f >> 1) + 2 * t4;
        const float* lr = p.lam + (row0 + i) * E;
        const bool ok = i < Tq;
        split3_bf16x2(ok && e < E ? __ldg(lr + e) : 0.f, ok && e + 1 < E ? __ldg(lr + e + 1) : 0.f,
                      a[0][f], a[1][f], a[2][f]);
      }
      ldmatrix_x4(bq, ohb + (n0 + (lane >> 4) * 8 + (lane & 7)) * SE + k0 + ((lane >> 3) & 1) * 8);
#pragma unroll
      for (int part = 2; part >= 0; --part) {  // lo, mid, hi
        mma_bf16(acc[0], a[part], bq[0], bq[1]);
        mma_bf16(acc[1], a[part], bq[2], bq[3]);
      }
    }
#pragma unroll
    for (int s = 0; s < 2; ++s)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int i = m0 + g + 8 * (c >> 1), j = n0 + 8 * s + 2 * t4 + (c & 1);
        float x = 0.f;
        if (i < Tq && j < Tk) {
          const float iqk = (p.diag_reset && j == qps[i]) ? 1.f : acc[s][c];
          x = iqk * ps[i * LP + j];
          if (drop.on) x *= drop.factor(b, h, i, j);
        }
        ub[i * SP + j] = __float2bfloat16(x);
      }
  }
  __syncthreads();

  // out = u @ v
  constexpr int NU = DH / 16;
  const int C = p.H * DH;
  bf16* out = static_cast<bf16*>(p.out) + (size_t)b * Tq * C + h * DH;
  for (int u = warp; u < (tqp / 16) * NU; u += kTcWarps) {
    const int m0 = (u / NU) * 16, n0 = (u % NU) * 16;
    float acc[2][4];
    mma_unit<true>(acc, ub, SP, m0, vb, SD, n0, tkp, lane);
#pragma unroll
    for (int s = 0; s < 2; ++s)
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int i = m0 + g + 8 * hr, d = n0 + 8 * s + 2 * t4;
        if (i < Tq)
          *reinterpret_cast<__nv_bfloat162*>(out + (size_t)i * C + d) =
              __floats2bfloat162_rn(acc[s][2 * hr], acc[s][2 * hr + 1]);
      }
  }
}

// fp32: the whole chain in one kernel. bf16: the attention side
// (mau_fwd_pre_kernel), the intensity head over every row (intensity_head.cuh,
// with its rounding kernel) and the modulation (mau_fwd_post_kernel); wd_b
// and side: the head's scratch (dh x E*dh bf16, 2 x E*dh fp32).
template <int DH>
cudaError_t launch(const Params& p, bf16* wd_b, float* side, cudaStream_t s) {
  const int blocks = p.B * p.H;
  if (!p.x)
    return go(mau_fwd_kernel<DH>, blocks, kThreads, smem_bytes(p.Tq, p.Tk, DH, p.E), s, p);
  cudaError_t e = go(mau_fwd_pre_kernel<DH>, blocks, kTcThreads,
                     (size_t)tc_layout(p.Tq, p.Tk, DH, p.E, false).bytes, s, p);
  if (e != cudaSuccess) return e;
  IntParams ip{};
  ip.x = p.x;
  ip.intervals = p.intervals;
  ip.bd = p.bd;
  ip.w = p.w;
  ip.scaling = p.scaling;
  ip.lam = p.lam;
  ip.raw = p.raw;
  ip.rows = p.B * p.H * p.Tq; ip.H = p.H; ip.Tq = p.Tq; ip.E = p.E;
  e = int_launch<true>(ip, p.wd, wd_b, side, DH, s);
  if (e != cudaSuccess) return e;
  return go(mau_fwd_post_kernel<DH>, blocks, kTcThreads,
            (size_t)tc_layout(p.Tq, p.Tk, DH, p.E, true).bytes, s, p);
}

// Dynamic shared memory of the largest kernel of a dtype's forward.
size_t fwd_smem_bytes(int Tq, int Tk, int dh, int E, int dtype) {
  if (!dtype) return smem_bytes(Tq, Tk, dh, E);
  return (size_t)imax(tc_layout(Tq, Tk, dh, E, false).bytes, tc_layout(Tq, Tk, dh, E, true).bytes);
}

}  // namespace

extern "C" {

// Dynamic shared memory the forward's largest block needs in `dtype` (0 =
// float32, 1 = bfloat16); above 232448 the kernels cannot run.
size_t mau_attention_fwd_smem_bytes(int Tq, int Tk, int dh, int E, int dtype) {
  return fwd_smem_bytes(Tq, Tk, dh, E, dtype);
}

// Launches on `stream` and returns cudaGetLastError() (0 on success).
// dtype: 0 = float32, 1 = bfloat16 (q, k, v, t and out); wd, bd, w and the
// other inputs are fp32. `raw` (may be null) receives the training residual;
// `seed` (an int64 on the device, or null for no dropout) keys the dropout
// mask. In bf16 the rows of q, k, v and t start on 16-byte boundaries, and
// the scratch: probs (B*H x Tq*Tk rounded up to 4, fp32), x (B*H*Tq*dh
// bf16), wd_b (dh*E*dh bf16) and side (2*E*dh fp32), 16-byte aligned; null
// in fp32.
int mau_attention_fwd(const void* q, long long q_bs, long long q_rs,
                      const void* k, long long k_bs, long long k_rs,
                      const void* v, long long v_bs, long long v_rs,
                      const void* t, long long t_bs, long long t_rs,
                      const void* key_mask, const void* intervals,
                      const void* qpos, const void* onehot, const void* wd,
                      const void* bd, const void* w, const void* scaling,
                      void* out, void* lam, void* raw, const void* seed,
                      unsigned drop_thresh, float drop_scale, void* probs_ws,
                      void* x_ws, void* wd_ws, void* side_ws, int B, int Tq,
                      int Tk, int H, int dh, int E, int causal, int diag_reset,
                      float scale, int dtype, void* stream) {
  if (Tq < 1 || Tk < Tq || Tk > 128 || E < 1 || B < 1 || H < 1 ||
      (dtype != 0 && dtype != 1) || (dtype == 1) != (x_ws != nullptr))
    return (int)cudaErrorInvalidValue;
  if (fwd_smem_bytes(Tq, Tk, dh, E, dtype) > kMaxSmem) return (int)cudaErrorInvalidValue;
  Params p;
  p.q = q; p.k = k; p.v = v; p.t = t;
  p.q_bs = q_bs; p.q_rs = q_rs; p.k_bs = k_bs; p.k_rs = k_rs;
  p.v_bs = v_bs; p.v_rs = v_rs; p.t_bs = t_bs; p.t_rs = t_rs;
  p.key_mask = static_cast<const float*>(key_mask);
  p.intervals = static_cast<const float*>(intervals);
  p.qpos = static_cast<const int*>(qpos);
  p.onehot = static_cast<const float*>(onehot);
  p.wd = static_cast<const float*>(wd);
  p.bd = static_cast<const float*>(bd);
  p.w = static_cast<const float*>(w);
  p.scaling = static_cast<const float*>(scaling);
  p.out = out;
  p.lam = static_cast<float*>(lam);
  p.raw = static_cast<float*>(raw);
  p.probs = static_cast<float*>(probs_ws);
  p.x = static_cast<bf16*>(x_ws);
  p.seed = static_cast<const long long*>(seed);
  p.drop_thresh = drop_thresh;
  p.drop_scale = drop_scale;
  p.scale = scale;
  p.B = B; p.Tq = Tq; p.Tk = Tk; p.H = H; p.E = E;
  p.causal = causal; p.diag_reset = diag_reset;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  bf16* wd_b = static_cast<bf16*>(wd_ws);
  float* side = static_cast<float*>(side_ws);
  switch (dh) {
    case 16: return (int)launch<16>(p, wd_b, side, s);
    case 32: return (int)launch<32>(p, wd_b, side, s);
    case 64: return (int)launch<64>(p, wd_b, side, s);
    case 128: return (int)launch<128>(p, wd_b, side, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

const char* mau_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

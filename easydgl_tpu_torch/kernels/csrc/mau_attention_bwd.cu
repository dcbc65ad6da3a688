// Fused MAU/BiMAU self-modulating attention, backward, for Hopper (sm_90a).
//
// Replaces the TPU kernel easydgl_tpu/kernels/mau_attention.py::_bwd_kernel
// (pallas_call in _mau_bwd). Given the forward's inputs, its residual raw
// (mau_attention_fwd.cu), the cotangents g_out (B, Tq, C) and g_lam
// (B, H, Tq, E) (the TPP regularizer's), and the dropout seed, it returns
// dq, dk, dv, dt in the input dtype and dWd, dbd, dw, dscaling in fp32:
//
//   dmod  = g_out v^T * drop;           dv = (iqk * probs * drop)^T g_out
//   dint  = dmod * probs (0 at the BiMAU diagonal); dprobs = dmod * iqk
//   dlam  = dint @ onehot + g_lam;      draw = dlam * sigmoid(raw / s)
//   dscaling += dlam * (softplus(raw/s) - sigmoid(raw/s) raw/s) * s
//   dz    = draw[e] * w * sig * (1 - sig),  sig = sigmoid(x Wd + bd)
//   dx    = dz Wd^T, dseq = dx[:, :dh]; dWd = x^T dz; dbd = sum dz;
//   dw    = sum draw[e] * sig
//   dprobs += dseq t^T;  dt = probs^T dseq
//   dlogit = probs * (dprobs - rowsum(dprobs * probs)), 0 where masked
//            (a fully masked row included), times 1/sqrt(dh)
//   dq = dlogit k;  dk = dlogit^T q
//
// What bounds it at the flagship train shape (B=512, H=8, Tq=Tk=31, dh=64,
// E=64; 126,976 rows of x = [su | interval]): the intensity head, three
// products of (rows x 65) by (65 x 4096) (z once, dx and dWd), ~203 GFLOP
// (0.21 ms at 989 TFLOP/s), and the sigmoids of 520 M entries: at one
// special-function op each, 0.124 ms of the SM's 16 such ops a clock
// (chip_smoke.py phase 4b); the exact form takes two. At the CTSMA train
// shape (B=512, H=4, Tq=Tk=30, dh=128: 61,440 rows by 129 lanes by E*dh =
// 8,192 columns) the same three products are ~390 GFLOP (0.39 ms) over 503
// M sigmoids.
//
// bf16 (the main path, every dh): three kernels.
//
// * mau_bwd_attn<kPre>: one block per (b, h, chunk of <= 32 query rows) on
//   the CUDA cores: probs from q and k, dmod, dv, dint, dlam, draw, d
//   scaling and x. It writes x (bf16, 64 lanes at dh <= 64, zero past dh;
//   128 at dh = 128), rnd(draw) transposed (bf16 (E, rows)), and probs and
//   dprobs = dmod iqk (fp32 (rows, Tk), 31 MB at the flagship shape) for
//   kPost, which reads them rather than recomputing the attention side.
// * mau_bwd_int_tc: the intensity head's three products on wgmma m64n64k16
//   with TMA-fed operands, z and dz formed once per (64-row tile, 64-column
//   tile). A block owns 128 columns of Wd (two consumer warpgroups, 64
//   each, and a producer warp) and a chunk of row tiles (mau_bwd_int_plan:
//   about eight waves of blocks). Its Wd tiles stay resident (two, or four
//   at dh = 128: each column tile's two 64-lane halves); each row tile's x
//   (one or two 64-lane halves), draw rows and intervals stream through a
//   three-stage ring. Per row tile a warpgroup forms z^T = Wd^T x^T (A:
//   Wd^T in registers at dh <= 64; at dh = 128 from the resident tiles,
//   MN-major, K = 128 in eight steps), sig (the exact form, two
//   special-function ops: see the kernel) and dz in packed bf16x2 at the
//   plain version's rounding points, sums dbd, dw and the interval lane of
//   dWd in registers, adds dWd^T += dz^T x (A: dz^T from the accumulators;
//   dWd^T, 64 columns by 64 lanes a half, stays in registers over the
//   chunk) and stores dz in shared memory; then each warpgroup forms dx^T
//   of 32 of the tile's rows over the block's 128 columns (A: the Wd tiles,
//   B: both warpgroups' dz), one 64-lane half at a time, and adds each half
//   to an fp32 (64 or 128 lanes, rows) workspace by TMA reduce-add
//   (cp.reduce.async.bulk). (Alternating whole tiles between the
//   warpgroups put that product in a branch, on which ptxas of CUDA 12.9
//   crashed.) Only one of the two sums can stay in registers.
//   Reduce traffic at the flagship shape:
//     (a) blocks own rows and loop over all 4,096 columns (dx in
//         registers), dWd^T added per (64-column tile, 128-row block): 64 x
//         992 x 16 KB = 1.04 GB, and dbd, dw, the interval lane by ~12 M
//         atomics;
//     (b) blocks own columns (dWd^T in registers), dx^T added per (64-row
//         tile, 128-column block): 32 x 1,984 x 16 KB = 1.04 GB; dWd^T 16 KB
//         a warpgroup and block at the end (35 MB), dbd, dw, the interval
//         lane by 0.4 M atomics.
//   This kernel is (b): the same traffic for dx, and the column sums stay
//   in registers. (a) was not built. At dh = 128 (CTSMA: 61,440 rows, E*dh
//   = 8,192) dx^T is twice as wide: 64 x 960 x 32 KB = 2.01 GB.
//   Registers at dh = 128: dWd^T (64 a thread), z^T (32), a dx^T half (16)
//   and the dz^T fragments (16) fit the 232 a consumer thread has; taking
//   z^T's A from shared memory spares the 32 of Wd^T's fragments, and one
//   dx^T half at a time the 16 of the other.
// * mau_bwd_attn<kPost>: reads probs, dprobs and dseq; dprobs += dseq t^T,
//   dt, dlogit, dq, dk on the CUDA cores.
//
// fp32 (the checks): mau_bwd_attn<kFull> (the whole attention side, and dx
// with z recomputed on the CUDA cores, intensity_bwd_scalar) then
// mau_bwd_weights (dWd, dbd, dw on the CUDA cores, z formed again).
//
// Precision contract (mirrors the TPU kernel): in bf16 mode the operands of
// every product are rounded to bf16 where the TPU kernel rounds them (probs,
// the modulated probs, g_out, x, Wd, dseq, dlogit), the (rows, E*dh)
// intermediates dsw = draw[e], dsig, dz and sig are bf16 (each product of
// two of them rounded), and all sums accumulate in fp32. In fp32 mode
// nothing is rounded and the sigmoid is exact.
//
// Limits: 1 <= Tq <= Tk <= 128, dh in {16, 32, 64, 128}, shared memory
// (mau_attention_bwd_smem_bytes: kPre's in bf16, kFull's in fp32) within
// 227 KB.

#include "hopper.cuh"

namespace {

using namespace port;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr float kNeg = -4294967295.0f;  // -(2^32) + 1, the reference mask
constexpr size_t kMaxSmem = 232448;
constexpr int kNC = 64;                 // Wd columns per chunk (intensity_bwd_scalar)
constexpr int kStageRows = 32;          // rows staged per pass (mau_bwd_weights)

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const void* t;
  const void* go;
  long long q_bs, q_rs, k_bs, k_rs, v_bs, v_rs, t_bs, t_rs, go_bs, go_rs;
  const float* key_mask;   // (B, Tk)
  const float* intervals;  // (B, Tq)
  const int* qpos;         // (B, Tq)
  const float* onehot;     // (B, Tk, E)
  const float* wd;         // (dh+1, E*dh) fp32
  const float* bd;         // (E*dh,)
  const float* w;          // (E*dh,) fp32
  const float* scaling;    // (E,)
  const float* raw;        // (B, H, Tq, E) forward residual
  const float* glam;       // (B, H, Tq, E)
  const long long* seed;   // null: no dropout
  unsigned drop_thresh;
  float drop_scale;
  void* dq;                // (B, Tq, C), input dtype
  void* dk;                // (B, Tk, C) x3, input dtype (one query chunk) ...
  void* dv;
  void* dt;
  float* dk_acc;           // ... or fp32 sums (several chunks), else null
  float* dv_acc;
  float* dt_acc;
  void* x_out;             // fp32 (rows, dh+1); tensor cores: bf16 (rows_pad, x_lanes(dh))
  void* draw_out;          // fp32 (rows, E); tensor cores: bf16 rnd(draw) (>= E, rows_pad)
  float* probs_ws;         // tensor cores: (rows, Tk) probs, kPre -> kPost
  float* dprobs_ws;        // tensor cores: (rows, Tk) dmod iqk
  float* dseq_ws;          // tensor cores: (x_lanes(dh), rows_pad) dseq^T sums, zeroed
  float* dscaling;         // (E,) fp32, summed atomically
  float* dwd;              // (dh+1, E*dh) fp32; tensor cores: dWd^T (>= E*dh, x_lanes(dh)), zeroed
  float* dwd_iv;           // tensor cores: (E*dh,) the interval lane of dWd, zeroed
  float* dbd;              // (E*dh,)
  float* dw;               // (E*dh,)
  float scale;
  int B, Tq, Tk, H, E, causal, diag_reset, qc, rows_per_chunk, tiles_per_chunk, rows_pad;
};

__host__ __device__ inline int row_stride(int dh) { return dh + 4; }
// Lanes of the tensor-core path's x rows, dseq^T and dWd^T: 64 (zero past
// dh) at dh <= 64, 128 at dh = 128; two 64-lane halves there.
__host__ __device__ constexpr int x_lanes(int dh) { return dh > 64 ? 128 : 64; }
__host__ __device__ constexpr int int_halves(int dh) { return x_lanes(dh) / 64; }
__host__ __device__ inline int event_stride(int E) { return round_up(E, 4) + 4; }

// The modes of mau_bwd_attn (see the kernel).
enum Mode { kFull = 0, kPre = 1, kPost = 2 };

// Shared-memory regions of mau_bwd_attn in `mode`, in floats, each a
// multiple of 4: kFull's phase 3 keeps a Wd chunk and a dz chunk in region
// v; kPre puts the v rows and the modulated probs in k's rows, dead after
// the logits, where they fit (region v empty); kPost has no v, g_out, lam
// or raw rows, and only dseq in region oh.
struct Layout {
  int k, t, v, q, go, p, lam, oh, dsc, small;
};

__host__ __device__ inline Layout layout(int qc, int Tk, int dh, int E, int mode) {
  const int ldh = row_stride(dh), lde = event_stride(E);
  const bool post = mode == kPost;
  Layout l;
  l.k = round_up(Tk * ldh, 4);
  l.t = l.k;
  // v rows (phase 2a), then the modulated probs (2b-2c), then in phase 3 a
  // Wd chunk and a dz chunk
  l.v = post || (mode == kPre && qc <= ldh)
            ? 0
            : round_up(imax(imax(Tk * ldh, qc * Tk),
                            mode == kFull ? (dh + 1) * (kNC + 1) + qc * (kNC + 1) : 0),
                       4);
  l.q = round_up(qc * ldh, 4);
  l.go = post ? 0 : l.q;            // g_out rows, then x (phase 3)
  l.p = round_up(qc * Tk, 4);       // x3: probs, dprobs, dint
  l.lam = post ? 0 : round_up(qc * lde, 4);  // x2: lam, raw -> draw
  l.oh = round_up(post ? qc * ldh : imax(Tk * lde, qc * ldh), 4);  // one-hot, then dseq
  l.dsc = round_up(E, 4);
  l.small = round_up(Tk + 2 * qc, 4);
  return l;
}

__host__ __device__ inline size_t smem_bytes(int qc, int Tk, int dh, int E, int mode) {
  const Layout l = layout(qc, Tk, dh, E, mode);
  return sizeof(float) *
         (size_t)(l.k + l.t + l.v + l.q + l.go + 3 * l.p + 2 * l.lam + l.oh + l.dsc + l.small);
}

// The most of it that a launch needs: kPre's and kPost's on the tensor-core
// path (kPre's is the larger), kFull's on the other.
inline size_t attn_smem_bytes(int qc, int Tk, int dh, int E, bool tc) {
  if (!tc) return smem_bytes(qc, Tk, dh, E, kFull);
  const size_t pre = smem_bytes(qc, Tk, dh, E, kPre), post = smem_bytes(qc, Tk, dh, E, kPost);
  return pre > post ? pre : post;
}

template <typename T>
__device__ __forceinline__ void load_rows(float* dst, int ld, const T* src, long long rs,
                                          int rows, int dh) {
  for (int i = threadIdx.x; i < rows * dh; i += kThreads) {
    const int r = i / dh, d = i - r * dh;
    dst[r * ld + d] = to_f(src[r * rs + d]);
  }
}

__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  return fmaf(a.w, b.w, fmaf(a.z, b.z, fmaf(a.y, b.y, fmaf(a.x, b.x, acc))));
}

// Store or accumulate one (Tk x dh) head slice of dk / dv / dt.
template <typename T>
__device__ __forceinline__ void put_key_grad(const Params& p, void* out, float* acc,
                                             int b, int h, int j, int d, float val, int dh) {
  const size_t off = ((size_t)b * p.Tk + j) * (size_t)(p.H * dh) + h * dh + d;
  if (acc) {
    atomicAdd(acc + off, val);
  } else {
    static_cast<T*>(out)[off] = from_f<T>(val);
  }
}

// dz of one z entry: sig = sigmoid(z + bd), dz = dsw w sig (1 - sig), at the
// bf16 rounding points of the TPU kernel (mau_attention.py:468-479).
template <typename T>
__device__ __forceinline__ float dz_of(float z, float bdv, float dsw, float wr, float* sig_out) {
  const float sig = rnd<T>(sigmoid(z + bdv));
  *sig_out = sig;
  const float dsig = rnd<T>(dsw * wr);
  return rnd<T>(rnd<T>(dsig * sig) * rnd<T>(1.f - sig));
}

// dseq (nq x DH, stride ldh) = (dz Wd^T)[:, :DH] on CUDA cores: z recomputed
// chunk by chunk of kNC Wd columns through shared memory (wdc, dzc).
template <typename T, int DH>
__device__ void intensity_bwd_scalar(const Params& p, const float* xs, int ldh,
                                     const float* rd_s, int lde, int nq, float* wdc,
                                     float* dzc, float* dseq) {
  const int tid = threadIdx.x, EDH = p.E * DH;
  constexpr int kDxPer = (32 * DH + kThreads - 1) / kThreads;
  float dxr[kDxPer];
#pragma unroll
  for (int m = 0; m < kDxPer; ++m) dxr[m] = 0.f;
  const int zc = tid % kNC, zr0 = tid / kNC;  // z: column zc, rows zr0 + 4m
  for (int c0 = 0; c0 < EDH; c0 += kNC) {
    __syncthreads();  // previous chunk consumed
    for (int idx = tid; idx < (DH + 1) * kNC; idx += kThreads) {
      const int kk = idx / kNC, c = idx - kk * kNC;
      wdc[kk * (kNC + 1) + c] = rnd<T>(p.wd[(size_t)kk * EDH + c0 + c]);
    }
    __syncthreads();
    {
      const int col = c0 + zc, e = col / DH;
      const float bdv = p.bd[col], wr = rnd<T>(p.w[col]);
      for (int i = zr0; i < nq; i += kThreads / kNC) {
        const float* xr = xs + i * ldh;
        float z0 = 0.f, z1 = 0.f, z2 = 0.f, z3 = 0.f;
        int kk = 0;
        for (; kk + 3 < DH + 1; kk += 4) {
          z0 = fmaf(xr[kk], wdc[kk * (kNC + 1) + zc], z0);
          z1 = fmaf(xr[kk + 1], wdc[(kk + 1) * (kNC + 1) + zc], z1);
          z2 = fmaf(xr[kk + 2], wdc[(kk + 2) * (kNC + 1) + zc], z2);
          z3 = fmaf(xr[kk + 3], wdc[(kk + 3) * (kNC + 1) + zc], z3);
        }
        for (; kk < DH + 1; ++kk) z0 = fmaf(xr[kk], wdc[kk * (kNC + 1) + zc], z0);
        float sig;
        dzc[i * (kNC + 1) + zc] =
            dz_of<T>((z0 + z1) + (z2 + z3), bdv, rnd<T>(rd_s[i * lde + e]), wr, &sig);
      }
    }
    __syncthreads();
#pragma unroll
    for (int m = 0; m < kDxPer; ++m) {
      const int idx = tid + m * kThreads;
      const int i = idx / DH, d = idx - i * DH;
      if (i < nq) {
        const float* zr = dzc + i * (kNC + 1);
        const float* wr = wdc + d * (kNC + 1);
        float acc = dxr[m];
        for (int c = 0; c < kNC; ++c) acc = fmaf(zr[c], wr[c], acc);
        dxr[m] = acc;
      }
    }
  }
#pragma unroll
  for (int m = 0; m < kDxPer; ++m) {
    const int idx = tid + m * kThreads;
    const int i = idx / DH, d = idx - i * DH;
    if (i < nq) dseq[i * ldh + d] = dxr[m];
  }
}

// The attention side, one block per (b, h, chunk of <= 32 query rows), in
// one of three modes:
//
// * kFull (fp32): the whole backward of its rows: probs
//   from q and k, everything of the attention side, dlam, draw and d
//   scaling, dx on the CUDA cores (intensity_bwd_scalar), and it writes x =
//   [su | interval] and draw for mau_bwd_weights.
// * kPre (bf16), before mau_bwd_int_tc: probs, dv, dlam, draw, d scaling
//   and x; writes x (bf16 rows x_lanes(DH) wide, zero past dh), rnd(draw)
//   transposed (E, rows) in bf16, and probs and dprobs = dmod iqk (fp32
//   (rows, Tk)) for kPost.
// * kPost (bf16), after it: reads probs, dprobs and dseq (the fp32
//   (x_lanes(DH), rows) sums of mau_bwd_int_tc), and forms dt, dlogit, dq,
//   dk.

template <typename T, int DH, int MODE>
__global__ void __launch_bounds__(kThreads, MODE == kFull ? 1 : 3) mau_bwd_attn(const Params p) {
  extern __shared__ __align__(16) float smem[];
  constexpr int ldh = DH + 4;
  constexpr int D4 = DH / 4;
  const int nchunks = (p.Tq + p.qc - 1) / p.qc;
  const int bh = blockIdx.x / nchunks, chunk = blockIdx.x - bh * nchunks;
  const int b = bh / p.H, h = bh - b * p.H;
  const int i0 = chunk * p.qc, nq = imin(p.qc, p.Tq - i0);
  const int Tk = p.Tk, E = p.E;
  const int lde = event_stride(E), E4 = round_up(E, 4) / 4;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const Layout l = layout(p.qc, Tk, DH, E, MODE);

  float* ks = smem;
  float* ts = ks + l.k;
  float* vs = MODE == kPre && l.v == 0 ? ks : ts + l.t;  // phase 2a
  float* ms = vs;             // modulated probs, phase 2b-2c
  float* wdc = vs;            // Wd chunk (DH+1) x (kNC+1), phase 3 (kFull)
  float* dzc = vs + (DH + 1) * (kNC + 1);  // dz chunk nq x (kNC+1)
  float* qs = ts + l.t + l.v;
  float* gos = qs + l.q;      // g_out rows (phase 2), then x (phase 3-)
  float* xs = gos;
  float* ps = gos + l.go;     // probs
  float* dps = ps + l.p;      // dmod, then dprobs, then dlogit
  float* dis = dps + l.p;     // dint
  float* lam_s = dis + l.p;
  float* rd_s = lam_s + l.lam;  // raw, then draw
  float* oh_s = rd_s + l.lam;   // one-hot rows, then dseq
  float* dseq = oh_s;
  float* dsc_s = oh_s + l.oh;
  float* kms = dsc_s + l.dsc;
  float* ivs = kms + Tk;
  int* qps = reinterpret_cast<int*>(ivs + p.qc);

  const T* qg = static_cast<const T*>(p.q) + b * p.q_bs + (long long)i0 * p.q_rs + h * DH;
  const T* kg = static_cast<const T*>(p.k) + b * p.k_bs + h * DH;
  const T* vg = static_cast<const T*>(p.v) + b * p.v_bs + h * DH;
  const T* tg = static_cast<const T*>(p.t) + b * p.t_bs + h * DH;
  const T* gog = static_cast<const T*>(p.go) + b * p.go_bs + (long long)i0 * p.go_rs + h * DH;
  const size_t row0 = ((size_t)b * p.H + h) * p.Tq + i0;  // first (b, h, i) row

  // ---- phase 1: probs (kPost: probs and dprobs from kPre)
  load_rows<T>(qs, ldh, qg, p.q_rs, nq, DH);
  load_rows<T>(ks, ldh, kg, p.k_rs, Tk, DH);
  load_rows<T>(ts, ldh, tg, p.t_rs, Tk, DH);
  for (int j = tid; j < Tk; j += kThreads) kms[j] = p.key_mask[(size_t)b * Tk + j];
  for (int i = tid; i < nq; i += kThreads) {
    ivs[i] = p.intervals[(size_t)b * p.Tq + i0 + i];
    qps[i] = p.qpos[(size_t)b * p.Tq + i0 + i];
  }
  if constexpr (MODE == kPost) {
    for (int idx = tid; idx < nq * Tk; idx += kThreads) {
      ps[idx] = p.probs_ws[row0 * Tk + idx];
      dps[idx] = p.dprobs_ws[row0 * Tk + idx];
    }
  } else {
    for (int e = tid; e < l.dsc; e += kThreads) dsc_s[e] = 0.f;
    __syncthreads();
    for (int idx = tid; idx < nq * Tk; idx += kThreads) {
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
    for (int i = warp; i < nq; i += kWarps) {
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

    // ---- phase 2: g_out side. dmod = g_out v^T; lam from raw; one-hot rows
    load_rows<T>(vs, ldh, vg, p.v_rs, Tk, DH);
    load_rows<T>(gos, ldh, gog, p.go_rs, nq, DH);
    const float* rawg = p.raw + row0 * E;
    for (int idx = tid; idx < nq * E4 * 4; idx += kThreads) {
      const int i = idx / (E4 * 4), e = idx - i * E4 * 4;
      float lv = 0.f, rv = 0.f;
      if (e < E) {
        const float s = expf(p.scaling[e]);
        rv = rawg[i * E + e];
        lv = s * softplus(rv / s);
      }
      lam_s[i * lde + e] = lv;
      rd_s[i * lde + e] = rv;
    }
    for (int idx = tid; idx < Tk * E4 * 4; idx += kThreads) {
      const int j = idx / (E4 * 4), e = idx - j * E4 * 4;
      oh_s[j * lde + e] = e < E ? p.onehot[((size_t)b * Tk + j) * E + e] : 0.f;
    }
    __syncthreads();
    for (int idx = tid; idx < nq * Tk; idx += kThreads) {
      const int i = idx / Tk, j = idx - i * Tk;
      const float4* ga = reinterpret_cast<const float4*>(gos + i * ldh);
      const float4* va = reinterpret_cast<const float4*>(vs + j * ldh);
      float acc = 0.f;
#pragma unroll
      for (int d = 0; d < D4; ++d) acc = dot4(ga[d], va[d], acc);
      dps[idx] = acc;
    }
    __syncthreads();  // v rows are dead from here: ms takes their place

    // elementwise: modulated (for dv), dprobs = dmod*iqk, dint = dmod*probs
    const Dropout drop = make_dropout(p.seed, p.drop_thresh, p.drop_scale);
    for (int idx = tid; idx < nq * Tk; idx += kThreads) {
      const int i = idx / Tk, j = idx - i * Tk;
      const bool diag = p.diag_reset && j == qps[i];
      float iqk = 1.f;
      if (!diag) {
        const float4* la = reinterpret_cast<const float4*>(lam_s + i * lde);
        const float4* oa = reinterpret_cast<const float4*>(oh_s + j * lde);
        iqk = 0.f;
        for (int e = 0; e < E4; ++e) iqk = dot4(la[e], oa[e], iqk);
      }
      const float f = drop.on ? drop.factor(b, h, i0 + i, j) : 1.f;
      const float pr = ps[idx];
      ms[idx] = rnd<T>(iqk * pr * f);
      const float dm = dps[idx] * f;
      dps[idx] = dm * iqk;
      dis[idx] = diag ? 0.f : dm * pr;
      if constexpr (MODE == kPre) {
        p.probs_ws[row0 * Tk + idx] = pr;
        p.dprobs_ws[row0 * Tk + idx] = dm * iqk;
      }
    }
    __syncthreads();

    // dv = modulated^T g_out
    for (int idx = tid; idx < Tk * DH; idx += kThreads) {
      const int j = idx / DH, d = idx - j * DH;
      float acc = 0.f;
      for (int i = 0; i < nq; ++i) acc = fmaf(ms[i * Tk + j], gos[i * ldh + d], acc);
      put_key_grad<T>(p, p.dv, p.dv_acc, b, h, j, d, acc, DH);
    }
    // dlam = dint @ onehot + g_lam; draw = dlam * sigmoid(raw/s); d scaling
    const float* glg = p.glam + row0 * E;
    for (int idx = tid; idx < nq * E; idx += kThreads) {
      const int i = idx / E, e = idx - i * E;
      float dl = glg[i * E + e];
      for (int j = 0; j < Tk; ++j) dl = fmaf(dis[i * Tk + j], oh_s[j * lde + e], dl);
      const float s = expf(p.scaling[e]);
      const float r = rd_s[i * lde + e] / s;
      const float sr = 1.f / (1.f + expf(-r));
      const float dr = dl * sr;
      rd_s[i * lde + e] = dr;
      if constexpr (MODE == kPre)  // rnd(draw), transposed for the tensor-core kernel
        static_cast<__nv_bfloat16*>(p.draw_out)[(size_t)e * p.rows_pad + row0 + i] =
            __float2bfloat16(dr);
      else
        static_cast<float*>(p.draw_out)[(row0 + i) * E + e] = dr;
      atomicAdd(dsc_s + e, dl * (softplus(r) - sr * r) * s);
    }
    __syncthreads();  // g_out rows and the one-hot rows are dead from here
    for (int e = tid; e < E; e += kThreads) atomicAdd(p.dscaling + e, dsc_s[e]);

    // ---- phase 3: x = [probs @ t | interval] (rounded)
    if constexpr (MODE == kPre) {  // the seq_units lanes, x_lanes(DH) wide, zero past DH
      constexpr int XL = x_lanes(DH);
      __nv_bfloat16* xg = static_cast<__nv_bfloat16*>(p.x_out) + row0 * XL;
      for (int idx = tid; idx < nq * XL; idx += kThreads) {
        const int i = idx / XL, d = idx - i * XL;
        float acc = 0.f;
        if (d < DH)
          for (int j = 0; j < Tk; ++j) acc = fmaf(rnd<T>(ps[i * Tk + j]), ts[j * ldh + d], acc);
        xg[(size_t)i * XL + d] = __float2bfloat16(acc);
      }
      return;
    }
    for (int idx = tid; idx < nq * (DH + 1); idx += kThreads) {
      const int i = idx / (DH + 1), d = idx - i * (DH + 1);
      float acc;
      if (d < DH) {
        acc = 0.f;
        for (int j = 0; j < Tk; ++j) acc = fmaf(rnd<T>(ps[i * Tk + j]), ts[j * ldh + d], acc);
      } else {
        acc = ivs[i];
      }
      acc = rnd<T>(acc);
      xs[i * ldh + d] = acc;
      static_cast<float*>(p.x_out)[(row0 + i) * (DH + 1) + d] = acc;
    }
    __syncthreads();
    intensity_bwd_scalar<T, DH>(p, xs, ldh, rd_s, lde, nq, wdc, dzc, dseq);
  }
  if constexpr (MODE == kPost) {
    for (int idx = tid; idx < nq * DH; idx += kThreads) {
      const int i = idx / DH, d = idx - i * DH;
      dseq[i * ldh + d] = p.dseq_ws[(size_t)d * p.rows_pad + row0 + i];
    }
  }
  __syncthreads();
  // dseq is rounded once to the compute dtype: both of its uses take it so
  for (int idx = tid; idx < nq * DH; idx += kThreads) {
    const int i = idx / DH, d = idx - i * DH;
    dseq[i * ldh + d] = rnd<T>(dseq[i * ldh + d]);
  }
  __syncthreads();

  // ---- phase 4: dprobs += dseq t^T; dt = probs^T dseq
  for (int idx = tid; idx < nq * Tk; idx += kThreads) {
    const int i = idx / Tk, j = idx - i * Tk;
    const float4* da = reinterpret_cast<const float4*>(dseq + i * ldh);
    const float4* ta = reinterpret_cast<const float4*>(ts + j * ldh);
    float acc = dps[idx];
#pragma unroll
    for (int d = 0; d < D4; ++d) acc = dot4(da[d], ta[d], acc);
    dps[idx] = acc;
  }
  for (int idx = tid; idx < Tk * DH; idx += kThreads) {
    const int j = idx / DH, d = idx - j * DH;
    float acc = 0.f;
    for (int i = 0; i < nq; ++i) acc = fmaf(rnd<T>(ps[i * Tk + j]), dseq[i * ldh + d], acc);
    put_key_grad<T>(p, p.dt, p.dt_acc, b, h, j, d, acc, DH);
  }
  __syncthreads();
  // softmax backward, one warp per row; masked entries (a fully masked row
  // included) get no gradient
  for (int i = warp; i < nq; i += kWarps) {
    float* dr = dps + i * Tk;
    const float* pr = ps + i * Tk;
    float sum = 0.f;
    for (int j = lane; j < Tk; j += 32) sum = fmaf(dr[j], pr[j], sum);
    for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
    for (int j = lane; j < Tk; j += 32) {
      const bool valid = kms[j] != 0.f && !(p.causal && j > qps[i]);
      dr[j] = valid ? rnd<T>(pr[j] * (dr[j] - sum) * p.scale) : 0.f;
    }
  }
  __syncthreads();
  const int C = p.H * DH;
  T* dqg = static_cast<T*>(p.dq) + ((size_t)b * p.Tq + i0) * C + h * DH;
  for (int idx = tid; idx < nq * DH; idx += kThreads) {
    const int i = idx / DH, d = idx - i * DH;
    float acc = 0.f;
    for (int j = 0; j < Tk; ++j) acc = fmaf(dps[i * Tk + j], ks[j * ldh + d], acc);
    dqg[(size_t)i * C + d] = from_f<T>(acc);
  }
  for (int idx = tid; idx < Tk * DH; idx += kThreads) {
    const int j = idx / DH, d = idx - j * DH;
    float acc = 0.f;
    for (int i = 0; i < nq; ++i) acc = fmaf(dps[i * Tk + j], qs[i * ldh + d], acc);
    put_key_grad<T>(p, p.dk, p.dk_acc, b, h, j, d, acc, DH);
  }
}

// dWd, dbd, dw (kFull's second kernel): thread = one Wd column, block = kThreads columns x one chunk
// of rows. Wd's column stays in registers for dh <= 64 (in shared memory
// above, where registers run out).
template <typename T, int DH>
__global__ void __launch_bounds__(kThreads, 1) mau_bwd_weights(const Params p) {
  constexpr int K = DH + 1;
  constexpr int XS = (K + 3) / 4 * 4;
  constexpr bool kRegWd = DH <= 64;
  extern __shared__ __align__(16) float smem[];
  float* xst = smem;                       // kStageRows x XS
  float* dst = xst + kStageRows * XS;      // kStageRows x E (draw)
  float* wds = dst + kStageRows * round_up(p.E, 4);  // K x kThreads (dh > 64)
  const int tid = threadIdx.x;
  const int EDH = p.E * DH;
  const int col = blockIdx.x * kThreads + tid;
  const bool valid = col < EDH;
  const int colc = valid ? col : EDH - 1;
  const int e = colc / DH;
  const int E4 = round_up(p.E, 4);
  float wreg[kRegWd ? K : 1];
  float acc[K];
#pragma unroll
  for (int kk = 0; kk < K; ++kk) {
    const float wv = rnd<T>(p.wd[(size_t)kk * EDH + colc]);
    if constexpr (kRegWd) wreg[kk] = wv; else wds[kk * kThreads + tid] = wv;
    acc[kk] = 0.f;
  }
  const float bdv = p.bd[colc], wr = rnd<T>(p.w[colc]);
  float dbd_acc = 0.f, dw_acc = 0.f;
  const long long rows = (long long)p.B * p.H * p.Tq;
  const long long r_begin = (long long)blockIdx.y * p.rows_per_chunk;
  const long long r_end = r_begin + p.rows_per_chunk < rows ? r_begin + p.rows_per_chunk : rows;
  for (long long r0 = r_begin; r0 < r_end; r0 += kStageRows) {
    const int nr = (int)(r_end - r0 < kStageRows ? r_end - r0 : kStageRows);
    __syncthreads();
    for (int idx = tid; idx < nr * K; idx += kThreads) {
      const int r = idx / K, kk = idx - r * K;
      xst[r * XS + kk] = static_cast<const float*>(p.x_out)[(r0 + r) * K + kk];
    }
    for (int idx = tid; idx < nr * p.E; idx += kThreads) {
      const int r = idx / p.E, ee = idx - r * p.E;
      dst[r * E4 + ee] = static_cast<const float*>(p.draw_out)[(r0 + r) * p.E + ee];
    }
    __syncthreads();
    for (int r = 0; r < nr; ++r) {
      const float* xr = xst + r * XS;
      float z[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int kk = 0; kk < K; ++kk) {
        const float wv = kRegWd ? wreg[kRegWd ? kk : 0] : wds[kk * kThreads + tid];
        z[kk & 3] = fmaf(xr[kk], wv, z[kk & 3]);
      }
      const float sig = rnd<T>(sigmoid((z[0] + z[1]) + (z[2] + z[3]) + bdv));
      const float dsw = rnd<T>(dst[r * E4 + e]);
      dw_acc += rnd<T>(dsw * sig);
      const float dsig = rnd<T>(dsw * wr);
      const float dz = rnd<T>(rnd<T>(dsig * sig) * rnd<T>(1.f - sig));
      dbd_acc += dz;
#pragma unroll
      for (int kk = 0; kk < K; ++kk) acc[kk] = fmaf(xr[kk], dz, acc[kk]);
    }
  }
  if (valid) {
#pragma unroll
    for (int kk = 0; kk < K; ++kk) atomicAdd(p.dwd + (size_t)kk * EDH + col, acc[kk]);
    atomicAdd(p.dbd + col, dbd_acc);
    atomicAdd(p.dw + col, dw_acc);
  }
}

// ---------------------------------------------------------------- intensity head, bf16
// mau_bwd_int_tc (see the header): warpgroups 0 and 1 consume, one
// 64-column tile of Wd each; the first warp of warpgroup 2 produces.

constexpr int kIntStages = 3;
constexpr int kIntGroups = 2;                         // consumer warpgroups
constexpr int kIntCols = 64 * kIntGroups;             // Wd columns a block
constexpr int kIntThreads = 128 * (kIntGroups + 1);   // and a producer warpgroup
constexpr int kIntEventsMax = kIntCols / 16;          // events a block at dh = 16
// A consumer thread holds z^T (32 fp32), dWd^T (32 a 64-lane half), a dx^T
// half (16), the dz^T fragments (16), at dh <= 64 the Wd^T fragments (16),
// and its columns' sums; 40 + 2 x 232 of a warpgroup thread fit the 65,536
// of an SM.
constexpr int kIntProducerRegs = 40, kIntConsumerRegs = 232;
constexpr int kTile = 64 * 64;                        // bf16 values of a (64 x 64) tile, 8 KB

// Dynamic shared memory of mau_bwd_int_tc<dh>, in bytes: the block's Wd
// tiles (two column tiles by int_halves(dh) lane halves); per stage x's
// lane halves, the draw rows of the block's events and the intervals; dz^T
// of both warpgroups, double-buffered; an fp32 (64 x 64) staging tile a
// warpgroup for the reductions; the mbarriers; 1 KB slack. 109 KB at dh <=
// 64, 149 KB at dh = 128.
__host__ __device__ constexpr size_t int_smem_bytes(int dh) {
  return 1024 +
         sizeof(__nv_bfloat16) * kTile * (int_halves(dh) * (kIntGroups + kIntStages) + 2 * kIntGroups) +
         sizeof(float) * kTile * kIntGroups +
         kIntStages * (sizeof(__nv_bfloat16) * kIntEventsMax * 64 + sizeof(float) * 64) +
         8 * (1 + 2 * kIntStages);
}

struct IntMaps {
  CUtensorMap wd;    // bf16 Wd (x_lanes, E*dh): boxes 64 lanes x 64 columns
  CUtensorMap x;     // bf16 x (rows, x_lanes): boxes 64 rows x 64 lanes
  CUtensorMap draw;  // bf16 rnd(draw) (E, rows): boxes of the block's events x 64 rows
  CUtensorMap dseq;  // fp32 dseq^T workspace (x_lanes, rows): boxes 64 lanes x 32 rows
  CUtensorMap dwd;   // fp32 dWd^T workspace (E*dh, x_lanes): boxes 64 columns x 32 lanes
};


__device__ __forceinline__ uint32_t bits2(__nv_bfloat162 v) {
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  return bits2(__floats2bfloat162_rn(lo, hi));
}

// A (64 x 32) fp32 warpgroup accumulator (rows r: the thread's 16 warp + g
// (+8); columns 8 n + 2 t4 (+1)) into st in the 128-byte swizzle (column
// 8 m + 2 t4 is 16-byte chunk 2 m + t4 / 2), as the reduce-add boxes read
// it.
__device__ __forceinline__ void stage_half(float* st, const float (&d)[16], int warp, int lane) {
  const int g = lane >> 2, t4 = lane & 3;
#pragma unroll
  for (int n = 0; n < 4; ++n)
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int r = 16 * warp + g + 8 * hr, chunk = (2 * n + (t4 >> 1)) ^ g;
      *reinterpret_cast<float2*>(reinterpret_cast<unsigned char*>(st) + r * 128 + (chunk << 4) +
                                 8 * (t4 & 1)) = make_float2(d[4 * n + 2 * hr], d[4 * n + 2 * hr + 1]);
    }
}

template <int DH>
__global__ void __launch_bounds__(kIntThreads, 1)
    mau_bwd_int_tc(const Params p, const __grid_constant__ IntMaps maps) {
  using bf16 = __nv_bfloat16;
  constexpr int KH = int_halves(DH);  // 64-lane halves of x and of each Wd column tile
  constexpr int EPB = kIntCols / DH;  // events a block
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* base = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  bf16* wds = reinterpret_cast<bf16*>(base);         // [group][half][64 lanes][64 columns]
  bf16* xs = wds + kIntGroups * KH * kTile;          // [stage][half][64 rows][64 lanes]
  bf16* dzt = xs + kIntStages * KH * kTile;          // [buffer][group][64 rows][64 columns]
  float* stg = reinterpret_cast<float*>(dzt + 2 * kIntGroups * kTile);  // [group][2][64][32]
  // [stage][EPB events][64 rows], 128-byte swizzle
  bf16* drs = reinterpret_cast<bf16*>(stg + kIntGroups * kTile);
  float* ivs = reinterpret_cast<float*>(drs + kIntStages * kIntEventsMax * 64);  // [stage][64]
  uint64_t* wd_full = reinterpret_cast<uint64_t*>(ivs + kIntStages * 64);
  uint64_t* full = wd_full + 1;          // [stage]
  uint64_t* empty = full + kIntStages;   // [stage]

  const int EDH = p.E * DH, rows = p.B * p.H * p.Tq;
  const int cb = blockIdx.x, c0 = cb * kIntCols, e0 = c0 / DH;
  const int tiles = (rows + 63) / 64;
  const int t_begin = blockIdx.y * p.tiles_per_chunk;
  const int ntiles = imin(p.tiles_per_chunk, tiles - t_begin);
  const int lane = threadIdx.x & 31;
  int warp = threadIdx.x >> 5;
  if (ntiles <= 0) return;
  if (threadIdx.x == 0) {
    mbar_init(wd_full, 1);
    for (int s = 0; s < kIntStages; ++s) {
      mbar_init(full + s, 32);
      mbar_init(empty + s, 128 * kIntGroups);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (warp >= 4 * kIntGroups) {  // ---- producer: its first warp works
    regs_dec<kIntProducerRegs>();
    if (warp > 4 * kIntGroups) return;
    if (lane == 0) {
      mbar_arrive_tx(wd_full, kIntGroups * KH * kTile * sizeof(bf16));
      for (int w = 0; w < kIntGroups; ++w)
        for (int lh = 0; lh < KH; ++lh)
          tma_2d(wds + (w * KH + lh) * kTile, &maps.wd, wd_full, c0 + 64 * w, 64 * lh);
    }
    for (int it = 0; it < ntiles; ++it) {
      const int s = it % kIntStages, r0 = (t_begin + it) * 64;
      mbar_wait(empty + s, ((it / kIntStages) & 1) ^ 1);
      for (int r = lane; r < 64; r += 32) {  // the interval lane of x, rounded
        const int row = r0 + r;
        ivs[s * 64 + r] = row < rows ? rnd<bf16>(p.intervals[(size_t)(row / (p.H * p.Tq)) * p.Tq +
                                                             row % p.Tq])
                                     : 0.f;
      }
      if (lane == 0) {
        mbar_arrive_tx(full + s, (KH * kTile + EPB * 64) * sizeof(bf16));
        for (int lh = 0; lh < KH; ++lh) tma_2d(xs + (s * KH + lh) * kTile, &maps.x, full + s, 64 * lh, r0);
        tma_2d(drs + s * kIntEventsMax * 64, &maps.draw, full + s, r0, e0);
      } else {
        mbar_arrive(full + s);
      }
    }
    return;
  }

  // ---- consumers: warpgroup wg owns columns n0 = c0 + 64 wg ..; thread
  // (warp, g, t4) holds columns n0 + 16 warp + g (+8) and, of a row tile,
  // rows 8 n + 2 t4 (+1): entry (column hm, row n, c) at zt[4 n + 2 hm + c]
  regs_inc<kIntConsumerRegs>();
  const int wg = warp >> 2, n0 = c0 + 64 * wg;
  warp &= 3;
  const int g = lane >> 2, t4 = lane & 3;
  const bool issuer = (threadIdx.x & 127) == 0;  // of the warpgroup's reductions
  float* stw = stg + wg * kTile;
  // dh <= 64: Wd^T of the warp's columns as A fragments: k step kk (lanes
  // 16 kk ..), entry i at column n0 + 16 warp + g + 8 (i & 1), lanes 16 kk +
  // 8 (i >> 1) + 2 t4 (+1); rounded to bf16, zero past dh and past E*dh.
  // dh = 128: z^T's A is read from the resident Wd tiles instead.
  uint32_t wf[KH == 1 ? 16 : 1];
  if constexpr (KH == 1) {
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int col = n0 + 16 * warp + g + 8 * (i & 1), ln = 16 * kk + 8 * (i >> 1) + 2 * t4;
        const bool ok = col < EDH;
        wf[4 * kk + i] = pack2(ok && ln < DH ? p.wd[(size_t)ln * EDH + col] : 0.f,
                               ok && ln + 1 < DH ? p.wd[(size_t)(ln + 1) * EDH + col] : 0.f);
      }
  }
  // the thread's columns: bd, rnd(w), rnd(Wd[dh]) (the interval lane), the
  // event's row in the stage's draw rows, and the sums over rows
  float bdv[2], wiv[2], dw[2] = {0.f, 0.f}, dbd[2] = {0.f, 0.f}, giv[2] = {0.f, 0.f};
  __nv_bfloat162 wr2[2];
  int el[2];
#pragma unroll
  for (int hm = 0; hm < 2; ++hm) {
    const int m = 16 * warp + g + 8 * hm, col = n0 + m;
    const bool ok = col < EDH;
    bdv[hm] = ok ? p.bd[col] : 0.f;
    const float wv = ok ? p.w[col] : 0.f;
    wr2[hm] = __floats2bfloat162_rn(wv, wv);
    wiv[hm] = ok ? rnd<bf16>(p.wd[(size_t)DH * EDH + col]) : 0.f;
    el[hm] = (64 * wg + m) / DH;
  }
  const uint64_t wdd = sw128_desc(wds);
  const uint64_t wda = wdd + 512 * KH * wg;  // the warpgroup's column tile, its lane halves
  float gwd[KH][32];  // dWd^T of lane half lh at (column, lane 64 lh + 8 n + 2 t4 + c)
#pragma unroll
  for (int lh = 0; lh < KH; ++lh)
#pragma unroll
    for (int i = 0; i < 32; ++i) gwd[lh][i] = 0.f;
  const __nv_bfloat162 one2 = __floats2bfloat162_rn(1.f, 1.f);
  mbar_wait(wd_full, 0);

  for (int it = 0; it < ntiles; ++it) {
    const int s = it % kIntStages, buf = it & 1, r0 = (t_begin + it) * 64;
    mbar_wait(full + s, (it / kIntStages) & 1);
    const uint64_t xd = sw128_desc(xs + s * KH * kTile);
    float zt[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) zt[i] = 0.f;
    wg_fence();
    if constexpr (KH == 1) {
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) wgmma_rs<0>(zt, wf + 4 * kk, xd + 2 * kk);  // z^T = Wd^T x^T
    } else {  // z^T = Wd^T x^T over both lane halves, A MN-major from the Wd tiles
#pragma unroll
      for (int kk = 0; kk < 4 * KH; ++kk)
        wgmma_ss<1, 0>(zt, wda + 512 * (kk >> 2) + 128 * (kk & 3), xd + 512 * (kk >> 2) + 2 * (kk & 3), 1);
    }
    wg_commit();
    wg_wait();
    reg_fence(zt);

    // z = x Wd + iv Wd[dh] + bd; sig, dz and the column sums at the bf16
    // rounding points of the plain version, two rows at a time in bf16x2;
    // dz^T's pairs are the A fragments of dWd^T += dz^T x (k step n / 2)
    const bf16* drw = drs + s * kIntEventsMax * 64;
    const float* ivr = ivs + s * 64;
    uint32_t dzf[16];
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const float2 iv = *reinterpret_cast<const float2*>(ivr + 8 * n + 2 * t4);
#pragma unroll
      for (int hm = 0; hm < 2; ++hm) {
        const int x0 = 4 * n + 2 * hm;
        const __nv_bfloat162 dsw = *reinterpret_cast<const __nv_bfloat162*>(
            drw + el[hm] * 64 + ((n ^ (el[hm] & 7)) << 3) + 2 * t4);
        // the exact two-op sigmoid (an ex2 and a reciprocal on the
        // special-function unit): the one-op (1 + tanh.approx(z / 2)) / 2,
        // whose error is ~2^-11 of the result, flips the bf16 rounding of sig
        // often enough that at phase 3b's inputs the worst error against
        // tolerance rose up to 8x (dt of bimau_qpos_tq6_bf16 0.037 -> 0.294,
        // dWd of bimau_bf16_flagship 0.006 -> 0.042); torch_ablate.py mau_bwd
        // times it
        const __nv_bfloat162 sig =
            __floats2bfloat162_rn(sigmoid(fmaf(iv.x, wiv[hm], zt[x0] + bdv[hm])),
                                  sigmoid(fmaf(iv.y, wiv[hm], zt[x0 + 1] + bdv[hm])));
        const __nv_bfloat162 dz =
            __hmul2(__hmul2(__hmul2(dsw, wr2[hm]), sig), __hsub2(one2, sig));
        const float2 dzv = __bfloat1622float2(dz);
        const float2 dwv = __bfloat1622float2(__hmul2(dsw, sig));
        dw[hm] += dwv.x + dwv.y;
        dbd[hm] += dzv.x + dzv.y;
        giv[hm] = fmaf(iv.x, dzv.x, fmaf(iv.y, dzv.y, giv[hm]));
        dzf[2 * n + hm] = bits2(dz);
      }
    }
    wg_fence();
#pragma unroll
    for (int lh = 0; lh < KH; ++lh)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_rs<1>(gwd[lh], dzf + 4 * kk, xd + 512 * lh + 128 * kk);  // dWd^T += dz^T x
    wg_commit();
    // dz (64 rows x the warpgroup's 64 columns) into the buffer's tile of
    // this warpgroup, 128-byte swizzle: the K-major B operand of dx^T
    unsigned char* dzw = reinterpret_cast<unsigned char*>(dzt + (buf * kIntGroups + wg) * kTile);
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int hm = 0; hm < 2; ++hm)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int rr = 8 * n + 2 * t4 + c;
          *reinterpret_cast<unsigned short*>(dzw + rr * 128 + (((2 * warp + hm) ^ (rr & 7)) << 4) +
                                             2 * g) = (unsigned short)(dzf[2 * n + hm] >> (16 * c));
        }
    fence_async_smem();
    wg_wait();
#pragma unroll
    for (int lh = 0; lh < KH; ++lh) reg_fence(gwd[lh]);
    mbar_arrive(empty + s);  // the stage's x tiles, draw rows and intervals are free
    named_sync(1, 128 * kIntGroups);  // both warpgroups' dz^T of this tile are in shared memory

    // dx^T of the warpgroup's 32 rows of the tile over the block's 128
    // columns (A: the Wd tiles of lane half lh; B: both warpgroups' dz, rows
    // 32 wg ..), one lane half at a time, each added to the workspace by TMA
    // from its own half of the staging tile
    const uint64_t dzd = sw128_desc(dzt + buf * kIntGroups * kTile) + 256 * wg;
#pragma unroll
    for (int lh = 0; lh < KH; ++lh) {
      float xt[16];
#pragma unroll
      for (int i = 0; i < 16; ++i) xt[i] = 0.f;
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < 2 * 4; ++kk)
        wgmma_ss_n32(xt, wdd + 512 * ((kk >> 2) * KH + lh) + 2 * (kk & 3),
                     dzd + 512 * (kk >> 2) + 2 * (kk & 3), 1);
      wg_commit();
      wg_wait();
      reg_fence(xt);
      if (lh == 0) {
        if (issuer) asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
        named_sync(2 + wg, 128);  // the last tile's reductions have read the staging tile
      }
      float* sth = stw + 2048 * lh;
      stage_half(sth, xt, warp, lane);
      fence_async_smem();
      named_sync(2 + wg, 128);
      if (issuer) {
        tma_reduce_add_2d(&maps.dseq, sth, r0 + 32 * wg, 64 * lh);
        asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
      }
    }
  }

  // dbd, dw and the interval lane of dWd: the quad's rows, one atomic a
  // column and block; dWd^T's lanes by TMA reduce-add
#pragma unroll
  for (int hm = 0; hm < 2; ++hm) {
    float a = dw[hm], bb = dbd[hm], v = giv[hm];
#pragma unroll
    for (int o = 1; o <= 2; o <<= 1) {
      a += __shfl_xor_sync(0xffffffffu, a, o);
      bb += __shfl_xor_sync(0xffffffffu, bb, o);
      v += __shfl_xor_sync(0xffffffffu, v, o);
    }
    const int col = n0 + 16 * warp + g + 8 * hm;
    if (t4 == 0 && col < EDH) {
      atomicAdd(p.dw + col, a);
      atomicAdd(p.dbd + col, bb);
      atomicAdd(p.dwd_iv + col, v);
    }
  }
  // each lane half of dWd^T as two 32-lane boxes: entries 16 .. of the
  // half's accumulator are its lanes 32 ..
#pragma unroll
  for (int lh = 0; lh < KH; ++lh) {
    if (issuer) asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
    named_sync(2 + wg, 128);
    stage_half(stw, reinterpret_cast<const float(&)[16]>(gwd[lh][0]), warp, lane);
    stage_half(stw + 2048, reinterpret_cast<const float(&)[16]>(gwd[lh][16]), warp, lane);
    fence_async_smem();
    named_sync(2 + wg, 128);
    if (issuer) {
      tma_reduce_add_2d(&maps.dwd, stw, 64 * lh, n0);
      tma_reduce_add_2d(&maps.dwd, stw + 2048, 64 * lh + 32, n0);
      asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
    }
  }
  if (issuer) asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

template <typename K>
cudaError_t set_smem(K kernel, size_t bytes) {
  if (bytes > kMaxSmem) return cudaErrorInvalidValue;
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

size_t weights_smem_bytes(int dh, int E) {
  const int K = dh + 1, XS = (K + 3) / 4 * 4;
  return sizeof(float) * ((size_t)kStageRows * XS + (size_t)kStageRows * round_up(E, 4) +
                          (dh > 64 ? (size_t)K * kThreads : 0));
}

template <typename T, int DH, int MODE>
cudaError_t launch_attn(const Params& p, cudaStream_t stream) {
  const size_t bytes = smem_bytes(p.qc, p.Tk, DH, p.E, MODE);
  cudaError_t e = set_smem(mau_bwd_attn<T, DH, MODE>, bytes);
  if (e != cudaSuccess) return e;
  const int nchunks = (p.Tq + p.qc - 1) / p.qc;
  mau_bwd_attn<T, DH, MODE><<<p.B * p.H * nchunks, kThreads, bytes, stream>>>(p);
  return cudaGetLastError();
}

// kFull then mau_bwd_weights: fp32.
template <int DH>
cudaError_t launch_full(const Params& p, cudaStream_t stream) {
  using T = float;
  cudaError_t e = launch_attn<T, DH, kFull>(p, stream);
  if (e != cudaSuccess) return e;
  const long long rows = (long long)p.B * p.H * p.Tq;
  const unsigned chunks = (unsigned)((rows + p.rows_per_chunk - 1) / p.rows_per_chunk);
  const size_t w_bytes = weights_smem_bytes(DH, p.E);
  e = set_smem(mau_bwd_weights<T, DH>, w_bytes);
  if (e != cudaSuccess) return e;
  const dim3 grid((p.E * DH + kThreads - 1) / kThreads, chunks);
  mau_bwd_weights<T, DH><<<grid, kThreads, w_bytes, stream>>>(p);
  return cudaGetLastError();
}

// A TMA map of a row-major 2-D operand (cols contiguous, rows `ld` elements
// apart), boxes of box_rows x box_cols, 128-byte swizzle.
bool map_2d(CUtensorMap* map, CUtensorMapDataType type, size_t item, const void* ptr, long long cols,
            long long rows, long long ld, int box_cols, int box_rows) {
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)ld * item};
  const cuuint32_t box[2] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows};
  return encode_map(map, type, 2, ptr, dims, strides, box);
}

// kPre, mau_bwd_int_tc, kPost: bf16. The workspaces cover rows_pad rows (a
// multiple of 64), x_lanes(DH) lanes and E*dh rounded up to 128 columns, so
// every box lies inside them; the wrapper zeroes what kPre does not write.
template <int DH>
cudaError_t launch_tc(const Params& p, const void* wd_tiles, int ecols, int edraw,
                      cudaStream_t stream) {
  using bf16 = __nv_bfloat16;
  const auto BF = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  const auto F32 = CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
  constexpr int XL = x_lanes(DH);
  constexpr size_t kSmem = int_smem_bytes(DH);
  IntMaps maps;
  if (!map_2d(&maps.wd, BF, sizeof(bf16), wd_tiles, ecols, XL, ecols, 64, 64) ||
      !map_2d(&maps.x, BF, sizeof(bf16), p.x_out, XL, p.rows_pad, XL, 64, 64) ||
      !map_2d(&maps.draw, BF, sizeof(bf16), p.draw_out, p.rows_pad, edraw, p.rows_pad, 64,
              kIntCols / DH) ||
      !map_2d(&maps.dseq, F32, sizeof(float), p.dseq_ws, p.rows_pad, XL, p.rows_pad, 32, 64) ||
      !map_2d(&maps.dwd, F32, sizeof(float), p.dwd, XL, ecols, XL, 32, 64))
    return cudaErrorInvalidValue;
  cudaError_t e = launch_attn<bf16, DH, kPre>(p, stream);
  if (e != cudaSuccess) return e;
  e = set_smem(mau_bwd_int_tc<DH>, kSmem);
  if (e != cudaSuccess) return e;
  const int tiles = p.rows_pad / 64;
  const dim3 grid(ecols / kIntCols, (tiles + p.tiles_per_chunk - 1) / p.tiles_per_chunk);
  mau_bwd_int_tc<DH><<<grid, kIntThreads, kSmem, stream>>>(p, maps);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  return launch_attn<bf16, DH, kPost>(p, stream);
}

cudaError_t launch_full_dh(const Params& p, int dh, cudaStream_t s) {
  switch (dh) {
    case 16: return launch_full<16>(p, s);
    case 32: return launch_full<32>(p, s);
    case 64: return launch_full<64>(p, s);
    case 128: return launch_full<128>(p, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// 1 where (dtype, dh) takes the tensor-core path (kPre, mau_bwd_int_tc,
// kPost): bf16 at every dh the kernels take; 0 where kFull and
// mau_bwd_weights (fp32).
int mau_attention_bwd_tensor_cores(int dh, int dtype) {
  return dtype == 1 && (dh == 16 || dh == 32 || dh == 64 || dh == 128);
}

// Dynamic shared memory of mau_bwd_attn for `qc` query rows per block, in
// bytes: the most that the modes run for (dh, dtype) need (kPre's in
// bf16, kFull's in fp32).
size_t mau_attention_bwd_smem_bytes(int qc, int Tk, int dh, int E, int dtype) {
  return attn_smem_bytes(qc, Tk, dh, E, mau_attention_bwd_tensor_cores(dh, dtype));
}

// Launches the backward's kernels on `stream`; returns cudaGetLastError()
// (0 on success). dtype: 0 = float32, 1 = bfloat16 (q, k, v, t, g_out and
// dq..dt). wd, bd, w, scaling, raw, g_lam are fp32. dscaling, dbd, dw must
// be zeroed by the caller. dk_acc/dv_acc/dt_acc (zeroed fp32, (B, Tk, C))
// are required when qc < Tq and must be null otherwise.
// kFull path: x_out fp32 (rows, dh+1) and draw_out fp32 (rows, E) are
// scratch; dwd is (dh+1, E*dh), zeroed; wd_tiles, the workspaces and dwd_iv
// may be null.
// Tensor-core path, XL = x_lanes(dh) (64, or 128 at dh = 128): wd_tiles is
// bf16 Wd (XL lanes, ecols = E*dh rounded up to 128) zero past dh and
// E*dh; x_out bf16 (rows_pad, XL) and draw_out bf16 (edraw = E rounded up
// to 8, rows_pad) with what kPre does not write zeroed (rows >= rows,
// events >= E); probs_ws, dprobs_ws fp32 (rows, Tk); dseq_ws fp32 (XL,
// rows_pad), dwd fp32 (ecols, XL) and dwd_iv (E*dh,) zeroed; rows_pad =
// rows rounded up to 64; tiles_per_chunk from mau_bwd_int_plan.
int mau_attention_bwd(const void* q, long long q_bs, long long q_rs,
                      const void* k, long long k_bs, long long k_rs,
                      const void* v, long long v_bs, long long v_rs,
                      const void* t, long long t_bs, long long t_rs,
                      const void* go, long long go_bs, long long go_rs,
                      const void* key_mask, const void* intervals,
                      const void* qpos, const void* onehot, const void* wd,
                      const void* bd, const void* w, const void* scaling,
                      const void* wd_tiles, const void* raw, const void* glam,
                      const void* seed, unsigned drop_thresh, float drop_scale,
                      void* dq, void* dk, void* dv, void* dt,
                      void* dk_acc, void* dv_acc, void* dt_acc,
                      void* x_out, void* draw_out, void* probs_ws, void* dprobs_ws,
                      void* dseq_ws, void* dscaling, void* dwd, void* dwd_iv,
                      void* dbd, void* dw, int B, int Tq, int Tk, int H, int dh,
                      int E, int causal, int diag_reset, float scale, int qc,
                      int rows_per_chunk, int tiles_per_chunk, int rows_pad, int dtype,
                      void* stream) {
  if (Tq < 1 || Tk < Tq || Tk > 128 || E < 1 || B < 1 || H < 1 || qc < 1 || qc > 32 ||
      rows_per_chunk < 1 || (dtype != 0 && dtype != 1) || ((qc < Tq) != (dk_acc != nullptr)))
    return (int)cudaErrorInvalidValue;
  const bool tc = mau_attention_bwd_tensor_cores(dh, dtype);
  if (attn_smem_bytes(qc, Tk, dh, E, tc) > kMaxSmem) return (int)cudaErrorInvalidValue;
  const long long rows = (long long)B * H * Tq;
  if (tc && (!wd_tiles || !probs_ws || !dprobs_ws || !dseq_ws || !dwd_iv || tiles_per_chunk < 1 ||
             rows_pad % 64 != 0 || rows_pad < rows))
    return (int)cudaErrorInvalidValue;
  Params p;
  p.q = q; p.k = k; p.v = v; p.t = t; p.go = go;
  p.q_bs = q_bs; p.q_rs = q_rs; p.k_bs = k_bs; p.k_rs = k_rs;
  p.v_bs = v_bs; p.v_rs = v_rs; p.t_bs = t_bs; p.t_rs = t_rs;
  p.go_bs = go_bs; p.go_rs = go_rs;
  p.key_mask = static_cast<const float*>(key_mask);
  p.intervals = static_cast<const float*>(intervals);
  p.qpos = static_cast<const int*>(qpos);
  p.onehot = static_cast<const float*>(onehot);
  p.wd = static_cast<const float*>(wd);
  p.bd = static_cast<const float*>(bd);
  p.w = static_cast<const float*>(w);
  p.scaling = static_cast<const float*>(scaling);
  p.raw = static_cast<const float*>(raw);
  p.glam = static_cast<const float*>(glam);
  p.seed = static_cast<const long long*>(seed);
  p.drop_thresh = drop_thresh;
  p.drop_scale = drop_scale;
  p.dq = dq; p.dk = dk; p.dv = dv; p.dt = dt;
  p.dk_acc = static_cast<float*>(dk_acc);
  p.dv_acc = static_cast<float*>(dv_acc);
  p.dt_acc = static_cast<float*>(dt_acc);
  p.x_out = x_out;
  p.draw_out = draw_out;
  p.probs_ws = static_cast<float*>(probs_ws);
  p.dprobs_ws = static_cast<float*>(dprobs_ws);
  p.dseq_ws = static_cast<float*>(dseq_ws);
  p.dscaling = static_cast<float*>(dscaling);
  p.dwd = static_cast<float*>(dwd);
  p.dwd_iv = static_cast<float*>(dwd_iv);
  p.dbd = static_cast<float*>(dbd);
  p.dw = static_cast<float*>(dw);
  p.scale = scale;
  p.B = B; p.Tq = Tq; p.Tk = Tk; p.H = H; p.E = E;
  p.causal = causal; p.diag_reset = diag_reset;
  p.qc = qc; p.rows_per_chunk = rows_per_chunk;
  p.tiles_per_chunk = tiles_per_chunk; p.rows_pad = rows_pad;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (tc) {
    const int ecols = round_up(E * dh, kIntCols), edraw = round_up(E, 8);
    switch (dh) {
      case 16: return (int)launch_tc<16>(p, wd_tiles, ecols, edraw, s);
      case 32: return (int)launch_tc<32>(p, wd_tiles, ecols, edraw, s);
      case 64: return (int)launch_tc<64>(p, wd_tiles, ecols, edraw, s);
      case 128: return (int)launch_tc<128>(p, wd_tiles, ecols, edraw, s);
      default: return (int)cudaErrorInvalidValue;
    }
  }
  return (int)launch_full_dh(p, dh, s);
}

}  // extern "C"

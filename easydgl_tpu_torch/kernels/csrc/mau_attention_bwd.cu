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
// Two kernels, because the weight gradients are reductions over all
// B*H*Tq rows (126,976 at the flagship train shape) and dWd alone is
// 65 x 4096 fp32, more than a block's shared memory:
//
// * mau_bwd_rows: one block per (b, h, chunk of <= 32 query rows), like the
//   forward. It recomputes probs from q and k (cheaper here than storing
//   them), everything of the attention side, dlam, draw and d scaling, and
//   dx, for which z = x Wd is recomputed and never stored. It writes
//   x = [su | interval] and draw for the second kernel (at the flagship
//   shape 20 MB of bf16 x rows padded to 80 and 32.5 MB of fp32 draw).
//   With one chunk per (b, h) it stores dk, dv and dt; with several it adds
//   them into fp32 buffers.
// * mau_bwd_weights(_mma): a 2-D grid of Wd-column tiles x row chunks. It
//   recomputes z, sig and dz for its columns and rows from x and draw, and
//   sums dWd, dbd and dw in registers; one atomic add per entry and row
//   chunk at the end (~17 M at the flagship shape).
//
// What bounds it: the intensity head, 4 products of (rows x 65) by
// (65 x 4096) — z twice, dx and dWd, 270 GFLOP at the flagship train shape
// with the padded K — plus 1 G sigmoids. In bf16 (dh <= 64) all four run on
// the tensor cores (mma.sync m16n8k16, fp32 accumulate; mau_bwd_rows'
// intensity_bwd_mma and mau_bwd_weights_mma), chaining each C fragment of
// dz into the A fragment of the next product without leaving registers,
// and the per-entry dz chain runs in packed bf16x2 arithmetic (dz2_bf16);
// what is left is that chain and the sigmoids, twice over 520 M entries.
// In fp32 (and bf16 at dh = 128) the products run on CUDA cores.
//
// Precision contract (mirrors the TPU kernel): in bf16 mode the operands of
// every product are rounded to bf16 where the TPU kernel rounds them (probs,
// the modulated probs, g_out, x, Wd, dseq, dlogit), the (rows, E*dh)
// intermediates dsw = draw[e], dsig, dz and sig are bf16 (each product of
// two of them rounded), and all sums accumulate in fp32. In fp32 mode
// nothing is rounded.
//
// Limits: 1 <= Tq <= Tk <= 128, dh in {16, 32, 64, 128}, shared memory
// (mau_attention_bwd_smem_bytes) within 227 KB.

#include "common.cuh"

namespace {

using namespace port;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr float kNeg = -4294967295.0f;  // -(2^32) + 1, the reference mask
constexpr size_t kMaxSmem = 232448;
constexpr int kNC = 64;                 // Wd columns per chunk (mau_bwd_rows)
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
  const void* wd_frag;     // bf16: Wd as mma B fragments (mau_attention_fwd.cu)
  const __nv_bfloat16* wd_bf16;  // bf16: Wd (dh+1, E*dh) row-major
  const __nv_bfloat16* wd_t;     // bf16: Wd^T (E*dh, kpad(dh)), zero-padded
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
  void* x_out;             // fp32 (B*H*Tq, dh+1); bf16 tensor-core path:
                           // bf16 (B*H*Tq, kpad(dh)), zero past dh+1
  float* draw_out;         // (B*H*Tq, E)
  float* dscaling;         // (E,) fp32, summed atomically
  float* dwd;              // (dh+1, E*dh) fp32, summed atomically
  float* dbd;              // (E*dh,)
  float* dw;               // (E*dh,)
  float scale;
  int B, Tq, Tk, H, E, causal, diag_reset, qc, rows_per_chunk;
};

__host__ __device__ inline int row_stride(int dh) { return dh + 4; }
// K of the bf16 z product, padded to the mma's depth of 16.
__host__ __device__ inline int kpad(int dh) { return round_up(dh + 1, 16); }
__host__ __device__ inline int event_stride(int E) { return round_up(E, 4) + 4; }

// Shared-memory regions of mau_bwd_rows, in floats, each a multiple of 4.
struct Layout {
  int k, t, v, q, go, p, lam, oh, dsc, small;
};

__host__ __device__ inline Layout layout(int qc, int Tk, int dh, int E) {
  const int ldh = row_stride(dh), lde = event_stride(E);
  Layout l;
  l.k = round_up(Tk * ldh, 4);
  l.t = l.k;
  // v rows (phase 2a), then the modulated probs (2b-2c), then in phase 3 a
  // Wd chunk and a dz chunk (CUDA cores) or 32 bf16 x rows (tensor cores)
  l.v = round_up(imax(imax(Tk * ldh, qc * Tk),
                      imax((dh + 1) * (kNC + 1) + qc * (kNC + 1), 32 * (kpad(dh) + 8) / 2)),
                 4);
  l.q = round_up(qc * ldh, 4);
  l.go = l.q;                       // g_out rows, then x (phase 3)
  l.p = round_up(qc * Tk, 4);       // x3: probs, dprobs, dint
  l.lam = round_up(qc * lde, 4);    // x2: lam, raw -> draw
  l.oh = round_up(imax(Tk * lde, qc * ldh), 4);  // one-hot, then dseq
  l.dsc = round_up(E, 4);
  l.small = round_up(Tk + 2 * qc, 4);
  return l;
}

__host__ __device__ inline size_t smem_bytes(int qc, int Tk, int dh, int E) {
  const Layout l = layout(qc, Tk, dh, E);
  return sizeof(float) *
         (size_t)(l.k + l.t + l.v + l.q + l.go + 3 * l.p + 2 * l.lam + l.oh + l.dsc + l.small);
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

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
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

__device__ __forceinline__ uint32_t bits(__nv_bfloat162 v) {
  return *reinterpret_cast<const uint32_t*>(&v);
}

// dz of two z entries at once in packed bf16x2 arithmetic: each bf16
// multiply or subtract rounds the exact result once, which is what rounding
// the fp32 result of the same bf16 operands gives, so this is dz_of<bf16>
// with half the instructions. Returns dz; *sig_out gets sig.
__device__ __forceinline__ __nv_bfloat162 dz2_bf16(float z0, float z1, float bd0, float bd1,
                                                   __nv_bfloat162 dsw, __nv_bfloat162 wr,
                                                   __nv_bfloat162* sig_out) {
  const __nv_bfloat162 sig = __floats2bfloat162_rn(sigmoid(z0 + bd0), sigmoid(z1 + bd1));
  *sig_out = sig;
  const __nv_bfloat162 one = __floats2bfloat162_rn(1.f, 1.f);
  return __hmul2(__hmul2(__hmul2(dsw, wr), sig), __hsub2(one, sig));
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

// dseq (nq x DH, fp32, zeroed, stride ldh) += (dz Wd^T)[:, :DH] on the
// tensor cores (bf16, DH <= 64). As in the forward, each warp keeps the 32 x
// kpad(DH) x rows as mma A fragments and takes events in turn; per chunk of
// NT*8 columns z = x Wd comes out of mma.sync as C fragments, dz is formed in
// place, and two adjacent 8-column C tiles are exactly one 16-deep A tile of
// the next product, dx += dz Wd^T, whose B fragments are pairs of adjacent
// Wd columns (one 4-byte load from row-major bf16 Wd). Each warp sums its
// events in registers; the 8 warps meet in shared memory at the end.
template <int DH>
__device__ void intensity_bwd_mma(const Params& p, const __nv_bfloat16* xb, int S,
                                  const float* rd_s, int lde, int nq, float* dseq,
                                  int ldh) {
  using bf16 = __nv_bfloat16;
  constexpr int KS = (DH + 1 + 15) / 16;
  constexpr int NT = DH >= 32 ? 4 : DH / 8;
  constexpr int CPE = DH / (NT * 8);
  constexpr int ND = DH / 8;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int EDH = p.E * DH;
  const uint2* wdf = static_cast<const uint2*>(p.wd_frag);
  uint32_t a[2][KS][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      const bf16* x0 = xb + (mt * 16 + g) * S + ks * 16 + 2 * t;
      a[mt][ks][0] = ld32(x0);
      a[mt][ks][1] = ld32(x0 + 8 * S);
      a[mt][ks][2] = ld32(x0 + 8);
      a[mt][ks][3] = ld32(x0 + 8 * S + 8);
    }
  float dx[2][ND][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nd = 0; nd < ND; ++nd)
#pragma unroll
      for (int i = 0; i < 4; ++i) dx[mt][nd][i] = 0.f;
  for (int e = warp; e < p.E; e += kWarps) {
    __nv_bfloat162 dsw[2][2];  // rows mt*16 + hr*8 + g, the value twice
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int r = mt * 16 + hr * 8 + g;
        const float v = r < nq ? rd_s[r * lde + e] : 0.f;
        dsw[mt][hr] = __floats2bfloat162_rn(v, v);
      }
#pragma unroll
    for (int c = 0; c < CPE; ++c) {
      const int n0 = e * DH + c * NT * 8;
      float acc[2][NT][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[mt][nt][i] = 0.f;
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        uint2 bf[NT];
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
          bf[nt] = __ldg(wdf + ((size_t)(n0 / 8 + nt) * KS + ks) * 32 + lane);
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
          for (int nt = 0; nt < NT; ++nt) mma_bf16(acc[mt][nt], a[mt][ks], bf[nt].x, bf[nt].y);
      }
      // dz of the pair (row, columns 2t and 2t+1) is one bf16x2: exactly
      // the packed A operand of dx += dz Wd^T below
      uint32_t dzp[2][NT][2];
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int col = n0 + nt * 8 + 2 * t;
        const float2 bdv = __ldg(reinterpret_cast<const float2*>(p.bd + col));
        const float2 wv = __ldg(reinterpret_cast<const float2*>(p.w + col));
        const __nv_bfloat162 wr = __floats2bfloat162_rn(wv.x, wv.y);
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
          for (int hr = 0; hr < 2; ++hr) {
            __nv_bfloat162 sig;
            dzp[mt][nt][hr] = bits(dz2_bf16(acc[mt][nt][2 * hr], acc[mt][nt][2 * hr + 1], bdv.x,
                                            bdv.y, dsw[mt][hr], wr, &sig));
          }
      }
#pragma unroll
      for (int kk = 0; kk < NT / 2; ++kk) {
        uint32_t az[2][4];
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          az[mt][0] = dzp[mt][2 * kk][0];
          az[mt][1] = dzp[mt][2 * kk][1];
          az[mt][2] = dzp[mt][2 * kk + 1][0];
          az[mt][3] = dzp[mt][2 * kk + 1][1];
        }
        const bf16* wcol = p.wd_bf16 + n0 + kk * 16 + 2 * t;
#pragma unroll
        for (int nd = 0; nd < ND; ++nd) {
          const bf16* wp = wcol + (size_t)(nd * 8 + g) * EDH;
          const uint32_t b0 = __ldg(reinterpret_cast<const unsigned int*>(wp));
          const uint32_t b1 = __ldg(reinterpret_cast<const unsigned int*>(wp + 8));
#pragma unroll
          for (int mt = 0; mt < 2; ++mt) mma_bf16(dx[mt][nd], az[mt], b0, b1);
        }
      }
    }
  }
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nd = 0; nd < ND; ++nd)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = mt * 16 + (i >> 1) * 8 + g, d = nd * 8 + 2 * t + (i & 1);
        if (r < nq) atomicAdd(dseq + r * ldh + d, dx[mt][nd][i]);
      }
}

template <typename T, int DH>
__global__ void __launch_bounds__(kThreads, 1) mau_bwd_rows(const Params p) {
  extern __shared__ __align__(16) float smem[];
  constexpr int ldh = DH + 4;
  constexpr int D4 = DH / 4;
  const int nchunks = (p.Tq + p.qc - 1) / p.qc;
  const int bh = blockIdx.x / nchunks, chunk = blockIdx.x - bh * nchunks;
  const int b = bh / p.H, h = bh - b * p.H;
  const int i0 = chunk * p.qc, nq = imin(p.qc, p.Tq - i0);
  const int Tk = p.Tk, E = p.E, EDH = E * DH;
  const int lde = event_stride(E), E4 = round_up(E, 4) / 4;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const Layout l = layout(p.qc, Tk, DH, E);

  float* ks = smem;
  float* ts = ks + l.k;
  float* vs = ts + l.t;       // phase 2a
  float* ms = vs;             // modulated probs, phase 2b-2c
  float* wdc = vs;            // Wd chunk (DH+1) x (kNC+1), phase 3
  float* dzc = vs + (DH + 1) * (kNC + 1);  // dz chunk nq x (kNC+1)
  float* qs = vs + l.v;
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

  // ---- phase 1: probs
  load_rows<T>(qs, ldh, qg, p.q_rs, nq, DH);
  load_rows<T>(ks, ldh, kg, p.k_rs, Tk, DH);
  load_rows<T>(ts, ldh, tg, p.t_rs, Tk, DH);
  for (int j = tid; j < Tk; j += kThreads) kms[j] = p.key_mask[(size_t)b * Tk + j];
  for (int i = tid; i < nq; i += kThreads) {
    ivs[i] = p.intervals[(size_t)b * p.Tq + i0 + i];
    qps[i] = p.qpos[(size_t)b * p.Tq + i0 + i];
  }
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
  float* drawg = p.draw_out + row0 * E;
  for (int idx = tid; idx < nq * E; idx += kThreads) {
    const int i = idx / E, e = idx - i * E;
    float dl = glg[i * E + e];
    for (int j = 0; j < Tk; ++j) dl = fmaf(dis[i * Tk + j], oh_s[j * lde + e], dl);
    const float s = expf(p.scaling[e]);
    const float r = rd_s[i * lde + e] / s;
    const float sr = 1.f / (1.f + expf(-r));
    const float dr = dl * sr;
    rd_s[i * lde + e] = dr;
    drawg[i * E + e] = dr;
    atomicAdd(dsc_s + e, dl * (softplus(r) - sr * r) * s);
  }
  __syncthreads();  // g_out rows and the one-hot rows are dead from here
  for (int e = tid; e < E; e += kThreads) atomicAdd(p.dscaling + e, dsc_s[e]);

  // ---- phase 3: x = [probs @ t | interval] (rounded), then dx = dz Wd^T
  constexpr bool kMma = sizeof(T) == 2 && DH <= 64;
  float* xg = static_cast<float*>(p.x_out) + row0 * (DH + 1);
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
    if constexpr (!kMma) xg[i * (DH + 1) + d] = acc;
  }
  if constexpr (kMma) {
    constexpr int KP = (DH + 1 + 15) / 16 * 16, S = KP + 8;
    __nv_bfloat16* xb = reinterpret_cast<__nv_bfloat16*>(vs);
    __nv_bfloat16* xgb = static_cast<__nv_bfloat16*>(p.x_out) + row0 * KP;
    __syncthreads();  // x rows written
    for (int idx = tid; idx < 32 * KP; idx += kThreads) {
      const int i = idx / KP, d = idx - i * KP;
      const __nv_bfloat16 v = __float2bfloat16(i < nq && d <= DH ? xs[i * ldh + d] : 0.f);
      xb[i * S + d] = v;
      if (i < nq) xgb[i * KP + d] = v;
    }
    for (int idx = tid; idx < nq * ldh; idx += kThreads) dseq[idx] = 0.f;
    __syncthreads();
    intensity_bwd_mma<DH>(p, xb, S, rd_s, lde, nq, dseq, ldh);
    __syncthreads();
  } else {
    intensity_bwd_scalar<T, DH>(p, xs, ldh, rd_s, lde, nq, wdc, dzc, dseq);
    __syncthreads();
  }
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

// dWd, dbd, dw: thread = one Wd column, block = kThreads columns x one chunk
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
      dst[r * E4 + ee] = p.draw_out[(r0 + r) * p.E + ee];
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

// dWd, dbd, dw on the tensor cores (bf16, dh <= 64). A warp owns 16 Wd
// columns (inside one event) and keeps their Wd^T rows as mma A fragments;
// a block of 8 warps takes 128 columns and stages 64 rows of x (bf16 rows
// from mau_bwd_rows, 16-byte loads; then a transposed copy) and draw at a
// time. (32 columns a warp reads x half as often but needs ~230 registers,
// one block per SM, and measured slower.) Per 16 rows: z^T = Wd^T x^T
// (C: columns x rows), dz^T formed in place, and two 8-row C tiles are one
// 16-deep A tile of dWd^T += dz^T x, B from the transposed x.
constexpr int kWColsPerWarp = 16;
constexpr int kWColsPerBlock = kWColsPerWarp * kWarps;
constexpr int kWStage = 64;

template <int DH>
__host__ __device__ inline size_t weights_mma_smem_bytes(int E) {
  constexpr int KP = (DH + 1 + 15) / 16 * 16;
  return 2 * ((size_t)kWStage * (KP + 8) + (size_t)KP * (kWStage + 8)) +
         sizeof(float) * (size_t)kWStage * round_up(E, 4);
}

template <int DH>
__global__ void __launch_bounds__(kThreads, 2) mau_bwd_weights_mma(const Params p) {
  using bf16 = __nv_bfloat16;
  constexpr int K = DH + 1, KP = (K + 15) / 16 * 16, KS = KP / 16, NK = KP / 8;
  constexpr int SX = KP + 8, ST = kWStage + 8;
  extern __shared__ __align__(16) float smem[];
  bf16* xs = reinterpret_cast<bf16*>(smem);  // kWStage x SX
  bf16* xt = xs + kWStage * SX;              // KP x ST (x transposed)
  float* ds = reinterpret_cast<float*>(xt + KP * ST);  // kWStage x E4 (draw)
  const unsigned short* xsu = reinterpret_cast<const unsigned short*>(xs);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int EDH = p.E * DH, E4 = round_up(p.E, 4);
  const int c0 = blockIdx.x * kWColsPerBlock + warp * kWColsPerWarp;
  // m-tile mt covers columns c0 + 16 mt .. +15 (E*dh is a multiple of 16)
  constexpr int MT = kWColsPerWarp / 16;
  bool act[MT];
  int cb[MT], ev[MT];
  uint32_t a[MT][KS][4];
  float bdv[MT][2], dbd[MT][2], dw[MT][2];
  __nv_bfloat162 wr[MT][2];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    act[mt] = c0 + 16 * mt < EDH;  // uniform per warp
    cb[mt] = act[mt] ? c0 + 16 * mt : 0;
    ev[mt] = cb[mt] / DH;
    const bf16* w0 = p.wd_t + (size_t)(cb[mt] + g) * KP + 2 * t;
    const bf16* w8 = w0 + 8 * KP;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      a[mt][ks][0] = ld32(w0 + ks * 16);
      a[mt][ks][1] = ld32(w8 + ks * 16);
      a[mt][ks][2] = ld32(w0 + ks * 16 + 8);
      a[mt][ks][3] = ld32(w8 + ks * 16 + 8);
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      bdv[mt][h] = p.bd[cb[mt] + g + 8 * h];
      const float wv = p.w[cb[mt] + g + 8 * h];
      wr[mt][h] = __floats2bfloat162_rn(wv, wv);
      dbd[mt][h] = dw[mt][h] = 0.f;
    }
  }
  float acc[MT][NK][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nk = 0; nk < NK; ++nk)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mt][nk][i] = 0.f;
  const bf16* xg = static_cast<const bf16*>(p.x_out);
  const long long rows = (long long)p.B * p.H * p.Tq;
  const long long r_begin = (long long)blockIdx.y * p.rows_per_chunk;
  const long long r_end = r_begin + p.rows_per_chunk < rows ? r_begin + p.rows_per_chunk : rows;
  for (long long r0 = r_begin; r0 < r_end; r0 += kWStage) {
    const int nr = (int)(r_end - r0 < kWStage ? r_end - r0 : kWStage);
    __syncthreads();
    for (int idx = tid; idx < kWStage * (KP / 8); idx += kThreads) {
      const int r = idx / (KP / 8), c = (idx - r * (KP / 8)) * 8;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (r < nr) v = __ldg(reinterpret_cast<const uint4*>(xg + (r0 + r) * KP + c));
      *reinterpret_cast<uint4*>(xs + r * SX + c) = v;
    }
    for (int idx = tid; idx < kWStage * p.E; idx += kThreads) {
      const int r = idx / p.E, ee = idx - r * p.E;
      ds[r * E4 + ee] = r < nr ? p.draw_out[(r0 + r) * p.E + ee] : 0.f;
    }
    __syncthreads();
    for (int idx = tid; idx < KP * (kWStage / 2); idx += kThreads) {
      const int k = idx / (kWStage / 2), r = (idx - k * (kWStage / 2)) * 2;
      *reinterpret_cast<uint32_t*>(xt + k * ST + r) =
          (uint32_t)xsu[r * SX + k] | ((uint32_t)xsu[(r + 1) * SX + k] << 16);
    }
    __syncthreads();
    if (!act[0]) continue;
    for (int rt = 0; rt * 16 < nr; ++rt) {
      float z[MT][2][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
#pragma unroll
          for (int i = 0; i < 4; ++i) z[mt][nt][i] = 0.f;
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        const bf16* xr = xs + (rt * 16 + nt * 8 + g) * SX + 2 * t;
#pragma unroll
        for (int ks = 0; ks < KS; ++ks) {
          const uint32_t b0 = ld32(xr + ks * 16), b1 = ld32(xr + ks * 16 + 8);
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) mma_bf16(z[mt][nt], a[mt][ks], b0, b1);
        }
      }
      // z[mt][nt][i]: column cb[mt] + g + 8 (i >> 1), row rt*16 + nt*8 +
      // 2t + (i & 1). A pair (i, i+1) shares its column and is one bf16x2 of
      // rows 2t, 2t+1: exactly the packed A operand of dWd^T += dz^T x.
      uint32_t az[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
          const int r = rt * 16 + nt * 8 + 2 * t;
          const __nv_bfloat162 dsw =
              __floats2bfloat162_rn(ds[r * E4 + ev[mt]], ds[(r + 1) * E4 + ev[mt]]);
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            __nv_bfloat162 sig;
            const __nv_bfloat162 dz = dz2_bf16(z[mt][nt][2 * h], z[mt][nt][2 * h + 1],
                                               bdv[mt][h], bdv[mt][h], dsw, wr[mt][h], &sig);
            const __nv_bfloat162 dws = __hmul2(dsw, sig);
            dw[mt][h] += __low2float(dws) + __high2float(dws);
            dbd[mt][h] += __low2float(dz) + __high2float(dz);
            az[mt][2 * nt + h] = bits(dz);
          }
        }
      }
#pragma unroll
      for (int nk = 0; nk < NK; ++nk) {
        const bf16* xc = xt + (nk * 8 + g) * ST + rt * 16 + 2 * t;
        const uint32_t b0 = ld32(xc), b1 = ld32(xc + 8);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) mma_bf16(acc[mt][nk], az[mt], b0, b1);
      }
    }
  }
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int o = 1; o < 4; o <<= 1) {
        dbd[mt][h] += __shfl_xor_sync(0xffffffffu, dbd[mt][h], o);
        dw[mt][h] += __shfl_xor_sync(0xffffffffu, dw[mt][h], o);
      }
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    if (!act[mt]) continue;
    if (t == 0) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        atomicAdd(p.dbd + cb[mt] + g + 8 * h, dbd[mt][h]);
        atomicAdd(p.dw + cb[mt] + g + 8 * h, dw[mt][h]);
      }
    }
#pragma unroll
    for (int nk = 0; nk < NK; ++nk)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int k = nk * 8 + 2 * t + (i & 1);
        if (k < K) atomicAdd(p.dwd + (size_t)k * EDH + cb[mt] + g + 8 * (i >> 1), acc[mt][nk][i]);
      }
  }
}

size_t weights_smem_bytes(int dh, int E) {
  const int K = dh + 1, XS = (K + 3) / 4 * 4;
  return sizeof(float) * ((size_t)kStageRows * XS + (size_t)kStageRows * round_up(E, 4) +
                          (dh > 64 ? (size_t)K * kThreads : 0));
}

template <typename K>
cudaError_t set_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

template <typename T, int DH>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  const size_t rows_bytes = smem_bytes(p.qc, p.Tk, DH, p.E);
  cudaError_t e = set_smem(mau_bwd_rows<T, DH>, rows_bytes);
  if (e != cudaSuccess) return e;
  const int nchunks = (p.Tq + p.qc - 1) / p.qc;
  mau_bwd_rows<T, DH><<<p.B * p.H * nchunks, kThreads, rows_bytes, stream>>>(p);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const long long rows = (long long)p.B * p.H * p.Tq;
  const unsigned chunks = (unsigned)((rows + p.rows_per_chunk - 1) / p.rows_per_chunk);
  if constexpr (sizeof(T) == 2 && DH <= 64) {
    const size_t w_bytes = weights_mma_smem_bytes<DH>(p.E);
    e = set_smem(mau_bwd_weights_mma<DH>, w_bytes);
    if (e != cudaSuccess) return e;
    const dim3 grid((p.E * DH + kWColsPerBlock - 1) / kWColsPerBlock, chunks);
    mau_bwd_weights_mma<DH><<<grid, kThreads, w_bytes, stream>>>(p);
  } else {
    const size_t w_bytes = weights_smem_bytes(DH, p.E);
    e = set_smem(mau_bwd_weights<T, DH>, w_bytes);
    if (e != cudaSuccess) return e;
    const dim3 grid((p.E * DH + kThreads - 1) / kThreads, chunks);
    mau_bwd_weights<T, DH><<<grid, kThreads, w_bytes, stream>>>(p);
  }
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_dh(const Params& p, int dh, cudaStream_t s) {
  switch (dh) {
    case 16: return launch<T, 16>(p, s);
    case 32: return launch<T, 32>(p, s);
    case 64: return launch<T, 64>(p, s);
    case 128: return launch<T, 128>(p, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// Dynamic shared memory of mau_bwd_rows for `qc` query rows per block.
size_t mau_attention_bwd_smem_bytes(int qc, int Tk, int dh, int E) {
  return smem_bytes(qc, Tk, dh, E);
}

// Launches both kernels on `stream`; returns cudaGetLastError() (0 on
// success). dtype: 0 = float32, 1 = bfloat16 (q, k, v, t, g_out and dq..dt).
// wd, bd, w, scaling, raw, g_lam are fp32; in bf16 mode with dh <= 64 the
// tensor-core paths also take Wd as mma B fragments (wd_frag, the forward's
// packing), as row-major bf16 (wd_bf16) and transposed with K padded to 16
// (wd_t, (E*dh, kpad(dh))); otherwise these may be null. dscaling, dwd,
// dbd, dw must be zeroed by the caller. dk_acc/dv_acc/dt_acc (zeroed fp32, (B, Tk, C)) are
// required when qc < Tq and must be null otherwise. x_out and draw_out are
// scratch: B*H*Tq rows of dh+1 floats (bf16 at dh <= 64: kpad(dh) bf16)
// and of E floats.
int mau_attention_bwd(const void* q, long long q_bs, long long q_rs,
                      const void* k, long long k_bs, long long k_rs,
                      const void* v, long long v_bs, long long v_rs,
                      const void* t, long long t_bs, long long t_rs,
                      const void* go, long long go_bs, long long go_rs,
                      const void* key_mask, const void* intervals,
                      const void* qpos, const void* onehot, const void* wd,
                      const void* bd, const void* w, const void* scaling,
                      const void* wd_frag, const void* wd_bf16, const void* wd_t,
                      const void* raw, const void* glam, const void* seed,
                      unsigned drop_thresh, float drop_scale,
                      void* dq, void* dk, void* dv, void* dt,
                      void* dk_acc, void* dv_acc, void* dt_acc,
                      void* x_out, void* draw_out, void* dscaling, void* dwd,
                      void* dbd, void* dw, int B, int Tq, int Tk, int H, int dh,
                      int E, int causal, int diag_reset, float scale, int qc,
                      int rows_per_chunk, int dtype, void* stream) {
  if (Tq < 1 || Tk < Tq || Tk > 128 || E < 1 || B < 1 || H < 1 || qc < 1 || qc > 32 ||
      rows_per_chunk < 1 || (dtype != 0 && dtype != 1) || ((qc < Tq) != (dk_acc != nullptr)))
    return (int)cudaErrorInvalidValue;
  if (smem_bytes(qc, Tk, dh, E) > kMaxSmem) return (int)cudaErrorInvalidValue;
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
  p.wd_frag = wd_frag;
  p.wd_bf16 = static_cast<const __nv_bfloat16*>(wd_bf16);
  p.wd_t = static_cast<const __nv_bfloat16*>(wd_t);
  if (dtype == 1 && dh <= 64 && (!wd_frag || !wd_bf16 || !wd_t)) return (int)cudaErrorInvalidValue;
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
  p.draw_out = static_cast<float*>(draw_out);
  p.dscaling = static_cast<float*>(dscaling);
  p.dwd = static_cast<float*>(dwd);
  p.dbd = static_cast<float*>(dbd);
  p.dw = static_cast<float*>(dw);
  p.scale = scale;
  p.B = B; p.Tq = Tq; p.Tk = Tk; p.H = H; p.E = E;
  p.causal = causal; p.diag_reset = diag_reset;
  p.qc = qc; p.rows_per_chunk = rows_per_chunk;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(dtype == 0 ? launch_dh<float>(p, dh, s)
                          : launch_dh<__nv_bfloat16>(p, dh, s));
}

}  // extern "C"

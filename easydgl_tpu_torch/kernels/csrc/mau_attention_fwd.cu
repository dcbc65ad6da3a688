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
// flagship shape, two special-function-unit operations each). The TPU kernel
// packs heads into 128-row MXU tiles and reduces events with a 0/1 selector
// matmul; here one block serves one (b, h), the (rows, E*dh) sigmoid
// activation never leaves registers, and the per-event reduction over an
// event's dh columns is a register sum plus a shuffle across lanes.
//
// * bf16: the z product runs on the tensor cores (mma.sync m16n8k16, fp32
//   accumulate). Each warp keeps the block's 32 x (dh+1) A operand in
//   registers and streams its events' Wd columns from L2, pre-packed by the
//   wrapper in B-fragment order (one coalesced 8-byte load per lane per
//   8x16 tile). What bounds it then is the sigmoids on the SFU.
// * fp32: the z product runs on CUDA cores, an 8x4 register tile per thread,
//   Wd row-major streamed from L2 with 16-byte loads.
//
// Precision contract (mirrors the TPU kernel): in bf16 mode the operands of
// every product are rounded to bf16 (probs before @t, [su | interval] before
// @Wd, Wd and w themselves, the modulated probs before @v) and the sigmoid is
// evaluated in fp32 and rounded to bf16 once; all sums accumulate in fp32.
// In fp32 mode nothing is rounded.
//
// Limits: 1 <= Tq <= Tk <= 128, dh in {16, 32, 64, 128}, and the block's
// shared memory (mau_attention_fwd_smem_bytes) within 227 KB.

#include "common.cuh"

namespace {

using namespace port;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr float kNeg = -4294967295.0f;  // -(2^32) + 1, the reference mask
constexpr size_t kMaxSmem = 232448;     // 227 KB, opt-in per block

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
  const void* wd;          // fp32: (dh+1, E*dh); bf16: B fragments (see below)
  const float* bd;         // (E*dh,)
  const void* w;           // (E, dh), input dtype
  const float* scaling;    // (E,)
  void* out;               // (B, Tq, H*dh), input dtype
  float* lam;              // (B, H, Tq, E)
  float* raw;              // (B, H, Tq, E) or null (eval)
  const long long* seed;   // dropout seed (device scalar) or null (no dropout)
  unsigned drop_thresh;
  float drop_scale;
  float scale;
  int B, Tq, Tk, H, E, causal, diag_reset;
};

// K of the bf16 z product, padded to the mma's depth of 16.
__host__ __device__ inline int kpad(int dh) { return round_up(dh + 1, 16); }

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
  // the z product's A operand — fp32: xT[(dh+1)][tqp]; bf16: rows of
  // kpad(dh)+8 bf16 — aliasing the q rows of the logits phase
  l.x = round_up(imax(imax((dh + 1) * tqp, Tq * ldh), tqp * (kpad(dh) + 8) / 2), 4);
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

// raw[r][e] for r < Tq into lam_s (row stride lde): bf16 on the tensor cores.
// xb: the A operand, tqp rows of kpad(DH) bf16 at row stride S (rows >= Tq
// and columns > DH are zero). wdf: Wd packed as B fragments —
// wdf[(n8 * KS + ks) * 32 + lane] holds, for lane = 4*g + t, the bf16 pairs
// Wd[ks*16 + 2t + {0,1}][n8*8 + g] and Wd[ks*16 + 8 + 2t + {0,1}][n8*8 + g].
// Warps take events in turn; per event, chunks of NT n-tiles (8 columns
// each) are multiplied, put through the sigmoid, weighted by w and summed
// into per-row partials, then summed over the 4 lanes that share a row.
template <int DH>
__device__ void intensity_head_mma(const Params& p, const __nv_bfloat16* xb,
                                   int S, float* lam_s, int lde) {
  constexpr int KS = (DH + 1 + 15) / 16;
  constexpr int NT = DH >= 32 ? 4 : DH / 8;
  constexpr int CPE = DH / (NT * 8);  // chunks per event
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const uint2* wdf = static_cast<const uint2*>(p.wd);
  const __nv_bfloat16* wf = static_cast<const __nv_bfloat16*>(p.w);
  for (int r0 = 0; r0 < p.Tq; r0 += 32) {
    uint32_t a[2][KS][4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        const __nv_bfloat16* x0 = xb + (r0 + mt * 16 + g) * S + ks * 16 + 2 * t;
        a[mt][ks][0] = *reinterpret_cast<const uint32_t*>(x0);
        a[mt][ks][1] = *reinterpret_cast<const uint32_t*>(x0 + 8 * S);
        a[mt][ks][2] = *reinterpret_cast<const uint32_t*>(x0 + 8);
        a[mt][ks][3] = *reinterpret_cast<const uint32_t*>(x0 + 8 * S + 8);
      }
    for (int e = warp; e < p.E; e += kWarps) {
      float part[4] = {0.f, 0.f, 0.f, 0.f};  // rows g, g+8, g+16, g+24
#pragma unroll
      for (int c = 0; c < CPE; ++c) {
        const int n0 = e * DH + c * NT * 8;  // first column of the chunk
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
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const int col = n0 + nt * 8 + 2 * t + j;
            const float bdv = __ldg(p.bd + col);
            const float wv = to_f(wf[col]);
#pragma unroll
            for (int mt = 0; mt < 2; ++mt)
#pragma unroll
              for (int hr = 0; hr < 2; ++hr) {
                const float sg = rnd<__nv_bfloat16>(sigmoid(acc[mt][nt][2 * hr + j] + bdv));
                part[2 * mt + hr] = fmaf(sg, wv, part[2 * mt + hr]);
              }
          }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        part[i] += __shfl_xor_sync(0xffffffffu, part[i], 1);
        part[i] += __shfl_xor_sync(0xffffffffu, part[i], 2);
      }
      if (t == 0) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int r = r0 + (i >> 1) * 16 + (i & 1) * 8 + g;
          if (r < p.Tq) lam_s[r * lde + e] = part[i];
        }
      }
    }
  }
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
  const float* wd = static_cast<const float*>(p.wd);
  const float* wf = static_cast<const float*>(p.w);
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
// global-load and barrier latency; the bf16 dh=128 tile needs more registers.
template <typename T, int DH>
__global__ void __launch_bounds__(kThreads, (sizeof(T) == 2 && DH == 128) ? 2 : 3)
    mau_fwd_kernel(const Params p) {
  constexpr bool kBf16 = sizeof(T) == 2;
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
  load_rows<T, DH>(qs, static_cast<const T*>(p.q) + b * p.q_bs + h * DH, p.q_rs, Tq);
  load_rows<T, DH>(ks, static_cast<const T*>(p.k) + b * p.k_bs + h * DH, p.k_rs, Tk);
  load_rows<T, DH>(ts, static_cast<const T*>(p.t) + b * p.t_bs + h * DH, p.t_rs, Tk);
  load_rows<T, DH>(vs, static_cast<const T*>(p.v) + b * p.v_bs + h * DH, p.v_rs, Tk);
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

  // A operand of z = [su | interval], rounded to the compute dtype; rows past
  // Tq (and, in bf16, columns past DH) are zero so the z tile may run over
  // them. The q rows it overwrites are dead here. su = probs @ t, each thread
  // a row i and 4 adjacent channels.
  constexpr int KP = (DH + 1 + 15) / 16 * 16, S = KP + 8;
  __nv_bfloat16* xb = reinterpret_cast<__nv_bfloat16*>(xs);
  if constexpr (kBf16) {
    for (int idx = tid; idx < tqp * KP; idx += kThreads) {
      const int i = idx / KP, d = idx - i * KP;
      if (i >= Tq || d >= DH) xb[i * S + d] = __float2bfloat16(i < Tq && d == DH ? ivs[i] : 0.f);
    }
  } else {
    for (int idx = tid; idx < (DH + 1) * tqp; idx += kThreads) {
      const int d = idx / tqp, i = idx - d * tqp;
      if (i >= Tq || d == DH) xs[idx] = i < Tq ? ivs[i] : 0.f;
    }
  }
  for (int idx = tid; idx < Tq * D4; idx += kThreads) {
    const int i = idx / D4, d0 = (idx - i * D4) * 4;
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int j = 0; j < Tk; ++j)
      axpy4(rnd<T>(ps[i * Tk + j]), *reinterpret_cast<const float4*>(ts + j * ldh + d0), acc);
    if constexpr (kBf16) {
      __nv_bfloat16* xr = xb + i * S + d0;
      xr[0] = __float2bfloat16(acc.x); xr[1] = __float2bfloat16(acc.y);
      xr[2] = __float2bfloat16(acc.z); xr[3] = __float2bfloat16(acc.w);
    } else {
      xs[(d0 + 0) * tqp + i] = acc.x; xs[(d0 + 1) * tqp + i] = acc.y;
      xs[(d0 + 2) * tqp + i] = acc.z; xs[(d0 + 3) * tqp + i] = acc.w;
    }
  }
  __syncthreads();

  // ---- phase 2: intensity head -> raw (Tq, E) in lam_s
  if constexpr (kBf16) {
    intensity_head_mma<DH>(p, xb, S, lam_s, lde);
  } else {
    intensity_head_fp32<DH>(p, xs, tqp, lam_s, lde);
  }
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
    ps[idx] = rnd<T>(m);
  }
  __syncthreads();

  const int C = p.H * DH;
  T* out = static_cast<T*>(p.out) + (size_t)b * Tq * C + h * DH;
  for (int idx = tid; idx < Tq * D4; idx += kThreads) {
    const int i = idx / D4, d0 = (idx - i * D4) * 4;
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int j = 0; j < Tk; ++j)
      axpy4(ps[i * Tk + j], *reinterpret_cast<const float4*>(vs + j * ldh + d0), acc);
    T* o = out + (size_t)i * C + d0;
    o[0] = from_f<T>(acc.x); o[1] = from_f<T>(acc.y);
    o[2] = from_f<T>(acc.z); o[3] = from_f<T>(acc.w);
  }
}

template <typename T, int DH>
cudaError_t launch(const Params& p, size_t bytes, cudaStream_t stream) {
  if (bytes > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        mau_fwd_kernel<T, DH>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (e != cudaSuccess) return e;
  }
  mau_fwd_kernel<T, DH><<<p.B * p.H, kThreads, bytes, stream>>>(p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_dh(const Params& p, int dh, size_t bytes, cudaStream_t s) {
  switch (dh) {
    case 16: return launch<T, 16>(p, bytes, s);
    case 32: return launch<T, 32>(p, bytes, s);
    case 64: return launch<T, 64>(p, bytes, s);
    case 128: return launch<T, 128>(p, bytes, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// Dynamic shared memory one block needs; above 232448 the kernel cannot run.
size_t mau_attention_fwd_smem_bytes(int Tq, int Tk, int dh, int E) {
  return smem_bytes(Tq, Tk, dh, E);
}

// Launches on `stream` and returns cudaGetLastError() (0 on success).
// dtype: 0 = float32, 1 = bfloat16 (q, k, v, t, wd, w and out). In bf16 mode
// `wd` is Wd packed as mma B fragments (intensity_head_mma). `raw` (may be
// null) receives the training residual; `seed` (an int64 on the device, or
// null for no dropout) keys the dropout mask.
int mau_attention_fwd(const void* q, long long q_bs, long long q_rs,
                      const void* k, long long k_bs, long long k_rs,
                      const void* v, long long v_bs, long long v_rs,
                      const void* t, long long t_bs, long long t_rs,
                      const void* key_mask, const void* intervals,
                      const void* qpos, const void* onehot, const void* wd,
                      const void* bd, const void* w, const void* scaling,
                      void* out, void* lam, void* raw, const void* seed,
                      unsigned drop_thresh, float drop_scale, int B, int Tq,
                      int Tk, int H, int dh, int E, int causal, int diag_reset,
                      float scale, int dtype, void* stream) {
  if (Tq < 1 || Tk < Tq || Tk > 128 || E < 1 || B < 1 || H < 1 ||
      (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  const size_t bytes = smem_bytes(Tq, Tk, dh, E);
  if (bytes > kMaxSmem) return (int)cudaErrorInvalidValue;
  Params p;
  p.q = q; p.k = k; p.v = v; p.t = t;
  p.q_bs = q_bs; p.q_rs = q_rs; p.k_bs = k_bs; p.k_rs = k_rs;
  p.v_bs = v_bs; p.v_rs = v_rs; p.t_bs = t_bs; p.t_rs = t_rs;
  p.key_mask = static_cast<const float*>(key_mask);
  p.intervals = static_cast<const float*>(intervals);
  p.qpos = static_cast<const int*>(qpos);
  p.onehot = static_cast<const float*>(onehot);
  p.wd = wd;
  p.bd = static_cast<const float*>(bd);
  p.w = w;
  p.scaling = static_cast<const float*>(scaling);
  p.out = out;
  p.lam = static_cast<float*>(lam);
  p.raw = static_cast<float*>(raw);
  p.seed = static_cast<const long long*>(seed);
  p.drop_thresh = drop_thresh;
  p.drop_scale = drop_scale;
  p.scale = scale;
  p.B = B; p.Tq = Tq; p.Tk = Tk; p.H = H; p.E = E;
  p.causal = causal; p.diag_reset = diag_reset;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(dtype == 0 ? launch_dh<float>(p, dh, bytes, s)
                          : launch_dh<__nv_bfloat16>(p, dh, bytes, s));
}

const char* mau_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

// Flash attention at wide heads for Hopper (sm_90a): the forward, and the
// backward (dQ, dK and dV) as one kernel, for q and k of any width D and v of
// any width DV (the wrapper zero-pads both to multiples of 64).
//
// Replaces the TPU kernels of easydgl_tpu/kernels/flash_attention.py at the
// head widths that flash_attention.cu does not take (the TPU kernel pads D to
// whole 128-lane tiles and takes any width, :242-262):
//
//   flash_wide_fwd_tc_kernel (bf16),   _fwd_kernel (:121; pallas_call in
//   flash_wide_fwd_kernel (fp32)       _flash_fwd, :318)
//   flash_wide_bwd_tc_kernel (bf16),   _dq_kernel (:166; pallas_call in _flash_bwd,
//   flash_wide_bwd_kernel (fp32)       :366) and _dkv_kernel (:199; :390)
//
// and computes what the plain versions of easydgl_tpu_torch/kernels/
// flash_attention.py compute (flash_fwd_reference, flash_bwd_reference), with
// their rounding points and the function of flash_attention.cu's header:
// masked probs exactly 0, a row that sees no key gives out 0 and lse =
// -1e38, p rounded to v's dtype before P @ V (relative to the running max),
// ds rounded to k's / q's dtype before dS @ K and dS^T @ Q, and dropout keeps
// entry (b, h, i, j) by the Philox draw of counter (j, i, h, b).
//
// Why a scheme of its own. TGAT's augmented heads are 2,048 wide and TGREC's
// 150 (easydgl_tpu/nn/temporal.py:187-192, :331-347). A 64-row bf16 tile of a
// 2,048-wide q is 256 KB and a (64 x 2,048) fp32 accumulator 512 KB, past the
// 227 KB of shared memory a block may hold, so no operand or accumulator of
// the full width stays resident. Both kernels walk the width in chunks:
//
// * the logits S (64 x 64) accumulate over chunks of q and k (and dP over
//   chunks of dO and v) staged in shared memory: in fp32 32 columns, the
//   next chunk fetched into registers while the current one is used; in
//   bf16 64 columns through a ring of slots filled by cp.async;
// * the forward keeps its (64 x DV) output accumulator in shared memory, up
//   to 512 columns a block (128 KB in fp32): TGAT passes v at its own width
//   dh = 512 (the wrapper takes a v narrower than q and k), so S is formed
//   once a tile pair. A wider v is split over blocks of 512 columns, each of
//   which forms S again;
// * the backward is key-major: a block takes a 64-key tile and up to four
//   of the query tiles that see it (bwd_block: a key tile that many query
//   tiles see, under causal key tile 0, is split over blocks, so that no
//   block's chain of tiles sets the launch's time). For each pair it forms
//   S and dP once, then p and ds once into shared memory, and walks the
//   width in 64-column chunks: dV, dK and dQ are added to zeroed fp32
//   workspaces by atomics. So nothing is formed twice, at the price of the
//   accumulators' traffic through the L2, and dk and dv, like dq, sum
//   their parts in whatever order the blocks run.
//
// 256 threads a block. fp32 (flash_wide_fwd_kernel, flash_wide_bwd_kernel)
// runs on the CUDA cores, each thread a 4 x 4 tile of every product. bf16
// (flash_wide_fwd_tc_kernel, flash_wide_bwd_tc_kernel) runs every product
// on the tensor cores, mma.sync m16n8k16 with fp32 accumulators, each warp
// a (16 x 32) part of every (64 x 64) product, the logits, dP and the
// accumulators passing through shared memory to the same entry-wise steps
// (the online softmax, p and ds), which round p and ds to bf16 where the
// products read them. No wgmma, no TMA: a simple design first.
//
// What bounds them, at TGAT's flash shape (B = 8, T = 2048, H = 1, D =
// 2,048, DV = 512, causal, every key live): the operations, 0.087 ms
// forward and 0.243 backward in bf16 at 989 TFLOP/s (1.28 and 3.59 in fp32
// at 67). The bf16 kernels take ~1.2 and ~5.2 ms: without their products
// they take as long, so what bounds them is streaming a tile pair's chunks
// from the L2 (the forward ~576 KB a pair, q read again for every key tile)
// and, backward, the atomic additions (~1.8 ms of it); fp32 (~4 and ~10
// ms) is bound by its CUDA-core products (scripts/torch_ablate.py wide,
// PERF.md).
//
// Padding is skipped as in flash_attention.cu: the wrapper codes each (batch
// row, 64-key tile) by flash_live_tiles, no dead tile is visited and under
// causal a query tile takes the key tiles up to its last query, a key tile
// the query tiles from its diagonal on. Every entry of a visited tile is
// tested (cheap beside the width).

#include "launch.cuh"

namespace {

constexpr int kT = 64;          // queries and keys a tile
constexpr int kDC = 32;         // width chunk of the S and dP products
constexpr int kOC = 64;         // width chunk of the output products
constexpr int kThreads = 256;   // 16 x 16 threads, each a 4 x 4 tile
constexpr int kMaxOut = 512;    // output columns one forward block holds
constexpr int kQGroup = 4;      // query tiles one backward block takes
constexpr int kLdC = kDC + 1;   // row strides in shared memory, in floats
constexpr int kLdT = kT + 1;
constexpr int kLdO = kOC + 4;   // float4 rows
constexpr float kDead = -1.0e38f;

struct Seq {
  const void* p;
  long long bs, hs, rs;  // batch, head and row strides, in elements
};

struct WideParams {
  Seq q, k, v, dout;
  const float* key_mask;  // (B, Tk)
  const int* live;        // (B, ceil(Tk / 64)) flash_live_tiles
  const float* lse;       // (B, H, Tq), the backward's
  const float* delta;     // (B, H, Tq)
  void* out;              // (B, H, Tq, DV) contiguous, the forward's
  float* lse_out;         // (B, H, Tq)
  float *dq, *dk, *dv;    // (B, H, T, D or DV) fp32 workspaces, zeroed
  const long long* seed;  // dropout seed on the device, or null
  unsigned drop_thresh;
  float drop_scale, scale;
  int B, H, Tq, Tk, D, DV, causal;
};

template <typename T>
__device__ __forceinline__ const T* head(const Seq& s, int b, int h) {
  return static_cast<const T*>(s.p) + b * s.bs + h * s.hs;
}

__device__ __forceinline__ bool visible(float km, int i, int j, int Tq, int Tk, int causal) {
  return (i < Tq) & (j < Tk) & (km > 0.f) & !(causal & (j > i));
}

// A (64 x W) chunk of a row-major source, fetched into registers as 16-byte
// vectors (rows >= nrows read as zeros) and then widened to fp32 into shared
// memory: fetch the next chunk while the current one is used.
template <typename T, int W>
struct Chunk {
  static constexpr int V = 16 / sizeof(T), NV = W / V, N = kT * NV / kThreads;
  static_assert(kT * NV % kThreads == 0, "a whole number of vectors a thread");
  uint4 raw[N];

  __device__ __forceinline__ void fetch(const T* src, long long rs, int r0, int nrows, int c0) {
#pragma unroll
    for (int n = 0; n < N; ++n) {
      const int idx = threadIdx.x + n * kThreads, r = idx / NV, c = (idx - r * NV) * V;
      raw[n] = r0 + r < nrows
                   ? __ldg(reinterpret_cast<const uint4*>(src + (long long)(r0 + r) * rs + c0 + c))
                   : make_uint4(0u, 0u, 0u, 0u);
    }
  }

  __device__ __forceinline__ void store(float* dst, int ld) const {
#pragma unroll
    for (int n = 0; n < N; ++n) {
      const int idx = threadIdx.x + n * kThreads, r = idx / NV, c = (idx - r * NV) * V;
      const T* x = reinterpret_cast<const T*>(&raw[n]);
#pragma unroll
      for (int e = 0; e < V; ++e) dst[r * ld + c + e] = to_f(x[e]);
    }
  }
};

// acc (rows ty + 16 i, cols tx + 16 j) += A B^T over the `kDC` columns of
// the staged chunks a and b (row stride kLdC).
__device__ __forceinline__ void mul_abt(float (&acc)[4][4], const float* a, const float* b,
                                        int ty, int tx) {
#pragma unroll 8
  for (int kk = 0; kk < kDC; ++kk) {
    float x[4], y[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) x[i] = a[(ty + 16 * i) * kLdC + kk];
#pragma unroll
    for (int j = 0; j < 4; ++j) y[j] = b[(tx + 16 * j) * kLdC + kk];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(x[i], y[j], acc[i][j]);
  }
}

// acc = sum over the width of rows [a0, a0 + 64) of a and [b0, b0 + 64) of b
// (width `width`, a multiple of kDC), through the staging buffers as, bs.
template <typename T>
__device__ __forceinline__ void products(float (&acc)[4][4], const T* a, long long ars, int a0,
                                         int na, const T* b, long long brs, int b0, int nb,
                                         int width, float* as, float* bs, int ty, int tx) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  Chunk<T, kDC> ca, cb;
  ca.fetch(a, ars, a0, na, 0);
  cb.fetch(b, brs, b0, nb, 0);
  for (int d0 = 0; d0 < width; d0 += kDC) {
    __syncthreads();  // the previous chunk is consumed
    ca.store(as, kLdC);
    cb.store(bs, kLdC);
    __syncthreads();
    if (d0 + kDC < width) {
      ca.fetch(a, ars, a0, na, d0 + kDC);
      cb.fetch(b, brs, b0, nb, d0 + kDC);
    }
    mul_abt(acc, as, bs, ty, tx);
  }
}

// acc (rows ty + 16 i, cols 4 tx .. 4 tx + 3) = sum_r w[r][row] x[r][col]
// (`trans`: w is read [row][r]) over the 64 rows of x (row stride kLdO) and of
// w (row stride kLdT).
template <bool kTrans>
__device__ __forceinline__ void mul_wx(float (&acc)[4][4], const float* w, const float* x,
                                       int ty, int tx) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][e] = 0.f;
#pragma unroll 8
  for (int r = 0; r < kT; ++r) {
    const float4 xv = *reinterpret_cast<const float4*>(x + r * kLdO + 4 * tx);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float a = kTrans ? w[(ty + 16 * i) * kLdT + r] : w[r * kLdT + ty + 16 * i];
      acc[i][0] = fmaf(a, xv.x, acc[i][0]);
      acc[i][1] = fmaf(a, xv.y, acc[i][1]);
      acc[i][2] = fmaf(a, xv.z, acc[i][2]);
      acc[i][3] = fmaf(a, xv.w, acc[i][3]);
    }
  }
}

__device__ __forceinline__ float4 fma4(float4 a, float s, const float (&b)[4]) {
  return make_float4(fmaf(a.x, s, b[0]), fmaf(a.y, s, b[1]), fmaf(a.z, s, b[2]),
                     fmaf(a.w, s, b[3]));
}

__device__ __forceinline__ float reduce16_max(float x) {
#pragma unroll
  for (int o = 1; o < 16; o <<= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float reduce16_sum(float x) {
#pragma unroll
  for (int o = 1; o < 16; o <<= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// ---------------------------------------------------------------- forward
// A block: 64 queries of one (b, h) and up to 512 output columns [oc0, oc0 +
// ow), heaviest query tiles first under causal. Shared memory: the q and k
// chunks, the rounded dropped probs, a v chunk, the key mask and the (64 x
// ow) fp32 output accumulator.

__host__ __device__ constexpr size_t fwd_smem(int ow) {
  return sizeof(float) * (2 * kT * kLdC + kT * kLdT + kT * kLdO + kT + kT * ow);
}

__global__ void __launch_bounds__(kThreads) flash_wide_fwd_kernel(const WideParams p, int ow_max) {
  using T = float;
  extern __shared__ __align__(16) float smem[];
  float* qc = smem;            // [64][kLdC]
  float* kc = qc + kT * kLdC;  // [64][kLdC]
  float* ps = kc + kT * kLdC;  // [64][kLdT] rnd(p keep)
  float* vc = ps + kT * kLdT;  // [64][kLdO]
  float* kms = vc + kT * kLdO; // [64]
  float* os = kms + kT;        // [64][ow], allocated [64][ow_max]

  const int nqt = (p.Tq + kT - 1) / kT, noc = (p.DV + kMaxOut - 1) / kMaxOut;
  const int BH = p.B * p.H, bh = blockIdx.x % BH, rest = blockIdx.x / BH;
  const int oc = rest % noc, qt = nqt - 1 - rest / noc;
  const int b = bh / p.H, h = bh - b * p.H, q0 = qt * kT, oc0 = oc * kMaxOut;
  const int ow = imin(ow_max, p.DV - oc0);
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const int nkt_all = (p.Tk + kT - 1) / kT;
  const int nkt = p.causal ? imin(nkt_all, (imin(q0 + kT, p.Tq) - 1) / kT + 1) : nkt_all;
  const int* live_row = p.live + (size_t)b * nkt_all;
  const float* km_row = p.key_mask + (size_t)b * p.Tk;
  const T* qg = head<T>(p.q, b, h);
  const T* kg = head<T>(p.k, b, h);
  const T* vg = head<T>(p.v, b, h);
  const Dropout drop = make_dropout(p.seed, p.drop_thresh, p.drop_scale);
  const float sl2 = p.scale * kLog2e;

  for (int idx = threadIdx.x; idx < kT * ow; idx += kThreads) os[idx] = 0.f;
  __syncthreads();  // each thread updates the entries of its own tiles
  float m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) m[i] = kDead, l[i] = 0.f;

  for (int kt = 0; kt < nkt; ++kt) {
    if (live_row[kt] == 0) continue;
    const int j0 = kt * kT;
    if (threadIdx.x < kT) kms[threadIdx.x] = j0 + threadIdx.x < p.Tk ? km_row[j0 + threadIdx.x] : 0.f;
    float s[4][4];
    products<T>(s, qg, p.q.rs, q0, p.Tq, kg, p.k.rs, j0, p.Tk, p.D, qc, kc, ty, tx);
    Chunk<T, kOC> cv;
    cv.fetch(vg, p.v.rs, j0, p.Tk, oc0);
    // the online softmax; without a branch, a hidden entry's exponent is
    // -inf, so p = 0; the max runs in log2 units
    float corr[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qi = q0 + ty + 16 * i;
      float mx = kDead;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kj = tx + 16 * j;
        s[i][j] = visible(kms[kj], qi, j0 + kj, p.Tq, p.Tk, p.causal) ? s[i][j] * sl2 : -INFINITY;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], reduce16_max(mx));
      corr[i] = exp2f(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kj = tx + 16 * j;
        float x = exp2f(s[i][j] - m_new);
        sum += x;  // l sums the undropped probs
        if (drop.on) x *= drop.factor(b, h, qi, j0 + kj);
        ps[(ty + 16 * i) * kLdT + kj] = rnd<T>(x);
      }
      l[i] = l[i] * corr[i] + reduce16_sum(sum);
      m[i] = m_new;
    }
    // O = O corr + rnd(p keep) @ V, chunk by chunk of 64 columns
    for (int c0 = 0; c0 < ow; c0 += kOC) {
      __syncthreads();  // ps is whole; vc is free
      cv.store(vc, kLdO);
      __syncthreads();
      if (c0 + kOC < ow) cv.fetch(vg, p.v.rs, j0, p.Tk, oc0 + c0 + kOC);
      float acc[4][4];
      mul_wx<true>(acc, ps, vc, ty, tx);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float4* o = reinterpret_cast<float4*>(os + (ty + 16 * i) * ow + c0 + 4 * tx);
        *o = fma4(*o, corr[i], acc[i]);
      }
    }
    __syncthreads();  // ps, vc and kms are free for the next tile
  }

  T* og = static_cast<T*>(p.out) + ((size_t)bh * p.Tq) * p.DV + oc0;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + ty + 16 * i;
    if (qi >= p.Tq) continue;
    const float inv = l[i] > 0.f ? 1.f / fmaxf(l[i], 1e-37f) : 0.f;
    for (int c = 4 * tx; c < ow; c += 4 * 16) {
      const float* o = os + (ty + 16 * i) * ow + c;
#pragma unroll
      for (int e = 0; e < 4; ++e) og[(size_t)qi * p.DV + c + e] = from_f<T>(o[e] * inv);
    }
    if (oc == 0 && tx == 0) {
      // a row that saw no key keeps m = -1e38 in natural units
      const float mn = l[i] > 0.f ? m[i] * kLn2 : kDead;
      p.lse_out[(size_t)bh * p.Tq + qi] = mn + logf(fmaxf(l[i], 1e-37f));
    }
  }
}

// ---------------------------------------------------------------- backward
// A block: one 64-key tile of one (b, h), key tile 0 (which every query tile
// sees under causal) first. Shared memory: the staging chunks, rnd(p keep)
// and rnd(ds) of the pair ([query][key]), an operand chunk and the key mask.

// The backward's work a block: key tile kt of (b, h) = bh and the query
// tiles [qt0, qt1) that can see it, at most kQGroup of them, so that a key
// tile that many query tiles see (under causal key tile 0 sees them all) is
// split over blocks and no block's chain of tiles is the launch's. Key tile
// 0's groups first. False where the block has no work: a dead key tile (its
// dk and dv rows stay 0) or a group past the last query tile.
__device__ __forceinline__ bool bwd_block(const WideParams& p, int& kt, int& bh, int& qt0,
                                          int& qt1) {
  const int nkt = (p.Tk + kT - 1) / kT, nqt = (p.Tq + kT - 1) / kT, BH = p.B * p.H;
  const int ng = (nqt + kQGroup - 1) / kQGroup;
  kt = blockIdx.x / (ng * BH);
  const int rest = blockIdx.x - kt * ng * BH, grp = rest / BH;
  bh = rest - grp * BH;
  qt0 = (p.causal ? kt : 0) + grp * kQGroup;
  qt1 = imin(nqt, qt0 + kQGroup);
  return qt0 < nqt && p.live[(size_t)(bh / p.H) * nkt + kt] != 0;
}

constexpr size_t kBwdSmem = sizeof(float) * (2 * kT * kLdC + 2 * kT * kLdT + kT * kLdO + kT);

// dst rows [r0, r0 + 64) (row stride ld; rows >= nrows skipped), columns c0
// + 4 tx .. + 3 of the 4 x 4 tile: add scale * acc by atomics.
__device__ __forceinline__ void add_rows(float* dst, int ld, int r0, int nrows, int c0,
                                         const float (&acc)[4][4], float scale, int ty, int tx) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = r0 + ty + 16 * i;
    if (r >= nrows) continue;
    float* d = dst + (size_t)r * ld + c0 + 4 * tx;
    atomicAdd(reinterpret_cast<float2*>(d), make_float2(acc[i][0] * scale, acc[i][1] * scale));
    atomicAdd(reinterpret_cast<float2*>(d + 2), make_float2(acc[i][2] * scale, acc[i][3] * scale));
  }
}

// acc rows of w (transposed or not) times chunks of x over the width
// `width`: for each 64-column chunk, dst += scale * w x.
template <typename T, bool kTrans>
__device__ __forceinline__ void accumulate(float* dst, int r0, int nrows, const float* w,
                                           const T* x, long long xrs, int x0, int nx, int width,
                                           float scale, float* xc, int ty, int tx) {
  Chunk<T, kOC> cx;
  cx.fetch(x, xrs, x0, nx, 0);
  for (int c0 = 0; c0 < width; c0 += kOC) {
    __syncthreads();  // xc is free
    cx.store(xc, kLdO);
    __syncthreads();
    if (c0 + kOC < width) cx.fetch(x, xrs, x0, nx, c0 + kOC);
    float acc[4][4];
    mul_wx<kTrans>(acc, w, xc, ty, tx);
    add_rows(dst, width, r0, nrows, c0, acc, scale, ty, tx);
  }
}

__global__ void __launch_bounds__(kThreads) flash_wide_bwd_kernel(const WideParams p) {
  using T = float;
  extern __shared__ __align__(16) float smem[];
  float* ac = smem;             // [64][kLdC]
  float* bc = ac + kT * kLdC;   // [64][kLdC]
  float* ps = bc + kT * kLdC;   // [64 queries][kLdT] rnd(p keep)
  float* dss = ps + kT * kLdT;  // [64 queries][kLdT] rnd(ds)
  float* xc = dss + kT * kLdT;  // [64][kLdO]
  float* kms = xc + kT * kLdO;  // [64]

  int kt, bh, qt0, qt1;
  if (!bwd_block(p, kt, bh, qt0, qt1)) return;
  const int k0 = kt * kT, b = bh / p.H, h = bh - b * p.H;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const T* qg = head<T>(p.q, b, h);
  const T* kg = head<T>(p.k, b, h);
  const T* vg = head<T>(p.v, b, h);
  const T* dog = head<T>(p.dout, b, h);
  const float* lse = p.lse + (size_t)bh * p.Tq;
  const float* delta = p.delta + (size_t)bh * p.Tq;
  float* dq = p.dq + (size_t)bh * p.Tq * p.D;
  float* dk = p.dk + (size_t)bh * p.Tk * p.D;
  float* dv = p.dv + (size_t)bh * p.Tk * p.DV;
  const Dropout drop = make_dropout(p.seed, p.drop_thresh, p.drop_scale);
  if (threadIdx.x < kT)
    kms[threadIdx.x] = k0 + threadIdx.x < p.Tk ? p.key_mask[(size_t)b * p.Tk + k0 + threadIdx.x] : 0.f;

  for (int qt = qt0; qt < qt1; ++qt) {
    const int q0 = qt * kT;
    float s[4][4], dp[4][4];
    products<T>(s, qg, p.q.rs, q0, p.Tq, kg, p.k.rs, k0, p.Tk, p.D, ac, bc, ty, tx);
    products<T>(dp, dog, p.dout.rs, q0, p.Tq, vg, p.v.rs, k0, p.Tk, p.DV, ac, bc, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qi = q0 + ty + 16 * i;
      const float ls = qi < p.Tq ? lse[qi] : 0.f, dl = qi < p.Tq ? delta[qi] : 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kj = tx + 16 * j;
        const bool vis = visible(kms[kj], qi, k0 + kj, p.Tq, p.Tk, p.causal);
        const float pr = expf(vis ? s[i][j] * p.scale - ls : -INFINITY);
        float d = dp[i][j], pd = pr;
        if (drop.on) {
          const float keep = drop.factor(b, h, qi, k0 + kj);
          pd *= keep;
          d *= keep;
        }
        ps[(ty + 16 * i) * kLdT + kj] = rnd<T>(pd);
        dss[(ty + 16 * i) * kLdT + kj] = rnd<T>(pr * (d - dl));
      }
    }
    // dv += rnd(p keep)^T dO, dk += scale rnd(ds)^T Q, dq += scale rnd(ds) K
    accumulate<T, false>(dv, k0, p.Tk, ps, dog, p.dout.rs, q0, p.Tq, p.DV, 1.f, xc, ty, tx);
    accumulate<T, false>(dk, k0, p.Tk, dss, qg, p.q.rs, q0, p.Tq, p.D, p.scale, xc, ty, tx);
    accumulate<T, true>(dq, q0, p.Tq, dss, kg, p.k.rs, k0, p.Tk, p.D, p.scale, xc, ty, tx);
    __syncthreads();  // ps, dss and xc are free for the next query tile
  }
}

// ---------------------------------------------------------------- bf16
// The same two schedules with every product on the tensor cores (mma.sync
// m16n8k16, bf16 operands, fp32 accumulators). The 64-column bf16 chunks of
// the operands stream through a ring of shared-memory slots by cp.async,
// several in flight (`pipeline`), in their own layout (row stride kLdB:
// ldmatrix without bank conflicts); each of the 8 warps takes a (16 x 32)
// part of every (64 x 64) product; the logits, dP and the fp32 accumulators
// pass through shared memory to the same entry-wise steps as above, which
// round p and ds to bf16 where the products read them.

constexpr int kLdB = kOC + 8;         // bf16 row stride of a staged (64 x 64) tile
constexpr int kTileB = kT * kLdB;     // bf16 values of a staged tile
constexpr int kStagesFwd = 3;         // ring slots: the forward's 1 block an SM
constexpr int kStagesBwd = 2;         // the backward's 2 blocks an SM

__device__ __forceinline__ void cp_async_16(void* dst, const void* src, bool ok) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(ok ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit_group() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait_group() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Rows [r0, r0 + 64) x columns [c0, c0 + 64) of a bf16 source (row stride
// rs) into a staged tile by cp.async; rows >= nrows are zero-filled.
__device__ __forceinline__ void tile_async(bf16* dst, const bf16* src, long long rs, int r0,
                                           int nrows, int c0) {
  for (int idx = threadIdx.x; idx < kT * (kOC / 8); idx += kThreads) {
    const int r = idx / (kOC / 8), c = (idx - r * (kOC / 8)) * 8;
    const bool ok = r0 + r < nrows;
    cp_async_16(dst + r * kLdB + c, src + (long long)(ok ? r0 + r : 0) * rs + c0 + c, ok);
  }
}

// `steps` chunks through a ring of kStages slots of `per` staged tiles:
// issue(step, slot) starts a chunk's copies, use(step, slot) consumes it
// once it has landed; kStages - 1 chunks are in flight while one is used.
// Ends with every copy landed and every warp past its last use, so the
// ring is free for the next pipeline.
template <int kStages, typename Issue, typename Use>
__device__ __forceinline__ void pipeline(int steps, bf16* ring, int per, Issue issue, Use use) {
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < steps) issue(s, ring + s * per * kTileB);
    cp_async_commit_group();
  }
  for (int step = 0; step < steps; ++step) {
    cp_async_wait_group<kStages - 2>();
    __syncthreads();  // the chunk is visible; the slot used last step is free
    const int next = step + kStages - 1;
    if (next < steps) issue(next, ring + (next % kStages) * per * kTileB);
    cp_async_commit_group();
    use(step, ring + (step % kStages) * per * kTileB);
  }
  cp_async_wait_group<0>();
  __syncthreads();
}

// acc (rows m0 + g + 8 (c >> 1), columns n0 + 8 t + 2 t4 + (c & 1)) += A B
// over 64 k: A [m][k] (stride lda), B as its rows [n][k] (kTransB false) or
// [k][n] (true), both bf16 in shared memory.
template <bool kTransB>
__device__ __forceinline__ void mma_16x32(float (&acc)[4][4], const bf16* A, int lda, int m0,
                                          const bf16* Bm, int ldb, int n0, int lane) {
#pragma unroll
  for (int k0 = 0; k0 < kOC; k0 += 16) {
    uint32_t a[4];
    ldmatrix_x4(a, A + (m0 + (lane & 15)) * lda + k0 + (lane >> 4) * 8);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      uint32_t bq[4];
      const int nn = n0 + 16 * h;
      if constexpr (kTransB)
        ldmatrix_x4_trans(bq, Bm + (k0 + ((lane >> 3) & 1) * 8 + (lane & 7)) * ldb + nn +
                                  (lane >> 4) * 8);
      else
        ldmatrix_x4(bq, Bm + (nn + (lane >> 4) * 8 + (lane & 7)) * ldb + k0 +
                            ((lane >> 3) & 1) * 8);
      mma_bf16(acc[2 * h], a, bq[0], bq[1]);
      mma_bf16(acc[2 * h + 1], a, bq[2], bq[3]);
    }
  }
}

__device__ __forceinline__ void zero44(float (&acc)[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
}

// S (64 x 64, fp32, row stride kLdT) = rows [a0, a0 + 64) of a times rows
// [b0, b0 + 64) of b over the width (a multiple of 64), the two operands'
// chunks streamed through the ring.
template <int kStages>
__device__ __forceinline__ void products_tc(float* out, const bf16* a, long long ars, int a0,
                                            int na, const bf16* b, long long brs, int b0, int nb,
                                            int width, bf16* ring, int warp, int lane) {
  const int m0 = (warp & 3) * 16, n0 = (warp >> 2) * 32, g = lane >> 2, t4 = lane & 3;
  float acc[4][4];
  zero44(acc);
  pipeline<kStages>(
      width / kOC, ring, 2,
      [&](int step, bf16* slot) {
        tile_async(slot, a, ars, a0, na, step * kOC);
        tile_async(slot + kTileB, b, brs, b0, nb, step * kOC);
      },
      [&](int, const bf16* slot) {
        mma_16x32<false>(acc, slot, kLdB, m0, slot + kTileB, kLdB, n0, lane);
      });
#pragma unroll
  for (int t = 0; t < 4; ++t)
#pragma unroll
    for (int c = 0; c < 4; ++c)
      out[(m0 + g + 8 * (c >> 1)) * kLdT + n0 + 8 * t + 2 * t4 + (c & 1)] = acc[t][c];
}

__host__ __device__ constexpr size_t fwd_tc_smem(int ow) {
  return sizeof(bf16) * (2 * kStagesFwd + 1) * kTileB +
         sizeof(float) * (kT * kLdT + 2 * kT + kT * ow);
}

__global__ void __launch_bounds__(kThreads) flash_wide_fwd_tc_kernel(const WideParams p,
                                                                     int ow_max) {
  extern __shared__ __align__(16) unsigned char smem_tc[];
  bf16* ring = reinterpret_cast<bf16*>(smem_tc);  // [kStagesFwd][2][64][kLdB] q and k, or v
  bf16* pb = ring + 2 * kStagesFwd * kTileB;       // [64][kLdB] rnd(p keep), [query][key]
  float* ss = reinterpret_cast<float*>(pb + kTileB);  // [64][kLdT] S
  float* kms = ss + kT * kLdT;                        // [64]
  float* cs = kms + kT;                               // [64] the rows' corrections
  float* os = cs + kT;                                // [64][ow]

  const int nqt = (p.Tq + kT - 1) / kT, noc = (p.DV + kMaxOut - 1) / kMaxOut;
  const int BH = p.B * p.H, bh = blockIdx.x % BH, rest = blockIdx.x / BH;
  const int oc = rest % noc, qt = nqt - 1 - rest / noc;
  const int b = bh / p.H, h = bh - b * p.H, q0 = qt * kT, oc0 = oc * kMaxOut;
  const int ow = imin(ow_max, p.DV - oc0);
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t4 = lane & 3;
  const int m0 = (warp & 3) * 16, n0 = (warp >> 2) * 32;
  const int nkt_all = (p.Tk + kT - 1) / kT;
  const int nkt = p.causal ? imin(nkt_all, (imin(q0 + kT, p.Tq) - 1) / kT + 1) : nkt_all;
  const int* live_row = p.live + (size_t)b * nkt_all;
  const float* km_row = p.key_mask + (size_t)b * p.Tk;
  const bf16* qg = head<bf16>(p.q, b, h);
  const bf16* kg = head<bf16>(p.k, b, h);
  const bf16* vg = head<bf16>(p.v, b, h);
  const Dropout drop = make_dropout(p.seed, p.drop_thresh, p.drop_scale);
  const float sl2 = p.scale * kLog2e;

  for (int idx = threadIdx.x; idx < kT * ow; idx += kThreads) os[idx] = 0.f;
  float m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) m[i] = kDead, l[i] = 0.f;

  for (int kt = 0; kt < nkt; ++kt) {
    if (live_row[kt] == 0) continue;
    const int j0 = kt * kT;
    if (threadIdx.x < kT) kms[threadIdx.x] = j0 + threadIdx.x < p.Tk ? km_row[j0 + threadIdx.x] : 0.f;
    products_tc<kStagesFwd>(ss, qg, p.q.rs, q0, p.Tq, kg, p.k.rs, j0, p.Tk, p.D, ring, warp,
                            lane);
    __syncthreads();  // S is whole
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i, qi = q0 + r;
      float s[4], mx = kDead;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kj = tx + 16 * j;
        s[j] = visible(kms[kj], qi, j0 + kj, p.Tq, p.Tk, p.causal) ? ss[r * kLdT + kj] * sl2
                                                                    : -INFINITY;
        mx = fmaxf(mx, s[j]);
      }
      const float m_new = fmaxf(m[i], reduce16_max(mx));
      const float corr = exp2f(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kj = tx + 16 * j;
        float x = exp2f(s[j] - m_new);
        sum += x;  // l sums the undropped probs
        if (drop.on) x *= drop.factor(b, h, qi, j0 + kj);
        pb[r * kLdB + kj] = __float2bfloat16(x);
      }
      l[i] = l[i] * corr + reduce16_sum(sum);
      m[i] = m_new;
      if (tx == 0) cs[r] = corr;
    }
    // O = O corr + rnd(p keep) @ V, chunk by chunk of 64 columns; each
    // thread updates the accumulator entries of its fragments
    pipeline<kStagesFwd>(
        ow / kOC, ring, 1,
        [&](int step, bf16* slot) { tile_async(slot, vg, p.v.rs, j0, p.Tk, oc0 + step * kOC); },
        [&](int step, const bf16* slot) {
          float acc[4][4];
          zero44(acc);
          mma_16x32<true>(acc, pb, kLdB, m0, slot, kLdB, n0, lane);
#pragma unroll
          for (int t = 0; t < 4; ++t)
#pragma unroll
            for (int c = 0; c < 4; ++c) {
              const int r = m0 + g + 8 * (c >> 1);
              float& o = os[r * ow + step * kOC + n0 + 8 * t + 2 * t4 + (c & 1)];
              o = fmaf(o, cs[r], acc[t][c]);
            }
        });
  }
  __syncthreads();  // where no key tile was visited: the zeroed accumulator

  bf16* og = static_cast<bf16*>(p.out) + ((size_t)bh * p.Tq) * p.DV + oc0;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + ty + 16 * i;
    if (qi >= p.Tq) continue;
    const float inv = l[i] > 0.f ? 1.f / fmaxf(l[i], 1e-37f) : 0.f;
    for (int c = 4 * tx; c < ow; c += 4 * 16) {
      const float* o = os + (ty + 16 * i) * ow + c;
#pragma unroll
      for (int e = 0; e < 4; ++e) og[(size_t)qi * p.DV + c + e] = __float2bfloat16(o[e] * inv);
    }
    if (oc == 0 && tx == 0) {
      const float mn = l[i] > 0.f ? m[i] * kLn2 : kDead;
      p.lse_out[(size_t)bh * p.Tq + qi] = mn + logf(fmaxf(l[i], 1e-37f));
    }
  }
}

constexpr size_t kBwdTcSmem =
    sizeof(bf16) * (2 * kStagesBwd + 3) * kTileB + sizeof(float) * (2 * kT * kLdT + kT);

// dst rows [r0, r0 + 64) (row stride: the width) += scale * w x over the
// width, x's 64-column chunks (rows [x0, x0 + 64)) streamed through the
// ring: w [m][k] bf16 (row stride kLdB), each warp a (16 x 32) part of a
// chunk; added by atomics.
__device__ __forceinline__ void accumulate_tc(float* dst, int r0, int nrows, const bf16* w,
                                              const bf16* x, long long xrs, int x0, int nx,
                                              int width, float scale, bf16* ring, int warp,
                                              int lane) {
  const int m0 = (warp & 3) * 16, n0 = (warp >> 2) * 32, g = lane >> 2, t4 = lane & 3;
  pipeline<kStagesBwd>(
      width / kOC, ring, 1,
      [&](int step, bf16* slot) { tile_async(slot, x, xrs, x0, nx, step * kOC); },
      [&](int step, const bf16* slot) {
        float acc[4][4];
        zero44(acc);
        mma_16x32<true>(acc, w, kLdB, m0, slot, kLdB, n0, lane);
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          const int r = r0 + m0 + g + 8 * hr;
          if (r >= nrows) continue;
#pragma unroll
          for (int t = 0; t < 4; ++t)
            atomicAdd(reinterpret_cast<float2*>(dst + (size_t)r * width + step * kOC + n0 +
                                                8 * t + 2 * t4),
                      make_float2(acc[t][2 * hr] * scale, acc[t][2 * hr + 1] * scale));
        }
      });
}

__global__ void __launch_bounds__(kThreads) flash_wide_bwd_tc_kernel(const WideParams p) {
  extern __shared__ __align__(16) unsigned char smem_tc[];
  bf16* ring = reinterpret_cast<bf16*>(smem_tc);  // [kStagesBwd][2][64][kLdB]
  bf16* ptb = ring + 2 * kStagesBwd * kTileB;      // [64 keys][kLdB] rnd(p keep)^T
  bf16* dstb = ptb + kTileB;                       // [64 keys][kLdB] rnd(ds)^T
  bf16* dsb = dstb + kTileB;                       // [64 queries][kLdB] rnd(ds)
  float* ss = reinterpret_cast<float*>(dsb + kTileB);  // [64][kLdT] S
  float* dps = ss + kT * kLdT;                         // [64][kLdT] dP
  float* kms = dps + kT * kLdT;                        // [64]

  int kt, bh, qt0, qt1;
  if (!bwd_block(p, kt, bh, qt0, qt1)) return;
  const int k0 = kt * kT, b = bh / p.H, h = bh - b * p.H;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const bf16* qg = head<bf16>(p.q, b, h);
  const bf16* kg = head<bf16>(p.k, b, h);
  const bf16* vg = head<bf16>(p.v, b, h);
  const bf16* dog = head<bf16>(p.dout, b, h);
  const float* lse = p.lse + (size_t)bh * p.Tq;
  const float* delta = p.delta + (size_t)bh * p.Tq;
  float* dq = p.dq + (size_t)bh * p.Tq * p.D;
  float* dk = p.dk + (size_t)bh * p.Tk * p.D;
  float* dv = p.dv + (size_t)bh * p.Tk * p.DV;
  const Dropout drop = make_dropout(p.seed, p.drop_thresh, p.drop_scale);
  if (threadIdx.x < kT)
    kms[threadIdx.x] = k0 + threadIdx.x < p.Tk ? p.key_mask[(size_t)b * p.Tk + k0 + threadIdx.x] : 0.f;

  for (int qt = qt0; qt < qt1; ++qt) {
    const int q0 = qt * kT;
    products_tc<kStagesBwd>(ss, qg, p.q.rs, q0, p.Tq, kg, p.k.rs, k0, p.Tk, p.D, ring, warp,
                            lane);
    products_tc<kStagesBwd>(dps, dog, p.dout.rs, q0, p.Tq, vg, p.v.rs, k0, p.Tk, p.DV, ring,
                            warp, lane);
    __syncthreads();  // S and dP are whole
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i, qi = q0 + r;
      const float ls = qi < p.Tq ? lse[qi] : 0.f, dl = qi < p.Tq ? delta[qi] : 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kj = tx + 16 * j;
        const bool vis = visible(kms[kj], qi, k0 + kj, p.Tq, p.Tk, p.causal);
        const float pr = expf(vis ? ss[r * kLdT + kj] * p.scale - ls : -INFINITY);
        float d = dps[r * kLdT + kj], pd = pr;
        if (drop.on) {
          const float keep = drop.factor(b, h, qi, k0 + kj);
          pd *= keep;
          d *= keep;
        }
        const bf16 ds = __float2bfloat16(pr * (d - dl));
        ptb[kj * kLdB + r] = __float2bfloat16(pd);
        dstb[kj * kLdB + r] = ds;
        dsb[r * kLdB + kj] = ds;
      }
    }
    // dv += rnd(p keep)^T dO, dk += scale rnd(ds)^T Q, dq += scale rnd(ds) K
    accumulate_tc(dv, k0, p.Tk, ptb, dog, p.dout.rs, q0, p.Tq, p.DV, 1.f, ring, warp, lane);
    accumulate_tc(dk, k0, p.Tk, dstb, qg, p.q.rs, q0, p.Tq, p.D, p.scale, ring, warp, lane);
    accumulate_tc(dq, q0, p.Tq, dsb, kg, p.k.rs, k0, p.Tk, p.D, p.scale, ring, warp, lane);
  }
}

cudaError_t launch_t(int which, const WideParams& p, int dtype, cudaStream_t s) {
  const int BH = p.B * p.H, nqt = (p.Tq + kT - 1) / kT, nkt = (p.Tk + kT - 1) / kT;
  const dim3 bwd_grid(BH * nkt * ((nqt + kQGroup - 1) / kQGroup));
  if (which == 0) {
    const int ow = imin(p.DV, kMaxOut), noc = (p.DV + kMaxOut - 1) / kMaxOut;
    const dim3 grid(BH * nqt * noc);
    return dtype ? go(flash_wide_fwd_tc_kernel, grid, kThreads, fwd_tc_smem(ow), s, p, ow)
                 : go(flash_wide_fwd_kernel, grid, kThreads, fwd_smem(ow), s, p, ow);
  }
  return dtype ? go(flash_wide_bwd_tc_kernel, bwd_grid, kThreads, kBwdTcSmem, s, p)
               : go(flash_wide_bwd_kernel, bwd_grid, kThreads, kBwdSmem, s, p);
}

int launch(int which, WideParams p, int dtype, void* stream) {
  if (p.B < 1 || p.H < 1 || p.Tq < 1 || p.Tk < 1 || p.D < kOC || p.DV < kOC || p.D % kOC ||
      p.DV % kOC || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)launch_t(which, p, dtype, s);
}

WideParams base_params(const void* q, long long q_bs, long long q_hs, long long q_rs,
                       const void* k, long long k_bs, long long k_hs, long long k_rs,
                       const void* v, long long v_bs, long long v_hs, long long v_rs,
                       const void* key_mask, const void* live, const void* seed,
                       unsigned drop_thresh, float drop_scale, int B, int H, int Tq, int Tk,
                       int D, int DV, int causal, float scale) {
  WideParams p = {};
  p.q = {q, q_bs, q_hs, q_rs};
  p.k = {k, k_bs, k_hs, k_rs};
  p.v = {v, v_bs, v_hs, v_rs};
  p.key_mask = static_cast<const float*>(key_mask);
  p.live = static_cast<const int*>(live);
  p.seed = static_cast<const long long*>(seed);
  p.drop_thresh = drop_thresh;
  p.drop_scale = drop_scale;
  p.scale = scale;
  p.B = B; p.H = H; p.Tq = Tq; p.Tk = Tk; p.D = D; p.DV = DV; p.causal = causal;
  return p;
}

}  // namespace

extern "C" {

// Each launches on `stream` and returns cudaGetLastError() (0 on success).
// dtype: 0 = float32, 1 = bfloat16 (q, k, v, dO and out). q and k are D
// wide, v, dO and out DV wide, both multiples of 64; strides in elements,
// channels contiguous, rows on 16-byte boundaries; out (B, H, Tq, DV) and
// the fp32 workspaces dq (B, H, Tq, D), dk (B, H, Tk, D), dv (B, H, Tk, DV)
// contiguous, the workspaces zeroed. key_mask (B, Tk), lse and delta (B, H,
// Tq) are fp32; `live` is flash_live_tiles. `seed` (an int64 on the device,
// or null for no dropout) keys the dropout mask: keep where the Philox word
// is below drop_thresh, scaled by drop_scale.
int flash_wide_fwd(const void* q, long long q_bs, long long q_hs, long long q_rs, const void* k,
                   long long k_bs, long long k_hs, long long k_rs, const void* v, long long v_bs,
                   long long v_hs, long long v_rs, const void* key_mask, const void* live,
                   const void* seed, unsigned drop_thresh, float drop_scale, void* out,
                   void* lse, int B, int H, int Tq, int Tk, int D, int DV, int causal,
                   float scale, int dtype, void* stream) {
  WideParams p = base_params(q, q_bs, q_hs, q_rs, k, k_bs, k_hs, k_rs, v, v_bs, v_hs, v_rs,
                             key_mask, live, seed, drop_thresh, drop_scale, B, H, Tq, Tk, D, DV,
                             causal, scale);
  p.out = out;
  p.lse_out = static_cast<float*>(lse);
  return launch(0, p, dtype, stream);
}

int flash_wide_bwd(const void* q, long long q_bs, long long q_hs, long long q_rs, const void* k,
                   long long k_bs, long long k_hs, long long k_rs, const void* v, long long v_bs,
                   long long v_hs, long long v_rs, const void* dout, long long d_bs,
                   long long d_hs, long long d_rs, const void* key_mask, const void* live,
                   const void* lse, const void* delta, const void* seed, unsigned drop_thresh,
                   float drop_scale, void* dq, void* dk, void* dv, int B, int H, int Tq, int Tk,
                   int D, int DV, int causal, float scale, int dtype, void* stream) {
  WideParams p = base_params(q, q_bs, q_hs, q_rs, k, k_bs, k_hs, k_rs, v, v_bs, v_hs, v_rs,
                             key_mask, live, seed, drop_thresh, drop_scale, B, H, Tq, Tk, D, DV,
                             causal, scale);
  p.dout = {dout, d_bs, d_hs, d_rs};
  p.lse = static_cast<const float*>(lse);
  p.delta = static_cast<const float*>(delta);
  p.dq = static_cast<float*>(dq);
  p.dk = static_cast<float*>(dk);
  p.dv = static_cast<float*>(dv);
  return launch(1, p, dtype, stream);
}

const char* flash_wide_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

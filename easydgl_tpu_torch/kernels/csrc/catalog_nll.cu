// Streamed full-catalog NLL, forward and backward, for Hopper (sm_90a).
//
// Replaces the TPU kernels of easydgl_tpu/kernels/scoring.py: _fwd_kernel
// (:41; pallas_call in _fwd_call, :84) and the backward's _bwd_fused_kernel
// (:108), _bwd_hidden_kernel (:170) and _bwd_table_kernel (:200)
// (pallas_calls in _catalog_bwd, :292, :323, :343). For N hidden rows h
// against the tied (V, C) table T and bias b, with s = h T^T + b never
// stored (4.7 GB fp32 at N = 65,536, V = 17,771):
//
//   forward:  lse[n] = logsumexp_v s[n, v],  ll[n] = s[n, label[n]]
//   backward: g = dlse * exp(s - lse) + dll * onehot(label)
//             dh = g T, dT = g^T h (g rounded to the compute dtype first,
//             both returned in it), db = sum_n g (fp32)
//
// The backward is two recompute passes, d_hidden (mode 1) and d_table with
// d_bias (mode 2); the score tile is formed in both. The TPU's fused
// backward exists because its whole (N, C) d_hidden accumulator fits VMEM;
// here a fused pass would add a (64 x C) fp32 d_hidden tile per 64 vocab
// ids, ~37 GB of reduction traffic at N = 65,536. Rows whose gradient is
// exactly zero are skipped: the wrapper codes each 64-row tile from dlse and
// dll (catalog_live_rows; a padded position has dlse = dll = 0, so g = 0 on
// its row) and lists the live tiles in order on the device. d_hidden
// computes nothing on a dead tile (its rows stay as zeroed by the caller),
// d_table streams only the live tiles.
//
// bf16 at C = 512 (catalog_bwd_tc_kernel; every configuration of the repo):
// a block keeps a 64-row resident tile R (hidden rows in mode 1, vocab rows
// in mode 2) and streams 64-row tiles S of the other operand (vocab tiles of
// a split, or the live hidden tiles of a split) through a two-stage ring
// that a producer warp fills by TMA (eight 64 x 64 boxes a tile, 128-byte
// swizzle) under full and empty mbarriers, with the stats of S's rows
// (bias, or lse, dlse, dll, label) by plain loads. Two consumer warpgroups
// split the work of a step: warpgroup w scores R against S's rows [32 w,
// 32 w + 32) over all of C (wgmma m64n32k16, both operands K-major in
// shared memory), forms that half of g in registers and stores it, rounded
// to bf16, into a shared (64 x 64) g tile (two, alternating by step); after
// a named barrier it adds g S[:, 256 w, 256 w + 256) to its (64 x 256) fp32
// accumulator (wgmma m64n64k16, g K-major, S MN-major), 128 registers a
// thread: a (64 x 512) accumulator does not fit one warpgroup. The producer
// warpgroup hands its registers to the consumers (setmaxnreg). One block an
// SM (216,104 bytes of shared memory); the vocab (mode 1) or the live row tiles
// (mode 2) split across blocks so that the grid fills the card in whole
// waves, the splits adding into zeroed fp32 buffers by atomics.
//
// Other dtypes and widths (catalog_kernel): a block keeps 32 resident rows
// in shared memory and streams 64-row tiles past them, recomputing each
// 32 x 64 score tile. The forward (mode 0) in bf16 with C % 64 == 0 forms it
// on mma.sync (m16n8k16, fp32 accumulate) from ldmatrix fragments; the
// backward's passes (modes 1 and 2) in fp32, and in bf16 at C != 512 (no
// configuration of the repo), and the forward otherwise run on the CUDA
// cores (fp32 FMA, no TF32). The forward's online max and sum per row are
// merged over vocab splits by catalog_merge.
//
// The entry owns the choice of kernel and of the splits: the caller passes
// zeroed fp32 accumulators for d_hidden, d_table and d_bias whatever runs.
//
// What bounds the backward: the products, 2 N V C FLOP each, three that the
// function needs (the score tile, dh, dT; the kernels compute the score tile
// twice), over the live rows (dlse or dll nonzero): 3.58 TFLOP with all
// 65,536 rows of a SASREC-LC batch live, 3.6 ms at 989 TFLOP/s in bf16. The
// kernels work on whole 64-row tiles, so they also compute the dead rows of
// a tile that holds a live one. The wgmma kernel's scores use m64n32 products whose
// operands both come from shared memory, and each step forms g on the CUDA
// cores between its two products.
//
// Limits: C % 4 == 0 and C <= 512 (the two operand tiles share 227 KB).

#include <algorithm>

#include "hopper.cuh"

namespace {

using namespace port;
using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;
constexpr int kA = 32;   // resident rows per block
constexpr int kB = 64;   // streamed rows per tile
constexpr int kMaxC = 512;
constexpr size_t kMaxSmem = 232448;

enum Mode { kFwd = 0, kDHidden = 1, kDTable = 2 };

struct Params {
  const void* hidden;   // (N, C)
  const void* table;    // (V, C)
  const float* bias;    // (V,)
  const int* labels;    // (N,)
  const float* lse;     // (N,)  backward
  const float* dlse;    // (N,)  backward
  const float* dll;     // (N,)  backward
  const int* live;      // (ceil(N / 64),) backward: 0 where a 64-row tile's g is all zero
  const int* order;     // backward: the number of live row tiles, then their indices
  float* part_m;        // (S, N) forward
  float* part_l;
  float* part_ll;
  float* dh_acc;        // (N, C) fp32 d_hidden, zeroed by the caller
  float* dt_acc;        // (V, C) fp32 d_table, zeroed by the caller
  float* dbias;         // (V,) fp32, zeroed by the caller
  int N, V, C, splits, tiles_per_split;
};

__host__ __device__ inline int cstride(int C) { return C + 4; }
// bf16 tiles (the forward's mma.sync path): rows of C + 8 halves keep
// 16-byte row alignment and put the 8 rows an mma fragment reads in
// distinct banks
__host__ __device__ inline int bstride(int C) { return C + 8; }

__host__ __device__ inline size_t smem_bytes(int C, bool mma) {
  if (mma) return 2 * (size_t)(kA + kB) * bstride(C) + sizeof(float) * (size_t)kA * (kB + 1);
  return sizeof(float) * ((size_t)(kA + kB) * cstride(C) + (size_t)kA * (kB + 1));
}

// Rows [row0, row0 + nrows) of a (rows_total, C) bf16 matrix into shared
// memory at row stride bstride(C), 16 bytes a thread; rows past the end are
// zero. C % 8 == 0.
__device__ __forceinline__ void load_tile_bf16(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                               int row0, int nrows, int rows_total, int C) {
  const int ld = bstride(C), c8 = C / 8;
  for (int idx = threadIdx.x; idx < nrows * c8; idx += kThreads) {
    const int r = idx / c8, c = (idx - r * c8) * 8;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < rows_total)
      v = __ldg(reinterpret_cast<const uint4*>(src + (size_t)(row0 + r) * C + c));
    *reinterpret_cast<uint4*>(dst + r * ld + c) = v;
  }
}

template <typename T>
__device__ __forceinline__ void load_tile(float* dst, const T* src, int row0, int nrows,
                                          int rows_total, int C) {
  const int ld = cstride(C);
  for (int idx = threadIdx.x; idx < nrows * C; idx += kThreads) {
    const int r = idx / C, c = idx - r * C;
    dst[r * ld + c] = row0 + r < rows_total ? to_f(src[(size_t)(row0 + r) * C + c]) : 0.f;
  }
}

// MMA (the forward in bf16, C % 64 == 0): the score tile on the tensor
// cores from bf16 tiles in shared memory, warp w computing rows
// 16 (w & 1) .. +15 by columns 16 (w >> 1) .. +15 over K = C.
template <typename T, int MODE, bool MMA>
__global__ void __launch_bounds__(kThreads, 1) catalog_kernel(const Params p) {
  static_assert(!MMA || MODE == kFwd, "mma.sync serves the forward only");
  using bf16 = __nv_bfloat16;
  extern __shared__ __align__(16) float smem[];
  const int C = p.C, ld = MMA ? bstride(C) : cstride(C);
  float* as = smem;                // kA x ld floats (CUDA cores)
  float* bs = as + kA * ld;        // kB x ld
  bf16* ah = reinterpret_cast<bf16*>(smem);  // kA x ld halves (tensor cores)
  bf16* bh = ah + kA * ld;                   // kB x ld
  float* gs = MMA ? reinterpret_cast<float*>(bh + kB * ld) : bs + kB * ld;  // kA x (kB+1)
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g8 = lane >> 2, t4 = lane & 3;
  const int a0 = blockIdx.x * kA;
  const bool resident_vocab = MODE == kDTable;
  const T* a_src = static_cast<const T*>(resident_vocab ? p.table : p.hidden);
  const T* b_src = static_cast<const T*>(resident_vocab ? p.hidden : p.table);
  const int a_total = resident_vocab ? p.V : p.N;
  const int b_total = resident_vocab ? p.N : p.V;
  // d_hidden: a dead row tile streams nothing and adds its zeros (an empty
  // loop; an early return measured 3.6% slower in fp32). d_table: the
  // streamed tiles are the live row tiles, in order, read through the list
  // only where some tile is dead (the list costs fp32 2.7% with every row
  // live).
  const int b_tiles = (b_total + kB - 1) / kB;
  int tile_begin = 0, tile_end = MODE == kDTable ? p.order[0] : b_tiles;
  const bool indirect = MODE == kDTable && tile_end < b_tiles;
  if (MODE != kDTable) {
    tile_begin = blockIdx.y * p.tiles_per_split;
    tile_end = imin(tile_end, tile_begin + p.tiles_per_split);
  }
  if (MODE == kDHidden && p.live[a0 / kB] == 0) tile_end = tile_begin;

  if constexpr (MMA) {
    load_tile_bf16(ah, reinterpret_cast<const bf16*>(a_src), a0, kA, a_total, C);
  } else {
    load_tile<T>(as, a_src, a0, kA, a_total, C);
  }

  // score tile: thread = column sb, rows sa0 .. sa0+7
  const int sb = tid % kB, sa0 = (tid / kB) * 8;
  // row pass: 8 threads per resident row, 8 columns each
  const int ra = tid / 8, rpart = tid % 8;
  const int arow = a0 + ra;
  const bool arow_ok = arow < a_total;
  // accumulate pass: rows acc_a0 .. +7, channel quads cq + 256 j
  const int acc_a0 = (tid / 64) * 8, cq = (tid % 64) * 4;
  float acc[8][2][4];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int x = 0; x < 4; ++x) acc[i][j][x] = 0.f;
  const int mt_s = warp & 1, ng_s = warp >> 1;
  // ldmatrix row addresses of this lane. A (rows x K, row-major): lanes
  // 0-15 give rows 0-15 at k, lanes 16-31 the same rows at k + 8. B
  // (streamed rows x K): matrix m = lane / 8 holds rows 8 (m / 2) .. +7 at
  // k + 8 (m % 2).
  const int lm = lane >> 3, lj = lane & 7;
  const bf16* a_ldm = ah + (16 * mt_s + (lane & 15)) * ld + (lane >> 4) * 8;
  const bf16* b_ldm = bh + (16 * ng_s + (lm >> 1) * 8 + lj) * ld + (lm & 1) * 8;
  float run_m = -INFINITY, run_l = 0.f, run_ll = 0.f, run_db = 0.f;
  int a_label = -1;
  float a_lse = 0.f, a_dlse = 0.f, a_dll = 0.f;
  if (MODE != kDTable && arow_ok) {
    a_label = p.labels[arow];
    if (MODE == kDHidden) {
      a_lse = p.lse[arow];
      a_dlse = p.dlse[arow];
      a_dll = p.dll[arow];
    }
  }

  for (int it = tile_begin; it < tile_end; ++it) {
    const int tile = indirect ? p.order[1 + it] : it;
    const int b0 = tile * kB, nb = imin(kB, b_total - b0);
    __syncthreads();  // previous tile consumed
    if constexpr (MMA) {
      load_tile_bf16(bh, reinterpret_cast<const bf16*>(b_src), b0, kB, b_total, C);
    } else {
      load_tile<T>(bs, b_src, b0, kB, b_total, C);
    }
    __syncthreads();
    if constexpr (MMA) {
      float c[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
      for (int k0 = 0; k0 < C; k0 += 16) {
        uint32_t a[4], b[4];
        ldmatrix_x4(a, a_ldm + k0);
        ldmatrix_x4(b, b_ldm + k0);
        mma_bf16(c[0], a, b[0], b[1]);
        mma_bf16(c[1], a, b[2], b[3]);
      }
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int r = 16 * mt_s + g8 + 8 * (i >> 1), cc = 16 * ng_s + 8 * nt + 2 * t4 + (i & 1);
          const int v = b0 + cc;
          gs[r * (kB + 1) + cc] = c[nt][i] + (v < p.V ? p.bias[v] : 0.f);
        }
    } else {
      float s[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) s[i] = 0.f;
      const float4* brow = reinterpret_cast<const float4*>(bs + sb * ld);
      for (int c4 = 0; c4 < C / 4; ++c4) {
        const float4 bv = brow[c4];
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const float4 av = reinterpret_cast<const float4*>(as + (sa0 + i) * ld)[c4];
          s[i] = fmaf(av.w, bv.w, fmaf(av.z, bv.z, fmaf(av.y, bv.y, fmaf(av.x, bv.x, s[i]))));
        }
      }
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int v = resident_vocab ? a0 + sa0 + i : b0 + sb;
        gs[(sa0 + i) * (kB + 1) + sb] = s[i] + (v < p.V ? p.bias[v] : 0.f);
      }
    }
    __syncthreads();
    float* grow = gs + ra * (kB + 1);
    if (MODE == kFwd) {
      float m = -INFINITY;
      for (int c = rpart; c < nb; c += 8) m = fmaxf(m, grow[c]);
      for (int o = 4; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
      const float m_new = fmaxf(run_m, m);
      float sum = 0.f;
      for (int c = rpart; c < nb; c += 8) {
        sum += expf(grow[c] - m_new);
        if (b0 + c == a_label) run_ll += grow[c];
      }
      for (int o = 4; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
      run_l = run_l * expf(run_m - m_new) + sum;
      run_m = m_new;
    } else {
      for (int c = rpart; c < kB; c += 8) {
        float g = 0.f;
        if (c < nb && arow_ok) {
          if (MODE == kDHidden) {
            g = a_dlse * expf(grow[c] - a_lse) + (b0 + c == a_label ? a_dll : 0.f);
          } else {
            const int n = b0 + c;
            g = p.dlse[n] * expf(grow[c] - p.lse[n]) + (p.labels[n] == arow ? p.dll[n] : 0.f);
            run_db += g;
          }
        }
        grow[c] = rnd<T>(g);
      }
      __syncthreads();
      for (int bb = 0; bb < nb; ++bb) {
        float gv[8];
#pragma unroll
        for (int i = 0; i < 8; ++i) gv[i] = gs[(acc_a0 + i) * (kB + 1) + bb];
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int c = cq + 256 * j;
          if (c < C) {
            const float4 bv = *reinterpret_cast<const float4*>(bs + bb * ld + c);
#pragma unroll
            for (int i = 0; i < 8; ++i) {
              acc[i][j][0] = fmaf(gv[i], bv.x, acc[i][j][0]);
              acc[i][j][1] = fmaf(gv[i], bv.y, acc[i][j][1]);
              acc[i][j][2] = fmaf(gv[i], bv.z, acc[i][j][2]);
              acc[i][j][3] = fmaf(gv[i], bv.w, acc[i][j][3]);
            }
          }
        }
      }
    }
  }

  if (MODE == kFwd) {
    for (int o = 4; o > 0; o >>= 1) run_ll += __shfl_xor_sync(0xffffffffu, run_ll, o);
    if (rpart == 0 && arow_ok) {
      const size_t off = (size_t)blockIdx.y * p.N + arow;
      p.part_m[off] = run_m;
      p.part_l[off] = run_l;
      p.part_ll[off] = run_ll;
    }
    return;
  }
  if (MODE == kDTable) {
    for (int o = 4; o > 0; o >>= 1) run_db += __shfl_xor_sync(0xffffffffu, run_db, o);
    if (rpart == 0 && arow_ok) p.dbias[arow] = run_db;
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int row = a0 + acc_a0 + i;
    if (row >= a_total) continue;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int c = cq + 256 * j;
      if (c >= C) continue;
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        const size_t off = (size_t)row * C + c + x;
        if (MODE == kDHidden && p.splits > 1) atomicAdd(p.dh_acc + off, acc[i][j][x]);
        else (MODE == kDHidden ? p.dh_acc : p.dt_acc)[off] = acc[i][j][x];
      }
    }
  }
}

// ---------------------------------------------------------------- backward, bf16, C = 512
// wgmma and TMA (see the header): warpgroups 0 and 1 consume, the first warp
// of warpgroup 2 produces. The block's resident tile R (64 rows x C) and the
// streamed tiles S (64 rows x C) are stored as eight (64 x 64) sub-tiles in
// the 128-byte swizzle.

constexpr int kTcC = 512;
constexpr int kTcSub = kTcC / 64;               // 64-column sub-tiles of a tile
constexpr int kTcStages = 2;
constexpr int kTcThreads = 384;
constexpr int kTcSubElems = 64 * 64;            // a (64 x 64) sub-tile, 8 KB
constexpr int kTcTileElems = kTcSub * kTcSubElems;  // a (64 x 512) tile, 64 KB
// Registers a thread after setmaxnreg: a consumer holds a (64 x 256) fp32
// accumulator (128 registers) and a (64 x 32) score tile; 24 + 2 x 240 a
// warpgroup thread fits the 65,536 of an SM.
constexpr int kTcProducerRegs = 24, kTcConsumerRegs = 240;
// R, the stages' S tiles, two g tiles, the stages' column stats (4 x 64
// words), the mbarriers, and slack to align the tiles to 1024 bytes.
constexpr size_t kTcSmem = 1024 +
                           sizeof(bf16) * ((1 + kTcStages) * kTcTileElems + 2 * kTcSubElems) +
                           sizeof(float) * kTcStages * 4 * 64 + 8 * (1 + 2 * kTcStages);

struct TcMaps {
  CUtensorMap hidden, table;  // (C, N) and (C, V) bf16, boxes of 64 x 64
};

__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// d_hidden (MODE 1): R = 64 live hidden rows (order[1 + blockIdx.x]), S the
// vocab tiles of split blockIdx.y; dh[R] (+)= g T_S into dh_acc.
// d_table (MODE 2): R = vocab tile blockIdx.x, S its share (split
// blockIdx.y) of the live hidden row tiles; dT[R] (+)= g^T h_S and db.
// Warpgroup w forms the score tile's columns [32 w, 32 w + 32) over all of C
// (m64n32k16, both operands K-major from shared memory) and that half of g,
// rounded to bf16 into a shared (64 x 64) tile; then its half of the
// channels, [256 w, 256 w + 256), of g S (m64n64k16 four times a k step, g
// K-major and S MN-major).
template <int MODE>
__global__ void __launch_bounds__(kTcThreads, 1)
    catalog_bwd_tc_kernel(const Params p, const __grid_constant__ TcMaps maps) {
  constexpr bool kTable = MODE == kDTable;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* base = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  bf16* rs = reinterpret_cast<bf16*>(base);        // [sub][64 rows][64]
  bf16* ss = rs + kTcTileElems;                     // [stage][sub][64 rows][64]
  bf16* gs = ss + kTcStages * kTcTileElems;         // [2][64 rows][64 columns] g
  float* cols = reinterpret_cast<float*>(gs + 2 * kTcSubElems);  // [stage][4][64]
  uint64_t* r_full = reinterpret_cast<uint64_t*>(cols + kTcStages * 4 * 64);
  uint64_t* full = r_full + 1;                      // [stage]
  uint64_t* empty = full + kTcStages;               // [stage]

  const int count = p.order[0];  // live row tiles
  int rt, it0, it1;              // the resident tile; the run of streamed ones
  if (!kTable) {
    if ((int)blockIdx.x >= count) return;
    rt = p.order[1 + blockIdx.x];
    it0 = blockIdx.y * p.tiles_per_split;
    it1 = imin((p.V + 63) / 64, it0 + p.tiles_per_split);
  } else {
    rt = blockIdx.x;
    it0 = (int)((long long)count * blockIdx.y / p.splits);
    it1 = (int)((long long)count * (blockIdx.y + 1) / p.splits);
  }
  const int ntiles = it1 - it0;
  if (ntiles <= 0) return;  // nothing to add (the outputs come zeroed)
  auto stile = [&](int it) { return kTable ? p.order[1 + it0 + it] : it0 + it; };

  if (threadIdx.x == 0) {
    mbar_init(r_full, 1);
    for (int s = 0; s < kTcStages; ++s) {
      mbar_init(full + s, 32);
      mbar_init(empty + s, 256);
    }
    mbar_fence_init();
  }
  __syncthreads();
  const int lane = threadIdx.x & 31;
  int warp = threadIdx.x >> 5;

  if (warp >= 8) {  // ---- producer: its first warp works
    regs_dec<kTcProducerRegs>();
    if (warp > 8) return;
    const CUtensorMap* rmap = kTable ? &maps.table : &maps.hidden;
    const CUtensorMap* smap = kTable ? &maps.hidden : &maps.table;
    if (lane == 0) {
      mbar_arrive_tx(r_full, kTcTileElems * sizeof(bf16));
      for (int kc = 0; kc < kTcSub; ++kc)
        tma_2d(rs + kc * kTcSubElems, rmap, r_full, 64 * kc, 64 * rt);
    }
    for (int it = 0; it < ntiles; ++it) {
      const int s = it % kTcStages, r0 = 64 * stile(it);
      mbar_wait(empty + s, ((it / kTcStages) & 1) ^ 1);
      // the streamed rows' stats: d_hidden the bias (-inf past V); d_table
      // lse log2(e), dlse, dll and the label (a past-N row has g = 0)
      float* cs = cols + s * 4 * 64;
      for (int r = lane; r < 64; r += 32) {
        const int n = r0 + r;
        if (kTable) {
          const bool ok = n < p.N;
          cs[r] = ok ? p.lse[n] * kLog2e : 0.f;
          cs[64 + r] = ok ? p.dlse[n] : 0.f;
          cs[128 + r] = ok ? p.dll[n] : 0.f;
          reinterpret_cast<int*>(cs)[192 + r] = ok ? p.labels[n] : -1;
        } else {
          cs[r] = n < p.V ? p.bias[n] : -INFINITY;
        }
      }
      if (lane == 0) {
        mbar_arrive_tx(full + s, kTcTileElems * sizeof(bf16));
        for (int kc = 0; kc < kTcSub; ++kc)
          tma_2d(ss + s * kTcTileElems + kc * kTcSubElems, smap, full + s, 64 * kc, r0);
      } else {
        mbar_arrive(full + s);
      }
    }
    return;
  }

  // ---- consumers: warpgroup wg; thread (warp, g, t4) holds resident rows
  // 16 warp + g (+8), score columns 32 wg + 8 n + 2 t4 (+1), channels
  // 256 wg + 64 j + 8 n + 2 t4 (+1)
  regs_inc<kTcConsumerRegs>();
  const int wg = warp >> 2;
  warp &= 3;
  const int g = lane >> 2, t4 = lane & 3;
  // the resident rows' stats: d_hidden lse log2(e), dlse, dll, label (g = 0
  // past N); d_table the bias (-inf past V) and the vocab id
  float r_l2[2], r_dl[2], r_dll[2], r_b[2];
  int r_id[2];
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int row = 64 * rt + 16 * warp + g + 8 * hr;
    r_id[hr] = row;
    if (kTable) {
      r_b[hr] = row < p.V ? p.bias[row] : -INFINITY;
    } else {
      const bool ok = row < p.N;
      r_l2[hr] = ok ? p.lse[row] * kLog2e : 0.f;
      r_dl[hr] = ok ? p.dlse[row] : 0.f;
      r_dll[hr] = ok ? p.dll[row] : 0.f;
      r_id[hr] = ok ? p.labels[row] : -1;
    }
  }
  float acc[4][32];
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[j][i] = 0.f;
  float db[2] = {0.f, 0.f};
  const uint64_t rd = sw128_desc(rs);
  mbar_wait(r_full, 0);

  for (int it = 0; it < ntiles; ++it) {
    const int s = it % kTcStages, c0 = 64 * stile(it);
    mbar_wait(full + s, (it / kTcStages) & 1);
    const bf16* st = ss + s * kTcTileElems;
    // scores: rows of R against the warpgroup's 32 rows of S, over C
    float sc[16];
#pragma unroll
    for (int i = 0; i < 16; ++i) sc[i] = 0.f;
    const uint64_t sd = sw128_desc(st + 32 * wg * 64);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < 4 * kTcSub; ++kk)
      wgmma_ss_n32(sc, rd + 512 * (kk >> 2) + 2 * (kk & 3), sd + 512 * (kk >> 2) + 2 * (kk & 3), 1);
    wg_commit();
    wg_wait();
    reg_fence(sc);

    // g = dlse exp(s - lse) + dll [label == v], rounded to bf16 into the g
    // tile of this step (row r, column chunk (4 wg + n) ^ g in the swizzle)
    const float* cs = cols + s * 4 * 64;
    unsigned char* gt = reinterpret_cast<unsigned char*>(gs + (it & 1) * kTcSubElems);
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        float gv[2];
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int cl = 32 * wg + 8 * n + 2 * t4 + c;  // the streamed row of the tile
          const float x = sc[4 * n + 2 * hr + c];
          if (kTable) {
            const int lab = reinterpret_cast<const int*>(cs)[192 + cl];
            gv[c] = cs[64 + cl] * fast_exp2(fmaf(x + r_b[hr], kLog2e, -cs[cl])) +
                    (lab == r_id[hr] ? cs[128 + cl] : 0.f);
            db[hr] += gv[c];
          } else {
            gv[c] = r_dl[hr] * fast_exp2(fmaf(x + cs[cl], kLog2e, -r_l2[hr])) +
                    (r_id[hr] == c0 + cl ? r_dll[hr] : 0.f);
          }
        }
        const int r = 16 * warp + g + 8 * hr;
        *reinterpret_cast<uint32_t*>(gt + r * 128 + (((4 * wg + n) ^ g) << 4) + 4 * t4) =
            pack2(gv[0], gv[1]);
      }
    fence_async_smem();
    named_sync(1, 256);  // both halves of g are in shared memory

    // acc (64 x 256) += g (64 x 64) S[:, 256 wg ..]
    const uint64_t gd = sw128_desc(gt);
    const uint64_t od = sw128_desc(st + 4 * wg * kTcSubElems);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int j = 0; j < 4; ++j) wgmma_ss<0, 1>(acc[j], gd + 2 * kk, od + 512 * j + 128 * kk, 1);
    wg_commit();
    wg_wait();
#pragma unroll
    for (int j = 0; j < 4; ++j) reg_fence(acc[j]);
    mbar_arrive(empty + s);  // the stage's S tile and stats are free
  }

  const int rows = kTable ? p.V : p.N;
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int row = 64 * rt + 16 * warp + g + 8 * hr;
    if (kTable) {
      float x = db[hr];
      x += __shfl_xor_sync(0xffffffffu, x, 1);
      x += __shfl_xor_sync(0xffffffffu, x, 2);
      if (t4 == 0 && row < rows) atomicAdd(p.dbias + row, x);
    }
    if (row >= rows) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        const size_t off = (size_t)row * kTcC + 256 * wg + 64 * j + 8 * n + 2 * t4;
        const float a = acc[j][4 * n + 2 * hr], b = acc[j][4 * n + 2 * hr + 1];
        float2* acc32 = reinterpret_cast<float2*>((kTable ? p.dt_acc : p.dh_acc) + off);
        if (p.splits > 1) atomicAdd(acc32, make_float2(a, b));
        else *acc32 = make_float2(a, b);
      }
  }
}

// lse = M + log(sum_s l_s exp(m_s - M)), M = max_s m_s; ll = sum_s ll_s.
__global__ void catalog_merge(const float* part_m, const float* part_l, const float* part_ll,
                              float* lse, float* ll, int N, int splits) {
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= N) return;
  float m = -INFINITY;
  for (int s = 0; s < splits; ++s) m = fmaxf(m, part_m[(size_t)s * N + n]);
  float l = 0.f, x = 0.f;
  for (int s = 0; s < splits; ++s) {
    l += part_l[(size_t)s * N + n] * expf(part_m[(size_t)s * N + n] - m);
    x += part_ll[(size_t)s * N + n];
  }
  lse[n] = m + logf(l);
  ll[n] = x;
}

template <typename T, int MODE, bool MMA>
cudaError_t launch_variant(const Params& p, dim3 grid, cudaStream_t stream) {
  const size_t bytes = smem_bytes(p.C, MMA);
  if (bytes > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        catalog_kernel<T, MODE, MMA>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (e != cudaSuccess) return e;
  }
  catalog_kernel<T, MODE, MMA><<<grid, kThreads, bytes, stream>>>(p);
  return cudaGetLastError();
}

// The forward in bf16 with C % 64 == 0 takes the tensor cores, everything
// else the CUDA cores.
template <int MODE>
cudaError_t launch_mode(const Params& p, int dtype, dim3 grid, cudaStream_t stream) {
  if (dtype == 0) return launch_variant<float, MODE, false>(p, grid, stream);
  if constexpr (MODE == kFwd) {
    if (p.C % 64 == 0) return launch_variant<bf16, MODE, true>(p, grid, stream);
  }
  return launch_variant<bf16, MODE, false>(p, grid, stream);
}

// The (rows, C) bf16 matrix at ptr as a TMA map: boxes of 64 rows x 64.
bool matrix_map(CUtensorMap* map, const void* ptr, int rows, int C) {
  const cuuint64_t dims[2] = {(cuuint64_t)C, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)C * sizeof(bf16)};
  const cuuint32_t box[2] = {64, 64};
  return encode_map(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, ptr, dims, strides, box);
}

template <int MODE>
cudaError_t launch_tc(const Params& p, const TcMaps& maps, dim3 grid, cudaStream_t stream) {
  const cudaError_t e = cudaFuncSetAttribute(
      catalog_bwd_tc_kernel<MODE>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kTcSmem);
  if (e != cudaSuccess) return e;
  catalog_bwd_tc_kernel<MODE><<<grid, kTcThreads, kTcSmem, stream>>>(p, maps);
  return cudaGetLastError();
}

bool valid_shape(int N, int V, int C, int dtype) {
  return N >= 1 && V >= 1 && C >= 4 && C % 4 == 0 && C <= kMaxC &&
         smem_bytes(C, false) <= kMaxSmem && (dtype == 0 || dtype == 1);
}

Params base(const void* hidden, const void* table, const void* bias, const void* labels,
            int N, int V, int C) {
  Params p = {};
  p.hidden = hidden;
  p.table = table;
  p.bias = static_cast<const float*>(bias);
  p.labels = static_cast<const int*>(labels);
  p.N = N; p.V = V; p.C = C;
  return p;
}

// Vocab splits of catalog_kernel's row-tiled passes (the forward, and the
// backward's d_hidden off the wgmma kernel): about 264 blocks, two an SM of
// an H100, so that N = 3,072 rows (96 tiles of 32) still fill the card.
int row_splits(int N, int V) {
  const int row_tiles = (N + kA - 1) / kA;
  return std::max(1, std::min((V + kB - 1) / kB, (264 + row_tiles - 1) / row_tiles));
}

// Splits for the wgmma kernel, one block an SM: the number of parts s that
// the `streamed` tiles of each of `blocks` resident tiles are cut into,
// minimising waves x (tiles a block streams + 1, + 1 more for the atomic
// epilogue of a split). Dead row tiles are counted as live: d_table divides
// the live tiles of a call evenly among its splits on the device.
int tc_splits(int blocks, int streamed, int sms) {
  int best = 1;
  long long best_cost = -1;
  for (int s = 1; s <= streamed; ++s) {
    const long long cost =
        ((long long)blocks * s + sms - 1) / sms * ((streamed + s - 1) / s + 1 + (s > 1));
    if (best_cost < 0 || cost < best_cost) {
      best = s;
      best_cost = cost;
    }
  }
  return best;
}

}  // namespace

extern "C" {

// Forward: lse, ll (N,) fp32. part is scratch of 3 * splits * N floats.
// dtype: 0 = float32, 1 = bfloat16 (hidden and table). Returns
// cudaGetLastError() (0 on success).
int catalog_nll_fwd(const void* hidden, const void* table, const void* bias,
                    const void* labels, void* lse, void* ll, void* part, int N,
                    int V, int C, int splits, int dtype, void* stream) {
  if (!valid_shape(N, V, C, dtype) || splits < 1) return (int)cudaErrorInvalidValue;
  Params p = base(hidden, table, bias, labels, N, V, C);
  const int tiles = (V + kB - 1) / kB;
  p.splits = splits;
  p.tiles_per_split = (tiles + splits - 1) / splits;
  float* pf = static_cast<float*>(part);
  p.part_m = pf;
  p.part_l = pf + (size_t)splits * N;
  p.part_ll = pf + 2 * (size_t)splits * N;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((N + kA - 1) / kA, splits);
  cudaError_t e = launch_mode<kFwd>(p, dtype, grid, s);
  if (e != cudaSuccess) return (int)e;
  catalog_merge<<<(N + 255) / 256, 256, 0, s>>>(p.part_m, p.part_l, p.part_ll,
                                                 static_cast<float*>(lse),
                                                 static_cast<float*>(ll), N, splits);
  return (int)cudaGetLastError();
}

// Vocab splits of the forward: part holds 3 * splits * N floats.
int catalog_splits(int N, int V) { return row_splits(N, V); }

// Backward into fp32 accumulators that the caller zeroes and casts: dh_acc
// (N, C), dt_acc (V, C), dbias (V,). live (ceil(N / 64),) codes each 64-row
// tile (0: every row has dlse = dll = 0); order is the number of live tiles,
// then their indices. bf16 at C = 512 runs the wgmma kernel, everything
// else catalog_kernel. splits_h and splits_t (the vocab splits of d_hidden,
// the row-tile splits of d_table; 0: chosen here for the card) set how the
// passes divide their work; only the wgmma kernel splits d_table.
int catalog_nll_bwd(const void* hidden, const void* table, const void* bias,
                    const void* labels, const void* lse, const void* dlse,
                    const void* dll, const void* live, const void* order, void* dh_acc,
                    void* dt_acc, void* dbias, int N, int V, int C, int splits_h,
                    int splits_t, int dtype, void* stream) {
  if (!valid_shape(N, V, C, dtype) || splits_h < 0 || splits_t < 0)
    return (int)cudaErrorInvalidValue;
  Params p = base(hidden, table, bias, labels, N, V, C);
  p.lse = static_cast<const float*>(lse);
  p.dlse = static_cast<const float*>(dlse);
  p.dll = static_cast<const float*>(dll);
  p.live = static_cast<const int*>(live);
  p.order = static_cast<const int*>(order);
  p.dh_acc = static_cast<float*>(dh_acc);
  p.dt_acc = static_cast<float*>(dt_acc);
  p.dbias = static_cast<float*>(dbias);
  const int vocab_tiles = (V + kB - 1) / kB;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1 && C == kTcC) {
    int dev = 0, sms = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return (int)e;
    const int row_tiles = (N + 63) / 64;
    p.splits = splits_h ? splits_h : tc_splits(row_tiles, vocab_tiles, sms);
    p.tiles_per_split = (vocab_tiles + p.splits - 1) / p.splits;
    TcMaps maps;
    if (!matrix_map(&maps.hidden, hidden, N, C) || !matrix_map(&maps.table, table, V, C))
      return (int)cudaErrorInvalidValue;
    e = launch_tc<kDHidden>(p, maps, dim3(row_tiles, p.splits), s);
    if (e != cudaSuccess) return (int)e;
    Params pt = p;
    pt.splits = splits_t ? splits_t : tc_splits(vocab_tiles, row_tiles, sms);
    return (int)launch_tc<kDTable>(pt, maps, dim3(vocab_tiles, pt.splits), s);
  }
  if (splits_t > 1) return (int)cudaErrorInvalidValue;
  p.splits = splits_h ? splits_h : row_splits(N, V);
  p.tiles_per_split = (vocab_tiles + p.splits - 1) / p.splits;
  cudaError_t e = launch_mode<kDHidden>(p, dtype, dim3((N + kA - 1) / kA, p.splits), s);
  if (e != cudaSuccess) return (int)e;
  return (int)launch_mode<kDTable>(p, dtype, dim3((V + kA - 1) / kA, 1), s);
}

const char* catalog_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

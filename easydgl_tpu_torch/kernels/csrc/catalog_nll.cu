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
// Forward, bf16 at C = 512 (catalog_fwd_tc_kernel; every configuration of
// the repo). What bounds it: the one product, 2 N V C FLOP: 1.193 TFLOP at
// N = 65,536, V = 17,771, 1.206 ms at 989 TFLOP/s (its bytes, the two
// operands read once, 0.085 GB, 0.025 ms); 0.0565 ms at N = 3,072. What
// the design does about it: a block keeps 128 hidden rows resident, 64 for
// each of two consumer warpgroups (128 KB), and streams the vocab tiles of
// its split, 128 ids x 512 channels, as eight (128 ids x 64 channels)
// chunks through a six-stage ring (16 KB a chunk) that a producer warp
// fills by TMA (128-byte swizzle) under full and empty mbarriers; the
// table crosses from L2 once per 128 rows (9.3 GB at N = 65,536, a quarter
// of the 32-row CUDA-core kernel's 37 GB). A warpgroup forms its 64 x 128
// score tile on wgmma m64n128k16, both operands K-major in shared memory,
// and keeps it in registers: each thread folds its 2 rows x 32 columns
// into a running max and exp-sum of its own in log2 units (ex2; the bias
// enters scaled by log2(e), -inf past V), with no shared score tile and no
// row pass; the quad of a row merges its four (m, l) once, at the end. The
// label logit is picked from the fragment of the thread that holds the
// label's column, on the rare tile that holds it (ll = s + b, in fp32 as
// the plain version). A wait on all but the newest wgmma group releases a
// chunk while the next is in flight. Shared memory 230,504 bytes (the
// resident rows 131,072, the ring 98,304, the mbarriers and 1,024 bytes of
// alignment slack): one block an SM; the producer hands its registers to
// the consumers (setmaxnreg 24 / 240; ptxas: 168 registers at entry, no
// spill). N = 3,072 rows are only 24 blocks, so the vocab splits
// (tc_splits, chosen here; forced by the caller for tests) fill the card in
// whole waves, and catalog_merge folds the splits' (m, l, ll). Rows are not
// skipped: lse and ll are returned on every row. Measured on an H100, the
// kernel runs at 1.9x its bound, and without its products it still takes
// two thirds of its time: the chunks' stream from L2 (~6 TB/s) costs as
// much as the products.
//
// Backward. Two recompute passes, d_hidden (mode 1) and d_table with
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
// Other dtypes and widths (catalog_kernel; fp32, and bf16 at C != 512, no
// configuration of the repo): a block keeps 32 resident rows in shared
// memory and streams 64-row tiles past them, recomputing each 32 x 64 score
// tile on the CUDA cores (fp32 FMA, no TF32). The forward's online max and
// sum per row are merged over vocab splits by catalog_merge.
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

__host__ __device__ inline size_t smem_bytes(int C) {
  return sizeof(float) * ((size_t)(kA + kB) * cstride(C) + (size_t)kA * (kB + 1));
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

template <typename T, int MODE>
__global__ void __launch_bounds__(kThreads, 1) catalog_kernel(const Params p) {
  extern __shared__ __align__(16) float smem[];
  const int C = p.C, ld = cstride(C);
  float* as = smem;                // kA x ld
  float* bs = as + kA * ld;        // kB x ld
  float* gs = bs + kB * ld;        // kA x (kB+1)
  const int tid = threadIdx.x;
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

  load_tile<T>(as, a_src, a0, kA, a_total, C);

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
    load_tile<T>(bs, b_src, b0, kB, b_total, C);
    __syncthreads();
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

// ---------------------------------------------------------------- forward, bf16, C = 512
// wgmma and TMA (see the header): warpgroups 0 and 1 consume, each with 64
// resident hidden rows stored as eight (64 x 64) sub-tiles in the 128-byte
// swizzle; the first warp of warpgroup 2 produces. A vocab tile is 128 ids;
// the ring holds (128 ids x 64 channels) chunks, eight a tile.

constexpr int kFwdGroups = 2;                         // consumer warpgroups
constexpr int kFwdRows = 64 * kFwdGroups;             // resident rows a block
constexpr int kFwdVocab = 128;                        // vocab ids a tile
constexpr int kFwdStages = 6;
constexpr int kFwdThreads = 128 * (kFwdGroups + 1);
constexpr int kFwdChunkElems = kFwdVocab * 64;        // a (128 x 64) chunk, 16 KB
constexpr float kFwdDead = -1.0e30f;                  // the running max before any id
// the resident rows, the ring, the mbarriers, and slack to align to 1024 bytes
constexpr size_t kFwdSmem =
    1024 + sizeof(bf16) * ((size_t)kFwdGroups * kTcTileElems + (size_t)kFwdStages * kFwdChunkElems) +
    8 * (1 + 2 * kFwdStages);
static_assert(kFwdSmem <= kMaxSmem, "the forward's shared memory exceeds 227 KB");

// Rows [128 blockIdx.x, +128) against the vocab tiles of split blockIdx.y:
// the split's (m, l, ll) of each row into part_m / part_l / part_ll (m in
// natural-log units, l = sum_v exp(s - m), ll the label logit where the
// label lies in the split, else 0). Thread (warpgroup wg, warp, g, t4)
// holds rows 64 wg + 16 warp + g (+8) and, of a tile, ids 8 n + 2 t4 (+1),
// n < 16, at sc[4 n + 2 hr + c].
__global__ void __launch_bounds__(kFwdThreads, 1)
    catalog_fwd_tc_kernel(const Params p, const __grid_constant__ TcMaps maps) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* base = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  bf16* rs = reinterpret_cast<bf16*>(base);                // [group][sub][64 rows][64]
  bf16* vs = rs + kFwdGroups * kTcTileElems;               // [stage][128 ids][64]
  uint64_t* r_full = reinterpret_cast<uint64_t*>(vs + kFwdStages * kFwdChunkElems);
  uint64_t* full = r_full + 1;                             // [stage]
  uint64_t* empty = full + kFwdStages;                     // [stage]

  const int row0 = blockIdx.x * kFwdRows;
  const int tiles = (p.V + kFwdVocab - 1) / kFwdVocab;
  const int t0 = blockIdx.y * p.tiles_per_split;
  const int t1 = imin(tiles, t0 + p.tiles_per_split);
  const int nchunks = imax(t1 - t0, 0) * kTcSub;

  if (threadIdx.x == 0) {
    mbar_init(r_full, 1);
    for (int s = 0; s < kFwdStages; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, 128 * kFwdGroups);
    }
    mbar_fence_init();
  }
  __syncthreads();
  const int lane = threadIdx.x & 31;
  int warp = threadIdx.x >> 5;

  if (warp >= 4 * kFwdGroups) {  // ---- producer: lane 0 of its first warp works
    regs_dec<kTcProducerRegs>();
    if (warp > 4 * kFwdGroups || lane != 0) return;
    mbar_arrive_tx(r_full, kFwdGroups * kTcTileElems * sizeof(bf16));
    for (int w = 0; w < kFwdGroups; ++w)
      for (int kc = 0; kc < kTcSub; ++kc)
        tma_2d(rs + w * kTcTileElems + kc * kTcSubElems, &maps.hidden, r_full, 64 * kc,
               row0 + 64 * w);
    for (int it = 0; it < nchunks; ++it) {
      const int s = it % kFwdStages;
      mbar_wait(empty + s, ((it / kFwdStages) & 1) ^ 1);
      mbar_arrive_tx(full + s, kFwdChunkElems * sizeof(bf16));
      tma_2d(vs + s * kFwdChunkElems, &maps.table, full + s, 64 * (it % kTcSub),
             kFwdVocab * (t0 + it / kTcSub));
    }
    return;
  }

  // ---- consumers
  regs_inc<kTcConsumerRegs>();
  const int wg = warp >> 2;
  warp &= 3;
  const int g = lane >> 2, t4 = lane & 3;
  const uint64_t rd = sw128_desc(rs + wg * kTcTileElems);
  int lab[2];
  float lab_b[2], m2[2] = {kFwdDead, kFwdDead}, l[2] = {0.f, 0.f}, ll[2] = {0.f, 0.f};
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int row = row0 + 64 * wg + 16 * warp + g + 8 * hr;
    lab[hr] = row < p.N ? p.labels[row] : -1;
    lab_b[hr] = lab[hr] >= 0 ? p.bias[lab[hr]] : 0.f;
  }
  mbar_wait(r_full, 0);

  int it = 0;
  for (int t = t0; t < t1; ++t) {
    const int v0 = t * kFwdVocab;
    // the tile's bias in log2 units at the thread's ids (-inf past V)
    float b2[32];
#pragma unroll
    for (int n = 0; n < 16; ++n)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int v = v0 + 8 * n + 2 * t4 + c;
        b2[2 * n + c] = v < p.V ? __ldg(p.bias + v) * kLog2e : -INFINITY;
      }
    float sc[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) sc[i] = 0.f;
    wg_fence();
#pragma unroll 1
    for (int kc = 0; kc < kTcSub; ++kc, ++it) {
      const int s = it % kFwdStages;
      mbar_wait(full + s, (it / kFwdStages) & 1);
      const uint64_t vd = sw128_desc(vs + s * kFwdChunkElems);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) wgmma_ss_n128(sc, rd + 512 * kc + 2 * kk, vd + 2 * kk, 1);
      wg_commit();
      if (kc > 0) {  // the previous chunk's products are done: free its stage
        wg_wait_n<1>();
        mbar_arrive(empty + (it - 1) % kFwdStages);
      }
    }
    wg_wait();
    reg_fence(sc);
    mbar_arrive(empty + (it - 1) % kFwdStages);

#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      // the label logit, from the thread that holds the label's id
      const int lc = lab[hr] - v0;
      if ((unsigned)lc < (unsigned)kFwdVocab && ((lc >> 1) & 3) == t4) {
#pragma unroll
        for (int n = 0; n < 16; ++n)
#pragma unroll
          for (int c = 0; c < 2; ++c)
            if (8 * n + 2 * t4 + c == lc) ll[hr] = sc[4 * n + 2 * hr + c] + lab_b[hr];
      }
      float mx = m2[hr];
#pragma unroll
      for (int n = 0; n < 16; ++n)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          float& x = sc[4 * n + 2 * hr + c];
          x = fmaf(x, kLog2e, b2[2 * n + c]);
          mx = fmaxf(mx, x);
        }
      float sum = 0.f;
#pragma unroll
      for (int n = 0; n < 16; ++n)
#pragma unroll
        for (int c = 0; c < 2; ++c) sum += fast_exp2(sc[4 * n + 2 * hr + c] - mx);
      l[hr] = l[hr] * fast_exp2(m2[hr] - mx) + sum;
      m2[hr] = mx;
    }
  }

  // merge the quad's four (m, l) of each row; write the split's part
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    float m = m2[hr], s = l[hr], x = ll[hr];
#pragma unroll
    for (int o = 1; o <= 2; o <<= 1) {
      const float mo = __shfl_xor_sync(0xffffffffu, m, o);
      const float so = __shfl_xor_sync(0xffffffffu, s, o);
      x += __shfl_xor_sync(0xffffffffu, x, o);
      const float mm = fmaxf(m, mo);
      s = s * fast_exp2(m - mm) + so * fast_exp2(mo - mm);
      m = mm;
    }
    const int row = row0 + 64 * wg + 16 * warp + g + 8 * hr;
    if (t4 == 0 && row < p.N) {
      const size_t off = (size_t)blockIdx.y * p.N + row;
      p.part_m[off] = m * kLn2;
      p.part_l[off] = s;
      p.part_ll[off] = x;
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

template <typename T, int MODE>
cudaError_t launch_variant(const Params& p, dim3 grid, cudaStream_t stream) {
  const size_t bytes = smem_bytes(p.C);
  if (bytes > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        catalog_kernel<T, MODE>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (e != cudaSuccess) return e;
  }
  catalog_kernel<T, MODE><<<grid, kThreads, bytes, stream>>>(p);
  return cudaGetLastError();
}

template <int MODE>
cudaError_t launch_mode(const Params& p, int dtype, dim3 grid, cudaStream_t stream) {
  if (dtype == 0) return launch_variant<float, MODE>(p, grid, stream);
  return launch_variant<bf16, MODE>(p, grid, stream);
}

// The (rows, C) bf16 matrix at ptr as a TMA map: boxes of box_rows rows x 64.
bool matrix_map(CUtensorMap* map, const void* ptr, int rows, int C, int box_rows = 64) {
  const cuuint64_t dims[2] = {(cuuint64_t)C, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)C * sizeof(bf16)};
  const cuuint32_t box[2] = {64, (cuuint32_t)box_rows};
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
         smem_bytes(C) <= kMaxSmem && (dtype == 0 || dtype == 1);
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

// Vocab splits of catalog_kernel's row-tiled passes (the forward and the
// backward's d_hidden off the wgmma kernels): about 264 blocks, two an SM of
// an H100, so that N = 3,072 rows (96 tiles of 32) still fill the card.
int row_splits(int N, int V) {
  const int row_tiles = (N + kA - 1) / kA;
  return std::max(1, std::min((V + kB - 1) / kB, (264 + row_tiles - 1) / row_tiles));
}

int multiprocessors(int* sms) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  return (int)e;
}

bool fwd_on_tc(int C, int dtype) { return dtype == 1 && C == kTcC; }

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

// Vocab splits of the forward (the entry's own choice for the card): part
// holds 3 * splits * N floats. 0 when the shape is refused or the device
// cannot be queried.
int catalog_splits(int N, int V, int C, int dtype) {
  if (!valid_shape(N, V, C, dtype)) return 0;
  if (!fwd_on_tc(C, dtype)) return row_splits(N, V);
  int sms = 0;
  if (multiprocessors(&sms) != 0) return 0;
  return tc_splits((N + kFwdRows - 1) / kFwdRows, (V + kFwdVocab - 1) / kFwdVocab, sms);
}

// Forward: lse, ll (N,) fp32. part is scratch of 3 * splits * N floats;
// splits is the number of vocab splits (catalog_splits' choice, or forced
// by the caller). bf16 at C = 512 runs the wgmma kernel, everything else
// catalog_kernel. dtype: 0 = float32, 1 = bfloat16 (hidden and table).
// Returns cudaGetLastError() (0 on success).
int catalog_nll_fwd(const void* hidden, const void* table, const void* bias,
                    const void* labels, void* lse, void* ll, void* part, int N,
                    int V, int C, int splits, int dtype, void* stream) {
  if (!valid_shape(N, V, C, dtype) || splits < 1) return (int)cudaErrorInvalidValue;
  Params p = base(hidden, table, bias, labels, N, V, C);
  p.splits = splits;
  float* pf = static_cast<float*>(part);
  p.part_m = pf;
  p.part_l = pf + (size_t)splits * N;
  p.part_ll = pf + 2 * (size_t)splits * N;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (fwd_on_tc(C, dtype)) {
    const int tiles = (V + kFwdVocab - 1) / kFwdVocab;
    p.tiles_per_split = (tiles + splits - 1) / splits;
    TcMaps maps;
    if (!matrix_map(&maps.hidden, hidden, N, C) ||
        !matrix_map(&maps.table, table, V, C, kFwdVocab))
      return (int)cudaErrorInvalidValue;
    e = cudaFuncSetAttribute(catalog_fwd_tc_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)kFwdSmem);
    if (e != cudaSuccess) return (int)e;
    catalog_fwd_tc_kernel<<<dim3((N + kFwdRows - 1) / kFwdRows, splits), kFwdThreads, kFwdSmem,
                            s>>>(p, maps);
    e = cudaGetLastError();
  } else {
    const int tiles = (V + kB - 1) / kB;
    p.tiles_per_split = (tiles + splits - 1) / splits;
    e = launch_mode<kFwd>(p, dtype, dim3((N + kA - 1) / kA, splits), s);
  }
  if (e != cudaSuccess) return (int)e;
  catalog_merge<<<(N + 255) / 256, 256, 0, s>>>(p.part_m, p.part_l, p.part_ll,
                                                 static_cast<float*>(lse),
                                                 static_cast<float*>(ll), N, splits);
  return (int)cudaGetLastError();
}

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
    int sms = 0;
    cudaError_t e = static_cast<cudaError_t>(multiprocessors(&sms));
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

// Streamed full-catalog NLL, forward and backward, for Hopper (sm_90a).
//
// Replaces the TPU kernels of easydgl_tpu/kernels/scoring.py: _fwd_kernel
// (pallas_call in _fwd_call) and the backward's _bwd_fused_kernel,
// _bwd_hidden_kernel and _bwd_table_kernel (pallas_calls in _catalog_bwd).
// For N hidden rows h against the tied (V, C) table T and bias b, with
// s = h T^T + b never stored (218 MB fp32 at N = 3072, V = 17,772):
//
//   forward:  lse[n] = logsumexp_v s[n, v],  ll[n] = s[n, label[n]]
//   backward: g = dlse * exp(s - lse) + dll * onehot(label)
//             dh = g T, dT = g^T h (g rounded to the compute dtype first,
//             both returned in it), db = sum_n g (fp32)
//
// One templated kernel serves the three passes. A block keeps 32 rows of its
// "resident" operand in shared memory and streams 64-row tiles of the other
// operand past them, recomputing each 32 x 64 score tile:
//
// * forward (mode 0): resident hidden rows, streamed vocab tiles of one
//   split of V; an online max and sum per row, merged over the splits by
//   catalog_merge (flash-decoding style, so N = 3072 fills the card).
// * d_hidden (mode 1): the same tiling; g is formed in shared memory and
//   dh += g T_tile accumulates in registers; the splits add into an fp32
//   buffer.
// * d_table (mode 2): resident vocab rows, streamed hidden tiles over all of
//   N; dT += g^T h_tile and db in registers, stored once.
//
// The TPU's fused backward exists because its whole (N, C) d_hidden
// accumulator fits VMEM; a block here has 227 KB of shared memory, so the
// two recompute passes of its large-N branch are the design for every N.
//
// What bounds it: the products, 2 N V C FLOP per pass (55.9 GFLOP at the
// flagship shape) — the forward one, the backward four (the score tile is
// recomputed in both backward passes). In bf16 with C % 64 == 0 they run
// on the tensor cores (mma.sync m16n8k16, fp32 accumulate) from bf16 tiles
// in shared memory, fragments loaded with ldmatrix; otherwise on CUDA cores
// (fp32 FMA). Two blocks share an SM, so one loads its next tile while the
// other computes; double-buffering the tile with cp.async (one block per
// SM) measured no faster on an H100.
//
// Limits: C % 4 == 0 and C <= 512 (the two operand tiles share 227 KB).

#include "common.cuh"

namespace {

using namespace port;

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
  float* part_m;        // (S, N) forward
  float* part_l;
  float* part_ll;
  float* dh_acc;        // (N, C) fp32
  void* dtable;         // (V, C), compute dtype
  float* dbias;         // (V,)
  int N, V, C, splits, tiles_per_split;
};

__host__ __device__ inline int cstride(int C) { return C + 4; }
// bf16 tiles (tensor-core path): rows of C + 8 halves keep 16-byte row
// alignment and put the 8 rows an mma fragment reads in distinct banks
__host__ __device__ inline int bstride(int C) { return C + 8; }
constexpr int kGB = kB + 8;  // row stride of the bf16 copy of g

__host__ __device__ inline size_t smem_bytes(int C, bool mma) {
  if (mma)
    return 2 * ((size_t)(kA + kB) * bstride(C) + (size_t)kA * kGB) +
           sizeof(float) * (size_t)kA * (kB + 1);
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

// MMA (bf16, C % 64 == 0): both products on the tensor cores, operands as
// bf16 tiles in shared memory. The score tile: warp w computes rows
// 16 (w & 1) .. +15 by columns 16 (w >> 1) .. +15 over K = C. The
// accumulation: warp w owns channels [w C/8, (w+1) C/8) of all 32 rows, A
// from the bf16 copy of g, B from pairs of streamed rows.
template <typename T, int MODE, bool MMA>
__global__ void __launch_bounds__(kThreads, 1) catalog_kernel(const Params p) {
  using bf16 = __nv_bfloat16;
  extern __shared__ __align__(16) float smem[];
  const int C = p.C, ld = MMA ? bstride(C) : cstride(C);
  float* as = smem;                // kA x ld floats (CUDA cores)
  float* bs = as + kA * ld;        // kB x ld
  bf16* ah = reinterpret_cast<bf16*>(smem);  // kA x ld halves (tensor cores)
  bf16* bh = ah + kA * ld;                   // kB x ld
  bf16* gh = bh + kB * ld;                   // kA x kGB: g in bf16
  float* gs = MMA ? reinterpret_cast<float*>(gh + kA * kGB) : bs + kB * ld;  // kA x (kB+1)
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g8 = lane >> 2, t4 = lane & 3;
  const int a0 = blockIdx.x * kA;
  const bool resident_vocab = MODE == kDTable;
  const T* a_src = static_cast<const T*>(resident_vocab ? p.table : p.hidden);
  const T* b_src = static_cast<const T*>(resident_vocab ? p.hidden : p.table);
  const int a_total = resident_vocab ? p.V : p.N;
  const int b_total = resident_vocab ? p.N : p.V;
  int tile_begin = 0, tile_end = (b_total + kB - 1) / kB;
  if (MODE != kDTable) {
    tile_begin = blockIdx.y * p.tiles_per_split;
    tile_end = imin(tile_end, tile_begin + p.tiles_per_split);
  }

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
  // CUDA cores: acc[row i][quad j][x]; tensor cores: acc[nt][mt][frag]
  float acc[8][2][4];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int x = 0; x < 4; ++x) acc[i][j][x] = 0.f;
  const int cw = C / 8;             // channels per warp (tensor cores)
  const int mt_s = warp & 1, ng_s = warp >> 1;
  // ldmatrix row addresses of this lane. A operands (rows x K, row-major):
  // lanes 0-15 give rows 0-15 at k, lanes 16-31 the same rows at k + 8.
  // The score tile's B (streamed rows x K): matrix m = lane / 8 holds rows
  // 8 (m / 2) .. +7 at k + 8 (m % 2). The accumulation's B (streamed rows x
  // channels, read transposed): matrix m holds rows k + 8 (m % 2) .. +7 at
  // channels 8 (m / 2) .. +7 of the warp's pair of channel tiles.
  const int lm = lane >> 3, lj = lane & 7;
  const bf16* a_ldm = ah + (16 * mt_s + (lane & 15)) * ld + (lane >> 4) * 8;
  const bf16* b_ldm = bh + (16 * ng_s + (lm >> 1) * 8 + lj) * ld + (lm & 1) * 8;
  const bf16* g_ldm = gh + (lane & 15) * kGB + (lane >> 4) * 8;
  const bf16* bt_ldm = bh + ((lm & 1) * 8 + lj) * ld + warp * cw + (lm >> 1) * 8;
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

  for (int tile = tile_begin; tile < tile_end; ++tile) {
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
          const int v = resident_vocab ? a0 + r : b0 + cc;
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
        if constexpr (MMA) gh[ra * kGB + c] = __float2bfloat16(g);
      }
      __syncthreads();
      if constexpr (MMA) {
        // acc[nt][mt] (rows 16 mt + g8 (+8), channels warp*cw + 8 nt + 2 t4 (+1))
        // += g (32 x 64) @ B tile (64 x C)
        for (int k0 = 0; k0 < kB; k0 += 16) {
          uint32_t a[2][4];
#pragma unroll
          for (int mt = 0; mt < 2; ++mt) ldmatrix_x4(a[mt], g_ldm + 16 * mt * kGB + k0);
#pragma unroll
          for (int nt = 0; nt < 8; nt += 2) {
            if (nt * 8 < cw) {  // a pair of channel tiles (the second may be unused)
              uint32_t b[4];
              ldmatrix_x4_trans(b, bt_ldm + k0 * ld + nt * 8);
#pragma unroll
              for (int mt = 0; mt < 2; ++mt) {
                mma_bf16(acc[nt][mt], a[mt], b[0], b[1]);
                mma_bf16(acc[nt + 1][mt], a[mt], b[2], b[3]);
              }
            }
          }
        }
        continue;
      }
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
  if constexpr (MMA) {
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int row = a0 + 16 * mt + g8 + 8 * (i >> 1);
          const int c = warp * cw + 8 * nt + 2 * t4 + (i & 1);
          if (nt * 8 >= cw || row >= a_total) continue;
          const size_t off = (size_t)row * C + c;
          if (MODE == kDHidden) {
            if (p.splits > 1) atomicAdd(p.dh_acc + off, acc[nt][mt][i]);
            else p.dh_acc[off] = acc[nt][mt][i];
          } else {
            static_cast<T*>(p.dtable)[off] = from_f<T>(acc[nt][mt][i]);
          }
        }
    return;
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
        if (MODE == kDHidden) {
          if (p.splits > 1) atomicAdd(p.dh_acc + off, acc[i][j][x]);
          else p.dh_acc[off] = acc[i][j][x];
        } else {
          static_cast<T*>(p.dtable)[off] = from_f<T>(acc[i][j][x]);
        }
      }
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

// bf16 with C % 64 == 0 takes the tensor cores, everything else CUDA cores.
template <int MODE>
cudaError_t launch_mode(const Params& p, int dtype, dim3 grid, cudaStream_t stream) {
  if (dtype == 0) return launch_variant<float, MODE, false>(p, grid, stream);
  if (p.C % 64 == 0) return launch_variant<__nv_bfloat16, MODE, true>(p, grid, stream);
  return launch_variant<__nv_bfloat16, MODE, false>(p, grid, stream);
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

// Backward: dh_acc (N, C) fp32 (zeroed by the caller when splits > 1),
// dtable (V, C) in the compute dtype, dbias (V,) fp32.
int catalog_nll_bwd(const void* hidden, const void* table, const void* bias,
                    const void* labels, const void* lse, const void* dlse,
                    const void* dll, void* dh_acc, void* dtable, void* dbias,
                    int N, int V, int C, int splits, int dtype, void* stream) {
  if (!valid_shape(N, V, C, dtype) || splits < 1) return (int)cudaErrorInvalidValue;
  Params p = base(hidden, table, bias, labels, N, V, C);
  p.lse = static_cast<const float*>(lse);
  p.dlse = static_cast<const float*>(dlse);
  p.dll = static_cast<const float*>(dll);
  p.dh_acc = static_cast<float*>(dh_acc);
  p.dtable = dtable;
  p.dbias = static_cast<float*>(dbias);
  const int tiles = (V + kB - 1) / kB;
  p.splits = splits;
  p.tiles_per_split = (tiles + splits - 1) / splits;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid_h((N + kA - 1) / kA, splits), grid_t((V + kA - 1) / kA, 1);
  cudaError_t e = launch_mode<kDHidden>(p, dtype, grid_h, s);
  if (e != cudaSuccess) return (int)e;
  e = launch_mode<kDTable>(p, dtype, grid_t, s);
  return (int)e;
}

const char* catalog_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

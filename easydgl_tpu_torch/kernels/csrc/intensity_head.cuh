// The Hawkes intensity head on wgmma, for the two forwards that run it over
// rows of many heads:
//
// * the streamed forward (mau_streamed_fwd.cu, mau_intensity; replaces
//   easydgl_tpu/kernels/mau_streamed.py::_int_fwd_kernel): fp32 in both
//   compute dtypes, its product in three bf16 passes of a hi/lo split of
//   each fp32 operand (mau_int_split_kernel splits Wd's seq_units lanes once
//   a launch);
// * the fused MAU/BiMAU forward in bf16 (mau_attention_fwd.cu, the head of
//   easydgl_tpu/kernels/mau_attention.py::_fwd_kernel): the fused contract,
//   one bf16 pass of the rounded [seq_units | interval] rows by the rounded
//   Wd (mau_int_round_kernel makes Wd's bf16 tiles, its rounded interval
//   lane and the rounded w once a launch), the sigmoid evaluated in fp32 and
//   rounded to bf16, times the bf16 w, summed in fp32; it also writes the
//   training residual raw.
//
// For each row r (= (b, h, i) flattened, B*H*Tq rows) and event e:
//
//   raw[r, e] = sum_d sigmoid([x_r | iv] Wd + bd)[e*dh + d] w[e, d]
//   lam[r, e] = s_e softplus(raw[r, e] / s_e),  s_e = exp(scaling[e])
//
// A row block is 192 rows (128 at dh = 128): three consumer warpgroups of
// 64 (two) and a producer warp (setmaxnreg 24 / 160, 24 / 240). The work,
// (row block, four column tiles) quads, is cut into one even, contiguous
// share a block, one block an SM (662 row blocks over 132 SMs would be 5.02
// waves, the sixth nearly empty). Each consumer keeps its rows of the row
// block at hand as A fragments in registers (hi and lo in the split form);
// the producer streams Wd's 64-column tiles (hi and lo, or the one bf16
// tile) by TMA (128-byte swizzle, B MN-major) into a ring of four stages,
// with the tile's interval lane, bd and w by plain loads. Per tile, on wgmma
// m64n64k16 with fp32 accumulators: z = x Wd_tile, then the interval's
// rank-1 term and bd in fp32, the exact sigmoid (ex2 and a reciprocal), the
// weight w, and each event's dh columns summed in the accumulator layout
// (in-thread sums, then the quad); an event's sum goes through the scaled
// softplus and out as lam as soon as its last tile is done (dh = 128: two
// tiles). Two accumulators: the next tile's products run while this tile's
// sigmoids are formed. The (rows, E*dh) activation never leaves the SM,
// any E fits, and Wd is read from L2 once a row block: at the fused
// forward's flagship shape (126,976 rows, E*dh = 4,096) 0.35 GB of it,
// where one block a (b, h) read 2.68 GB.
//
// What bounds it: its sigmoids (two special-function ops each: 520 M at
// the fused flagship shape, 537 M at the streamed LC shape, ~0.25 ms at 16
// a clock an SM) more than its product (one bf16 pass of 126,976 x 65 x
// 4,096, 0.068 ms at 989 TFLOP/s; three passes in the split form).
#pragma once

#include "launch.cuh"

namespace {

using namespace port;

struct IntParams {
  const float* su;         // split: (rows, dh) fp32 seq_units
  const bf16* x;           // fused: (rows, dh) bf16, the rounded seq_units lanes
  const float* intervals;  // (B, Tq)
  const float* wiv;        // (E*dh,) Wd's interval lane (fused: rounded to bf16)
  const float* bd;         // (E*dh,)
  const float* w;          // (E*dh,) (fused: rounded to bf16)
  const float* scaling;    // (E,)
  float* lam;              // (rows, E)
  float* raw;              // fused, training: (rows, E) the residual; else null
  int rows, H, Tq, E;
};

constexpr int kIntStages = 4;  // ring stages of (64-column) Wd tiles

// Consumer warpgroups a block: three at dh <= 64, two at dh = 128 (whose
// rows' hi/lo A fragments alone take 64 registers).
__host__ __device__ constexpr int int_groups(int dh) { return dh == 128 ? 2 : 3; }

// Wd tiles a stage: hi and lo (split), the one bf16 tile (fused).
__host__ __device__ constexpr int int_tiles(bool fused) { return fused ? 1 : 2; }

// Dynamic shared memory: per stage the Wd tiles (dh rows of 64 columns, 128
// bytes a row) and the tile's interval lane, bd and w (3 x 64 fp32); the
// mbarriers; 1 KB of slack to align the tiles to 1024 bytes.
__host__ __device__ inline size_t int_tc_smem_bytes(int dh, bool fused) {
  return 1024 +
         (size_t)kIntStages * (int_tiles(fused) * dh * 64 * sizeof(bf16) + 3 * 64 * sizeof(float)) +
         8 * 2 * kIntStages;
}

struct IntMaps {
  CUtensorMap hi, lo;  // (E*dh columns, dh rows), boxes of 64 columns x dh rows
};

// Wd's seq_units lanes (its first dh rows: n2 pairs of values) into bf16
// hi and lo (split_bf16x2), a pair a thread and step.
__global__ void mau_int_split_kernel(const float2* wd, uint32_t* hi, uint32_t* lo, int n2) {
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n2; i += gridDim.x * blockDim.x)
    split_bf16x2(wd[i].x, wd[i].y, hi[i], lo[i]);
}

// The fused contract's operands, rounded to bf16 once a launch: Wd's
// seq_units lanes (dh x edh) as the bf16 tiles' source, and its interval
// lane and w (edh each) as fp32 values of bf16 precision in `side`.
__global__ void mau_int_round_kernel(const float* wd, const float* w, bf16* wd_b, float* side,
                                     int dh, int edh) {
  const int n = dh * edh, stride = gridDim.x * blockDim.x;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n + 2 * edh; i += stride) {
    if (i < n)
      wd_b[i] = __float2bfloat16(wd[i]);
    else
      side[i - n] = rnd<bf16>(i < n + edh ? wd[i] : w[i - n - edh]);
  }
}

// z = x Wd_tile for the block's tile t once its stage has landed: KK k
// steps (B MN-major: 16 lanes a k step) of one bf16 pass (fused) or three
// (split: the ring's hi tile, then its lo tile), committed as one group.
template <int KK, bool kFused>
__device__ __forceinline__ void int_products(float (&z)[32], const uint32_t (&xh)[KK][4],
                                             const uint32_t (&xl)[KK][4], const bf16* ring,
                                             uint64_t* full, int t) {
  constexpr int kTile = KK * 16 * 64, NT = int_tiles(kFused);
  const int s = t % kIntStages;
  mbar_wait(full + s, (t / kIntStages) & 1);
  const uint64_t dhi = sw128_desc(ring + s * NT * kTile);
  zero32(z);
  wg_fence();
  if constexpr (kFused) {
#pragma unroll
    for (int kk = 0; kk < KK; ++kk) wgmma_rs<1>(z, xh[kk], dhi + 128 * kk);
  } else {
    const uint64_t dlo = sw128_desc(ring + s * NT * kTile + kTile);
#pragma unroll
    for (int kk = 0; kk < KK; ++kk) wgmma_rs_x3<1>(z, xh[kk], xl[kk], dhi + 128 * kk, dlo + 128 * kk);
  }
  wg_commit();
}

// Thread (warp, g, t4) of warpgroup wg holds rows r0 + g (+8), r0 = the
// block's first row + 64 wg + 16 warp, and, of a column tile, columns 8 n +
// 2 t4 (+1) at z[4 n + 2 hr + c]. An event's dh columns lie in one tile
// (dh <= 64: 64 / dh events a tile) or two (dh = 128: the first tile's sum
// is carried). The products of the next tile run while the sigmoids of
// this one are formed: two accumulators in turn, four tiles (a quad) an
// iteration (no group in flight across the loop, which would have ptxas
// serialize the products), the count rounded up to four with tiles past
// E*dh (zeros, their events not stored). The block's quads run in order;
// the ring's stage and phase follow the block's own count of tiles.
template <int DH, bool kFused>
__global__ void __launch_bounds__(128 * (int_groups(DH) + 1), 1)
    mau_int_fwd_tc_kernel(const IntParams p, const __grid_constant__ IntMaps maps) {
  constexpr int G = int_groups(DH), KK = DH / 16, NT = int_tiles(kFused);
  constexpr int EL = DH >= 64 ? 1 : 64 / DH;  // events a tile holds
  constexpr int kTile = DH * 64;              // bf16 values of a Wd tile
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* base = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  bf16* ring = reinterpret_cast<bf16*>(base);  // [stage][hi, lo or the one][DH lanes][64 columns]
  float* side = reinterpret_cast<float*>(ring + kIntStages * NT * kTile);  // [stage][iv lane, bd, w][64]
  uint64_t* full = reinterpret_cast<uint64_t*>(side + kIntStages * 3 * 64);  // [stage]
  uint64_t* empty = full + kIntStages;                                        // [stage]
  const int edh = p.E * DH, nq = (edh + 255) / 256;  // quads of column tiles a row block
  // this block's quads [q0, q1) of the row blocks' nrb * nq
  const long long nquads = (long long)((p.rows + 64 * G - 1) / (64 * G)) * nq;
  const int q0 = (int)(blockIdx.x * nquads / gridDim.x);
  const int q1 = (int)((blockIdx.x + 1) * nquads / gridDim.x);
  const int lane = threadIdx.x & 31;
  int warp = threadIdx.x >> 5;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kIntStages; ++s) {
      mbar_init(full + s, 32);
      mbar_init(empty + s, 128 * G);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (warp >= 4 * G) {  // ---- producer: its first warp streams the column tiles
    regs_dec<kQmProducerRegs>();
    if (warp > 4 * G) return;
    for (int it = 0; it < 4 * (q1 - q0); ++it) {  // the block's tiles, in order
      const int s = it % kIntStages, c0 = 64 * (4 * ((q0 + it / 4) % nq) + it % 4);
      mbar_wait(empty + s, ((it / kIntStages) & 1) ^ 1);
      float* sd = side + s * 3 * 64;
      for (int c = lane; c < 64; c += 32) {
        const bool ok = c0 + c < edh;
        sd[c] = ok ? p.wiv[c0 + c] : 0.f;
        sd[64 + c] = ok ? p.bd[c0 + c] : 0.f;
        sd[128 + c] = ok ? p.w[c0 + c] : 0.f;
      }
      if (lane == 0) {
        bf16* d = ring + s * NT * kTile;
        mbar_arrive_tx(full + s, (uint32_t)(NT * kTile * sizeof(bf16)));
        tma_2d(d, &maps.hi, full + s, c0, 0);
        if constexpr (!kFused) tma_2d(d + kTile, &maps.lo, full + s, c0, 0);
      } else {
        mbar_arrive(full + s);
      }
    }
    return;
  }

  // ---- consumers
  regs_inc<qm_consumer_regs(G)>();
  const int wg = warp >> 2;
  warp &= 3;
  const int g = lane >> 2, t4 = lane & 3;
  int r0 = -1;  // the warp's first row in the row block at hand
  // the rows as A fragments (split: hi and lo): k step kk, entry i at row
  // r0 + g + 8 (i & 1), lanes 16 kk + 8 (i >> 1) + 2 t4 (+1)
  uint32_t xh[KK][4], xl[KK][4];
  float iv[2], carry[2] = {0.f, 0.f};
  auto take_rows = [&](int rb) {
    r0 = (rb * G + wg) * 64 + 16 * warp;
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int row = r0 + g + 8 * hr;
      const float v = row < p.rows ? p.intervals[(size_t)(row / (p.Tq * p.H)) * p.Tq + row % p.Tq] : 0.f;
      iv[hr] = kFused ? rnd<bf16>(v) : v;  // the fused contract rounds the interval
    }
#pragma unroll
    for (int kk = 0; kk < KK; ++kk)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = r0 + g + 8 * (i & 1), c = 16 * kk + 8 * (i >> 1) + 2 * t4;
        if constexpr (kFused) {
          xh[kk][i] = row < p.rows ? *reinterpret_cast<const uint32_t*>(p.x + (size_t)row * DH + c) : 0u;
        } else {
          const float2 v = row < p.rows ? *reinterpret_cast<const float2*>(p.su + (size_t)row * DH + c)
                                        : make_float2(0.f, 0.f);
          split_bf16x2(v.x, v.y, xh[kk][i], xl[kk][i]);
        }
      }
  };

  // column tile t's products in z, the block's tile `it` on the ring:
  // sigmoid(z + iv Wd[dh] + bd) w (fused: the sigmoid rounded to bf16)
  // summed over the thread's columns of each event, the quad's columns,
  // then lam = s softplus(raw / s) by one lane an event
  auto finish = [&](int t, int it, const float (&z)[32]) {
    const int s = it % kIntStages;
    const float* sd = side + s * 3 * 64;
    float raw[2][EL];
#pragma unroll
    for (int hr = 0; hr < 2; ++hr)
#pragma unroll
      for (int el = 0; el < EL; ++el) raw[hr][el] = 0.f;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const int el = DH >= 64 ? 0 : 8 * n / DH, col = 8 * n + 2 * t4;
      const float2 wiv = *reinterpret_cast<const float2*>(sd + col);
      const float2 bdc = *reinterpret_cast<const float2*>(sd + 64 + col);
      const float2 wc = *reinterpret_cast<const float2*>(sd + 128 + col);
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        float s0 = sigmoid(fmaf(iv[hr], wiv.x, z[4 * n + 2 * hr] + bdc.x));
        float s1 = sigmoid(fmaf(iv[hr], wiv.y, z[4 * n + 2 * hr + 1] + bdc.y));
        if constexpr (kFused) round_bf16x2(s0, s1);  // the fused contract's rounding
        raw[hr][el] = fmaf(s1, wc.y, fmaf(s0, wc.x, raw[hr][el]));
      }
    }
    mbar_arrive(empty + s);  // the stage's tiles and side lanes are read
#pragma unroll
    for (int hr = 0; hr < 2; ++hr)
#pragma unroll
      for (int el = 0; el < EL; ++el) {
        float x = raw[hr][el];
        x += __shfl_xor_sync(0xffffffffu, x, 1);
        x += __shfl_xor_sync(0xffffffffu, x, 2);
        raw[hr][el] = x;
      }
    if constexpr (DH == 128) {
      if (!(t & 1)) {  // the event's first half
        carry[0] = raw[0][0];
        carry[1] = raw[1][0];
        return;
      }
      raw[0][0] += carry[0];
      raw[1][0] += carry[1];
    }
#pragma unroll
    for (int el = 0; el < EL; ++el) {
      const int e = DH == 128 ? t / 2 : 64 * t / DH + el;
      if (t4 != el || e >= p.E) continue;
      const float sc = expf(p.scaling[e]);
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int row = r0 + g + 8 * hr;
        if (row >= p.rows) continue;
        p.lam[(size_t)row * p.E + e] = sc * softplus(raw[hr][el] / sc);
        if (kFused && p.raw) p.raw[(size_t)row * p.E + e] = raw[hr][el];
      }
    }
  };

  float z0[32], z1[32];
  for (int q = q0; q < q1; ++q) {
    const int rb = q / nq, t = 4 * (q % nq), it = 4 * (q - q0);
    if (r0 != (rb * G + wg) * 64 + 16 * warp) take_rows(rb);
    int_products<KK, kFused>(z0, xh, xl, ring, full, it);
    int_products<KK, kFused>(z1, xh, xl, ring, full, it + 1);
    wg_wait_n<1>();
    reg_fence(z0);
    finish(t, it, z0);
    int_products<KK, kFused>(z0, xh, xl, ring, full, it + 2);
    wg_wait_n<1>();
    reg_fence(z1);
    finish(t + 1, it + 1, z1);
    int_products<KK, kFused>(z1, xh, xl, ring, full, it + 3);
    wg_wait_n<1>();
    reg_fence(z0);
    finish(t + 2, it + 2, z0);
    wg_wait();
    reg_fence(z1);
    finish(t + 3, it + 3, z1);
  }
}

// The map of a bf16 (dh, edh) Wd tile source: boxes of 64 columns x dh rows.
inline bool wd_tile_map(CUtensorMap* map, const bf16* src, int dh, int edh) {
  const cuuint64_t dims[2] = {(cuuint64_t)edh, (cuuint64_t)dh};
  const cuuint64_t strides[1] = {(cuuint64_t)edh * sizeof(bf16)};
  const cuuint32_t box[2] = {64, (cuuint32_t)dh};
  return encode_map(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, src, dims, strides, box);
}

// Makes the head's operands once a launch, then runs it; any (dh, E) with
// dh in {16, 32, 64, 128}. wd: Wd (dh+1, E*dh) fp32. The split form splits
// Wd's seq_units lanes into hi and lo (wd_b: 2 x dh x E*dh bf16) and reads
// Wd's own interval lane; the fused form rounds them into wd_b (dh x E*dh
// bf16), and the interval lane and p.w into side (2 x E*dh fp32).
template <bool kFused>
cudaError_t int_launch(IntParams p, const float* wd, bf16* wd_b, float* side, int dh,
                       cudaStream_t s) {
  const int edh = p.E * dh, n = kFused ? dh * edh + 2 * edh : dh * edh / 2;
  const int grid = imin((n + 255) / 256, 1024);
  IntMaps maps{};
  cudaError_t e;
  if constexpr (kFused) {
    e = go(mau_int_round_kernel, grid, 256, 0, s, wd, p.w, wd_b, side, dh, edh);
    p.wiv = side;
    p.w = side + edh;
  } else {
    e = go(mau_int_split_kernel, grid, 256, 0, s, reinterpret_cast<const float2*>(wd),
           reinterpret_cast<uint32_t*>(wd_b), reinterpret_cast<uint32_t*>(wd_b + dh * edh), n);
    p.wiv = wd + (size_t)dh * edh;
    if (e == cudaSuccess && !wd_tile_map(&maps.lo, wd_b + dh * edh, dh, edh))
      e = cudaErrorInvalidValue;
  }
  if (e == cudaSuccess && !wd_tile_map(&maps.hi, wd_b, dh, edh)) e = cudaErrorInvalidValue;
  if (e != cudaSuccess) return e;
  // one block an SM, each an even share of the quads
  const int groups = int_groups(dh), rows_a_block = 64 * groups, threads = 128 * (groups + 1);
  int dev = 0, sms = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess ||
      (e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return e;
  const long long quads = (long long)((p.rows + rows_a_block - 1) / rows_a_block) * ((edh + 255) / 256);
  const int blocks = (int)(quads < sms ? quads : sms);
  const size_t bytes = int_tc_smem_bytes(dh, kFused);
  switch (dh) {
    case 16: return go(mau_int_fwd_tc_kernel<16, kFused>, blocks, threads, bytes, s, p, maps);
    case 32: return go(mau_int_fwd_tc_kernel<32, kFused>, blocks, threads, bytes, s, p, maps);
    case 64: return go(mau_int_fwd_tc_kernel<64, kFused>, blocks, threads, bytes, s, p, maps);
    case 128: return go(mau_int_fwd_tc_kernel<128, kFused>, blocks, threads, bytes, s, p, maps);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

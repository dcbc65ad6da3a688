// What the streamed MAU/BiMAU kernels share, forward (mau_streamed_fwd.cu)
// and backward (mau_streamed_bwd.cu): the tile sizes, the key flags and
// masked logits of the blocked plain version, the causal tile rule, the
// live-tile rule, cp.async, and the producer and entries of the query-major
// wgmma kernels (the launcher and the setmaxnreg split: launch.cuh).
#pragma once

#include <type_traits>

#include "launch.cuh"

namespace {

using namespace port;

constexpr int kThreads = 256;
constexpr int BQ = 64;                  // queries a tile
constexpr int BK = 64;                  // keys a tile
constexpr int LD = 68;                  // row stride of the 64-wide tiles
constexpr float kNeg = -4294967295.0f;  // -(2^32) + 1, the reference mask
constexpr float kPadNeg = -1.0e38f;     // the running max before any key

struct Seq {
  const void* p;
  long long bs, rs;  // batch and row strides, in elements
};

template <int N>
__device__ __forceinline__ void lds(const float* p, float (&o)[N]) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int i = 0; i < N; i += 4) {
      const float4 v = *reinterpret_cast<const float4*>(p + i);
      o[i] = v.x; o[i + 1] = v.y; o[i + 2] = v.z; o[i + 3] = v.w;
    }
  } else if constexpr (N == 2) {
    const float2 v = *reinterpret_cast<const float2*>(p);
    o[0] = v.x; o[1] = v.y;
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) o[i] = p[i];
  }
}

// Number of key tiles the query tile [q0, q0 + 64) visits: under causal,
// tiles after the tile's last query are skipped, unless no real key lies at
// or before q0 (then a row of the tile may see no key at all, and such a row
// is uniform over every real key, as in the plain version). Every thread of
// the block must call it.
__device__ __forceinline__ int key_tiles(const float* km_row, int Tq, int Tk, int q0,
                                         int causal) {
  const int all = (Tk + BK - 1) / BK;
  if (!causal) return all;
  int seen = 0;
  for (int j = threadIdx.x; j <= imin(q0, Tk - 1); j += blockDim.x) seen |= km_row[j] > 0.f;
  if (!__syncthreads_or(seen)) return all;
  const int q_last = imin(q0 + BQ, Tq) - 1;
  return imin(all, q_last / BK + 1);
}

// Key j of a tile, from its raw mask entry km: 1 where it is real and not
// masked (mask > 0, as the plain version), 0 where it is real and masked, -1
// past Tk (alignment padding).
__device__ __forceinline__ float flag_of(float km, int j, int Tk) {
  return j < Tk ? (km > 0.f ? 1.f : 0.f) : -1.f;
}

__device__ __forceinline__ float key_flag(const float* km_row, int j, int Tk) {
  return flag_of(j < Tk ? km_row[j] : 0.f, j, Tk);
}

// The logit of entry (i, j) from the raw dot product, as _masked_logits:
// visible -> dot * scale; real masked or causally hidden -> NEG; padding
// (j >= Tk, marked by a negative mask entry) -> padval.
__device__ __forceinline__ float logit(float dot, float km, int i, int j, float scale,
                                       int causal, float padval) {
  if (km < 0.f) return padval;
  if (km == 0.f || (causal && j > i)) return kNeg;
  return dot * scale;
}

// ---------------------------------------------------------------- the
// tiles of four warps (flash_attention.cu's fp32 kernels) and cp.async

constexpr int kThreadsMma = 128;
constexpr int KH = 32;  // keys a half tile

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src),
               "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

__device__ __forceinline__ void cp_async_wait_prev() {
  asm volatile("cp.async.wait_group 1;\n" ::);  // all groups but the newest
}

__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_group 0;\n" ::); }

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// ---------------------------------------------------------------- the
// live-tile rule of the bf16 output, d-lambda and dk/dv/dt kernels

__host__ __device__ inline int key_tile_count(int Tk) { return (Tk + BK - 1) / BK; }

// Bytes of the plan a block keeps in shared memory (key_plan).
__host__ __device__ inline size_t plan_bytes(int Tk) {
  return sizeof(int) * (size_t)(key_tile_count(Tk) + 1);
}

// The plan of a batch row, made by the block from its key-mask row into
// shared memory (streamed_key_plan of kernels/mau_streamed.py is the same
// in PyTorch): the code of each of its nkt 64-key tiles, 0 where no key of
// the tile is real, 2 where all 64 are, 1 otherwise; then its first real
// key, Tk where it has none. Every thread of the block calls it; it ends
// with a barrier.
__device__ __forceinline__ void key_plan(const float* km_row, int Tk, int* plan) {
  const int nkt = key_tile_count(Tk), lane = threadIdx.x & 31;
  if (threadIdx.x == 0) plan[nkt] = Tk;
  __syncthreads();
  for (int kt = threadIdx.x >> 5; kt < nkt; kt += blockDim.x >> 5) {
    const int j0 = kt * BK, jl = j0 + lane, jh = jl + 32;
    const unsigned lo = __ballot_sync(0xffffffffu, jl < Tk && km_row[imin(jl, Tk - 1)] > 0.f);
    const unsigned hi = __ballot_sync(0xffffffffu, jh < Tk && km_row[imin(jh, Tk - 1)] > 0.f);
    if (lane == 0) {
      plan[kt] = (lo | hi) == 0u ? 0 : (lo & hi) == 0xffffffffu ? 2 : 1;
      if (lo | hi) atomicMin(plan + nkt, lo ? j0 + __ffs(lo) - 1 : j0 + 31 + __ffs(hi));
    }
  }
  __syncthreads();
}

// The rule, from a batch row's plan. A query tile [q0, q0 + 64) is blind
// where a row of it sees no key: every row where the batch row has no real
// key, and under causal the rows before its first real key. Such a row is
// uniform over every real key, masked ones included, so a blind query tile
// visits every key tile; any other one visits the tiles that hold a real
// key, under causal none after its last query (key_tiles' range). Every
// pair left out adds exactly 0: in a row that sees a key, a key that is not
// visible has a prob of 0. The visible-only form (dq's) treats no query
// tile as blind: a term that is zero wherever its entry is not visible gets
// nothing from a row that sees no key, so only the tiles that hold a real
// key, within the causal range, are visited. P: the kernel's parameters
// (Tq, Tk, causal), read where they are used.
struct TileRule {
  const int* plan;  // the batch row's plan, in shared memory
  int first;

  template <typename P>
  __device__ __forceinline__ bool blind(const P& p, int q0) const {
    return first >= p.Tk || (p.causal && q0 < first);
  }
  // Whether query tile q0 visits key tile kt (< key_tile_count) of code `code`.
  template <typename P>
  __device__ __forceinline__ bool visits_code(const P& p, int kt, int code, int q0,
                                              bool visible_only = false) const {
    if (q0 >= p.Tq) return false;
    const bool bl = !visible_only && blind(p, q0);
    if (p.causal && !bl && kt * BK > imin(q0 + BQ, p.Tq) - 1) return false;
    return bl || code != 0;
  }
  template <typename P>
  __device__ __forceinline__ bool visits(const P& p, int kt, int q0,
                                         bool visible_only = false) const {
    return kt < key_tile_count(p.Tk) && visits_code(p, kt, plan[kt], q0, visible_only);
  }
  // Whether the entries of (query tile q0, key tile kt) are tested one by
  // one: a tile with a key that is not real (masked or past Tk), and under
  // causal the diagonal tile and those after it. Rows past Tq are never
  // stored, so the ragged query edge needs no test.
  template <typename P>
  __device__ __forceinline__ bool test(const P& p, int kt, int q0) const {
    return plan[kt] != 2 || (p.causal && kt * BK + BK - 1 > q0);
  }
};

__device__ __forceinline__ TileRule tile_rule(const int* plan, int Tk) {
  return {plan, plan[key_tile_count(Tk)]};
}

// ---------------------------------------------------------------- bf16 on
// wgmma: what the query-major stats (mau_stats_tc_kernel), output
// (mau_out_tc_kernel), d-lambda (mau_glam_tc_kernel) and dq
// (mau_dq_tc_kernel) kernels share, on
// flash_fwd_tc_kernel's pattern: a block owns G warpgroups of 64 queries of
// one (b, h) and a producer warp (its warpgroup hands its registers over by
// setmaxnreg). The producer copies each warpgroup's resident tiles once,
// then streams the visited key tiles' K, V (T) and one-hot by TMA (128-byte
// swizzle) into a ring of stages under full and empty mbarriers, with their
// key mask by plain loads; every warpgroup consumes every stage and skips
// the tiles its own queries do not visit.

constexpr int kQmTile = 64 * 64;   // bf16 values of a (64 x 64) tile, 8 KB
constexpr int kQmStages = 2;       // ring stages where they fit (four measured no faster)

// The maps the producer copies from, each (64 columns x 64 rows) boxes of a
// (B, H, T, cols) operand: per warpgroup nres[m] column tiles of res[m] once
// (Q first: the stats' Q, the output's Q and lam, the d-lambda's Q and dO,
// dq's Q, dO, g_su and lam); per visited key tile nring[m] column tiles of
// ring[m] into a stage, in the order K, V (not the stats'), T (the stats'
// and dq's), one-hot (one head for all, so read at head 0).
constexpr int kQmMaps = 4, kQmOnehot = 3;
struct QmMaps {
  CUtensorMap res[kQmMaps], ring[kQmMaps];
  int nres[kQmMaps], nring[kQmMaps];
};

__host__ __device__ inline int qm_tiles(const int (&n)[kQmMaps]) { return n[0] + n[1] + n[2] + n[3]; }

// Dynamic shared memory of a block: `groups` x `res` resident tiles,
// `stages` x `ring` tiles and 64 key-mask floats, the mbarriers, the plan
// of Tk keys, 1 KB of slack to align the tiles to 1024 bytes.
__host__ __device__ inline size_t qm_smem_bytes(int groups, int res, int stages, int ring,
                                                int Tk) {
  return 1024 + sizeof(bf16) * kQmTile * (size_t)(groups * res + stages * ring) +
         sizeof(float) * BK * stages + 8 * (1 + 2 * stages) + plan_bytes(Tk);
}

template <int G>
struct QmBlock {
  TileRule rule;
  int b, h, q0;
  bool visible_only;  // the rule's visible-only form (dq)

  template <typename P>
  __device__ __forceinline__ bool wg_visits(const P& p, int kt, int wg) const {
    return rule.visits(p, kt, q0 + 64 * wg, visible_only);
  }
  // The first key tile from kt on that a warpgroup of the block visits
  // (the number of key tiles if none).
  template <typename P>
  __device__ __forceinline__ int next(const P& p, int kt) const {
    for (; kt < key_tile_count(p.Tk); ++kt)
#pragma unroll
      for (int w = 0; w < G; ++w)
        if (wg_visits(p, kt, w)) return kt;
    return kt;
  }
};

// The producer warp: each warpgroup's resident tiles once (maps.res), then
// each visited key tile's ring tiles (maps.ring) into stage it % stages, and
// its key mask (0 past Tk).
template <int G, typename P>
__device__ __forceinline__ void qm_produce(const P& p, const QmBlock<G>& blk, const QmMaps& maps,
                                           int stages, bf16* res, bf16* ring, float* kms,
                                           uint64_t* res_full, uint64_t* full, uint64_t* empty,
                                           int lane) {
  const int rt = qm_tiles(maps.nres), st = qm_tiles(maps.nring);
  if (lane == 0) {
    mbar_arrive_tx(res_full, (uint32_t)(G * rt * kQmTile * sizeof(bf16)));
    for (int w = 0; w < G; ++w) {
      bf16* r = res + w * rt * kQmTile;
      for (int m = 0; m < kQmMaps; ++m)
        for (int c = 0; c < maps.nres[m]; ++c, r += kQmTile)
          tma_rows(r, &maps.res[m], res_full, blk.q0 + 64 * w, blk.h, blk.b, 64 * c);
    }
  }
  const int Tk = p.Tk, nkt = key_tile_count(Tk);
  const float* km_row = p.key_mask + (size_t)blk.b * Tk;
  int it = 0;
  for (int kt = blk.next(p, 0); kt < nkt; kt = blk.next(p, kt + 1), ++it) {
    const int s = it % stages, j0 = kt * BK;
    mbar_wait(empty + s, ((it / stages) & 1) ^ 1);
    for (int r = lane; r < BK; r += 32) kms[s * BK + r] = j0 + r < Tk ? km_row[j0 + r] : 0.f;
    if (lane == 0) {
      bf16* d = ring + s * st * kQmTile;
      mbar_arrive_tx(full + s, (uint32_t)(st * kQmTile * sizeof(bf16)));
      for (int m = 0; m < kQmMaps; ++m)
        for (int c = 0; c < maps.nring[m]; ++c, d += kQmTile)
          tma_rows(d, &maps.ring[m], full + s, j0, m == kQmOnehot ? 0 : blk.h, blk.b, 64 * c);
    } else {
      mbar_arrive(full + s);
    }
  }
}

// What the entries p = exp(s - m) / l of a thread's two rows need: m log2
// e, the exponent (NEG - m) log2 e of a key that is real but not visible
// (formed before the scaling, so that it is exactly 0 in a row that sees no
// key, whose m is NEG: such a row is uniform over its real keys), and 1 / l.
struct RowStats {
  float m2[2], hid2[2], rl[2];
};

__device__ __forceinline__ RowStats row_stats(const float* m, const float* l, size_t row0, int i0,
                                              int Tq) {
  RowStats r;
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int i = i0 + 8 * hr;
    const float mi = i < Tq ? m[row0 + i] : 0.f, li = i < Tq ? l[row0 + i] : 1.f;
    r.m2[hr] = mi * kLog2e;
    r.hid2[hr] = (kNeg - mi) * kLog2e;
    r.rl[hr] = 1.f / li;
  }
  return r;
}

// Whether entry (i, j) is visible: outside tested tiles every entry is; in
// them the key must be real (not masked, not past Tk, whose mask entry
// reads 0) and, under causal, not after the query.
__device__ __forceinline__ bool entry_visible(bool test, float km, int i, int j, int causal) {
  return !test || (km > 0.f && !(causal && j > i));
}

// The base-2 exponent of p for entry (i, j) of row hr from its raw dot
// product, without a branch: visible -> dot scale log2 e - m log2 e; a real
// key that is masked or causally hidden -> hid2; padding (j >= Tk) -> -inf,
// so p = 0.
__device__ __forceinline__ float entry_exp2(float dot, bool test, float km, int i, int j, float sl2,
                                          const RowStats& r, int hr, int Tk, int causal) {
  return entry_visible(test, km, i, j, causal) ? fmaf(dot, sl2, -r.m2[hr])
                                               : (j < Tk ? r.hid2[hr] : -INFINITY);
}

// A flag that is a constant where the caller passes one
// (std::true_type / std::false_type), else a run-time bool.
__device__ __forceinline__ bool flag(bool f) { return f; }
template <bool F>
__device__ __forceinline__ constexpr bool flag(std::integral_constant<bool, F>) {
  return F;
}

// The accumulator's (64 x 64) entries rounded to bf16 as wgmma A fragments:
// k step kk (columns 16 kk ..) at f[4 kk ..].
__device__ __forceinline__ void a_frags(uint32_t (&f)[16], const float (&d)[32]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int e = 0; e < 4; ++e) f[4 * kk + e] = pack_bf16(d[8 * kk + 2 * e], d[8 * kk + 2 * e + 1]);
}

// Rows of a warpgroup accumulator (the thread's rows r0 + g (+8), columns
// 8 n + 2 t4 (+1) at d[4 n + 2 hr + c]) into bf16 rows r < nrows of dst.
__device__ __forceinline__ void store_acc_bf16(bf16* dst, long long rs, const float (&d)[32],
                                               int r0, int nrows, int lane) {
  const int g = lane >> 2, t4 = lane & 3;
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int r = r0 + g + 8 * hr;
    if (r >= nrows) continue;
#pragma unroll
    for (int n = 0; n < 8; ++n)
      *reinterpret_cast<__nv_bfloat162*>(dst + (long long)r * rs + 8 * n + 2 * t4) =
          __floats2bfloat162_rn(d[4 * n + 2 * hr], d[4 * n + 2 * hr + 1]);
  }
}

// The TMA map of a bf16 (B, H, T, cols) operand with element strides (rs,
// hs, bs): boxes of 64 rows x 64 columns, 128-byte swizzle, zeros read past
// row T and column `cols`.
inline bool bf16_rows_map(CUtensorMap* map, const void* ptr, long long cols, int T, int H, int B,
                          long long rs, long long hs, long long bs) {
  const cuuint64_t dims[4] = {(cuuint64_t)cols, (cuuint64_t)T, (cuuint64_t)H, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)rs * 2, (cuuint64_t)hs * 2, (cuuint64_t)bs * 2};
  const cuuint32_t box[4] = {64, 64, 1, 1};
  return encode_map(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, ptr, dims, strides, box);
}

// A bf16 (B, T, H * dh) sequence's map: a head's dh channels by its rows.
inline bool heads_seq_map(CUtensorMap* map, const Seq& s, int T, int H, int B, int dh = 64) {
  return bf16_rows_map(map, s.p, dh, T, H, B, s.rs, dh, s.bs);
}

// A bf16 (B, H, T, cols) contiguous tensor's map (lam, g_su).
inline bool heads_map(CUtensorMap* map, const void* ptr, long long cols, int T, int H, int B) {
  return bf16_rows_map(map, ptr, cols, T, H, B, cols, T * cols, H * T * cols);
}

// The bf16 one-hot (B, Tk, EP)'s map, one head.
inline bool onehot_map(CUtensorMap* map, const void* ptr, long long ep, int Tk, int B) {
  return bf16_rows_map(map, ptr, ep, Tk, 1, B, ep, Tk * ep, Tk * ep);
}

}  // namespace

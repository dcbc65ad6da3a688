// What the warp-specialised wgmma kernels of the MAU sources share, below the
// streamed tile rules: the shared-memory limit and the launcher, the
// setmaxnreg split of a producer warp and G consumer warpgroups, and the
// zeroing of an accumulator. Included by intensity_head.cuh (the head both
// forwards run) and mau_streamed.cuh (the streamed kernels).
#pragma once

#include "hopper.cuh"

namespace {

using namespace port;

using bf16 = __nv_bfloat16;

constexpr size_t kMaxSmem = 232448;  // 227 KB, opt-in per block

constexpr int kQmProducerRegs = 24;
// Registers a consumer thread after setmaxnreg: 24 + 3 x 160 or 24 + 2 x
// 240 of a warpgroup thread fit the 65,536 of an SM.
__host__ __device__ constexpr int qm_consumer_regs(int groups) { return groups == 3 ? 160 : 240; }

__device__ __forceinline__ void zero32(float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) d[i] = 0.f;
}

template <typename K, typename... Args>
cudaError_t go(K kernel, dim3 blocks, int threads, size_t bytes, cudaStream_t stream,
               const Args&... args) {
  if (bytes > kMaxSmem) return cudaErrorInvalidValue;
  if (bytes > 48 * 1024) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (e != cudaSuccess) return e;
  }
  kernel<<<blocks, threads, bytes, stream>>>(args...);
  return cudaGetLastError();
}

}  // namespace

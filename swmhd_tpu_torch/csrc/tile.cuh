// What the kernels over 2-D tiles in shared memory share: the tile probes
// of tile.cu and the vector-invariant substage of vi_tile.cuh.

#pragma once

#include <cuda_pipeline.h>
#include <cuda_runtime.h>

namespace swmhd {

// The card's opt-in shared memory a block (232,448 B on an H100).
inline int smem_optin_limit() {
  int dev = 0, limit = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                         dev);
  return limit;
}

// Waits for this thread's cp.async copies, then for the block's.
__device__ __forceinline__ void wait_copies() {
  __pipeline_commit();
  __pipeline_wait_prior(0);
  __syncthreads();
}

}  // namespace swmhd

// What the kernels over 2-D tiles in shared memory share: the tile probes
// of tile.cu, the tile-tendency probe (tendency_tile.cuh) and the two
// substage kernels, vi_tile.cuh (vector-invariant) and cons_tile.cuh
// (conservative): a block's shape, the index map of a
// tile's axis, the region loops, the load of the state windows, the
// Laplacian in box coordinates, the launch of a substage kernel with
// its dynamic shared memory, and the loop and the cooperative launch of
// the resident kernels (3·n substages in one launch).

#pragma once

#include <cooperative_groups.h>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include "substage.cuh"

namespace swmhd {

constexpr int kTileThreads = 256;   // a block
constexpr int kTileY = 32;   // a substage tile's columns (ops/substage.py)
constexpr int kTileRows = kTileThreads / kTileY;

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

// Local index a of a tile's axis is the point i0 + a of an axis of n
// points (the padded extent on an exchanged axis). A shift goes to the
// neighbouring slot of the window on a periodic axis (loaded wrapped),
// and otherwise to the local index of the clamped global one: at a wall
// the wall point (edge replication), on an exchanged axis a point of the
// padded array.
template <Axis A>
struct Map {
  static constexpr Axis kAxis = A;
  int i0, n;
  // shift by m
  __device__ __forceinline__ int sh(int a, int m) const {
    if constexpr (A == Axis::kPeriodic) {
      return a + m;
    } else {
      return clampi(i0 + a + m, n) - i0;
    }
  }
  // shift by m, then by s: a shift of a shifted derived array, clamped
  // at each step
  __device__ __forceinline__ int sh2(int a, int m, int s) const {
    if constexpr (A == Axis::kPeriodic) {
      return a + m + s;
    } else if constexpr (A == Axis::kBounded) {
      return clampi(clampi(i0 + a + m, n) + s, n) - i0;
    } else {
      return clampi(i0 + a + m + s, n) - i0;
    }
  }
  __device__ __forceinline__ int g(int a) const { return i0 + a; }
  // the index a window slot is loaded from: wrapped once (and clamped,
  // for the slots of a ragged tile's far side that no point reads) or
  // clamped
  __device__ __forceinline__ int load(int a) const {
    if constexpr (A == Axis::kPeriodic) {
      const int x = wrap(i0 + a, n);
      return x < n ? x : n - 1;
    } else {
      return clampi(i0 + a, n);
    }
  }
};

// f(a, b) for every (a, b) of [a0, a1) × [B0, B1), the block's threads
// taking consecutive points.
template <int B0, int B1, typename F>
__device__ __forceinline__ void each_point(int a0, int a1, const F& f) {
  constexpr int cols = B1 - B0;
  const int n = (a1 - a0) * cols;
  for (int e = threadIdx.x; e < n; e += kTileThreads) {
    const int r = e / cols;
    f(a0 + r, B0 + e - r * cols);
  }
}

// The four state windows of a tile into `win`: plane k (rows × Cols
// slots) holds field k of the stacked state s (strides p.in_row,
// p.in_plane) at the local points [-Lo, rows - Lo) × [-Lo, Cols - Lo),
// by cp.async, all issued at once,
// from the maps' wrapped, clamped or exchanged indices (Map::load), so no
// padded copy of the state exists. Returns when the block has them.
template <int Lo, int Cols, typename T, Axis X, Axis Y>
__device__ __forceinline__ void load_windows(T* win, const T* s,
                                             const Params<T>& p,
                                             const Map<X>& M,
                                             const Map<Y>& N, int rows) {
  const int plane = rows * Cols;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    for (int e = threadIdx.x; e < plane; e += kTileThreads) {
      const int r = e / Cols;
      const int gi = M.load(r - Lo), gj = N.load(e - r * Cols - Lo);
      __pipeline_memcpy_async(
          win + k * plane + e,
          s + k * p.in_plane + static_cast<size_t>(gi) * p.in_row + gj,
          sizeof(T));
    }
  }
  wait_copies();
}

// ∇² at local (a, b) of rd(a, b), through the maps, with the reciprocal
// spacings rdx, rdy; FX, FY: the field lies on faces along x, y (uh or u:
// (f,c) is <true, false>, vh or v: (c,f) <false, true>, a center field
// <false, false>).
template <bool FX, bool FY, Axis X, Axis Y, typename T, typename RD>
__device__ __forceinline__ T tile_laplacian(const RD& rd, const Map<X>& mx,
                                            const Map<Y>& my, int a, int b,
                                            T rdx, T rdy) {
  return second_difference_by<FX>(
             [&](int k) { return rd(k, b); },
             [&](int k, int m) { return mx.sh(k, m); }, a, rdx)
         + second_difference_by<FY>(
             [&](int k) { return rd(a, k); },
             [&](int k, int m) { return my.sh(k, m); }, b, rdy);
}

// Kernel k (null for axis modes no launch takes) with its dynamic shared
// memory limit raised to `bytes` where *allowed, the most raised so far
// for it, falls short; cudaErrorInvalidValue for a null kernel or bytes
// over the card's opt-in limit.
inline cudaError_t raise_smem_limit(const void* k, size_t bytes,
                                    size_t* allowed) {
  static const int limit = smem_optin_limit();
  if (k == nullptr || bytes > static_cast<size_t>(limit)) {
    return cudaErrorInvalidValue;
  }
  if (bytes > *allowed) {
    const cudaError_t err = cudaFuncSetAttribute(
        k, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(bytes));
    if (err != cudaSuccess) return err;
    *allowed = bytes;
  }
  return cudaSuccess;
}

// Launches substage kernel k, ready for `bytes` of shared memory, over the
// (tile_x, kTileY) tiles of a launch's unpadded output: block
// (blockIdx.y, blockIdx.x) is tile (x0 / tile_x, y0 / kTileY).
template <typename T>
cudaError_t launch_tiles(const void* k, const Launch<T>& a, size_t bytes) {
  const Params<T>& p = a.p;
  const int mx = p.nx - 2 * p.hx, my = p.ny - 2 * p.hy;
  const int tx = a.tile_x;
  if (mx < 1 || my < 1 || tx < 1) return cudaErrorInvalidValue;
  const dim3 grid((my + kTileY - 1) / kTileY, (mx + tx - 1) / tx);
  if (grid.y > 65535) return cudaErrorInvalidValue;
  Params<T> pp = p;
  int tile_x = tx;
  T dt = a.dt, gk = a.gk, zk = a.zk;
  void* args[] = {const_cast<T**>(&a.s_in), const_cast<T**>(&a.g_prev),
                  const_cast<T**>(&a.s_out), const_cast<T**>(&a.g_out),
                  &pp, &tile_x, &dt, &gk, &zk};
  return cudaLaunchKernel(k, grid, dim3(kTileThreads), args, bytes,
                          a.stream);
}

// Le–Moin coefficients (γ_k, ζ_k) of substage k.
template <typename T>
__device__ __forceinline__ T rk_gamma(int k) {
  return k == 0 ? T(8.0 / 15.0) : (k == 1 ? T(5.0 / 12.0) : T(3.0 / 4.0));
}
template <typename T>
__device__ __forceinline__ T rk_zeta(int k) {
  return k == 0 ? T(0.0) : (k == 1 ? T(-17.0 / 60.0) : T(-5.0 / 12.0));
}

// The body of a resident kernel: n_steps RK3 steps of a whole domain (no
// halo), 3·n_steps substages, each calling body(s, g_prev, s_out, g_out,
// γ_k, ζ_k, ti, tj) on every tile (ti, tj) of the output, the block
// walking the tiles t = blockIdx.x, blockIdx.x + gridDim.x, ... (row-major
// over the (tile rows, tile columns) of the one-substage launch), with a
// grid barrier between substages. Buffers as the loop of one-substage
// launches kept them: substage m reads the previous substage's output (in
// for m = 0) and writes out or work, alternating so that the last lands
// in out; in is never written; G of stage 0 goes to gbuf[0], G of stage 1
// to gbuf[1]. The grid must fit the card at once (launch_resident).
template <typename T, typename Body>
__device__ __forceinline__ void resident_substages(const T* in, T* out,
                                                   T* work, T* gbuf,
                                                   const Params<T>& p,
                                                   int tx, int n_steps,
                                                   const Body& body) {
  const int tiles_y = (p.ny + kTileY - 1) / kTileY;
  const int tiles = (p.nx + tx - 1) / tx * tiles_y;
  const size_t n4 = 4 * static_cast<size_t>(p.nx) * p.ny;
  const int total = 3 * n_steps;
  cooperative_groups::grid_group grid = cooperative_groups::this_grid();
  const T* src = in;
#pragma unroll 1
  for (int m = 0; m < total; ++m) {
    const int stage = m % 3;
    T* const dst = (total - 1 - m) % 2 == 0 ? out : work;
    const T* const g_prev = stage == 0 ? nullptr : gbuf + (stage - 1) * n4;
    T* const g_out = stage == 2 ? nullptr : gbuf + stage * n4;
#pragma unroll 1
    for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
      body(src, g_prev, dst, g_out, rk_gamma<T>(stage), rk_zeta<T>(stage),
           t / tiles_y, t % tiles_y);
      // the next tile's windows overwrite what this tile's update read
      __syncthreads();
    }
    // every tile of substage m is written before any block reads it
    if (m + 1 < total) grid.sync();
    src = dst;
  }
}

// The grid of a resident launch over `tiles` tiles: every block resident
// at once (blocks_per_sm on each of sms SMs), and no more than the tiles.
inline int resident_grid(int tiles, int sms, int blocks_per_sm) {
  return tiles < sms * blocks_per_sm ? tiles : sms * blocks_per_sm;
}

// Kernel k of a resident launch ready for `bytes` of shared memory
// (raise_smem_limit into *allowed), with its resident blocks an SM in
// *blocks: asked of the runtime once for each (kernel, bytes) and kept in
// *cached, so that a launch inside a stream capture makes no query.
// cudaErrorCooperativeLaunchTooLarge where no block fits an SM.
inline cudaError_t resident_ready(const void* k, size_t bytes,
                                  size_t* allowed, int* cached,
                                  int* blocks) {
  cudaError_t err = raise_smem_limit(k, bytes, allowed);
  if (err != cudaSuccess) return err;
  if (*cached == 0) {
    int n = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, k, kTileThreads,
                                                        bytes);
    if (err != cudaSuccess) return err;
    *cached = n;
  }
  *blocks = *cached;
  return *blocks > 0 ? cudaSuccess : cudaErrorCooperativeLaunchTooLarge;
}

// Launches resident kernel k, ready for `bytes` (resident_ready), as one
// cooperative launch of resident_grid(tiles, a.sms, blocks_per_sm) blocks
// on a.stream. A grid the card refuses returns its error
// (cudaErrorCooperativeLaunchTooLarge); nothing falls back to a loop.
template <typename T>
cudaError_t launch_resident(const void* k, const Resident<T>& a,
                            size_t bytes, int blocks_per_sm) {
  const Params<T>& p = a.p;
  const int tx = a.tile_x;
  if (p.hx || p.hy || p.nx < 1 || p.ny < 1 || tx < 1 || a.n_steps < 1
      || a.sms < 1) {
    return cudaErrorInvalidValue;
  }
  const int tiles = (p.nx + tx - 1) / tx * ((p.ny + kTileY - 1) / kTileY);
  const dim3 grid(resident_grid(tiles, a.sms, blocks_per_sm));
  Params<T> pp = p;
  int tile_x = tx, n_steps = a.n_steps;
  T dt = a.dt;
  void* args[] = {const_cast<T**>(&a.s_in), const_cast<T**>(&a.s_out),
                  const_cast<T**>(&a.work), const_cast<T**>(&a.gbuf),
                  &pp, &tile_x, &dt, &n_steps};
  return cudaLaunchCooperativeKernel(k, grid, dim3(kTileThreads), args,
                                     bytes, a.stream);
}

// out[0] shared memory bytes a block, out[1] registers a thread, out[2]
// resident blocks an SM (cudaOccupancyMaxActiveBlocksPerMultiprocessor)
// of kernel k, ready for `bytes`.
inline int tile_kernel_info(const void* k, size_t bytes, int* out) {
  cudaFuncAttributes attr{};
  cudaError_t err = cudaFuncGetAttributes(&attr, k);
  if (err != cudaSuccess) return static_cast<int>(err);
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, k,
                                                      kTileThreads, bytes);
  out[0] = static_cast<int>(bytes);
  out[1] = attr.numRegs;
  out[2] = blocks;
  return static_cast<int>(err);
}

}  // namespace swmhd

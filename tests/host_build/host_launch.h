// The host side of a g++ (-std=c++20) build of a tile kernel (vi_host.cpp,
// cons_host.cpp, tile_host.cpp): the thread and block indices, the block
// barrier and the shared memory the stand-in cuda_runtime.h declares, and
// a launch that runs the blocks one after another, each on kTileThreads
// host threads that meet at a std::barrier wherever the kernel calls
// __syncthreads (and, in a grid of one block, a grid barrier). Before each block the shared memory is filled with 0xff
// bytes, so a slot read before it is written (an intermediate outside its
// region, a slot past a wall) is a NaN and shows in G.
#pragma once
#include <thread>
#include <vector>

#include "cuda_runtime.h"

thread_local dim3 threadIdx, blockIdx, gridDim;
std::barrier<>* block_barrier;
namespace swmhd {
alignas(16) unsigned char smem[1 << 20];
}

#include "tile.cuh"

namespace swmhd {

// Blocks (by, bx) of a grid_y × grid_x grid, one after another, each
// running block() on kTileThreads threads; cudaErrorInvalidValue for more
// shared memory than the stand-in has.
template <typename F>
int run_grid(unsigned grid_x, unsigned grid_y, size_t bytes,
             const F& block) {
  if (bytes > sizeof(smem)) return cudaErrorInvalidValue;
  std::barrier<> barrier(kTileThreads);
  block_barrier = &barrier;
  std::vector<std::thread> threads;
  for (int t = 0; t < kTileThreads; ++t) {
    threads.emplace_back([&, t] {
      threadIdx = dim3(t);
      gridDim = dim3(grid_x, grid_y);
      for (unsigned by = 0; by < grid_y; ++by) {
        for (unsigned bx = 0; bx < grid_x; ++bx) {
          blockIdx = dim3(bx, by);
          if (t == 0) std::memset(smem, 0xff, sizeof(smem));
          barrier.arrive_and_wait();
          block();
          barrier.arrive_and_wait();
        }
      }
    });
  }
  for (auto& th : threads) th.join();
  return cudaSuccess;
}

// The grid of launch_tiles (tile.cuh) over the unpadded output of p;
// cudaErrorInvalidValue for a tile_x out of [1, max_tile_x] or an empty
// output.
template <typename T, typename F>
int run_tiles(const Params<T>& p, int tile_x, int max_tile_x, size_t bytes,
              const F& block) {
  const int mx = p.nx - 2 * p.hx, my = p.ny - 2 * p.hy;
  if (tile_x < 1 || tile_x > max_tile_x || mx < 1 || my < 1) {
    return cudaErrorInvalidValue;
  }
  return run_grid((my + kTileY - 1) / kTileY, (mx + tile_x - 1) / tile_x,
                  bytes, block);
}

// substage.cu make_params
template <typename T>
Params<T> host_params(int nx, int ny, int hx, int hy, int mode_x,
                      int mode_y, int closure, int momentum, int mass,
                      int tracer, int stencil, double dx, double dy,
                      double g, double f, double gam_bg, double nu,
                      double kappa) {
  const size_t px = nx + 2 * hx, py = ny + 2 * hy;
  return Params<T>{nx + 2 * hx, ny + 2 * hy, hx, hy, mode_x, mode_y,
                   closure, momentum, mass, tracer, stencil,
                   T(dx), T(dy), T(g), T(f), T(gam_bg), T(dx * dy),
                   T(nu), T(kappa), py, px * py, static_cast<size_t>(ny),
                   static_cast<size_t>(nx) * ny};
}

// host_params with the strides of a launch on a region (substage.cu
// swmhd_substage)
template <typename T>
Params<T> with_strides(Params<T> p, long long in_row, long long in_plane,
                       long long out_row, long long out_plane) {
  p.in_row = in_row;
  p.in_plane = in_plane;
  p.out_row = out_row;
  p.out_plane = out_plane;
  return p;
}

}  // namespace swmhd

// swmhd_multistep's arguments (substage.cu) without the formulation, the
// SMs and the stream, for a host entry point NAME_SUFFIX that calls
// resident<T> of its file: the resident kernel as one block walking every
// tile.
#define SWMHD_HOST_RESIDENT(NAME, T, SUFFIX)                                 \
  extern "C" int NAME##_##SUFFIX(                                            \
      const T* s_in, T* s_out, T* work, T* gbuf, int nx, int ny,             \
      int mode_x, int mode_y, int closure, int momentum, int mass,           \
      int tracer, int stencil, int tile_x, double dx, double dy, double g,   \
      double f, double gam_bg, double nu, double kappa, double dt,           \
      int n_steps) {                                                         \
    return swmhd::resident<T>(                                               \
        s_in, s_out, work, gbuf,                                             \
        swmhd::host_params<T>(nx, ny, 0, 0, mode_x, mode_y, closure,         \
                              momentum, mass, tracer, stencil, dx, dy, g, f, \
                              gam_bg, nu, kappa),                            \
        tile_x, T(dt), n_steps);                                             \
  }

// swmhd_substage's arguments (substage.cu) without the stream, for a
// host entry point NAME_SUFFIX that calls substage<T> of its file: nx, ny
// are the unpadded extents, every array contiguous; and NAME_region_SUFFIX
// with the strides of a launch on a region (in_row, in_plane, out_row,
// out_plane after hy).
#define SWMHD_HOST_ENTRY(NAME, T, SUFFIX)                                    \
  extern "C" int NAME##_region_##SUFFIX(                                     \
      const T* s, const T* g_prev, T* s_out, T* g_out, int nx, int ny,       \
      int hx, int hy, long long in_row, long long in_plane,                  \
      long long out_row, long long out_plane, int mode_x, int mode_y,        \
      int closure, int momentum, int mass, int tracer, int stencil,          \
      int tile_x, double dx, double dy, double g, double f, double gam_bg,   \
      double nu, double kappa, double dt, double gk, double zk) {            \
    return swmhd::substage<T>(                                               \
        s, g_prev, s_out, g_out,                                             \
        swmhd::with_strides(                                                 \
            swmhd::host_params<T>(nx, ny, hx, hy, mode_x, mode_y, closure,   \
                                  momentum, mass, tracer, stencil, dx, dy,   \
                                  g, f, gam_bg, nu, kappa),                  \
            in_row, in_plane, out_row, out_plane),                           \
        tile_x, T(dt), T(gk), T(zk));                                        \
  }                                                                          \
  extern "C" int NAME##_##SUFFIX(                                            \
      const T* s, const T* g_prev, T* s_out, T* g_out, int nx, int ny,       \
      int hx, int hy, int mode_x, int mode_y, int closure, int momentum,     \
      int mass, int tracer, int stencil, int tile_x, double dx, double dy,   \
      double g, double f, double gam_bg, double nu, double kappa, double dt, \
      double gk, double zk) {                                                \
    return swmhd::substage<T>(                                               \
        s, g_prev, s_out, g_out,                                             \
        swmhd::host_params<T>(nx, ny, hx, hy, mode_x, mode_y, closure,       \
                              momentum, mass, tracer, stencil, dx, dy, g, f, \
                              gam_bg, nu, kappa),                            \
        tile_x, T(dt), T(gk), T(zk));                                        \
  }

// The vector-invariant tile kernel of swmhd_tpu_torch/csrc/vi_tile.cuh
// built for the host, so the CPU tests can hold its logic to the plain
// emulation of its tiling (tests/test_torch_vi_tile_host.py):
//
//   g++ -std=c++20 -O1 -ffp-contract=off -shared -fPIC -pthread \
//       -I tests/host_build -I swmhd_tpu_torch/csrc \
//       tests/host_build/vi_host.cpp -o vi_host.so
//
// A launch runs the blocks one after another, each on kViThreads host
// threads that meet at a std::barrier wherever the kernel calls
// __syncthreads. Before each block the shared memory is filled with 0xff
// bytes, so a slot read before it is written (an intermediate outside its
// region, a slot past a wall) is a NaN and shows in G.
#include <thread>
#include <vector>

#include "cuda_runtime.h"

thread_local dim3 threadIdx, blockIdx;
std::barrier<>* block_barrier;
namespace swmhd {
alignas(16) unsigned char smem[1 << 20];
}

#include "vi_tile.cuh"

namespace swmhd {
namespace {

template <typename T, bool Opt>
int launch(const T* s, const T* g_prev, T* s_out, T* g_out,
           const Params<T>& p, int tx, T dt, T gk, T zk) {
  const auto k = vi_kernel<T, Opt>(p.mode_x, p.mode_y);
  const int mx = p.nx - 2 * p.hx, my = p.ny - 2 * p.hy;
  const size_t bytes = vi_smem_bytes(sizeof(T), tx,
                                     Opt && p.closure == kBiharmonic);
  if (k == nullptr || tx < 1 || tx > kViMaxTileX || mx < 1 || my < 1
      || bytes > sizeof(smem)) {
    return cudaErrorInvalidValue;
  }
  // the launch's grid: x along y, y along x (launch_vector_invariant)
  const unsigned grid_x = (my + kViTileY - 1) / kViTileY;
  const unsigned grid_y = (mx + tx - 1) / tx;
  std::barrier<> barrier(kViThreads);
  block_barrier = &barrier;
  std::vector<std::thread> threads;
  for (int t = 0; t < kViThreads; ++t) {
    threads.emplace_back([&, t] {
      threadIdx = dim3(t);
      for (unsigned by = 0; by < grid_y; ++by) {
        for (unsigned bx = 0; bx < grid_x; ++bx) {
          blockIdx = dim3(bx, by);
          if (t == 0) std::memset(smem, 0xff, sizeof(smem));
          barrier.arrive_and_wait();
          k(s, g_prev, s_out, g_out, p, tx, dt, gk, zk);
          barrier.arrive_and_wait();
        }
      }
    });
  }
  for (auto& th : threads) th.join();
  return cudaSuccess;
}

template <typename T>
int substage(const T* s, const T* g_prev, T* s_out, T* g_out, int nx,
             int ny, int hx, int hy, int mode_x, int mode_y, int closure,
             int momentum, int mass, int tracer, int stencil, int tile_x,
             double dx, double dy, double g, double f, double gam_bg,
             double nu, double kappa, double dt, double gk, double zk) {
  // substage.cu make_params
  const Params<T> p{nx + 2 * hx, ny + 2 * hy, hx, hy, mode_x, mode_y,
                    closure, momentum, mass, tracer, stencil,
                    T(dx), T(dy), T(g), T(f), T(gam_bg), T(dx * dy),
                    T(nu), T(kappa)};
  return vi_opt(p) ? launch<T, true>(s, g_prev, s_out, g_out, p, tile_x,
                                     T(dt), T(gk), T(zk))
                   : launch<T, false>(s, g_prev, s_out, g_out, p, tile_x,
                                      T(dt), T(gk), T(zk));
}

}  // namespace
}  // namespace swmhd

// swmhd_substage's arguments (substage.cu) without the intermediates and
// the stream: nx, ny are the unpadded extents.
#define SWMHD_HOST_ENTRY(T, SUFFIX)                                          \
  extern "C" int vi_host_substage_##SUFFIX(                                  \
      const T* s, const T* g_prev, T* s_out, T* g_out, int nx, int ny,       \
      int hx, int hy, int mode_x, int mode_y, int closure, int momentum,     \
      int mass, int tracer, int stencil, int tile_x, double dx, double dy,   \
      double g, double f, double gam_bg, double nu, double kappa, double dt, \
      double gk, double zk) {                                                \
    return swmhd::substage<T>(s, g_prev, s_out, g_out, nx, ny, hx, hy,       \
                              mode_x, mode_y, closure, momentum, mass,       \
                              tracer, stencil, tile_x, dx, dy, g, f, gam_bg, \
                              nu, kappa, dt, gk, zk);                        \
  }
SWMHD_HOST_ENTRY(float, f32)
SWMHD_HOST_ENTRY(double, f64)

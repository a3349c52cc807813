// The vector-invariant tile kernel of swmhd_tpu_torch/csrc/vi_tile.cuh
// built for the host, so the CPU tests can hold its logic to the plain
// emulation of its tiling (tests/test_torch_vi_tile_host.py):
//
//   g++ -std=c++20 -O1 -ffp-contract=off -shared -fPIC -pthread \
//       -I tests/host_build -I swmhd_tpu_torch/csrc \
//       tests/host_build/vi_host.cpp -o vi_host.so
//
// A launch runs the blocks as host_launch.h says; the resident kernel runs
// as one block walking every tile.
#include "host_launch.h"
#include "vi_tile.cuh"

namespace swmhd {
namespace {

template <typename T, bool Opt>
int launch(const T* s, const T* g_prev, T* s_out, T* g_out,
           const Params<T>& p, int tx, T dt, T gk, T zk) {
  const auto k = vi_kernel<T, Opt>(p.mode_x, p.mode_y);
  if (k == nullptr) return cudaErrorInvalidValue;
  return run_tiles(p, tx, kViMaxTileX,
                   vi_smem_bytes(sizeof(T), tx,
                                 Opt && p.closure == kBiharmonic),
                   [&] { k(s, g_prev, s_out, g_out, p, tx, dt, gk, zk); });
}

template <typename T>
int substage(const T* s, const T* g_prev, T* s_out, T* g_out,
             const Params<T>& p, int tile_x, T dt, T gk, T zk) {
  return vi_opt(p) ? launch<T, true>(s, g_prev, s_out, g_out, p, tile_x,
                                     dt, gk, zk)
                   : launch<T, false>(s, g_prev, s_out, g_out, p, tile_x,
                                      dt, gk, zk);
}

// n_steps RK3 steps through the resident kernel as one block (a grid of
// one) walking every tile, as a block of the card's grid walks its share.
template <typename T, bool Opt>
int resident_launch(const T* in, T* out, T* work, T* gbuf,
                    const Params<T>& p, int tx, T dt, int n_steps) {
  const auto k = vi_resident_kernel<T, Opt>(p.mode_x, p.mode_y);
  if (k == nullptr || tx < 1 || tx > kViMaxTileX || n_steps < 1) {
    return cudaErrorInvalidValue;
  }
  return run_grid(1, 1, vi_smem_bytes(sizeof(T), tx,
                                 Opt && p.closure == kBiharmonic),
                  [&] { k(in, out, work, gbuf, p, tx, dt, n_steps); });
}

template <typename T>
int resident(const T* in, T* out, T* work, T* gbuf, const Params<T>& p,
             int tile_x, T dt, int n_steps) {
  return vi_opt(p) ? resident_launch<T, true>(in, out, work, gbuf, p, tile_x,
                                           dt, n_steps)
                   : resident_launch<T, false>(in, out, work, gbuf, p,
                                               tile_x, dt, n_steps);
}

}  // namespace
}  // namespace swmhd

SWMHD_HOST_ENTRY(vi_host_substage, float, f32)
SWMHD_HOST_ENTRY(vi_host_substage, double, f64)
SWMHD_HOST_RESIDENT(vi_host_resident, float, f32)
SWMHD_HOST_RESIDENT(vi_host_resident, double, f64)

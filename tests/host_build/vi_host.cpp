// The vector-invariant tile kernel of swmhd_tpu_torch/csrc/vi_tile.cuh
// built for the host, so the CPU tests can hold its logic to the plain
// emulation of its tiling (tests/test_torch_vi_tile_host.py):
//
//   g++ -std=c++20 -O1 -ffp-contract=off -shared -fPIC -pthread \
//       -I tests/host_build -I swmhd_tpu_torch/csrc \
//       tests/host_build/vi_host.cpp -o vi_host.so
//
// A launch runs the blocks as host_launch.h says.
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

}  // namespace
}  // namespace swmhd

SWMHD_HOST_ENTRY(vi_host_substage, float, f32)
SWMHD_HOST_ENTRY(vi_host_substage, double, f64)

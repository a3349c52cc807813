// The tile-tendency probe of swmhd_tpu_torch/csrc/tendency_tile.cuh built
// for the host, so the CPU tests can hold its logic to the plain emulation
// of the vector-invariant substage's tiling (tests/test_torch_tile_host.py):
//
//   g++ -std=c++20 -O1 -ffp-contract=off -shared -fPIC -pthread \
//       -I tests/host_build -I swmhd_tpu_torch/csrc \
//       tests/host_build/tile_host.cpp -o tile_host.so
//
// A launch runs the blocks as host_launch.h says.
#include "host_launch.h"
#include "tendency_tile.cuh"

namespace swmhd {
namespace {

// swmhd_tendency_tile's arguments (tile.cu) without the stream.
template <typename T>
int tendency(const T* s, T* out, int nx, int ny, int tx, int ty, int halo,
             int split, double dx, double dy, double g, double f) {
  const auto k = tendency_kernel<T>(split, ty);
  if (k == nullptr || !tendency_args_ok(nx, ny, tx, ty, halo)) {
    return cudaErrorInvalidValue;
  }
  const Params<T> p = tendency_params<T>(nx, ny, dx, dy, g, f);
  return run_grid(ny / ty, nx / tx,
                  tendency_smem_bytes(sizeof(T), tx, ty, halo, split),
                  [&] { k(s, out, p, tx, halo); });
}

}  // namespace
}  // namespace swmhd

#define SWMHD_TILE_HOST_ENTRY(T, SUFFIX)                                  \
  extern "C" int tile_host_tendency_##SUFFIX(                             \
      const T* s, T* out, int nx, int ny, int tx, int ty, int halo,       \
      int split, double dx, double dy, double g, double f) {              \
    return swmhd::tendency<T>(s, out, nx, ny, tx, ty, halo, split, dx, dy, \
                              g, f);                                      \
  }

SWMHD_TILE_HOST_ENTRY(float, f32)
SWMHD_TILE_HOST_ENTRY(double, f64)

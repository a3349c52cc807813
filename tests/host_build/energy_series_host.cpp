// The energy series kernel of swmhd_tpu_torch/csrc/energy_series.cuh built
// for the host, so the CPU tests can hold it to its plain version
// (tests/test_torch_energy_series_host.py):
//
//   g++ -std=c++20 -O1 -ffp-contract=off -shared -fPIC -pthread \
//       -I tests/host_build -I swmhd_tpu_torch/csrc \
//       tests/host_build/energy_series_host.cpp -o energy_series_host.so
//
// A launch runs the blocks one after another as host_launch.h says. The
// kernel's own shared variables are static here (one block at a time holds
// them); a warp shuffle is an exchange through a block-wide buffer between
// two block barriers (every thread of the block shuffles alike); the
// atomic ticket is a std::atomic_ref.
#include <atomic>

#include "host_launch.h"

inline void __threadfence() {}
inline double __ldcg(const double* p) { return *p; }
inline unsigned atomicAdd(unsigned* p, unsigned v) {
  return std::atomic_ref<unsigned>(*p).fetch_add(v);
}
inline double shuffle_slots[swmhd::kTileThreads];
inline double __shfl_down_sync(unsigned, double v, int off) {
  shuffle_slots[threadIdx.x] = v;
  __syncthreads();
  const int lane = threadIdx.x % 32, src = lane + off;
  const double r = src < 32 ? shuffle_slots[threadIdx.x - lane + src] : v;
  __syncthreads();
  return r;
}

#undef __shared__
#define __shared__ static
#include "energy_series.cuh"

static_assert(swmhd::kSeriesThreads == swmhd::kTileThreads);

// energy_series.cu's entry point without the stream.
#define HOST_ENTRY(T, SUFFIX)                                                 \
  extern "C" int energy_series_host_##SUFFIX(                                 \
      const T* h, const T* u, const T* v, const T* A, const T* h0, T* out,    \
      double* scratch, int nx, int ny, int rows, int conservative,            \
      int mode_x, int mode_y, double dx, double dy, double lx, double ly,     \
      double g, double gam_bg) {                                              \
    const auto k = conservative                                               \
                       ? swmhd::series_kernel<T, true>(mode_x, mode_y)        \
                       : swmhd::series_kernel<T, false>(mode_x, mode_y);      \
    if (nx < 1 || ny < 1 || rows < 1 || k == nullptr) {                       \
      return cudaErrorInvalidValue;                                           \
    }                                                                         \
    const swmhd::SeriesArgs<T> a{h,     u,     v,     A,  h0,                 \
                                 out,   scratch, nx,  ny, rows,               \
                                 T(dx), T(dy), T(0.5 * g), T(gam_bg),         \
                                 lx,    ly};                                  \
    return swmhd::run_grid((nx + rows - 1) / rows, 1, 0, [&] { k(a); });      \
  }

HOST_ENTRY(float, f32)
HOST_ENTRY(double, f64)

// The kernel of the energy series (energy_series.cu says what it computes
// and how): its arguments, the densities of a point, the block's sum and
// the kernel, templated on the value type, the formulation and the two
// axis modes; series_kernel picks the instantiation for a launch's modes.
// energy_series.cu launches it; tests/host_build/energy_series_host.cpp
// runs it on the host.

#pragma once

#include "substage.cuh"

namespace swmhd {

constexpr int kSeriesThreads = 256;

template <typename T>
struct SeriesArgs {
  const T *h, *u, *v, *A, *h0;
  T* out;            // the five values, in ops.energies.ENERGY_NAMES' order
  double* scratch;   // 4 sums a block, then the ticket
  int nx, ny, rows;  // the grid; the rows of a block's band
  T dx, dy, half_g, gam_bg;
  double lx, ly;
};

namespace {

// the index of a read shifted by m (|m| <= 1) on an axis of mode A
template <Axis A>
__device__ __forceinline__ int shifted(int i, int m, int n) {
  if constexpr (A == Axis::kPeriodic) {
    return wrap(i + m, n);
  } else {
    return clampi(i + m, n);
  }
}

// The densities of kinetic, magnetic and potential energy and of the
// cross-helicity at centre (i, j), added to acc.
template <typename T, bool kCons, Axis X, Axis Y>
__device__ __forceinline__ void add_densities(const SeriesArgs<T>& a, int i,
                                              int j, double acc[4]) {
  const int nx = a.nx, ny = a.ny;
  const int ip = shifted<X>(i, 1, nx), im = shifted<X>(i, -1, nx);
  const int jp = shifted<Y>(j, 1, ny), jm = shifted<Y>(j, -1, ny);
  const auto at = [ny](int x, int y) {
    return static_cast<size_t>(x) * ny + y;
  };
  const T h = a.h[at(i, j)];
  // u at faces i and i + 1 (ℑxᶜ reads the shifted face), v at j and j + 1
  T u0 = a.u[at(i, j)], u1 = a.u[at(ip, j)];
  T v0 = a.v[at(i, j)], v1 = a.v[at(i, jp)];
  if constexpr (kCons) {
    // transports over ℑᶠh: u = uh / (½ (h[i] + h[i-1])) at each face
    u0 = u0 / (T(0.5) * (h + a.h[at(im, j)]));
    u1 = u1 / (T(0.5) * (a.h[at(ip, j)] + a.h[at(shifted<X>(ip, -1, nx), j)]));
    v0 = v0 / (T(0.5) * (h + a.h[at(i, jm)]));
    v1 = v1 / (T(0.5) * (a.h[at(i, jp)] + a.h[at(i, shifted<Y>(jp, -1, ny))]));
  }
  const T ke = T(0.5) * h
               * (T(0.5) * (u1 * u1 + u0 * u0) + T(0.5) * (v1 * v1 + v0 * v0));
  // B at the centre: Bx = −ℑyᶜ(∂yᶠA + γ) / h, By = ℑxᶜ(∂xᶠA) / h
  const T* A = a.A;
  const T fy0 = (A[at(i, j)] - A[at(i, jm)]) / a.dy + a.gam_bg;
  const T fy1 = (A[at(i, jp)] - A[at(i, shifted<Y>(jp, -1, ny))]) / a.dy
                + a.gam_bg;
  const T fx0 = (A[at(i, j)] - A[at(im, j)]) / a.dx;
  const T fx1 = (A[at(ip, j)] - A[at(shifted<X>(ip, -1, nx), j)]) / a.dx;
  const T bx = -(T(0.5) * (fy1 + fy0)) / h;
  const T by = T(0.5) * (fx1 + fx0) / h;
  const T me = T(0.5) * h * (bx * bx + by * by);
  const T eta = h - a.h0[at(i, j)];
  const T pe = a.half_g * (eta * eta);
  const T ch = h * (T(0.5) * (u1 + u0) * bx + T(0.5) * (v1 + v0) * by);
  acc[0] += static_cast<double>(ke);
  acc[1] += static_cast<double>(me);
  acc[2] += static_cast<double>(pe);
  acc[3] += static_cast<double>(ch);
}

// Each thread's four sums into thread 0's, in a fixed order: a shuffle
// tree in each warp, then the warps in order.
__device__ __forceinline__ void block_sum(double acc[4]) {
  __shared__ double warps[kSeriesThreads / 32][4];
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  __syncthreads();
  for (int k = 0; k < 4; ++k) {
    for (int off = 16; off > 0; off >>= 1) {
      acc[k] += __shfl_down_sync(0xffffffffu, acc[k], off);
    }
    if (lane == 0) warps[warp][k] = acc[k];
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int k = 0; k < 4; ++k) {
      double s = warps[0][k];
      for (int w = 1; w < kSeriesThreads / 32; ++w) s += warps[w][k];
      acc[k] = s;
    }
  }
}

}  // namespace

template <typename T, bool kCons, Axis X, Axis Y>
__global__ void __launch_bounds__(kSeriesThreads)
    energy_series(const SeriesArgs<T> a) {
  const int r0 = blockIdx.x * a.rows;
  const int points = (min(r0 + a.rows, a.nx) - r0) * a.ny;
  double acc[4] = {0.0, 0.0, 0.0, 0.0};
  for (int p = threadIdx.x; p < points; p += kSeriesThreads) {
    add_densities<T, kCons, X, Y>(a, r0 + p / a.ny, p % a.ny, acc);
  }
  block_sum(acc);
  double* part = a.scratch;
  unsigned int* ticket =
      reinterpret_cast<unsigned int*>(a.scratch + 4 * gridDim.x);
  __shared__ bool last;
  if (threadIdx.x == 0) {
    for (int k = 0; k < 4; ++k) part[4 * blockIdx.x + k] = acc[k];
    __threadfence();
    last = atomicAdd(ticket, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  // the last block: every block's sums, each thread a fixed stride of
  // blocks in order, then the block's fixed order (L2 reads: the other
  // blocks wrote them)
  double s[4] = {0.0, 0.0, 0.0, 0.0};
  for (int b = threadIdx.x; b < static_cast<int>(gridDim.x);
       b += kSeriesThreads) {
    for (int k = 0; k < 4; ++k) s[k] += __ldcg(part + 4 * b + k);
  }
  block_sum(s);
  if (threadIdx.x == 0) {
    const double n = static_cast<double>(a.nx) * a.ny;
    const double ke = s[0] / n * a.lx * a.ly, me = s[1] / n * a.lx * a.ly,
                 pe = s[2] / n * a.lx * a.ly, ch = s[3] / n * a.lx * a.ly;
    a.out[0] = static_cast<T>(ke);
    a.out[1] = static_cast<T>(me);
    a.out[2] = static_cast<T>(pe);
    a.out[3] = static_cast<T>(ke + me + pe);
    a.out[4] = static_cast<T>(ch);
    *ticket = 0u;
  }
}

// The kernel for a launch of axis modes (mode_x, mode_y), each periodic
// (0) or bounded (1); nullptr for another mode.
template <typename T, bool kCons>
auto series_kernel(int mode_x, int mode_y) {
  constexpr Axis P = Axis::kPeriodic, B = Axis::kBounded;
  using K = void (*)(SeriesArgs<T>);
  if (mode_x < 0 || mode_x > 1 || mode_y < 0 || mode_y > 1) {
    return static_cast<K>(nullptr);
  }
  switch (mode_x * 2 + mode_y) {
    case 0: return static_cast<K>(energy_series<T, kCons, P, P>);
    case 1: return static_cast<K>(energy_series<T, kCons, P, B>);
    case 2: return static_cast<K>(energy_series<T, kCons, B, P>);
    default: return static_cast<K>(energy_series<T, kCons, B, B>);
  }
}

}  // namespace swmhd

// K6, the tile-tendency probe, written by hand for Hopper (sm_90a): G of
// the bench.py model (vector-invariant, periodic, WENO5 with the
// VelocityStencil, no closure, no background gradient), all of it or the
// part a split names, one block per (tx, TY) tile of the (4, nx, ny)
// state, from windows `halo` points wide wrapped at load time. It
// replaces make_probe of benchmarks/exp_fused2d.py (a Pallas kernel that
// DMAs the four wrap-padded windows into VMEM and evaluates
// model.tendencies on them); tile.cu's swmhd_tendency_tile_{f32,f64}
// launch it, and tests/host_build/tile_host.cpp builds it for the host.
//
// What bounds it: about 1100 fp32 operations a point against 4 words in
// and 4 (or 2) out: operations, as for the substage.
//
// Design. The probe times the design the main path runs: it is the
// vector-invariant substage kernel's own phases (vi_tile.cuh
// vi_mass_tracer, vi_momentum) with an epilogue that writes G in place of
// the Le–Moin update. So its G equals swmhd_substage's bit for bit, as
// long as nvcc contracts multiplies and adds alike in both kernels
// (chip_smoke.py phase 9 checks it on the card).
//   - full runs both phases, 8 box arrays at the peak; mom runs phase 2
//     alone (8 box arrays); mt phase 1 alone (4). A block's shared
//     memory is the four windows of (tx + 2·halo) × (TY + 2·halo) values
//     and the box arrays of (tx + 6) × (TY + 6): 69,312 B for 32×32,
//     halo 3, f32, as the substage's; 83,072 B at halo 8.
//   - TY is a template parameter (8, 16, 32 or 64), so the regions'
//     loops divide by constants and a warp's lanes take 32 neighbouring
//     columns of a row (TY >= 32) or 32 / TY whole rows; tx is a runtime
//     argument up to kViMaxTileX.
//   - The windows go to shared memory by cp.async, one 4- or 8-byte copy
//     a slot, wrapped at load time. Their width TY + 2·halo is known only
//     at run time (the probe measures the halo), so each thread steps its
//     row and column by the block's stride instead of dividing: one
//     division a thread, none a slot, and the four fields share each
//     slot's wrapped index.
//   - Divisions by constants are products with reciprocals, as in the
//     substage (1/6, 1/dx, 1/dy).

#pragma once

#include <cuda_pipeline.h>

#include "substage.cuh"
#include "tile.cuh"
#include "vi_tile.cuh"

namespace swmhd {

// Which fields of G a launch writes (ops/tile.py SPLITS): all four (h, u,
// v, A), the momentum part (u, v) or the mass and tracer part (h, A).
enum Split : int { kFull = 0, kMom = 1, kMassTracer = 2 };

// the least halo: the composed read radius of the tendency
constexpr int kTileRadius = kViRadius;

// Box arrays at a split's peak (ops/tile.py N_TILE_TMP).
constexpr int tendency_box_arrays(int split) {
  return split == kMassTracer ? 4 : kViBoxArrays;
}

// Shared memory of a block (ops/tile.py tile_smem_bytes).
inline size_t tendency_smem_bytes(size_t word, int tx, int ty, int halo,
                                  int split) {
  const size_t win = static_cast<size_t>(tx + 2 * halo) * (ty + 2 * halo);
  const size_t box = static_cast<size_t>(tx + 2 * kTileRadius)
                     * (ty + 2 * kTileRadius);
  return word * (4 * win + tendency_box_arrays(split) * box);
}

// The state windows `lo` points wide around the tile, `cols` slots a row.
template <typename T>
struct HaloWindows {
  const T* win;
  int plane, cols, lo;
  __device__ __forceinline__ T operator()(int k, int a, int b) const {
    return win[k * plane + (a + lo) * cols + b + lo];
  }
};

// The four windows of the stacked state s into `win`, rows × cols slots
// each, from the wrapped indices of the maps (Map::load), by cp.async.
// Returns when the block has them.
template <typename T>
__device__ __forceinline__ void load_halo_windows(
    T* win, const T* s, const Params<T>& p, const Map<Axis::kPeriodic>& M,
    const Map<Axis::kPeriodic>& N, int lo, int rows, int cols) {
  const size_t n = static_cast<size_t>(p.nx) * p.ny;
  const int plane = rows * cols;
  const int dr = kTileThreads / cols, dc = kTileThreads - dr * cols;
  int r = threadIdx.x / cols, c = threadIdx.x - r * cols;
  for (int e = threadIdx.x; e < plane; e += kTileThreads) {
    const T* src = s + static_cast<size_t>(M.load(r - lo)) * p.ny
                   + N.load(c - lo);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      __pipeline_memcpy_async(win + k * plane + e, src + k * n, sizeof(T));
    }
    r += dr;
    c += dc;
    if (c >= cols) {
      c -= cols;
      ++r;
    }
  }
  wait_copies();
}

// s: the unpadded (4, p.nx, p.ny) state; out: the split's fields of G,
// each (p.nx, p.ny). Block (blockIdx.y, blockIdx.x) is tile (x0 / tx,
// y0 / TY).
template <typename T, int S, int TY>
__global__ void __launch_bounds__(kTileThreads, kViMinBlocks)
vi_tendency_tile(const T* __restrict__ s, T* __restrict__ out, Params<T> p,
                 int tx, int halo) {
  p = vi_options<false>(p);
  constexpr Axis P = Axis::kPeriodic;
  constexpr int R = kTileRadius;
  extern __shared__ __align__(16) unsigned char smem[];
  T* const win = reinterpret_cast<T*>(smem);
  const int cols = TY + 2 * halo, plane = (tx + 2 * halo) * cols;
  const int x0 = blockIdx.y * tx, y0 = blockIdx.x * TY;
  const Map<P> M{x0, p.nx};
  const Map<P> N{y0, p.ny};

  load_halo_windows(win, s, p, M, N, halo, tx + 2 * halo, cols);
  const HaloWindows<T> st{win, plane, cols, halo};
  const ViTile<T, P, P, TY, HaloWindows<T>> tile{
      p, st, win + 4 * plane, (tx + 2 * R) * (TY + 2 * R), M, N, tx, tx,
      TY, T(1) / p.dx, T(1) / p.dy};

  // G of field k at tile point (a, b), in the split's row of k
  const size_t n = static_cast<size_t>(p.nx) * p.ny;
  auto write = [&](int k, T G, int a, int b) {
    const int row = S == kFull ? k : (S == kMom ? k - 1 : k / 3);
    out[row * n + static_cast<size_t>(x0 + a) * p.ny + y0 + b] = G;
  };
  if constexpr (S != kMom) vi_mass_tracer(tile, write);
  if constexpr (S == kFull) __syncthreads();
  if constexpr (S != kMassTracer) vi_momentum(tile, write);
}

template <typename T>
using TendencyKernel = decltype(&vi_tendency_tile<T, kFull, 32>);

template <typename T, int S>
TendencyKernel<T> tendency_kernel_of(int ty) {
  switch (ty) {
    case 8: return &vi_tendency_tile<T, S, 8>;
    case 16: return &vi_tendency_tile<T, S, 16>;
    case 32: return &vi_tendency_tile<T, S, 32>;
    case 64: return &vi_tendency_tile<T, S, 64>;
    default: return nullptr;
  }
}

// The kernel of a split and tile columns TY, one of 8, 16, 32, 64
// (ops/tile.py TILE_COLUMNS); null for any other.
template <typename T>
TendencyKernel<T> tendency_kernel(int split, int ty) {
  switch (split) {
    case kFull: return tendency_kernel_of<T, kFull>(ty);
    case kMom: return tendency_kernel_of<T, kMom>(ty);
    case kMassTracer: return tendency_kernel_of<T, kMassTracer>(ty);
    default: return nullptr;
  }
}

// The probe's parameters: the bench.py model on an nx × ny periodic grid.
template <typename T>
Params<T> tendency_params(int nx, int ny, double dx, double dy, double g,
                          double f) {
  const int P = static_cast<int>(Axis::kPeriodic);
  return Params<T>{nx, ny, 0, 0, P, P, kNoClosure, kWeno5, kWeno5, kWeno5,
                   kVelocityStencil, T(dx), T(dy), T(g), T(f), T(0),
                   T(dx * dy), T(0), T(0)};
}

// Whether a launch's arguments are ones the kernel takes: tiles of at
// most kViMaxTileX rows that divide the grid, at most 65535 tile rows, a
// halo of at least kTileRadius and at most the grid.
inline bool tendency_args_ok(int nx, int ny, int tx, int ty, int halo) {
  return tx >= 1 && tx <= kViMaxTileX && ty >= 1 && nx % tx == 0
         && ny % ty == 0 && nx / tx <= 65535 && halo >= kTileRadius
         && halo <= nx && halo <= ny;
}

}  // namespace swmhd

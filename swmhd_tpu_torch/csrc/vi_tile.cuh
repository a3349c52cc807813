// The vector-invariant RK3 substage in one kernel over 2-D tiles, written
// by hand for Hopper (sm_90a): mass and tracer reconstruction (WENO5-Z,
// UpwindBiased3 or Centered2), the vorticity flux of the momentum scheme
// (WENO5 with VelocityStencil or VorticityStencil weights, UpwindBiased3,
// or the centered form), Bernoulli gradient, f-plane Coriolis,
// hA-conservative tracer with a linear background gradient, the Laplacian
// or biharmonic closure, jacobian-form Lorentz force
// (swmhd_tpu/models/shallow_water.py _tendencies_vector_invariant,
// physics/diffusion.py, physics/lorentz.py lorentz_force_jacobian), then
// the Le–Moin update, for each periodic/bounded pair of axes and on
// exchanged tiles. The entry points of substage.cu reach it through
// launch_vector_invariant (vector_invariant.cu, vector_invariant_f64.cu);
// it is the Hopper counterpart of the vector-invariant branch of
// build_fused_calls (swmhd_tpu/ops/fused_step.py) and, with a halo, of
// DomainDecomposition.fused_step_fn (swmhd_tpu/parallel/decomposition.py).
//
// What bounds it: about 1100 fp32 operations a point (many of them IEEE
// divisions and the WENO-Z weights) against 16 words of state, G_prev, new
// state and G: operations. The design keeps every intermediate on chip.
//
// Design. One block of kTileThreads threads per (TX, kTileY) tile of the
// unpadded output; TX is the wrapper's choice (ops/substage.py
// tile_shape), kTileY = 32 is one warp's width along y, the
// contiguous axis. Local index (a, b) is the point (i0 + a, j0 + b) of the
// (padded) arrays, the tile's points a in [0, TX), b in [0, 32).
//   1. The four state windows, kViRadius = 3 cells around the tile (the
//      composed read radius of the tendency), go to shared memory by
//      cp.async, all issued at once, from wrapped, clamped or exchanged
//      indices (Map::load), so no padded copy of the state exists.
//   2. Phase 1, mass and tracer: Uf, Fx, Vf, Fy over [0, TX] × [0, 32]
//      (and ∇²A for a biharmonic closure over [-1, TX] × [-1, 32]), the
//      regions of the box the tile's points read; then, at the tile's
//      points, Gh and GA and their Le–Moin update, written out at once (no
//      register carries them on).
//   3. Phase 2, momentum: ζ, ℑu, ℑv over [-2, TX + 2] × [-2, 34], then
//      K + gh, ∂xA, ∂yA + γ, Bx, By (and ∇²u, ∇²v) over [-1, TX] ×
//      [-1, 32], in the same shared memory; then Gu, Gv, the wall masks
//      and their update. The peak is 8 box arrays (10 with a biharmonic
//      closure) beside the windows: 69,312 B a block for 32×32 f32, 3
//      blocks an SM.
//   The two phases are device functions, vi_mass_tracer and vi_momentum,
//   templated on the tile's columns, the layout of the state windows and
//   an epilogue that takes each G as (field, G, a, b): here the Le–Moin
//   update; the tile-tendency probe (tendency_tile.cuh) runs the same
//   phases with an epilogue that writes G.
//   Each region is one loop over its rectangle with a compile-time width,
//   so every thread of a warp runs the same code and the loop divides by
//   a constant; the intermediates read over about the same region share
//   one loop (four loops a substage, five with a biharmonic closure), so a
//   small tile's block runs few partial passes; the tile's points are
//   owned one column a lane and one row a warp, so a warp reads 32
//   neighbouring words of a box row. Tile
//   points past a ragged edge are skipped; box slots past it are computed
//   from in-bounds reads and never read.
//
// Traps the design handles:
//   - Wall semantics. A shift of a derived array past a bounded axis'
//     wall reads the derived array at the clamped index, and a shift of a
//     shifted array clamps at each step (tile.cuh Map::sh2). Here every
//     read, of the state or of an intermediate, goes through Map::sh and
//     Map::sh2, which clamp the global index and turn it back into a local
//     one: a read past the wall lands on the wall point's slot, which is
//     the edge replication of the derived array without copying it into
//     the slots past the wall (never read; the plain emulation
//     ops/vi_tile.py fills them with NaN to show it).
//   - Masks. Gu at i = 0 and Gv at j = 0 of a bounded axis are zero
//     (no penetration).
//   - Bitwise tiles. A tile of a decomposition (exchanged axes) runs the
//     same expressions in the same order as the whole grid's periodic
//     axes; only the index maps differ, and the tile interior matches the
//     whole-grid kernel bit for bit (checked on the card at halos 6 and
//     7, biharmonic included). That holds while every product is taken
//     once a value: each intermediate is computed at its own slot and
//     stored, and the points only read it. Recomputing K + gh or ∂A at
//     the points instead (to fit 4 blocks an SM) broke it: on a periodic
//     axis the compiler proved two of those evaluations read the same
//     slot, shared their product, and so contracted it into an fma
//     differently from the exchanged axis (PERF.md §6).
//   - The f32 NaN trap. The WENO-Z weights are substage.cuh's
//     weno_combine, with the power-of-two rescaling of the betas
//     (_normalize_betas of the reference) that keeps a constant field
//     finite in fp32.
//   - Divisions. A division by a constant (the 1/6 of every third-order
//     candidate, the grid spacings dx, dy of every difference and of the
//     closures' Laplacians) is a product with its reciprocal (T(1.0 / 6.0),
//     1/dx and 1/dy rounded once per thread): an IEEE fp32 division is a
//     subroutine on the card, and with these products the 2048² f32
//     substage took 28% less on an H100 (PERF.md §6). The products differ
//     from the plain version's quotients by an ulp, inside the kernels'
//     bounds (1e-11 f64, 2e-5 f32); tiles stay bitwise, as both sides
//     take the same products.
//     Divisions by data (the WENO-Z weights' sum, h, the face averages of
//     h) stay IEEE divisions; there is no __fdividef.
//
// The default model (no closure, WENO5 everywhere, VelocityStencil) runs
// the Opt-false instantiation, in which those options are constants and
// carry no code of the other branches; any other model runs the Opt
// instantiation, which reads them from Params (warp-uniform branches).

#pragma once

#include <cuda_pipeline.h>

#include "substage.cuh"
#include "tile.cuh"

namespace swmhd {

constexpr int kViRadius = 3;        // ops/substage.py TILE_LAYOUTS
constexpr int kViBoxCols = kTileY + 2 * kViRadius;
constexpr int kViBoxArrays = 8;
constexpr int kViBiharmonicArrays = 2;
constexpr int kViMaxTileX = 64;
// resident blocks an SM the register allocation is sized for (at most 128
// registers a thread; the default model's kernel takes 63 in f32)
constexpr int kViMinBlocks = 2;

// Shared memory of a block (ops/substage.py smem_bytes).
inline size_t vi_smem_bytes(size_t word, int tile_x, bool biharmonic) {
  return word * static_cast<size_t>(tile_x + 2 * kViRadius) * kViBoxCols
         * (4 + kViBoxArrays + kViBiharmonicArrays * biharmonic);
}

template <bool Opt, typename T>
__device__ __forceinline__ Params<T> vi_options(Params<T> p) {
  if constexpr (!Opt) {
    p.closure = kNoClosure;
    p.momentum = p.mass = p.tracer = kWeno5;
    p.stencil = kVelocityStencil;
  }
  return p;
}

// (left, right) of ζ on the flux point at local q along the axis of map m
// of the reconstruction, from load(t, qq) of box t (0 ζ, 1 ℑu, 2 ℑv) at
// local qq along it. WENO5 reconstructs the shifted arrays ζ, ℑu, ℑv at
// the face form (windows shifted, then clamped); UpwindBiased3 takes its
// face form at the next face (windows clamped at that face, then
// shifted), as the reference's center-from-face reconstruction does.
template <bool Wall, Axis A, typename T, typename L>
__device__ __forceinline__ void vi_vorticity(const Params<T>& p,
                                             const L& load, const Map<A>& m,
                                             int q, T& zl, T& zr) {
  T z[6], uw[6], vw[6];
  const bool velocity = p.stencil == kVelocityStencil;
  if (p.momentum == kWeno5) {
#pragma unroll
    for (int k = 0; k < 6; ++k) {
      const int qq = m.sh2(q, k - 3, 1);
      z[k] = load(0, qq);
      if (velocity) {
        uw[k] = load(1, qq);
        vw[k] = load(2, qq);
      }
    }
    vorticity_pair<true>(z, uw, vw, velocity, Wall && m.g(q) == m.n - 1,
                         zl, zr);
  } else {
#pragma unroll
    for (int k = 0; k < 6; ++k) z[k] = load(0, m.sh2(q, 1, k - 3));
    upwind3_pair<Wall, true>(z, m.g(m.sh(q, 1)), m.n, zl, zr);
  }
}

// The state windows of a tile as the phases read them: field k at local
// (a, b), a in [-Lo, rows - Lo), b in [-Lo, Cols - Lo), plane k of the
// block's shared memory. The substage's windows are kViRadius wide.
template <typename T, int Lo, int Cols>
struct FixedWindows {
  const T* win;
  int plane;
  __device__ __forceinline__ T operator()(int k, int a, int b) const {
    return win[k * plane + (a + Lo) * Cols + b + Lo];
  }
};

// What the two phases share of a (tx, TY) tile: the kernel's parameters
// (after vi_options), the state windows st (FixedWindows or another
// layout with the same call), the box arrays of (tx + 6) × (TY + 6) slots
// from `box` on, `plane` slots apart, the index maps of both axes, the
// extent (ex, ey) of the tile's points inside the output and the
// reciprocal spacings.
template <typename T, Axis X, Axis Y, int TY, typename W>
struct ViTile {
  static_assert(kTileThreads % TY == 0, "a row of points is whole warps "
                "or a whole number of rows is a warp");
  static constexpr int R = kViRadius, BC = TY + 2 * R;
  const Params<T>& p;
  W st;
  T* box;
  int plane;
  Map<X> M;
  Map<Y> N;
  int tx, ex, ey;
  T rdx, rdy;
  __device__ __forceinline__ static int slot(int a, int b) {
    return (a + R) * BC + b + R;
  }
  __device__ __forceinline__ T* bx(int t) const { return box + t * plane; }
};

// f(a, b) at each of the tile's points: one column a thread, so a warp
// takes 32 neighbouring words of a row (TY >= 32) or 32 / TY whole rows.
template <int TY, typename F>
__device__ __forceinline__ void each_tile_point(int ex, int ey, const F& f) {
  const int b = threadIdx.x % TY;
  for (int a = threadIdx.x / TY; a < ex && b < ey; a += kTileThreads / TY) {
    f(a, b);
  }
}

// Phase 1, mass and tracer: Uf, Fx, Vf, Fy (and ∇²A) in box arrays 0–3
// (4), then Gh and GA at the tile's points, handed to epi(field, G, a, b)
// one at a time.
template <typename C, typename E>
__device__ __forceinline__ void vi_mass_tracer(const C& tile, const E& epi) {
  using T = decltype(tile.rdx);
  constexpr bool WX = decltype(tile.M)::kAxis == Axis::kBounded;
  constexpr bool WY = decltype(tile.N)::kAxis == Axis::kBounded;
  constexpr int TY = C::BC - 2 * C::R;
  enum { H = 0, U = 1, V = 2, A = 3 };
  const auto& p = tile.p;
  const auto& st = tile.st;
  const auto& M = tile.M;
  const auto& N = tile.N;
  const T rdx = tile.rdx, rdy = tile.rdy;
  auto slot = [](int a, int b) { return C::slot(a, b); };
  T* const Uf = tile.bx(0);
  T* const Vf = tile.bx(1);
  T* const Fx = tile.bx(2);
  T* const Fy = tile.bx(3);
  T* const LA = tile.bx(4);
  each_point<0, TY + 1>(0, tile.tx + 1, [&](int a, int b) {
    T c[6], l, r;
#pragma unroll
    for (int k = 0; k < 6; ++k) c[k] = st(H, M.sh(a, k - 3), b);
    face_pair<WX, true>(p.mass, c, M.g(a), p.nx, l, r);
    const T uf = upwind(st(U, a, b), l, r);
#pragma unroll
    for (int k = 0; k < 6; ++k) c[k] = st(A, M.sh(a, k - 3), b);
    face_pair<WX, true>(p.tracer, c, M.g(a), p.nx, l, r);
    Uf[slot(a, b)] = uf;
    Fx[slot(a, b)] = upwind(uf, l, r);
#pragma unroll
    for (int k = 0; k < 6; ++k) c[k] = st(H, a, N.sh(b, k - 3));
    face_pair<WY, true>(p.mass, c, N.g(b), p.ny, l, r);
    const T vf = upwind(st(V, a, b), l, r);
#pragma unroll
    for (int k = 0; k < 6; ++k) c[k] = st(A, a, N.sh(b, k - 3));
    face_pair<WY, true>(p.tracer, c, N.g(b), p.ny, l, r);
    Vf[slot(a, b)] = vf;
    Fy[slot(a, b)] = upwind(vf, l, r);
  });
  if (p.closure == kBiharmonic) {
    each_point<-1, TY + 1>(-1, tile.tx + 1, [&](int a, int b) {
      LA[slot(a, b)] = tile_laplacian<false, false>(
          [&](int i, int j) { return st(A, i, j); }, M, N, a, b, rdx, rdy);
    });
  }
  __syncthreads();

  each_tile_point<TY>(tile.ex, tile.ey, [&](int a, int b) {
    const bool last_x = WX && M.g(a) == p.nx - 1;
    const bool last_y = WY && N.g(b) == p.ny - 1;
    const int ap = M.sh(a, 1), bp = N.sh(b, 1);
    const T h0 = st(H, a, b);
    const T Vf0 = Vf[slot(a, b)], Vf_jp = Vf[slot(a, bp)];
    // a bounded axis has no flux through its far wall
    const T Uf_up = last_x ? T(0) : Uf[slot(ap, b)];
    const T Vf_up = last_y ? T(0) : Vf_jp;
    const T divU = (Uf_up - Uf[slot(a, b)]) * rdx + (Vf_up - Vf0) * rdy;
    const T fx_up = last_x ? T(0) : Fx[slot(ap, b)];
    const T fy_up = last_y ? T(0) : Fy[slot(a, bp)];
    const T div_flux = (fx_up - Fx[slot(a, b)]) * rdx
                       + (fy_up - Fy[slot(a, b)]) * rdy;
    T GA = (st(A, a, b) * divU - div_flux) / h0;
    if (p.gam_bg != T(0)) {
      GA = GA - p.gam_bg * (T(0.5) * (Vf_jp + Vf0)) / h0;
    }
    if (p.closure == kLaplacian) {
      GA = GA + p.kappa * tile_laplacian<false, false>(
                              [&](int i, int j) { return st(A, i, j); },
                              M, N, a, b, rdx, rdy);
    } else if (p.closure == kBiharmonic) {
      GA = GA + (-p.kappa) * tile_laplacian<false, false>(
                                 [&](int i, int j) {
                                   return LA[slot(i, j)];
                                 },
                                 M, N, a, b, rdx, rdy);
    }
    epi(H, -divU, a, b);
    epi(A, GA, a, b);
  });
}

// Phase 2, momentum: ζ, ℑu, ℑv in box arrays 0–2, K + gh, ∂xA, ∂yA + γ,
// Bx, By (and ∇²u, ∇²v) in 3–7 (8, 9), then Gu, Gv at the tile's points,
// with the wall masks, handed to epi(field, G, a, b) one at a time. The
// caller synchronises the block between phase 1 and phase 2, whose box
// arrays overlap.
template <typename C, typename E>
__device__ __forceinline__ void vi_momentum(const C& tile, const E& epi) {
  using T = decltype(tile.rdx);
  constexpr bool WX = decltype(tile.M)::kAxis == Axis::kBounded;
  constexpr bool WY = decltype(tile.N)::kAxis == Axis::kBounded;
  constexpr int TY = C::BC - 2 * C::R;
  enum { H = 0, U = 1, V = 2, A = 3 };
  const auto& p = tile.p;
  const auto& st = tile.st;
  const auto& M = tile.M;
  const auto& N = tile.N;
  const T rdx = tile.rdx, rdy = tile.rdy;
  const int tx = tile.tx;
  auto slot = [](int a, int b) { return C::slot(a, b); };
  auto bx = [&](int k) { return tile.bx(k); };
  T* const zeta = bx(0);
  T* const uff = bx(1);
  T* const vff = bx(2);
  T* const KB = bx(3);
  T* const dAdx = bx(4);
  T* const dAdy = bx(5);
  T* const Bx = bx(6);
  T* const By = bx(7);
  T* const Lu = bx(8);
  T* const Lv = bx(9);
  each_point<-2, TY + 3>(-2, tx + 3, [&](int a, int b) {
    const T u0 = st(U, a, b), v0 = st(V, a, b);
    const T u_jm = st(U, a, N.sh(b, -1)), v_im = st(V, M.sh(a, -1), b);
    zeta[slot(a, b)] = (v0 - v_im) * rdx - (u0 - u_jm) * rdy;
    uff[slot(a, b)] = T(0.5) * (u0 + u_jm);
    vff[slot(a, b)] = T(0.5) * (v0 + v_im);
  });
  // K + gh, ∂xA, ∂yA + γ and B = (−ℑyᶜ(∂yᶠA + γ), ℑxᶜ(∂xᶠA))/h (∂A at
  // j+1, i+1 clamped), and a biharmonic closure's ∇²u, ∇²v
  each_point<-1, TY + 1>(-1, tx + 1, [&](int a, int b) {
    const int am = M.sh(a, -1), ap = M.sh(a, 1);
    const int bm = N.sh(b, -1), bp = N.sh(b, 1);
    const T u0 = st(U, a, b), v0 = st(V, a, b);
    const T u_ip = st(U, ap, b), v_jp = st(V, a, bp);
    const T K = T(0.5) * (T(0.5) * (u_ip * u_ip + u0 * u0)
                          + T(0.5) * (v_jp * v_jp + v0 * v0));
    const T h0 = st(H, a, b), A0 = st(A, a, b);
    KB[slot(a, b)] = K + p.g * h0;
    const T dx0 = (A0 - st(A, am, b)) * rdx;
    const T dy0 = (A0 - st(A, a, bm)) * rdy + p.gam_bg;
    dAdx[slot(a, b)] = dx0;
    dAdy[slot(a, b)] = dy0;
    const T dy1 = (WY && N.g(b) == p.ny - 1)
                      ? dy0
                      : (st(A, a, bp) - A0) * rdy + p.gam_bg;
    Bx[slot(a, b)] = -(T(0.5) * (dy1 + dy0)) / h0;
    const T dx1 = (WX && M.g(a) == p.nx - 1)
                      ? dx0
                      : (st(A, ap, b) - A0) * rdx;
    By[slot(a, b)] = T(0.5) * (dx1 + dx0) / h0;
    if (p.closure == kBiharmonic) {
      Lu[slot(a, b)] = tile_laplacian<true, false>(
          [&](int i, int j) { return st(U, i, j); }, M, N, a, b, rdx, rdy);
      Lv[slot(a, b)] = tile_laplacian<false, true>(
          [&](int i, int j) { return st(V, i, j); }, M, N, a, b, rdx, rdy);
    }
  });
  __syncthreads();

  each_tile_point<TY>(tile.ex, tile.ey, [&](int a, int b) {
    const bool last_x = WX && M.g(a) == p.nx - 1;
    const bool last_y = WY && N.g(b) == p.ny - 1;
    const int am = M.sh(a, -1), ap = M.sh(a, 1);
    const int bm = N.sh(b, -1), bp = N.sh(b, 1);
    auto at = [&](const T* t, int i, int j) { return t[slot(i, j)]; };
    const T h0 = st(H, a, b);

    // vorticity flux, with the transverse velocities ℑxyᶠᶜv and ℑxyᶜᶠu:
    // the u-equation's along y onto (f,c), the v-equation's along x onto
    // (c,f)
    const T v_hat = T(0.5) * (T(0.5) * (st(V, a, bp) + st(V, a, b))
                              + T(0.5) * (st(V, am, bp) + st(V, am, b)));
    const T u_hat = T(0.5) * (at(uff, ap, b) + at(uff, a, b));
    T vort_u, vort_v;
    if (p.momentum == kCentered2) {
      // ℑyᶜ(ζ ℑxᶠv), −ℑxᶜ(ζ ℑyᶠu)
      vort_u = T(0.5) * (at(zeta, a, bp) * at(vff, a, bp)
                         + at(zeta, a, b) * at(vff, a, b));
      vort_v = -(T(0.5) * (at(zeta, ap, b) * at(uff, ap, b)
                           + at(zeta, a, b) * at(uff, a, b)));
    } else {
      T zl, zr;
      vi_vorticity<WY>(
          p, [&](int t, int q) { return at(bx(t), a, q); }, N, b, zl, zr);
      vort_u = upwind(v_hat, zl, zr);
      vi_vorticity<WX>(
          p, [&](int t, int q) { return at(bx(t), q, b); }, M, a, zl, zr);
      vort_v = -upwind(u_hat, zl, zr);
    }

    // Bernoulli gradient and Coriolis
    const T KB0 = at(KB, a, b);
    T Gu = vort_u - (KB0 - at(KB, am, b)) * rdx;
    T Gv = vort_v - (KB0 - at(KB, a, bm)) * rdy;
    Gu = Gu + p.f * v_hat;
    Gv = Gv + (-p.f) * u_hat;

    if (p.closure == kLaplacian) {
      Gu = Gu + p.nu * tile_laplacian<true, false>(
                           [&](int i, int j) { return st(U, i, j); }, M, N,
                           a, b, rdx, rdy);
      Gv = Gv + p.nu * tile_laplacian<false, true>(
                           [&](int i, int j) { return st(V, i, j); }, M, N,
                           a, b, rdx, rdy);
    } else if (p.closure == kBiharmonic) {
      Gu = Gu + (-p.nu) * tile_laplacian<true, false>(
                              [&](int i, int j) { return at(Lu, i, j); }, M,
                              N, a, b, rdx, rdy);
      Gv = Gv + (-p.nu) * tile_laplacian<false, true>(
                              [&](int i, int j) { return at(Lv, i, j); }, M,
                              N, a, b, rdx, rdy);
    }

    // jacobian Lorentz force; ∂yᶠBx at j+1 and ∂xᶠBy at i+1 are clamped
    const T Bx0 = at(Bx, a, b), Bx_im = at(Bx, am, b);
    const T dyBx = (Bx0 - at(Bx, a, bm)) * rdy;
    const T dyBx_jp = last_y ? dyBx : (at(Bx, a, bp) - Bx0) * rdy;
    const T dyBx_c = T(0.5) * (dyBx_jp + dyBx);
    const T dyBx_im = (Bx_im - at(Bx, am, bm)) * rdy;
    const T dyBx_imjp = last_y ? dyBx_im : (at(Bx, am, bp) - Bx_im) * rdy;
    const T dyBx_m = T(0.5) * (dyBx_imjp + dyBx_im);
    const T dAdy0 = at(dAdy, a, b);
    const T iDAdy = T(0.5) * (T(0.5) * (at(dAdy, a, bp) + dAdy0)
                              + T(0.5) * (at(dAdy, am, bp)
                                          + at(dAdy, am, b)));
    const T dAdx0 = at(dAdx, a, b);
    const T jac_x = dAdx0 * (T(0.5) * (dyBx_c + dyBx_m))
                    - iDAdy * ((Bx0 - Bx_im) * rdx);

    const T By0 = at(By, a, b), By_jm = at(By, a, bm);
    const T dxBy_c = T(0.5) * ((By0 - at(By, am, b)) * rdx
                               + (By_jm - at(By, am, bm)) * rdx);
    const T dxBy_p = last_x ? dxBy_c
                            : T(0.5) * ((at(By, ap, b) - By0) * rdx
                                        + (at(By, ap, bm) - By_jm) * rdx);
    const T iDAdx = T(0.5) * (T(0.5) * (at(dAdx, ap, b) + at(dAdx, ap, bm))
                              + T(0.5) * (dAdx0 + at(dAdx, a, bm)));
    const T jac_y = iDAdx * ((By0 - By_jm) * rdy)
                    - dAdy0 * (T(0.5) * (dxBy_p + dxBy_c));

    Gu = Gu + jac_x / (T(0.5) * (h0 + st(H, am, b)));
    Gv = Gv + jac_y / (T(0.5) * (h0 + st(H, a, bm)));
    // no penetration: the wall-normal tendency on face 0
    if (WX && M.g(a) == 0) Gu = T(0);
    if (WY && N.g(b) == 0) Gv = T(0);
    epi(U, Gu, a, b);
    epi(V, Gv, a, b);
  });
}

// One substage on tile (ti, tj) of the unpadded output, the points
// [ti·tx, ti·tx + tx) × [tj·kTileY, tj·kTileY + kTileY): s, g_prev, s_out,
// g_out as in Launch; p.nx, p.ny the padded extents. The body of both the
// one-substage kernel (vi_substage) and the resident one (vi_resident).
template <typename T, Axis X, Axis Y, bool Opt>
__device__ __forceinline__ void vi_substage_tile(const T* s, const T* g_prev,
                                                 T* s_out, T* g_out,
                                                 Params<T> p, int tx, T dt,
                                                 T gk, T zk, int ti, int tj) {
  p = vi_options<Opt>(p);
  constexpr int R = kViRadius, TY = kTileY, BC = kViBoxCols;
  extern __shared__ __align__(16) unsigned char smem[];
  T* const win = reinterpret_cast<T*>(smem);
  const int plane = (tx + 2 * R) * BC;
  const int mx = p.nx - 2 * p.hx, my = p.ny - 2 * p.hy;
  const int x0 = ti * tx, y0 = tj * TY;
  const Map<X> M{p.hx + x0, p.nx};
  const Map<Y> N{p.hy + y0, p.ny};

  // 1. the state windows
  load_windows<R, BC>(win, s, p, M, N, tx + 2 * R);
  const FixedWindows<T, R, BC> st{win, plane};
  const ViTile<T, X, Y, TY, FixedWindows<T, R, BC>> tile{
      p, st, win + 4 * plane, plane, M, N, tx, min(tx, mx - x0),
      min(TY, my - y0), T(1) / p.dx, T(1) / p.dy};

  // the Le–Moin update of field k at tile point (a, b)
  auto update = [&](int k, T G, int a, int b) {
    const size_t o = k * p.out_plane + static_cast<size_t>(x0 + a) * p.out_row
                     + y0 + b;
    // the rounding this kernel had compiled to: ζG_prev fused
    const T inc = g_prev ? mul_add(zk, g_prev[o], gk * G) : gk * G;
    s_out[o] = mul_add(dt, inc, st(k, a, b));
    if (g_out) g_out[o] = G;
  };

  // 2. mass and tracer
  vi_mass_tracer(tile, update);
  __syncthreads();
  // 3. momentum
  vi_momentum(tile, update);
}

// One substage; block (blockIdx.y, blockIdx.x) is tile (x0 / tx, y0 /
// kTileY) of the unpadded output.
template <typename T, Axis X, Axis Y, bool Opt>
__global__ void __launch_bounds__(kTileThreads, kViMinBlocks)
vi_substage(const T* __restrict__ s, const T* __restrict__ g_prev,
            T* __restrict__ s_out, T* __restrict__ g_out, Params<T> p,
            int tx, T dt, T gk, T zk) {
  vi_substage_tile<T, X, Y, Opt>(s, g_prev, s_out, g_out, p, tx, dt, gk, zk,
                                 blockIdx.y, blockIdx.x);
}

// Resident blocks an SM the resident kernel's registers are sized for: as
// many as the one-substage kernel of the default model holds in float (3,
// its shared memory's limit at 32×32 tiles). Left alone, the loop around
// the inlined tile body keeps about 40 more registers live (99 against 56
// a thread in the periodic float kernel) and the kernel falls to 2 blocks
// an SM; held to 80, it runs 3. The other models' one-substage kernels
// take up to 96 registers and run 2, as a biharmonic closure's shared
// memory allows no more.
template <typename T, bool Opt>
constexpr int kViResidentMinBlocks =
    sizeof(T) == 4 && !Opt ? 3 : kViMinBlocks;

// n_steps RK3 steps of a whole domain (no halo) in one cooperative launch
// (tile.cuh resident_substages).
template <typename T, Axis X, Axis Y, bool Opt>
__global__ void __launch_bounds__(kTileThreads,
                                  (kViResidentMinBlocks<T, Opt>))
vi_resident(const T* in, T* out, T* work, T* gbuf, Params<T> p, int tx,
            T dt, int n_steps) {
  resident_substages(in, out, work, gbuf, p, tx, n_steps,
                     [&](const T* s, const T* g_prev, T* s_out, T* g_out,
                         T gk, T zk, int ti, int tj) {
                       vi_substage_tile<T, X, Y, Opt>(s, g_prev, s_out,
                                                      g_out, p, tx, dt, gk,
                                                      zk, ti, tj);
                     });
}

// The kernel of a launch's axis modes, or null for a pair no launch takes
// (a bounded axis is never exchanged).
template <typename T, bool Opt>
struct ViKernel {
  using Fn = decltype(&vi_substage<T, Axis::kPeriodic, Axis::kPeriodic, Opt>);
  template <Axis X, Axis Y>
  static Fn go() { return &vi_substage<T, X, Y, Opt>; }
  static Fn none() { return nullptr; }
};

template <typename T, bool Opt>
auto vi_kernel(int mode_x, int mode_y) {
  return on_axes<ViKernel<T, Opt>>(mode_x, mode_y);
}

// Whether a model runs the Opt instantiation.
template <typename T>
bool vi_opt(const Params<T>& p) {
  return p.closure != kNoClosure || p.momentum != kWeno5
         || p.mass != kWeno5 || p.tracer != kWeno5
         || p.stencil != kVelocityStencil;
}

// The kernel of (mode_x, mode_y, opt) ready for `bytes` of shared memory
// (raise_smem_limit); null, with cudaErrorInvalidValue in *err, for modes
// no launch takes, a tile_x out of [1, kViMaxTileX] or bytes over the card's
// opt-in limit.
template <typename T>
const void* vi_ready(int mode_x, int mode_y, bool opt, int tile_x,
                     size_t bytes, cudaError_t* err) {
  static size_t allowed[2][9] = {};
  const int m = mode_x * 3 + mode_y;
  *err = cudaErrorInvalidValue;
  if (m < 0 || m > 8 || tile_x < 1 || tile_x > kViMaxTileX) return nullptr;
  const void* k = opt ? reinterpret_cast<const void*>(
                            vi_kernel<T, true>(mode_x, mode_y))
                      : reinterpret_cast<const void*>(
                            vi_kernel<T, false>(mode_x, mode_y));
  *err = raise_smem_limit(k, bytes, &allowed[opt][m]);
  return *err == cudaSuccess ? k : nullptr;
}

template <typename T>
cudaError_t launch_vector_invariant(const Launch<T>& a) {
  const Params<T>& p = a.p;
  const bool opt = vi_opt(p);
  const size_t bytes = vi_smem_bytes(sizeof(T), a.tile_x,
                                     opt && p.closure == kBiharmonic);
  cudaError_t err;
  const void* k = vi_ready<T>(p.mode_x, p.mode_y, opt, a.tile_x, bytes,
                              &err);
  return k == nullptr ? err : launch_tiles(k, a, bytes);
}

// tile_kernel_info of the kernel a launch with these arguments takes.
template <typename T>
int vi_tile_info(int mode_x, int mode_y, int opt, int tile_x,
                 int biharmonic, int* out) {
  const size_t bytes = vi_smem_bytes(sizeof(T), tile_x, biharmonic != 0);
  cudaError_t err;
  const void* k = vi_ready<T>(mode_x, mode_y, opt != 0, tile_x, bytes, &err);
  return k == nullptr ? static_cast<int>(err)
                      : tile_kernel_info(k, bytes, out);
}

// The resident kernel of a whole domain's axis modes, or null for an
// exchanged axis (a tile of a decomposition takes one-substage launches).
template <typename T, bool Opt>
struct ViResidentKernel {
  using Fn = decltype(&vi_resident<T, Axis::kPeriodic, Axis::kPeriodic, Opt>);
  template <Axis X, Axis Y>
  static Fn go() {
    if constexpr (X == Axis::kExchanged || Y == Axis::kExchanged) {
      return nullptr;
    } else {
      return &vi_resident<T, X, Y, Opt>;
    }
  }
  static Fn none() { return nullptr; }
};

template <typename T, bool Opt>
auto vi_resident_kernel(int mode_x, int mode_y) {
  return on_axes<ViResidentKernel<T, Opt>>(mode_x, mode_y);
}

// The resident kernel of (mode_x, mode_y, opt) ready for a launch with
// tiles of tile_x rows (tile.cuh resident_ready), its blocks an SM in
// *blocks; null, with the error in *err, as vi_ready, or for an exchanged
// axis.
template <typename T>
const void* vi_resident_ready(int mode_x, int mode_y, bool opt, int tile_x,
                              bool biharmonic, int* blocks,
                              cudaError_t* err) {
  static size_t allowed[2][9] = {};
  static int cached[2][9][2][kViMaxTileX + 1] = {};
  const int m = mode_x * 3 + mode_y;
  *err = cudaErrorInvalidValue;
  if (m < 0 || m > 8 || tile_x < 1 || tile_x > kViMaxTileX) return nullptr;
  const void* k = opt ? reinterpret_cast<const void*>(
                            vi_resident_kernel<T, true>(mode_x, mode_y))
                      : reinterpret_cast<const void*>(
                            vi_resident_kernel<T, false>(mode_x, mode_y));
  if (k == nullptr) return nullptr;
  *err = resident_ready(k, vi_smem_bytes(sizeof(T), tile_x, biharmonic),
                        &allowed[opt][m], &cached[opt][m][biharmonic][tile_x],
                        blocks);
  return *err == cudaSuccess ? k : nullptr;
}

template <typename T>
cudaError_t launch_vi_resident(const Resident<T>& a) {
  const Params<T>& p = a.p;
  const bool opt = vi_opt(p);
  const bool biharmonic = opt && p.closure == kBiharmonic;
  int blocks = 0;
  cudaError_t err;
  const void* k = vi_resident_ready<T>(p.mode_x, p.mode_y, opt, a.tile_x,
                                       biharmonic, &blocks, &err);
  return k == nullptr ? err
                      : launch_resident(k, a,
                                        vi_smem_bytes(sizeof(T), a.tile_x,
                                                      biharmonic),
                                        blocks);
}

// tile_kernel_info of the resident kernel a launch with these arguments
// takes, and out[3] its grid over `tiles` tiles on `sms` SMs.
template <typename T>
int vi_resident_info(int mode_x, int mode_y, int opt, int tile_x,
                     int biharmonic, int tiles, int sms, int* out) {
  int blocks = 0;
  cudaError_t err;
  const void* k = vi_resident_ready<T>(mode_x, mode_y, opt != 0, tile_x,
                                       biharmonic != 0, &blocks, &err);
  if (k == nullptr) return static_cast<int>(err);
  out[3] = resident_grid(tiles, sms, blocks);
  return tile_kernel_info(
      k, vi_smem_bytes(sizeof(T), tile_x, biharmonic != 0), out);
}

}  // namespace swmhd

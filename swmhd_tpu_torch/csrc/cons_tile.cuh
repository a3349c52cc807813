// The conservative (flux-form) RK3 substage in one kernel over 2-D tiles,
// written by hand for Hopper (sm_90a): momentum flux ∇·(U ⊗ ũ) with the
// momentum scheme's reconstructions (WENO5-Z, UpwindBiased3 or Centered2)
// of u = uh/ℑxᶠh and v = vh/ℑyᶠh, gravity −g ℑh ∂h, f-plane Coriolis on
// the transports, mass −∇·(uh, vh), hA-conservative tracer with the
// tracer scheme and a linear background gradient, the Laplacian or
// biharmonic closure of uh, vh and A, the divergence-form Lorentz force
// ∇·(hB⊗B) with UpwindBiased3 reconstructions of B
// (swmhd_tpu/models/shallow_water.py _tendencies_conservative,
// physics/diffusion.py, physics/lorentz.py lorentz_force_divergence),
// then the Le–Moin update, for each periodic/bounded pair of axes and on
// exchanged tiles. The entry points of substage.cu reach it through
// launch_conservative (conservative.cu, conservative_f64.cu); it is the
// Hopper counterpart of the conservative branch of build_fused_calls
// (swmhd_tpu/ops/fused_step.py) and, with a halo, of
// DomainDecomposition.fused_step_fn (swmhd_tpu/parallel/decomposition.py).
//
// What bounds it: about 1100 fp32 operations a point (six WENO5-Z
// reconstructions, each with two IEEE divisions, and the divisions of u,
// v, Bx, By by the face averages of h) against 16 words of state,
// G_prev, new state and G: operations. The design keeps every
// intermediate on chip, so a substage moves those 16 words and no more.
//
// Design. One block of kTileThreads threads per (TX, kTileY) tile of the
// unpadded output; TX is the wrapper's choice (ops/substage.py
// tile_shape). Local index (a, b) is the point (i0 + a, j0 + b) of the
// (padded) arrays, the tile's points a in [0, TX), b in [0, 32). Every
// array of shared memory, window or box, is (TX + 7) × 39: the composed
// read radius is kConsLo = 4 cells below the tile and kConsHi = 3 above
// (u = uh/ℑxᶠh and Bx = hBx/ℑxᶠh reach h and A one cell further than the
// fluxes reach them).
//   1. The four state windows go to shared memory by cp.async, all issued
//      at once, from wrapped, clamped or exchanged indices (Map::load).
//   2. Phase 1, mass and tracer: the tracer fluxes Fx, Fy over [0, TX] ×
//      [0, 32] (and ∇²A for a biharmonic closure over [-1, TX] × [-1,
//      32]); then, at the tile's points, Gh, GA and their update.
//   3. Phase 2, momentum: u, v over [-3, TX + 2] × [-3, 34] (and ∇²uh,
//      ∇²vh over [-1, TX] × [-1, 32]); then the fluxes along x, Mxx at
//      (c,c) over [-1, TX) × [0, 32) and Mxy at (f,f) over [0, TX] × [0,
//      32), in one loop; then those along y, Myx at (f,f) over [0, TX) ×
//      [0, 32] and Myy at (c,c) over [0, TX) × [-1, 32), in another;
//      then at the points the momentum flux divergence, gravity, Coriolis
//      and the closure of Gu and Gv, held in registers (TX / 8 points a
//      thread).
//   4. Phase 3, Lorentz force, in the same shared memory: hBx, hBy, Bx, By
//      over [-2, TX + 1] × [-2, 33]; the fluxes Lxx, Lxy (along x) and
//      Lyx, Lyy (along y) over the regions of the momentum fluxes; then
//      at the points their divergence, the wall masks and the update of
//      uh and vh.
//   The peak is 8 box arrays beside the 4 windows in phases 2 (u, v, four
//   momentum fluxes, a biharmonic closure's ∇²uh and ∇²vh) and 3 (hBx,
//   hBy, Bx, By, four Lorentz fluxes), so a biharmonic closure takes no
//   more: 12 arrays of (TX + 7) × 39 values, 73,008 B a block for 32×32
//   f32, 86,112 B for 16×32 f64 (cons_smem_bytes). A loop covers a
//   rectangle with a compile-time width, the tile's points are owned one
//   column a lane and one row a warp, as in vi_tile.cuh.
//
// Traps the design handles:
//   - Three difference operators at a bounded axis, kept apart: the
//     wall-aware flux differences (mass, tracer, the cross momentum
//     fluxes Myx, Mxy) read zero past the far wall; ∂ᶠ of the (c,c)
//     momentum fluxes Mxx, Myy reads the clamped neighbour below; the
//     Lorentz flux differences are plain clamped ones (at the far wall
//     the flux minus itself).
//   - Wall semantics. A shift of a derived array past a wall reads it at
//     the clamped index (edge replication), and the center forms of the
//     reconstructions read windows clamped at each of the two shifts:
//     every read goes through Map::sh and Map::sh2 (tile.cuh), so a read
//     past a wall lands on the wall point's slot. No slot past a wall is
//     read; the plain emulation (ops/cons_tile.py) fills them with NaN.
//   - Masks. Gu at i = 0 and Gv at j = 0 of a bounded axis are zero (no
//     penetration).
//   - Bitwise tiles. A tile of a decomposition runs the same expressions
//     in the same order as the whole grid's periodic axes, and matches it
//     bit for bit, as long as every product is taken once a value: each
//     intermediate is computed at its own slot and stored, and a loop
//     never reads one array along both axes (the x and y fluxes have loops
//     of their own), so the compiler cannot prove two reads of one slot
//     equal on a periodic axis only and contract them differently from
//     an exchanged one (PERF.md §6).
//   - The f32 NaN trap. The WENO-Z weights are substage.cuh's
//     weno_combine, with the power-of-two rescaling of the betas
//     (_normalize_betas of the reference) that keeps a constant field,
//     such as u at a rest start, finite in fp32.
//   - Divisions. A division by a constant (the 1/6 of every third-order
//     candidate, dx, dy and the cell area dx·dy of every difference and
//     of the closures' Laplacians) is a product with its reciprocal,
//     rounded once per thread. Divisions by data (uh/ℑh, hB/ℑh, the WENO-Z
//     weights' sum, /h) stay IEEE divisions; there is no __fdividef.
//
// Options: the default model (no closure, WENO5 momentum and tracer)
// runs the Opt-false instantiation, in which those options are constants;
// any other model runs the Opt instantiation, which reads them from
// Params (warp-uniform branches). Measured against runtime switches for
// every model, the constant options took 3.7% less a 2048² f32 substage
// on an H100 (PERF.md §6), so the split stays.

#pragma once

#include "substage.cuh"
#include "tile.cuh"

namespace swmhd {

constexpr int kConsLo = 4;          // ops/substage.py TILE_LAYOUTS
constexpr int kConsHi = 3;
constexpr int kConsBoxCols = kTileY + kConsLo + kConsHi;
constexpr int kConsBoxArrays = 8;
// the most rows a tile may have: a thread holds Gu and Gv of
// kConsMaxTileX / kTileRows points from phase 2 to phase 3
constexpr int kConsMaxTileX = 32;
constexpr int kConsHeld = kConsMaxTileX / kTileRows;
// resident blocks an SM the register allocation is sized for
constexpr int kConsMinBlocks = 2;

// Shared memory of a block (ops/substage.py smem_bytes).
inline size_t cons_smem_bytes(size_t word, int tile_x) {
  return word * static_cast<size_t>(tile_x + kConsLo + kConsHi)
         * kConsBoxCols * (4 + kConsBoxArrays);
}

// The options the formulation reads (it reconstructs no mass and has no
// vorticity flux), constant in the Opt-false instantiation.
template <bool Opt, typename T>
__device__ __forceinline__ Params<T> cons_options(Params<T> p) {
  if constexpr (!Opt) {
    p.closure = kNoClosure;
    p.momentum = p.tracer = kWeno5;
  }
  return p;
}

// Whether a model runs the Opt instantiation.
template <typename T>
bool cons_opt(const Params<T>& p) {
  return p.closure != kNoClosure || p.momentum != kWeno5
         || p.tracer != kWeno5;
}

// One substage on tile (ti, tj) of the unpadded output, the points
// [ti·tx, ti·tx + tx) × [tj·kTileY, tj·kTileY + kTileY): s, g_prev, s_out,
// g_out as in Launch; p.nx, p.ny the padded extents. The body of both the
// one-substage kernel (cons_substage) and the resident one
// (cons_resident).
template <typename T, Axis X, Axis Y, bool Opt>
__device__ __forceinline__ void cons_substage_tile(const T* s,
                                                   const T* g_prev,
                                                   T* s_out, T* g_out,
                                                   Params<T> p, int tx, T dt,
                                                   T gk, T zk, int ti,
                                                   int tj) {
  p = cons_options<Opt>(p);
  constexpr bool WX = X == Axis::kBounded, WY = Y == Axis::kBounded;
  constexpr int LO = kConsLo, TY = kTileY, BC = kConsBoxCols;
  enum { H = 0, U = 1, V = 2, A = 3 };   // h, uh, vh, A
  extern __shared__ __align__(16) unsigned char smem[];
  T* const win = reinterpret_cast<T*>(smem);
  const int plane = (tx + LO + kConsHi) * BC;
  T* const box = win + 4 * plane;
  const int mx = p.nx - 2 * p.hx, my = p.ny - 2 * p.hy;
  const int x0 = ti * tx, y0 = tj * TY;
  const Map<X> M{p.hx + x0, p.nx};
  const Map<Y> N{p.hy + y0, p.ny};
  const int ex = min(tx, mx - x0), ey = min(TY, my - y0);
  const T rdx = T(1) / p.dx, rdy = T(1) / p.dy, raz = T(1) / p.az;

  auto slot = [&](int a, int b) { return (a + LO) * BC + b + LO; };
  auto st = [&](int k, int a, int b) { return win[k * plane + slot(a, b)]; };
  auto bx = [&](int t) { return box + t * plane; };
  auto state = [&](int k) {
    return [&, k](int a, int b) { return st(k, a, b); };
  };

  // 1. the state windows
  load_windows<LO, BC>(win, s, p, M, N, tx + LO + kConsHi);

  // the Le–Moin update of field k at tile point (a, b)
  auto update = [&](int k, T G, int a, int b) {
    const size_t o = k * p.out_plane + static_cast<size_t>(x0 + a) * p.out_row
                     + y0 + b;
    // the roundings this kernel had compiled to: momentum fused γG, mass
    // and tracer ζG_prev
    const T inc = !g_prev ? gk * G
                  : (k == U || k == V) ? mul_add(gk, G, zk * g_prev[o])
                                       : mul_add(zk, g_prev[o], gk * G);
    s_out[o] = mul_add(dt, inc, st(k, a, b));
    if (g_out) g_out[o] = G;
  };
  const int lane = threadIdx.x % TY, warp = threadIdx.x / TY;

  // 2. mass and tracer
  {
    T* const Fx = bx(0);
    T* const Fy = bx(1);
    T* const LA = bx(2);
    each_point<0, TY + 1>(0, tx + 1, [&](int a, int b) {
      T c[6], l, r;
#pragma unroll
      for (int k = 0; k < 6; ++k) c[k] = st(A, M.sh(a, k - 3), b);
      face_pair<WX, true>(p.tracer, c, M.g(a), p.nx, l, r);
      Fx[slot(a, b)] = upwind(st(U, a, b), l, r);
#pragma unroll
      for (int k = 0; k < 6; ++k) c[k] = st(A, a, N.sh(b, k - 3));
      face_pair<WY, true>(p.tracer, c, N.g(b), p.ny, l, r);
      Fy[slot(a, b)] = upwind(st(V, a, b), l, r);
    });
    if (p.closure == kBiharmonic) {
      each_point<-1, TY + 1>(-1, tx + 1, [&](int a, int b) {
        LA[slot(a, b)] =
            tile_laplacian<false, false>(state(A), M, N, a, b, rdx, rdy);
      });
    }
    __syncthreads();

    for (int a = warp; a < ex && lane < ey; a += kTileRows) {
      const int b = lane;
      const bool last_x = WX && M.g(a) == p.nx - 1;
      const bool last_y = WY && N.g(b) == p.ny - 1;
      const int ap = M.sh(a, 1), bp = N.sh(b, 1);
      const T h0 = st(H, a, b), uh0 = st(U, a, b), vh0 = st(V, a, b);
      const T vh_jp = st(V, a, bp);
      // a bounded axis has no flux through its far wall
      const T uh_up = last_x ? T(0) : st(U, ap, b);
      const T vh_up = last_y ? T(0) : vh_jp;
      const T divU = (uh_up - uh0) * rdx + (vh_up - vh0) * rdy;
      const T fx_up = last_x ? T(0) : Fx[slot(ap, b)];
      const T fy_up = last_y ? T(0) : Fy[slot(a, bp)];
      const T div_flux = (fx_up - Fx[slot(a, b)]) * rdx
                         + (fy_up - Fy[slot(a, b)]) * rdy;
      T GA = (st(A, a, b) * divU - div_flux) / h0;
      if (p.gam_bg != T(0)) {
        GA = GA - p.gam_bg * (T(0.5) * (vh_jp + vh0)) / h0;
      }
      if (p.closure == kLaplacian) {
        GA = GA + p.kappa * tile_laplacian<false, false>(state(A), M, N, a,
                                                         b, rdx, rdy);
      } else if (p.closure == kBiharmonic) {
        GA = GA + (-p.kappa) * tile_laplacian<false, false>(
                                   [&](int i, int j) {
                                     return LA[slot(i, j)];
                                   },
                                   M, N, a, b, rdx, rdy);
      }
      update(H, -divU, a, b);
      update(A, GA, a, b);
    }
  }
  __syncthreads();

  // 3. momentum: Gu, Gv without the Lorentz force, held for phase 3
  T gu[kConsHeld], gv[kConsHeld];
  {
    T* const u = bx(0);
    T* const v = bx(1);
    T* const Mxx = bx(2);
    T* const Mxy = bx(3);
    T* const Myx = bx(4);
    T* const Myy = bx(5);
    T* const Lu = bx(6);
    T* const Lv = bx(7);
    each_point<-3, TY + 3>(-3, tx + 3, [&](int a, int b) {
      const T h0 = st(H, a, b);
      u[slot(a, b)] = st(U, a, b) / (T(0.5) * (h0 + st(H, M.sh(a, -1), b)));
      v[slot(a, b)] = st(V, a, b) / (T(0.5) * (h0 + st(H, a, N.sh(b, -1))));
    });
    if (p.closure == kBiharmonic) {
      each_point<-1, TY + 1>(-1, tx + 1, [&](int a, int b) {
        Lu[slot(a, b)] =
            tile_laplacian<true, false>(state(U), M, N, a, b, rdx, rdy);
        Lv[slot(a, b)] =
            tile_laplacian<false, true>(state(V), M, N, a, b, rdx, rdy);
      });
    }
    __syncthreads();
    // along x: Mxx = ℑxᶜuh · ũ at (c,c), the center form (the face form
    // at the next face, its window clamped at each shift); Mxy = ℑyᶠuh · ṽ
    // at (f,f)
    each_point<0, TY>(-1, tx + 1, [&](int a, int b) {
      T c[6], l, r;
      if (a < tx) {
        const int ap = M.sh(a, 1);
#pragma unroll
        for (int k = 0; k < 6; ++k) c[k] = u[slot(M.sh2(a, 1, k - 3), b)];
        center_pair<WX, true>(p.momentum, c, u[slot(a, b)], M.g(ap), p.nx,
                              l, r);
        Mxx[slot(a, b)] = upwind(T(0.5) * (st(U, ap, b) + st(U, a, b)), l, r);
      }
      if (a >= 0) {
#pragma unroll
        for (int k = 0; k < 6; ++k) c[k] = v[slot(M.sh(a, k - 3), b)];
        face_pair<WX, true>(p.momentum, c, M.g(a), p.nx, l, r);
        Mxy[slot(a, b)] =
            upwind(T(0.5) * (st(U, a, b) + st(U, a, N.sh(b, -1))), l, r);
      }
    });
    // along y: Myx = ℑxᶠvh · ũ at (f,f); Myy = ℑyᶜvh · ṽ at (c,c)
    each_point<-1, TY + 1>(0, tx, [&](int a, int b) {
      T c[6], l, r;
      if (b >= 0) {
#pragma unroll
        for (int k = 0; k < 6; ++k) c[k] = u[slot(a, N.sh(b, k - 3))];
        face_pair<WY, true>(p.momentum, c, N.g(b), p.ny, l, r);
        Myx[slot(a, b)] =
            upwind(T(0.5) * (st(V, a, b) + st(V, M.sh(a, -1), b)), l, r);
      }
      if (b < TY) {
        const int bp = N.sh(b, 1);
#pragma unroll
        for (int k = 0; k < 6; ++k) c[k] = v[slot(a, N.sh2(b, 1, k - 3))];
        center_pair<WY, true>(p.momentum, c, v[slot(a, b)], N.g(bp), p.ny,
                              l, r);
        Myy[slot(a, b)] = upwind(T(0.5) * (st(V, a, bp) + st(V, a, b)), l, r);
      }
    });
    __syncthreads();

#pragma unroll
    for (int q = 0; q < kConsHeld; ++q) {
      const int a = warp + q * kTileRows, b = lane;
      if (a >= ex || b >= ey) continue;
      const bool last_x = WX && M.g(a) == p.nx - 1;
      const bool last_y = WY && N.g(b) == p.ny - 1;
      const int am = M.sh(a, -1), ap = M.sh(a, 1);
      const int bm = N.sh(b, -1), bp = N.sh(b, 1);
      auto at = [&](const T* t, int i, int j) { return t[slot(i, j)]; };
      const T h0 = st(H, a, b), uh0 = st(U, a, b), vh0 = st(V, a, b);
      const T h_im = st(H, am, b), h_jm = st(H, a, bm);
      const T hfx = T(0.5) * (h0 + h_im);
      const T hfy = T(0.5) * (h0 + h_jm);

      // momentum flux divergence: ∂ᶠ of the (c,c) fluxes, the wall-aware
      // difference of the (f,f) ones
      const T myx_up = last_y ? T(0) : at(Myx, a, bp);
      const T mxy_up = last_x ? T(0) : at(Mxy, ap, b);
      T Gu = -((at(Mxx, a, b) - at(Mxx, am, b)) * rdx
               + (myx_up - at(Myx, a, b)) * rdy);
      T Gv = -((mxy_up - at(Mxy, a, b)) * rdx
               + (at(Myy, a, b) - at(Myy, a, bm)) * rdy);

      // gravity −g ℑh ∂h, Coriolis on the transports
      Gu = Gu - p.g * hfx * ((h0 - h_im) * rdx);
      Gv = Gv - p.g * hfy * ((h0 - h_jm) * rdy);
      const T vbar = T(0.5) * (T(0.5) * (st(V, a, bp) + vh0)
                               + T(0.5) * (st(V, am, bp) + st(V, am, b)));
      const T ubar = T(0.5) * (T(0.5) * (st(U, ap, b) + st(U, ap, bm))
                               + T(0.5) * (uh0 + st(U, a, bm)));
      Gu = Gu + p.f * vbar;
      Gv = Gv + (-p.f) * ubar;

      if (p.closure == kLaplacian) {
        Gu = Gu + p.nu * tile_laplacian<true, false>(state(U), M, N, a, b,
                                                     rdx, rdy);
        Gv = Gv + p.nu * tile_laplacian<false, true>(state(V), M, N, a, b,
                                                     rdx, rdy);
      } else if (p.closure == kBiharmonic) {
        Gu = Gu + (-p.nu) * tile_laplacian<true, false>(
                                [&](int i, int j) { return at(Lu, i, j); },
                                M, N, a, b, rdx, rdy);
        Gv = Gv + (-p.nu) * tile_laplacian<false, true>(
                                [&](int i, int j) { return at(Lv, i, j); },
                                M, N, a, b, rdx, rdy);
      }
      gu[q] = Gu;
      gv[q] = Gv;
    }
  }
  __syncthreads();

  // 4. the divergence-form Lorentz force
  T* const hBx = bx(0);
  T* const hBy = bx(1);
  T* const Bx = bx(2);
  T* const By = bx(3);
  T* const Lxx = bx(4);
  T* const Lxy = bx(5);
  T* const Lyx = bx(6);
  T* const Lyy = bx(7);
  // hBx = −ℑxᶠ(ℑyᶜ(∂yᶠA + γ)) at (f,c), hBy = ℑxᶜ(ℑyᶠ(∂xᶠA)) at (c,f)
  // (∂yᶠA at j+1 and ∂xᶠA at i+1 clamped), B = hB over the face mean of h
  each_point<-2, TY + 2>(-2, tx + 2, [&](int a, int b) {
    const int am = M.sh(a, -1), ap = M.sh(a, 1);
    const int bm = N.sh(b, -1), bp = N.sh(b, 1);
    const bool last_x = WX && M.g(a) == p.nx - 1;
    const bool last_y = WY && N.g(b) == p.ny - 1;
    auto iyc_dAdy = [&](int i) {
      const T a0 = st(A, i, b);
      const T d = (a0 - st(A, i, bm)) * rdy + p.gam_bg;
      const T d_jp = last_y ? d : (st(A, i, bp) - a0) * rdy + p.gam_bg;
      return T(0.5) * (d_jp + d);
    };
    auto iyf_dAdx = [&](int i, int im) {
      return T(0.5) * ((st(A, i, b) - st(A, im, b)) * rdx
                       + (st(A, i, bm) - st(A, im, bm)) * rdx);
    };
    const T h0 = st(H, a, b);
    const T hbx = -(T(0.5) * (iyc_dAdy(a) + iyc_dAdy(am)));
    const T P0 = iyf_dAdx(a, am);
    const T hby = T(0.5) * ((last_x ? P0 : iyf_dAdx(ap, a)) + P0);
    hBx[slot(a, b)] = hbx;
    hBy[slot(a, b)] = hby;
    Bx[slot(a, b)] = hbx / (T(0.5) * (h0 + st(H, am, b)));
    By[slot(a, b)] = hby / (T(0.5) * (h0 + st(H, a, bm)));
  });
  __syncthreads();
  // along x: Lxx = Ax ℑxᶜhBx · B̃x at (c,c), Lxy = Ax ℑyᶠhBx · B̃y at (f,f);
  // UpwindBiased3 reads slots 1..4 of its window
  each_point<0, TY>(-1, tx + 1, [&](int a, int b) {
    T c[6], l, r;
    if (a < tx) {
      const int ap = M.sh(a, 1);
#pragma unroll
      for (int k = 1; k < 5; ++k) c[k] = Bx[slot(M.sh2(a, 1, k - 3), b)];
      upwind3_pair<WX, true>(c, M.g(ap), p.nx, l, r);
      Lxx[slot(a, b)] =
          p.dy * upwind(T(0.5) * (hBx[slot(ap, b)] + hBx[slot(a, b)]), l, r);
    }
    if (a >= 0) {
#pragma unroll
      for (int k = 1; k < 5; ++k) c[k] = By[slot(M.sh(a, k - 3), b)];
      upwind3_pair<WX, true>(c, M.g(a), p.nx, l, r);
      Lxy[slot(a, b)] = p.dy * upwind(T(0.5) * (hBx[slot(a, b)]
                                                + hBx[slot(a, N.sh(b, -1))]),
                                      l, r);
    }
  });
  // along y: Lyx = Ay ℑxᶠhBy · B̃x at (f,f), Lyy = Ay ℑyᶜhBy · B̃y at (c,c)
  each_point<-1, TY + 1>(0, tx, [&](int a, int b) {
    T c[6], l, r;
    if (b >= 0) {
#pragma unroll
      for (int k = 1; k < 5; ++k) c[k] = Bx[slot(a, N.sh(b, k - 3))];
      upwind3_pair<WY, true>(c, N.g(b), p.ny, l, r);
      Lyx[slot(a, b)] = p.dx * upwind(T(0.5) * (hBy[slot(a, b)]
                                                + hBy[slot(M.sh(a, -1), b)]),
                                      l, r);
    }
    if (b < TY) {
      const int bp = N.sh(b, 1);
#pragma unroll
      for (int k = 1; k < 5; ++k) c[k] = By[slot(a, N.sh2(b, 1, k - 3))];
      upwind3_pair<WY, true>(c, N.g(bp), p.ny, l, r);
      Lyy[slot(a, b)] =
          p.dx * upwind(T(0.5) * (hBy[slot(a, bp)] + hBy[slot(a, b)]), l, r);
    }
  });
  __syncthreads();

#pragma unroll
  for (int q = 0; q < kConsHeld; ++q) {
    const int a = warp + q * kTileRows, b = lane;
    if (a >= ex || b >= ey) continue;
    const int am = M.sh(a, -1), ap = M.sh(a, 1);
    const int bm = N.sh(b, -1), bp = N.sh(b, 1);
    // plain (clamped) differences of the fluxes, over the cell area
    T Gu = gu[q] + ((Lxx[slot(a, b)] - Lxx[slot(am, b)])
                    + (Lyx[slot(a, bp)] - Lyx[slot(a, b)])) * raz;
    T Gv = gv[q] + ((Lxy[slot(ap, b)] - Lxy[slot(a, b)])
                    + (Lyy[slot(a, b)] - Lyy[slot(a, bm)])) * raz;
    // no penetration: the wall-normal tendency on face 0
    if (WX && M.g(a) == 0) Gu = T(0);
    if (WY && N.g(b) == 0) Gv = T(0);
    update(U, Gu, a, b);
    update(V, Gv, a, b);
  }
}

// One substage; block (blockIdx.y, blockIdx.x) is tile (x0 / tx, y0 /
// kTileY) of the unpadded output.
template <typename T, Axis X, Axis Y, bool Opt>
__global__ void __launch_bounds__(kTileThreads, kConsMinBlocks)
cons_substage(const T* __restrict__ s, const T* __restrict__ g_prev,
              T* __restrict__ s_out, T* __restrict__ g_out, Params<T> p,
              int tx, T dt, T gk, T zk) {
  cons_substage_tile<T, X, Y, Opt>(s, g_prev, s_out, g_out, p, tx, dt, gk,
                                   zk, blockIdx.y, blockIdx.x);
}

// Resident blocks an SM the resident kernel's registers are sized for: as
// many as the one-substage kernel holds in float (3, its shared memory's
// limit at 32×32 tiles, closures included). Left alone, the loop around
// the inlined tile body keeps about 40 more registers live (96 against 48
// a thread in the periodic float kernel) and the kernel falls to 2 blocks
// an SM; held to 80, it runs 3.
template <typename T>
constexpr int kConsResidentMinBlocks = sizeof(T) == 4 ? 3 : kConsMinBlocks;

// n_steps RK3 steps of a whole domain (no halo) in one cooperative launch
// (tile.cuh resident_substages).
template <typename T, Axis X, Axis Y, bool Opt>
__global__ void __launch_bounds__(kTileThreads,
                                  (kConsResidentMinBlocks<T>))
cons_resident(const T* in, T* out, T* work, T* gbuf, Params<T> p, int tx,
              T dt, int n_steps) {
  resident_substages(in, out, work, gbuf, p, tx, n_steps,
                     [&](const T* s, const T* g_prev, T* s_out, T* g_out,
                         T gk, T zk, int ti, int tj) {
                       cons_substage_tile<T, X, Y, Opt>(s, g_prev, s_out,
                                                        g_out, p, tx, dt, gk,
                                                        zk, ti, tj);
                     });
}

// The kernel of a launch's axis modes, or null for a pair no launch takes
// (a bounded axis is never exchanged).
template <typename T, bool Opt>
struct ConsKernel {
  using Fn =
      decltype(&cons_substage<T, Axis::kPeriodic, Axis::kPeriodic, Opt>);
  template <Axis X, Axis Y>
  static Fn go() { return &cons_substage<T, X, Y, Opt>; }
  static Fn none() { return nullptr; }
};

template <typename T, bool Opt>
auto cons_kernel(int mode_x, int mode_y) {
  return on_axes<ConsKernel<T, Opt>>(mode_x, mode_y);
}

// The kernel of (mode_x, mode_y, opt) ready for `bytes` of shared memory
// (raise_smem_limit); null, with cudaErrorInvalidValue in *err, for modes
// no launch takes, a tile_x out of [1, kConsMaxTileX] or bytes over the
// card's opt-in limit.
template <typename T>
const void* cons_ready(int mode_x, int mode_y, bool opt, int tile_x,
                       size_t bytes, cudaError_t* err) {
  static size_t allowed[2][9] = {};
  const int m = mode_x * 3 + mode_y;
  *err = cudaErrorInvalidValue;
  if (m < 0 || m > 8 || tile_x < 1 || tile_x > kConsMaxTileX) return nullptr;
  const void* k = opt ? reinterpret_cast<const void*>(
                            cons_kernel<T, true>(mode_x, mode_y))
                      : reinterpret_cast<const void*>(
                            cons_kernel<T, false>(mode_x, mode_y));
  *err = raise_smem_limit(k, bytes, &allowed[opt][m]);
  return *err == cudaSuccess ? k : nullptr;
}

template <typename T>
cudaError_t launch_conservative(const Launch<T>& a) {
  const size_t bytes = cons_smem_bytes(sizeof(T), a.tile_x);
  cudaError_t err;
  const void* k = cons_ready<T>(a.p.mode_x, a.p.mode_y, cons_opt(a.p),
                                a.tile_x, bytes, &err);
  return k == nullptr ? err : launch_tiles(k, a, bytes);
}

// tile_kernel_info of the kernel a launch with these arguments takes.
template <typename T>
int cons_tile_info(int mode_x, int mode_y, int opt, int tile_x, int* out) {
  const size_t bytes = cons_smem_bytes(sizeof(T), tile_x);
  cudaError_t err;
  const void* k = cons_ready<T>(mode_x, mode_y, opt != 0, tile_x, bytes,
                                &err);
  return k == nullptr ? static_cast<int>(err)
                      : tile_kernel_info(k, bytes, out);
}

// The resident kernel of a whole domain's axis modes, or null for an
// exchanged axis (a tile of a decomposition takes one-substage launches).
template <typename T, bool Opt>
struct ConsResidentKernel {
  using Fn =
      decltype(&cons_resident<T, Axis::kPeriodic, Axis::kPeriodic, Opt>);
  template <Axis X, Axis Y>
  static Fn go() {
    if constexpr (X == Axis::kExchanged || Y == Axis::kExchanged) {
      return nullptr;
    } else {
      return &cons_resident<T, X, Y, Opt>;
    }
  }
  static Fn none() { return nullptr; }
};

template <typename T, bool Opt>
auto cons_resident_kernel(int mode_x, int mode_y) {
  return on_axes<ConsResidentKernel<T, Opt>>(mode_x, mode_y);
}

// The resident kernel of (mode_x, mode_y, opt) ready for a launch with
// tiles of tile_x rows (tile.cuh resident_ready), its blocks an SM in
// *blocks; null, with the error in *err, as cons_ready, or for an
// exchanged axis.
template <typename T>
const void* cons_resident_ready(int mode_x, int mode_y, bool opt,
                                int tile_x, int* blocks, cudaError_t* err) {
  static size_t allowed[2][9] = {};
  static int cached[2][9][kConsMaxTileX + 1] = {};
  const int m = mode_x * 3 + mode_y;
  *err = cudaErrorInvalidValue;
  if (m < 0 || m > 8 || tile_x < 1 || tile_x > kConsMaxTileX) return nullptr;
  const void* k = opt ? reinterpret_cast<const void*>(
                            cons_resident_kernel<T, true>(mode_x, mode_y))
                      : reinterpret_cast<const void*>(
                            cons_resident_kernel<T, false>(mode_x, mode_y));
  if (k == nullptr) return nullptr;
  *err = resident_ready(k, cons_smem_bytes(sizeof(T), tile_x),
                        &allowed[opt][m], &cached[opt][m][tile_x], blocks);
  return *err == cudaSuccess ? k : nullptr;
}

template <typename T>
cudaError_t launch_cons_resident(const Resident<T>& a) {
  int blocks = 0;
  cudaError_t err;
  const void* k = cons_resident_ready<T>(a.p.mode_x, a.p.mode_y,
                                         cons_opt(a.p), a.tile_x, &blocks,
                                         &err);
  return k == nullptr ? err
                      : launch_resident(k, a,
                                        cons_smem_bytes(sizeof(T), a.tile_x),
                                        blocks);
}

// tile_kernel_info of the resident kernel a launch with these arguments
// takes, and out[3] its grid over `tiles` tiles on `sms` SMs.
template <typename T>
int cons_resident_info(int mode_x, int mode_y, int opt, int tile_x,
                       int tiles, int sms, int* out) {
  int blocks = 0;
  cudaError_t err;
  const void* k = cons_resident_ready<T>(mode_x, mode_y, opt != 0, tile_x,
                                         &blocks, &err);
  if (k == nullptr) return static_cast<int>(err);
  out[3] = resident_grid(tiles, sms, blocks);
  return tile_kernel_info(k, cons_smem_bytes(sizeof(T), tile_x), out);
}

}  // namespace swmhd

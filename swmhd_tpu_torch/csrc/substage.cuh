// Shared pieces of the RK3 substage kernels (substage.cu, vi_tile.cuh,
// conservative.cu) and of the 2-D tile tendency (tile.cu): parameters,
// the index maps of periodic, bounded and exchanged axes, the WENO5-Z /
// third-order biased / centered reconstructions with their near-wall
// degradation, the WENO5 vorticity reconstruction, and the staggered
// Laplacians of the diffusion closures.
//
// Layout: every field is (Nx, Ny) row-major, index i*Ny + j, i along x.
// Face i is the left edge of cell i. On a tile of a domain decomposition
// the state and the intermediates are the tile padded by (hx, hy) cells
// of halo, and G_prev and the outputs are the unpadded tile.

#pragma once

#include <cuda_runtime.h>

#include <cstddef>
#include <type_traits>

namespace swmhd {

constexpr int kBlockY = 32;
constexpr int kBlockX = 8;

// How an axis reads past its end. Periodic wraps and bounded clamps at a
// wall (edge replication) over the whole domain. Exchanged is an axis of
// a tile padded with a halo that the caller filled from the neighbouring
// tiles: reads go straight into the padded array, and the few that would
// leave it are clamped into it. A value that took such a read lies within
// one stencil radius of the array's end, and a value that reads it within
// two: the composed radius of a substage is at most the model's
// exchange_halo (6, 7 with a biharmonic closure), so with a halo that wide
// no such value reaches the unpadded tile, which is all the update writes.
// There the arithmetic is that of the periodic axis.
enum class Axis : int { kPeriodic = 0, kBounded = 1, kExchanged = 2 };

// The model's options, fields of Params, the same for every thread of a
// launch (ids of ops/substage.py); a formulation's kernels read only the
// ones it uses (the conservative one has no mass reconstruction and no
// vorticity stencil).
enum Scheme : int { kWeno5 = 0, kUpwind3 = 1, kCentered2 = 2 };
enum Closure : int { kNoClosure = 0, kLaplacian = 1, kBiharmonic = 2 };
enum Stencil : int { kVelocityStencil = 0, kVorticityStencil = 1 };

template <typename T>
struct Params {
  int nx, ny;            // extents of the state and intermediates (padded)
  int hx, hy;            // halo widths; the update writes the inner
                         // (nx - 2hx, ny - 2hy)
  int mode_x, mode_y;    // Axis of each axis
  int closure;           // Closure
  int momentum, mass, tracer;  // Scheme of each advection
  int stencil;           // Stencil of the WENO5 vorticity flux
  T dx, dy, g, f, gam_bg;
  T az;                  // cell area dx·dy (divergence-form Lorentz force)
  T nu, kappa;           // the closure's diffusivities
};

// One substage: input state, G_prev (null in substage 0), outputs (g_out
// may be null), the intermediates buffer (the conservative kernels'; null
// for the vector-invariant one), the step and the Le–Moin coefficients
// (γ_k, ζ_k), and the rows of the vector-invariant kernel's tiles.
template <typename T>
struct Launch {
  const T* s_in;
  const T* g_prev;
  T* s_out;
  T* g_out;
  T* tmp;
  Params<T> p;
  T dt, gk, zk;
  int tile_x;
  cudaStream_t stream;
};

// Each formulation's translation unit defines its launcher for float and
// double; both return cudaGetLastError() after their launches.
template <typename T>
cudaError_t launch_vector_invariant(const Launch<T>& a);
template <typename T>
cudaError_t launch_conservative(const Launch<T>& a);

// R::go<X, Y>(args...) for a launch's pair of axis modes: each periodic /
// bounded pair on a whole domain, and on a tile an exchanged x with a
// periodic, bounded or exchanged y, or a periodic x with an exchanged y (a
// mesh of one tile along x); R::none() for a pair no launch takes. Only a
// periodic axis is ever cut into tiles.
template <typename R, typename... Args>
auto on_axes(int mode_x, int mode_y, const Args&... args) {
  constexpr Axis P = Axis::kPeriodic, B = Axis::kBounded,
                 E = Axis::kExchanged;
  switch (mode_x * 3 + mode_y) {
    case 0: return R::template go<P, P>(args...);
    case 1: return R::template go<P, B>(args...);
    case 2: return R::template go<P, E>(args...);
    case 3: return R::template go<B, P>(args...);
    case 4: return R::template go<B, B>(args...);
    case 6: return R::template go<E, P>(args...);
    case 7: return R::template go<E, B>(args...);
    case 8: return R::template go<E, E>(args...);
    default: return R::none();
  }
}

inline dim3 block_dims() { return dim3(kBlockY, kBlockX); }

inline dim3 grid_dims(int nx, int ny) {
  return dim3((ny + kBlockY - 1) / kBlockY, (nx + kBlockX - 1) / kBlockX);
}

// -- index maps ---------------------------------------------------------------
//
// A shift by m of a field: wrapped on a periodic axis (|m| < n), clamped
// to the edge on a bounded axis (edge replication), straight into the
// halo on an exchanged axis (clamped only at the padded array's end). A
// shift of a derived array is the derived array evaluated at the shifted
// index, so where the reference shifts a shifted array the index is
// clamped at each step (sh2); on a periodic axis that is one wrap.

__device__ __forceinline__ int wrap(int i, int n) {
  return i < 0 ? i + n : (i >= n ? i - n : i);
}

__device__ __forceinline__ int clampi(int i, int n) {
  return i < 0 ? 0 : (i >= n ? n - 1 : i);
}

template <Axis A>
__device__ __forceinline__ int sh(int i, int m, int n) {
  if constexpr (A == Axis::kPeriodic) {
    return wrap(i + m, n);
  } else {
    return clampi(i + m, n);
  }
}

// shift by m, then by s
template <Axis A>
__device__ __forceinline__ int sh2(int i, int m, int s, int n) {
  if constexpr (A == Axis::kPeriodic) {
    return wrap(i + m + s, n);
  } else if constexpr (A == Axis::kBounded) {
    return clampi(clampi(i + m, n) + s, n);
  } else {
    return clampi(i + m + s, n);
  }
}

// Indices of the point an update thread owns: (i, j) in the padded arrays,
// c there, co in the unpadded outputs; false for a thread past the end.
template <typename T>
__device__ __forceinline__ bool update_point(const Params<T>& p, int& i,
                                             int& j, size_t& c,
                                             size_t& co) {
  const int mx = p.nx - 2 * p.hx, my = p.ny - 2 * p.hy;
  const int jj = blockIdx.x * kBlockY + threadIdx.x;
  const int ii = blockIdx.y * kBlockX + threadIdx.y;
  if (ii >= mx || jj >= my) return false;
  i = ii + p.hx;
  j = jj + p.hy;
  c = static_cast<size_t>(i) * p.ny + j;
  co = static_cast<size_t>(ii) * my + jj;
  return true;
}

// -- arithmetic -----------------------------------------------------------------

template <typename T>
__device__ __forceinline__ T sq(T x) { return x * x; }

// 0.5·((ũ+|ũ|)ψᴸ + (ũ−|ũ|)ψᴿ): the upwind select as arithmetic, so its
// roundoff is that of the PyTorch version.
template <typename T>
__device__ __forceinline__ T upwind(T ut, T l, T r) {
  return T(0.5) * ((ut + fabs(ut)) * l + (ut - fabs(ut)) * r);
}

// Smoothness indicators of the left stencil at face i from c[i-3..i+1].
template <typename T>
__device__ __forceinline__ void betas_left(T cm3, T cm2, T cm1, T c0, T cp1,
                                           T& b0, T& b1, T& b2) {
  b0 = T(13.0 / 12.0) * sq(cm3 - T(2) * cm2 + cm1)
       + T(0.25) * sq(cm3 - T(4) * cm2 + T(3) * cm1);
  b1 = T(13.0 / 12.0) * sq(cm2 - T(2) * cm1 + c0) + T(0.25) * sq(cm2 - c0);
  b2 = T(13.0 / 12.0) * sq(cm1 - T(2) * c0 + cp1)
       + T(0.25) * sq(T(3) * cm1 - T(4) * c0 + cp1);
}

// x / 6, or x · (1/6) with Recip (the vector-invariant tile kernel: an
// IEEE division by a constant is a subroutine call on the card, and the
// product stays within the kernels' bounds; PERF.md §6).
template <bool Recip, typename T>
__device__ __forceinline__ T over6(T x) {
  if constexpr (Recip) {
    return x * T(1.0 / 6.0);
  } else {
    return x / T(6);
  }
}

template <bool Recip = false, typename T>
__device__ __forceinline__ void cands_left(T cm3, T cm2, T cm1, T c0, T cp1,
                                           T& p0, T& p1, T& p2) {
  p0 = over6<Recip>(T(2) * cm3 - T(7) * cm2 + T(11) * cm1);
  p1 = over6<Recip>(-cm2 + T(5) * cm1 + T(2) * c0);
  p2 = over6<Recip>(T(2) * cm1 + T(5) * c0 - cp1);
}

template <bool Recip = false, typename T>
__device__ __forceinline__ void cands_right(T cm2, T cm1, T c0, T cp1, T cp2,
                                            T& p0, T& p1, T& p2) {
  p0 = over6<Recip>(T(2) * cp2 - T(7) * cp1 + T(11) * c0);
  p1 = over6<Recip>(-cp1 + T(5) * c0 + T(2) * cm1);
  p2 = over6<Recip>(T(2) * c0 + T(5) * cm1 - cm2);
}

// WENO-Z weights in the divide-free rational form, eps = 1e-8, linear
// weights (0.1, 0.6, 0.3). fp32 first rescales the betas and eps by a
// power of two read off the exponent bits of their sum (clamped at
// 2^-126), so a constant field (betas 0, as at a rest start) gives finite
// weights; fp64 skips that step, as the reference does.
template <typename T>
__device__ __forceinline__ T weno_combine(T p0, T p1, T p2,
                                          T b0, T b1, T b2) {
  T eps = T(1e-8);
  if constexpr (std::is_same<T, float>::value) {
    const float s = b0 + b1 + b2 + eps;
    const int bits = __float_as_int(s);
    const float inv =
        __int_as_float(max(0x7F000000 - (bits & 0x7F800000), 0x00800000));
    b0 *= inv;
    b1 *= inv;
    b2 *= inv;
    eps *= inv;
  }
  const T tau2 = sq(b0 - b2);
  const T q0 = sq(b0 + eps);
  const T q1 = sq(b1 + eps);
  const T q2 = sq(b2 + eps);
  const T a0 = T(0.1) * (q0 + tau2) * (q1 * q2);
  const T a1 = T(0.6) * (q1 + tau2) * (q0 * q2);
  const T a2 = T(0.3) * (q2 + tau2) * (q0 * q1);
  return (a0 * p0 + a1 * p1 + a2 * p2) / (a0 + a1 + a2);
}

// (left, right) WENO5 values at face i from c[k] = c(i + k - 3), k = 0..5;
// the right betas are the left betas of face i+1, mirrored.
template <bool Recip = false, typename T>
__device__ __forceinline__ void weno_pair(const T* c, T& left, T& right) {
  T b0, b1, b2, r0, r1, r2, p0, p1, p2;
  betas_left(c[0], c[1], c[2], c[3], c[4], b0, b1, b2);
  cands_left<Recip>(c[0], c[1], c[2], c[3], c[4], p0, p1, p2);
  left = weno_combine(p0, p1, p2, b0, b1, b2);
  betas_left(c[1], c[2], c[3], c[4], c[5], r0, r1, r2);
  cands_right<Recip>(c[1], c[2], c[3], c[4], c[5], p0, p1, p2);
  right = weno_combine(p0, p1, p2, r2, r1, r0);
}

// WENO5 reconstruction of ζ onto the flux point from windows z[k], uf[k],
// vf[k] = value at offset k - 2 (k = 0..5) along the reconstruction axis:
// candidates from ζ, weights from the averaged betas of ℑu and ℑv at
// (f,f) (velocity; uf, vf are read only then) or from ζ's own. At a
// bounded axis' last point (last) the right betas are the left ones: the
// reference's shift of the betas is clamped.
template <bool Recip = false, typename T>
__device__ __forceinline__ void vorticity_pair(const T* z, const T* uf,
                                               const T* vf, bool velocity,
                                               bool last, T& zl, T& zr) {
  T b0, b1, b2, r0, r1, r2;   // left betas at this face and at the next
  if (velocity) {
    T ua0, ua1, ua2, va0, va1, va2, ub0, ub1, ub2, vb0, vb1, vb2;
    betas_left(uf[0], uf[1], uf[2], uf[3], uf[4], ua0, ua1, ua2);
    betas_left(vf[0], vf[1], vf[2], vf[3], vf[4], va0, va1, va2);
    if (last) {
      ub0 = ua0; ub1 = ua1; ub2 = ua2;
      vb0 = va0; vb1 = va1; vb2 = va2;
    } else {
      betas_left(uf[1], uf[2], uf[3], uf[4], uf[5], ub0, ub1, ub2);
      betas_left(vf[1], vf[2], vf[3], vf[4], vf[5], vb0, vb1, vb2);
    }
    b0 = T(0.5) * (ua0 + va0);
    b1 = T(0.5) * (ua1 + va1);
    b2 = T(0.5) * (ua2 + va2);
    r0 = T(0.5) * (ub0 + vb0);
    r1 = T(0.5) * (ub1 + vb1);
    r2 = T(0.5) * (ub2 + vb2);
  } else {
    betas_left(z[0], z[1], z[2], z[3], z[4], b0, b1, b2);
    if (last) {
      r0 = b0; r1 = b1; r2 = b2;
    } else {
      betas_left(z[1], z[2], z[3], z[4], z[5], r0, r1, r2);
    }
  }
  T p0, p1, p2;
  cands_left<Recip>(z[0], z[1], z[2], z[3], z[4], p0, p1, p2);
  zl = weno_combine(p0, p1, p2, b0, b1, b2);
  cands_right<Recip>(z[1], z[2], z[3], z[4], z[5], p0, p1, p2);
  zr = weno_combine(p0, p1, p2, r2, r1, r0);
}

// -- reconstructions at faces, wall-aware ------------------------------------------
//
// Window c[k] = c(q + k - 3), k = 0..5, read through sh<Wall>; q is the
// face index on an axis of n points. On a bounded axis the reference
// replaces the values near a wall by lower-order ones: third order within
// two cells (first order at the outermost faces), and WENO5 by that
// degraded third order within three. Where a value survives, its
// stencil needs no clamped read, so the window is exact there.

// UpwindBiased3 (left, right) at face q.
template <bool Wall, bool Recip = false, typename T>
__device__ __forceinline__ void upwind3_pair(const T* c, int q, int n,
                                             T& left, T& right) {
  left = over6<Recip>(T(2) * c[3] + T(5) * c[2] - c[1]);
  right = over6<Recip>(-c[4] + T(5) * c[3] + T(2) * c[2]);
  if constexpr (Wall) {
    if (q < 2) left = c[2];
    if (q < 1 || q > n - 2) right = c[3];
  }
}

// WENO5 (left, right) at face q.
template <bool Wall, bool Recip = false, typename T>
__device__ __forceinline__ void weno5_pair(const T* c, int q, int n,
                                           T& left, T& right) {
  weno_pair<Recip>(c, left, right);
  if constexpr (Wall) {
    const bool deg_left = q < 3 || q > n - 2;
    const bool deg_right = q < 2 || q > n - 3;
    if (deg_left || deg_right) {
      T l3, r3;
      upwind3_pair<Wall, Recip>(c, q, n, l3, r3);
      if (deg_left) left = l3;
      if (deg_right) right = r3;
    }
  }
}

// (left, right) of scheme s at face q from the window c[k] = c(q + k - 3).
// Centered2 is unbiased: both are ℑᶠc = (c[q] + c[q-1])/2.
template <bool Wall, bool Recip = false, typename T>
__device__ __forceinline__ void face_pair(int s, const T* c, int q, int n,
                                          T& left, T& right) {
  if (s == kCentered2) {
    left = right = T(0.5) * (c[3] + c[2]);
  } else if (s == kUpwind3) {
    upwind3_pair<Wall, Recip>(c, q, n, left, right);
  } else {
    weno5_pair<Wall, Recip>(c, q, n, left, right);
  }
}

// (left, right) of scheme s at center i from face values: the face form at
// the next face q, read through the window c[k] = c(q + k - 3) clamped at
// each shift. Centered2's is ℑᶜ = (c[i+1] + c[i])/2 of the value c_i at i
// itself, which at a bounded axis' last point is not the window's c[2].
template <bool Wall, typename T>
__device__ __forceinline__ void center_pair(int s, const T* c, T c_i, int q,
                                            int n, T& left, T& right) {
  if (s == kCentered2) {
    left = right = T(0.5) * (c[3] + c_i);
  } else {
    face_pair<Wall>(s, c, q, n, left, right);
  }
}

// -- Laplacians of the closures ------------------------------------------------
//
// ∂ᶠ(∂ᶜ a) (Face) or ∂ᶜ(∂ᶠ a) along one axis at index i, from rd(k),
// the value of a at index k, shift(k, m), the index k shifted by m, and
// the spacing d (with Recip its reciprocal, multiplied by). The inner
// difference is an array of its own, so the outer one reads it at the
// shifted index: at a wall, the clamped index (∂ᶠ(∂ᶜ a) is 0 at face 0,
// ∂ᶜ(∂ᶠ a) at the last center).
template <bool Face, bool Recip = false, typename T, typename R, typename S>
__device__ __forceinline__ T second_difference_by(const R& rd,
                                                  const S& shift, int i,
                                                  T d) {
  auto by = [d](T x) {
    if constexpr (Recip) {
      return x * d;
    } else {
      return x / d;
    }
  };
  if constexpr (Face) {
    const int im = shift(i, -1);
    return by(by(rd(shift(i, 1)) - rd(i)) - by(rd(shift(im, 1)) - rd(im)));
  } else {
    const int ip = shift(i, 1);
    return by(by(rd(ip) - rd(shift(ip, -1))) - by(rd(i) - rd(shift(i, -1))));
  }
}

// The same on an axis of n points in mode A (sh<A>).
template <Axis A, bool Face, typename T, typename R>
__device__ __forceinline__ T second_difference(const R& rd, int i, int n,
                                               T d) {
  return second_difference_by<Face>(
      rd, [n](int k, int m) { return sh<A>(k, m, n); }, i, d);
}

// ∇²a at (i, j); FX, FY: a lies on faces along x, y (u: (f,c) is <true,
// false>, v: (c,f) <false, true>, a center field <false, false>).
template <Axis X, Axis Y, bool FX, bool FY, typename T>
__device__ __forceinline__ T laplacian(const T* a, int i, int j,
                                       const Params<T>& p) {
  auto rx = [&](int k) { return a[static_cast<size_t>(k) * p.ny + j]; };
  auto ry = [&](int k) { return a[static_cast<size_t>(i) * p.ny + k]; };
  return second_difference<X, FX>(rx, i, p.nx, p.dx)
         + second_difference<Y, FY>(ry, j, p.ny, p.dy);
}

// The inner Laplacians of a biharmonic closure, of the momentum
// prognostics mu, mv and the tracer A, stored at c of the intermediates
// lu, lv, lA by a first kernel over the whole (padded) array.
template <Axis X, Axis Y, typename T>
__device__ __forceinline__ void store_inner_laplacians(
    const T* mu, const T* mv, const T* A, int i, int j, size_t c,
    const Params<T>& p, T* lu, T* lv, T* lA) {
  lu[c] = laplacian<X, Y, true, false>(mu, i, j, p);
  lv[c] = laplacian<X, Y, false, true>(mv, i, j, p);
  lA[c] = laplacian<X, Y, false, false>(A, i, j, p);
}

// The closure's tendencies added to (Gu, Gv, GA) at (i, j): ν∇² of the
// momentum prognostics mu, mv and κ∇²A, or −ν∇⁴ and −κ∇⁴ as the outer
// Laplacians of the stored inner ones lu, lv, lA.
template <Axis X, Axis Y, typename T>
__device__ __forceinline__ void add_closure(
    const Params<T>& p, const T* mu, const T* mv, const T* A, const T* lu,
    const T* lv, const T* lA, int i, int j, T& Gu, T& Gv, T& GA) {
  if (p.closure == kLaplacian) {
    Gu = Gu + p.nu * laplacian<X, Y, true, false>(mu, i, j, p);
    Gv = Gv + p.nu * laplacian<X, Y, false, true>(mv, i, j, p);
    GA = GA + p.kappa * laplacian<X, Y, false, false>(A, i, j, p);
  } else if (p.closure == kBiharmonic) {
    Gu = Gu + (-p.nu) * laplacian<X, Y, true, false>(lu, i, j, p);
    Gv = Gv + (-p.nu) * laplacian<X, Y, false, true>(lv, i, j, p);
    GA = GA + (-p.kappa) * laplacian<X, Y, false, false>(lA, i, j, p);
  }
}

// -- the end of a substage ------------------------------------------------------
//
// No penetration (the wall-normal tendency is zero on face 0 of a bounded
// axis; the far wall face is not stored), then the Le–Moin update
// s' = s + dt (γ G + ζ G_prev): s at c of the padded arrays, G_prev and
// the outputs at co of the unpadded ones, G stored where g_out is given.
template <bool WX, bool WY, typename T>
__device__ __forceinline__ void mask_and_update(
    T Gh, T Gu, T Gv, T GA, int i, int j, size_t c, size_t co,
    const Params<T>& p, const T* s, const T* g_prev, T* s_out, T* g_out,
    T dt, T gk, T zk) {
  if (WX && i == 0) Gu = T(0);
  if (WY && j == 0) Gv = T(0);
  const size_t n = static_cast<size_t>(p.nx) * p.ny;
  const size_t no = static_cast<size_t>(p.nx - 2 * p.hx) * (p.ny - 2 * p.hy);
  const T G[4] = {Gh, Gu, Gv, GA};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const size_t o = k * no + co;
    const T inc = g_prev ? gk * G[k] + zk * g_prev[o] : gk * G[k];
    s_out[o] = s[k * n + c] + dt * inc;
    if (g_out) g_out[o] = G[k];
  }
}

}  // namespace swmhd

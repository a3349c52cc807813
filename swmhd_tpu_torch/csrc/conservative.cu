// The conservative (flux-form) substage: momentum flux ∇·(U ⊗ ũ) with
// the momentum scheme's reconstructions (WENO5-Z, UpwindBiased3 or
// Centered2) of u = uh/ℑh and v = vh/ℑh, gravity −g ℑh ∂h, f-plane
// Coriolis on the transports, mass −∇·(uh, vh), hA-conservative tracer
// with the tracer scheme, the Laplacian or biharmonic closure of uh, vh
// and A, and the divergence-form Lorentz force ∇·(hB⊗B) with
// UpwindBiased3 reconstructions of B (swmhd_tpu/models/shallow_water.py
// _tendencies_conservative, physics/diffusion.py, physics/lorentz.py
// lorentz_force_divergence), for each periodic/bounded pair of axes and on
// exchanged tiles.
//
// Three kernels, each reading the previous one's arrays at radius <= 3;
// the first two run over the whole (padded) array, the last over the
// unpadded points:
//   point_fields: the point-local derived arrays u, v, hBx, hBy, Bx, By,
//     the tracer fluxes and, with a biharmonic closure, the inner
//     Laplacians;
//   flux_fields: the momentum and Lorentz fluxes at (c,c) and (f,f);
//   flux_update: their differences, gravity, Coriolis, mass and tracer,
//     then the Le–Moin update.
// Every model reads the closure and the schemes from Params at run time:
// flux_fields then takes fewer registers than with them constant, and the
// default model's step is the faster for it.
// A reconstruction at centers is the face form at the next face, read
// through a window clamped at each of the two shifts (sh2). Three
// difference operators differ at a bounded axis and stay apart: the
// wall-aware flux differences (mass, tracer, the cross momentum fluxes),
// ∂ᶠ of the (c,c) momentum fluxes, and the plain clamped differences of
// the Lorentz fluxes.

#include "substage.cuh"

namespace swmhd {
namespace {

// Intermediates, each (Nx, Ny): point_fields writes the first eight,
// flux_fields the next eight.
enum Tmp {
  kU, kV,            // u = uh/ℑxᶠh at (f,c), v = vh/ℑyᶠh at (c,f)
  kHBx, kHBy,        // hBx at (f,c), hBy at (c,f)
  kBx, kBy,          // Bx = hBx/ℑxᶠh, By = hBy/ℑyᶠh
  kFx, kFy,          // tracer fluxes uh·Ã, vh·Ã
  kMxx, kMyx,        // momentum fluxes of u: (c,c), (f,f)
  kMxy, kMyy,        // momentum fluxes of v: (f,f), (c,c)
  kLxx, kLyx,        // Lorentz fluxes of the uh equation: (c,c), (f,f)
  kLxy, kLyy,        // Lorentz fluxes of the vh equation: (f,f), (c,c)
  kNumTmp,
  // with a biharmonic closure: ∇²uh at (f,c), ∇²vh at (c,f), ∇²A at (c,c)
  kLu = kNumTmp, kLv, kLA,
  kNumTmpBiharmonic
};
static_assert(kNumTmp == 16 && kNumTmpBiharmonic == 19,
              "N_TMP of ops/substage.py");

template <typename T, Axis X, Axis Y>
__global__ void __launch_bounds__(kBlockX * kBlockY)
point_fields(const T* __restrict__ s, T* __restrict__ tmp, Params<T> p) {
  constexpr bool WX = X == Axis::kBounded, WY = Y == Axis::kBounded;
  const int j = blockIdx.x * kBlockY + threadIdx.x;
  const int i = blockIdx.y * kBlockX + threadIdx.y;
  if (i >= p.nx || j >= p.ny) return;
  const size_t n = static_cast<size_t>(p.nx) * p.ny;
  const T* h = s;
  const T* uh = s + n;
  const T* vh = s + 2 * n;
  const T* A = s + 3 * n;
  auto at = [&](const T* a, int di, int dj) {
    return a[static_cast<size_t>(sh<X>(i, di, p.nx)) * p.ny
             + sh<Y>(j, dj, p.ny)];
  };
  const size_t c = static_cast<size_t>(i) * p.ny + j;
  const bool last_x = WX && i == p.nx - 1;
  const bool last_y = WY && j == p.ny - 1;

  const T h0 = h[c];
  const T hfx = T(0.5) * (h0 + at(h, -1, 0));
  const T hfy = T(0.5) * (h0 + at(h, 0, -1));
  const T uh0 = uh[c], vh0 = vh[c];

  // hBx = −ℑxᶠ(ℑyᶜ(∂yᶠA + γ)): columns i and i−1, ∂yᶠA at j+1 clamped
  auto iyc_dAdy = [&](int di) {
    const T a0 = at(A, di, 0);
    const T d = (a0 - at(A, di, -1)) / p.dy + p.gam_bg;
    const T d_jp = last_y ? d : (at(A, di, 1) - a0) / p.dy + p.gam_bg;
    return T(0.5) * (d_jp + d);
  };
  const T hBx = -(T(0.5) * (iyc_dAdy(0) + iyc_dAdy(-1)));
  // hBy = ℑxᶜ(ℑyᶠ(∂xᶠA)): rows i and i+1, ∂xᶠA at i+1 clamped
  auto iyf_dAdx = [&](int di) {
    return T(0.5) * ((at(A, di, 0) - at(A, di - 1, 0)) / p.dx
                     + (at(A, di, -1) - at(A, di - 1, -1)) / p.dx);
  };
  const T P0 = iyf_dAdx(0);
  const T hBy = T(0.5) * ((last_x ? P0 : iyf_dAdx(1)) + P0);

  T ax[6], ay[6];
#pragma unroll
  for (int k = 0; k < 6; ++k) {
    ax[k] = at(A, k - 3, 0);
    ay[k] = at(A, 0, k - 3);
  }
  T l, r;
  face_pair<WX>(p.tracer, ax, i, p.nx, l, r);
  const T fx = upwind(uh0, l, r);
  face_pair<WY>(p.tracer, ay, j, p.ny, l, r);
  const T fy = upwind(vh0, l, r);

  const T out[8] = {uh0 / hfx, vh0 / hfy, hBx, hBy, hBx / hfx, hBy / hfy,
                    fx, fy};
#pragma unroll
  for (int k = 0; k < 8; ++k) tmp[(kU + k) * n + c] = out[k];
  if (p.closure == kBiharmonic) {
    store_inner_laplacians<X, Y>(uh, vh, A, i, j, c, p, tmp + kLu * n,
                                 tmp + kLv * n, tmp + kLA * n);
  }
}

template <typename T, Axis X, Axis Y>
__global__ void __launch_bounds__(kBlockX * kBlockY)
flux_fields(const T* __restrict__ s, T* __restrict__ tmp, Params<T> p) {
  constexpr bool WX = X == Axis::kBounded, WY = Y == Axis::kBounded;
  const int j = blockIdx.x * kBlockY + threadIdx.x;
  const int i = blockIdx.y * kBlockX + threadIdx.y;
  if (i >= p.nx || j >= p.ny) return;
  const size_t n = static_cast<size_t>(p.nx) * p.ny;
  auto ld = [&](const T* a, int ii, int jj) {
    return a[static_cast<size_t>(ii) * p.ny + jj];
  };
  auto at = [&](const T* a, int di, int dj) {
    return ld(a, sh<X>(i, di, p.nx), sh<Y>(j, dj, p.ny));
  };
  const size_t c = static_cast<size_t>(i) * p.ny + j;
  const T* uh = s + n;
  const T* vh = s + 2 * n;
  const T* u = tmp + kU * n;
  const T* v = tmp + kV * n;
  const T* hBx = tmp + kHBx * n;
  const T* hBy = tmp + kHBy * n;
  const T* Bx = tmp + kBx * n;
  const T* By = tmp + kBy * n;
  const int ip = sh<X>(i, 1, p.nx), jp = sh<Y>(j, 1, p.ny);

  // windows: at faces (i, j) and at the next face (the center forms)
  T ux[6], uy[6], vx[6], vy[6], bxx[6], bxy[6], byx[6], byy[6];
#pragma unroll
  for (int k = 0; k < 6; ++k) {
    const int ic = sh2<X>(i, 1, k - 3, p.nx);
    const int jc = sh2<Y>(j, 1, k - 3, p.ny);
    const int jf = sh<Y>(j, k - 3, p.ny);
    const int iff = sh<X>(i, k - 3, p.nx);
    ux[k] = ld(u, ic, j);        // u at centers along x
    uy[k] = ld(u, i, jf);        // u at faces along y
    vx[k] = ld(v, iff, j);       // v at faces along x
    vy[k] = ld(v, i, jc);        // v at centers along y
    bxx[k] = ld(Bx, ic, j);
    bxy[k] = ld(Bx, i, jf);
    byx[k] = ld(By, iff, j);
    byy[k] = ld(By, i, jc);
  }
  const T uh0 = uh[c], vh0 = vh[c];
  const T hBx0 = hBx[c], hBy0 = hBy[c];
  T l, r;
  center_pair<WX>(p.momentum, ux, u[c], ip, p.nx, l, r);
  const T Mxx = upwind(T(0.5) * (ld(uh, ip, j) + uh0), l, r);
  face_pair<WY>(p.momentum, uy, j, p.ny, l, r);
  const T Myx = upwind(T(0.5) * (vh0 + at(vh, -1, 0)), l, r);
  face_pair<WX>(p.momentum, vx, i, p.nx, l, r);
  const T Mxy = upwind(T(0.5) * (uh0 + at(uh, 0, -1)), l, r);
  center_pair<WY>(p.momentum, vy, v[c], jp, p.ny, l, r);
  const T Myy = upwind(T(0.5) * (ld(vh, i, jp) + vh0), l, r);

  upwind3_pair<WX>(bxx, ip, p.nx, l, r);
  const T Lxx = p.dy * upwind(T(0.5) * (ld(hBx, ip, j) + hBx0), l, r);
  upwind3_pair<WY>(bxy, j, p.ny, l, r);
  const T Lyx = p.dx * upwind(T(0.5) * (hBy0 + at(hBy, -1, 0)), l, r);
  upwind3_pair<WX>(byx, i, p.nx, l, r);
  const T Lxy = p.dy * upwind(T(0.5) * (hBx0 + at(hBx, 0, -1)), l, r);
  upwind3_pair<WY>(byy, jp, p.ny, l, r);
  const T Lyy = p.dx * upwind(T(0.5) * (ld(hBy, i, jp) + hBy0), l, r);

  const T out[8] = {Mxx, Myx, Mxy, Myy, Lxx, Lyx, Lxy, Lyy};
#pragma unroll
  for (int k = 0; k < 8; ++k) tmp[(kMxx + k) * n + c] = out[k];
}

template <typename T, Axis X, Axis Y>
__global__ void __launch_bounds__(kBlockX * kBlockY)
flux_update(const T* __restrict__ s, const T* __restrict__ tmp,
            const T* __restrict__ g_prev, T* __restrict__ s_out,
            T* __restrict__ g_out, Params<T> p, T dt, T gk, T zk) {
  constexpr bool WX = X == Axis::kBounded, WY = Y == Axis::kBounded;
  int i, j;
  size_t c, co;
  if (!update_point(p, i, j, c, co)) return;
  const size_t n = static_cast<size_t>(p.nx) * p.ny;
  auto at = [&](const T* a, int di, int dj) {
    return a[static_cast<size_t>(sh<X>(i, di, p.nx)) * p.ny
             + sh<Y>(j, dj, p.ny)];
  };
  const bool last_x = WX && i == p.nx - 1;
  const bool last_y = WY && j == p.ny - 1;
  const T* h = s;
  const T* uh = s + n;
  const T* vh = s + 2 * n;
  const T* A = s + 3 * n;
  // the value at the next point, zero through a bounded axis' far wall
  auto up_x = [&](const T* a) { return last_x ? T(0) : at(a, 1, 0); };
  auto up_y = [&](const T* a) { return last_y ? T(0) : at(a, 0, 1); };
  const T* Fx = tmp + kFx * n;
  const T* Fy = tmp + kFy * n;
  const T* Mxx = tmp + kMxx * n;
  const T* Myx = tmp + kMyx * n;
  const T* Mxy = tmp + kMxy * n;
  const T* Myy = tmp + kMyy * n;
  const T* Lxx = tmp + kLxx * n;
  const T* Lyx = tmp + kLyx * n;
  const T* Lxy = tmp + kLxy * n;
  const T* Lyy = tmp + kLyy * n;

  const T h0 = h[c], uh0 = uh[c], vh0 = vh[c];
  const T h_im = at(h, -1, 0), h_jm = at(h, 0, -1);
  const T hfx = T(0.5) * (h0 + h_im);
  const T hfy = T(0.5) * (h0 + h_jm);

  // momentum flux divergence
  T Gu = -((Mxx[c] - at(Mxx, -1, 0)) / p.dx + (up_y(Myx) - Myx[c]) / p.dy);
  T Gv = -((up_x(Mxy) - Mxy[c]) / p.dx + (Myy[c] - at(Myy, 0, -1)) / p.dy);

  // gravity −g ℑh ∂h, Coriolis on the transports
  Gu = Gu - p.g * hfx * ((h0 - h_im) / p.dx);
  Gv = Gv - p.g * hfy * ((h0 - h_jm) / p.dy);
  const T vh_jp = at(vh, 0, 1);
  const T vbar = T(0.5) * (T(0.5) * (vh_jp + vh0)
                           + T(0.5) * (at(vh, -1, 1) + at(vh, -1, 0)));
  const T ubar = T(0.5) * (T(0.5) * (at(uh, 1, 0) + at(uh, 1, -1))
                           + T(0.5) * (uh0 + at(uh, 0, -1)));
  Gu = Gu + p.f * vbar;
  Gv = Gv + (-p.f) * ubar;

  // mass and tracer
  const T divU = (up_x(uh) - uh0) / p.dx + (up_y(vh) - vh0) / p.dy;
  const T Gh = -divU;
  const T div_flux = (up_x(Fx) - Fx[c]) / p.dx + (up_y(Fy) - Fy[c]) / p.dy;
  T GA = (A[c] * divU - div_flux) / h0;
  if (p.gam_bg != T(0)) GA = GA - p.gam_bg * (T(0.5) * (vh_jp + vh0)) / h0;

  add_closure<X, Y>(p, uh, vh, A, tmp + kLu * n, tmp + kLv * n,
                    tmp + kLA * n, i, j, Gu, Gv, GA);

  // divergence-form Lorentz force, plain (clamped) differences
  const T Lyx0 = Lyx[c], Lxy0 = Lxy[c];
  Gu = Gu + ((Lxx[c] - at(Lxx, -1, 0)) + (at(Lyx, 0, 1) - Lyx0)) / p.az;
  Gv = Gv + ((at(Lxy, 1, 0) - Lxy0) + (Lyy[c] - at(Lyy, 0, -1))) / p.az;

  mask_and_update<WX, WY>(Gh, Gu, Gv, GA, i, j, c, co, p, s, g_prev, s_out,
                          g_out, dt, gk, zk);
}

template <typename T>
struct Run {
  template <Axis X, Axis Y>
  static cudaError_t go(const Launch<T>& a) {
    const dim3 block = block_dims();
    const dim3 grid = grid_dims(a.p.nx, a.p.ny);
    point_fields<T, X, Y><<<grid, block, 0, a.stream>>>(a.s_in, a.tmp, a.p);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    flux_fields<T, X, Y><<<grid, block, 0, a.stream>>>(a.s_in, a.tmp, a.p);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    flux_update<T, X, Y><<<grid_dims(a.p.nx - 2 * a.p.hx,
                                     a.p.ny - 2 * a.p.hy),
                           block, 0, a.stream>>>(
        a.s_in, a.tmp, a.g_prev, a.s_out, a.g_out, a.p, a.dt, a.gk, a.zk);
    return cudaGetLastError();
  }
  static cudaError_t none() { return cudaErrorInvalidValue; }
};

}  // namespace

template <typename T>
cudaError_t launch_conservative(const Launch<T>& a) {
  return on_axes<Run<T>>(a.p.mode_x, a.p.mode_y, a);
}

template cudaError_t launch_conservative<float>(const Launch<float>&);
template cudaError_t launch_conservative<double>(const Launch<double>&);

}  // namespace swmhd

// The vector-invariant substage: mass and tracer reconstruction (WENO5-Z,
// UpwindBiased3 or Centered2), the vorticity flux of the momentum scheme
// (WENO5 with VelocityStencil or VorticityStencil weights, UpwindBiased3,
// or the centered form), Bernoulli gradient, f-plane Coriolis,
// hA-conservative tracer with a linear background gradient, the Laplacian
// or biharmonic closure, jacobian-form Lorentz force
// (swmhd_tpu/models/shallow_water.py _tendencies_vector_invariant,
// physics/diffusion.py, physics/lorentz.py lorentz_force_jacobian), for
// each periodic/bounded pair of axes and on exchanged tiles.
//
// Two kernels: face_fluxes writes the 12 intermediates below (15 with a
// biharmonic closure) over the whole (padded) array, and tendency_update
// reads them at radius <= 3 and applies the Le–Moin update on the
// unpadded points.
// Each intermediate is the reference's derived array, so a shift of it is a
// read at the shifted (wrapped or clamped) index. Where the reference
// shifts a derived array that this code recomputes from raw reads instead
// (∂A at i+1 for B, ∂B at i+1 for the jacobian, ζ and ℑu, ℑv on the
// center-from-face window, the right betas), a bounded axis takes the
// derived array's value at the clamped index: at the last point a shift by
// +1 repeats that point's own value.

#include "substage.cuh"

namespace swmhd {
namespace {

// The default model (no closure, WENO5 everywhere, VelocityStencil) runs
// kernels with Opt false, in which those options are constants, so they
// carry no code of the other branches; any other model runs the Opt
// kernels, which read the options from Params. With the options read at
// run time, tendency_update took more registers and the default step 12%
// longer on the card.
template <bool Opt, typename T>
__device__ __forceinline__ Params<T> options(Params<T> p) {
  if constexpr (!Opt) {
    p.closure = kNoClosure;
    p.momentum = p.mass = p.tracer = kWeno5;
    p.stencil = kVelocityStencil;
  }
  return p;
}

// Intermediates written by face_fluxes, in this order, each (Nx, Ny).
enum Tmp {
  kUf, kVf,        // mass fluxes u·h̃ at (f,c), v·h̃ at (c,f)
  kFx, kFy,        // tracer fluxes Uf·Ã, Vf·Ã
  kZeta,           // ζ = ∂x v − ∂y u at (f,f)
  kUff, kVff,      // ℑyᶠu, ℑxᶠv at (f,f)
  kKB,             // K + g h at (c,c)
  kDAdx, kDAdy,    // ∂xᶠA at (f,c), ∂yᶠA + γ at (c,f)
  kBx, kBy,        // B at (c,c)
  kNumTmp,
  // with a biharmonic closure: ∇²u at (f,c), ∇²v at (c,f), ∇²A at (c,c)
  kLu = kNumTmp, kLv, kLA,
  kNumTmpBiharmonic
};
static_assert(kNumTmp == 12 && kNumTmpBiharmonic == 15,
              "N_TMP of ops/substage.py");

// (left, right) of ζ on the flux point at (i, j) along axis A, the
// reconstruction axis, of n points at index q of it. WENO5 reconstructs
// the shifted arrays ζ, ℑu, ℑv at the face form (windows shifted, then
// clamped); UpwindBiased3 takes its face form at the next face (windows
// clamped at that face, then shifted), as the reference's center-from-face
// reconstruction does.
template <Axis A, bool Wall, typename T, typename L>
__device__ __forceinline__ void vorticity_recon(const Params<T>& p,
                                                const L& load, int q, int n,
                                                T& zl, T& zr) {
  T z[6], uw[6], vw[6];
  const bool velocity = p.stencil == kVelocityStencil;
  if (p.momentum == kWeno5) {
#pragma unroll
    for (int k = 0; k < 6; ++k) {
      const int qq = sh2<A>(q, k - 3, 1, n);
      z[k] = load(kZeta, qq);
      if (velocity) {
        uw[k] = load(kUff, qq);
        vw[k] = load(kVff, qq);
      }
    }
    vorticity_pair(z, uw, vw, velocity, Wall && q == n - 1, zl, zr);
  } else {
#pragma unroll
    for (int k = 0; k < 6; ++k) z[k] = load(kZeta, sh2<A>(q, 1, k - 3, n));
    upwind3_pair<Wall>(z, sh<A>(q, 1, n), n, zl, zr);
  }
}

template <typename T, Axis X, Axis Y, bool Opt>
__global__ void __launch_bounds__(kBlockX * kBlockY)
face_fluxes(const T* __restrict__ s, T* __restrict__ tmp, Params<T> p) {
  p = options<Opt>(p);
  constexpr bool WX = X == Axis::kBounded, WY = Y == Axis::kBounded;
  const int j = blockIdx.x * kBlockY + threadIdx.x;
  const int i = blockIdx.y * kBlockX + threadIdx.y;
  if (i >= p.nx || j >= p.ny) return;
  const size_t n = static_cast<size_t>(p.nx) * p.ny;
  const T* h = s;
  const T* u = s + n;
  const T* v = s + 2 * n;
  const T* A = s + 3 * n;
  auto at = [&](const T* a, int di, int dj) {
    return a[static_cast<size_t>(sh<X>(i, di, p.nx)) * p.ny
             + sh<Y>(j, dj, p.ny)];
  };
  const size_t c = static_cast<size_t>(i) * p.ny + j;
  const bool last_x = WX && i == p.nx - 1;
  const bool last_y = WY && j == p.ny - 1;

  T hx[6], hy[6], ax[6], ay[6];
#pragma unroll
  for (int k = 0; k < 6; ++k) {
    hx[k] = at(h, k - 3, 0);
    hy[k] = at(h, 0, k - 3);
    ax[k] = at(A, k - 3, 0);
    ay[k] = at(A, 0, k - 3);
  }
  T l, r;
  const T u0 = u[c], v0 = v[c];
  face_pair<WX>(p.mass, hx, i, p.nx, l, r);
  const T Uf = upwind(u0, l, r);
  face_pair<WY>(p.mass, hy, j, p.ny, l, r);
  const T Vf = upwind(v0, l, r);
  face_pair<WX>(p.tracer, ax, i, p.nx, l, r);
  const T fx = upwind(Uf, l, r);
  face_pair<WY>(p.tracer, ay, j, p.ny, l, r);
  const T fy = upwind(Vf, l, r);

  const T u_jm = at(u, 0, -1), u_ip = at(u, 1, 0);
  const T v_im = at(v, -1, 0), v_jp = at(v, 0, 1);
  const T zeta = (v0 - v_im) / p.dx - (u0 - u_jm) / p.dy;
  const T u_ff = T(0.5) * (u0 + u_jm);
  const T v_ff = T(0.5) * (v0 + v_im);
  const T K = T(0.5) * (T(0.5) * (u_ip * u_ip + u0 * u0)
                        + T(0.5) * (v_jp * v_jp + v0 * v0));
  const T h0 = hx[3];
  const T KB = K + p.g * h0;

  // B = (−ℑyᶜ(∂yᶠA + γ), ℑxᶜ(∂xᶠA))/h: ∂A at i+1, j+1 clamped
  const T dAdx = (ax[3] - ax[2]) / p.dx;
  const T dAdx_ip = last_x ? dAdx : (ax[4] - ax[3]) / p.dx;
  const T dAdy = (ay[3] - ay[2]) / p.dy + p.gam_bg;
  const T dAdy_jp = last_y ? dAdy : (ay[4] - ay[3]) / p.dy + p.gam_bg;
  const T Bx = -(T(0.5) * (dAdy_jp + dAdy)) / h0;
  const T By = T(0.5) * (dAdx_ip + dAdx) / h0;

  const T out[kNumTmp] = {Uf, Vf, fx, fy, zeta, u_ff, v_ff, KB,
                          dAdx, dAdy, Bx, By};
#pragma unroll
  for (int k = 0; k < kNumTmp; ++k) tmp[k * n + c] = out[k];
  if (p.closure == kBiharmonic) {
    store_inner_laplacians<X, Y>(u, v, A, i, j, c, p, tmp + kLu * n,
                                 tmp + kLv * n, tmp + kLA * n);
  }
}

template <typename T, Axis X, Axis Y, bool Opt>
__global__ void __launch_bounds__(kBlockX * kBlockY)
tendency_update(const T* __restrict__ s, const T* __restrict__ tmp,
                const T* __restrict__ g_prev, T* __restrict__ s_out,
                T* __restrict__ g_out, Params<T> p, T dt, T gk, T zk) {
  p = options<Opt>(p);
  constexpr bool WX = X == Axis::kBounded, WY = Y == Axis::kBounded;
  int i, j;
  size_t c, co;
  if (!update_point(p, i, j, c, co)) return;
  const size_t n = static_cast<size_t>(p.nx) * p.ny;
  auto ld = [&](const T* a, int ii, int jj) {
    return a[static_cast<size_t>(ii) * p.ny + jj];
  };
  auto at = [&](const T* a, int di, int dj) {
    return ld(a, sh<X>(i, di, p.nx), sh<Y>(j, dj, p.ny));
  };
  const bool last_x = WX && i == p.nx - 1;
  const bool last_y = WY && j == p.ny - 1;
  const T* h = s;
  const T* u = s + n;
  const T* v = s + 2 * n;
  const T* A = s + 3 * n;
  const T* Uf = tmp + kUf * n;
  const T* Vf = tmp + kVf * n;
  const T* fx = tmp + kFx * n;
  const T* fy = tmp + kFy * n;
  const T* zeta = tmp + kZeta * n;
  const T* uff = tmp + kUff * n;
  const T* vff = tmp + kVff * n;
  const T* KB = tmp + kKB * n;
  const T* dAdx = tmp + kDAdx * n;
  const T* dAdy = tmp + kDAdy * n;
  const T* Bx = tmp + kBx * n;
  const T* By = tmp + kBy * n;
  const T h0 = h[c];

  // mass; a bounded axis has no flux through its far wall
  const T Vf0 = Vf[c], Vf_jp = at(Vf, 0, 1);
  const T Uf_up = last_x ? T(0) : at(Uf, 1, 0);
  const T Vf_up = last_y ? T(0) : Vf_jp;
  const T divU = (Uf_up - Uf[c]) / p.dx + (Vf_up - Vf0) / p.dy;
  const T Gh = -divU;

  // vorticity flux, with the transverse velocities ℑxyᶠᶜv and ℑxyᶜᶠu:
  // the u-equation's along y onto (f,c), the v-equation's along x onto
  // (c,f)
  const T v_hat = T(0.5) * (T(0.5) * (at(v, 0, 1) + v[c])
                            + T(0.5) * (at(v, -1, 1) + at(v, -1, 0)));
  const T u_hat = T(0.5) * (at(uff, 1, 0) + uff[c]);
  T vort_u, vort_v;
  if (p.momentum == kCentered2) {
    // ℑyᶜ(ζ ℑxᶠv), −ℑxᶜ(ζ ℑyᶠu)
    vort_u = T(0.5) * (at(zeta, 0, 1) * at(vff, 0, 1) + zeta[c] * vff[c]);
    vort_v = -(T(0.5) * (at(zeta, 1, 0) * at(uff, 1, 0) + zeta[c] * uff[c]));
  } else {
    T zl, zr;
    vorticity_recon<Y, WY>(
        p, [&](int t, int jj) { return ld(tmp + t * n, i, jj); }, j, p.ny,
        zl, zr);
    vort_u = upwind(v_hat, zl, zr);
    vorticity_recon<X, WX>(
        p, [&](int t, int ii) { return ld(tmp + t * n, ii, j); }, i, p.nx,
        zl, zr);
    vort_v = -upwind(u_hat, zl, zr);
  }

  // Bernoulli gradient and Coriolis
  const T KB0 = KB[c];
  T Gu = vort_u - (KB0 - at(KB, -1, 0)) / p.dx;
  T Gv = vort_v - (KB0 - at(KB, 0, -1)) / p.dy;
  Gu = Gu + p.f * v_hat;
  Gv = Gv + (-p.f) * u_hat;

  // tracer, hA-flux form, with the background-gradient source
  const T fx_up = last_x ? T(0) : at(fx, 1, 0);
  const T fy_up = last_y ? T(0) : at(fy, 0, 1);
  const T div_flux = (fx_up - fx[c]) / p.dx + (fy_up - fy[c]) / p.dy;
  T GA = (A[c] * divU - div_flux) / h0;
  if (p.gam_bg != T(0)) GA = GA - p.gam_bg * (T(0.5) * (Vf_jp + Vf0)) / h0;

  add_closure<X, Y>(p, u, v, A, tmp + kLu * n, tmp + kLv * n, tmp + kLA * n,
                    i, j, Gu, Gv, GA);

  // jacobian Lorentz force; ∂yᶠBx at j+1 and ∂xᶠBy at i+1 are clamped
  const T Bx0 = Bx[c], Bx_im = at(Bx, -1, 0);
  const T dyBx = (Bx0 - at(Bx, 0, -1)) / p.dy;
  const T dyBx_jp = last_y ? dyBx : (at(Bx, 0, 1) - Bx0) / p.dy;
  const T dyBx_c = T(0.5) * (dyBx_jp + dyBx);
  const T dyBx_im = (Bx_im - at(Bx, -1, -1)) / p.dy;
  const T dyBx_imjp = last_y ? dyBx_im : (at(Bx, -1, 1) - Bx_im) / p.dy;
  const T dyBx_m = T(0.5) * (dyBx_imjp + dyBx_im);
  const T dAdy0 = dAdy[c];
  const T iDAdy = T(0.5) * (T(0.5) * (at(dAdy, 0, 1) + dAdy0)
                            + T(0.5) * (at(dAdy, -1, 1) + at(dAdy, -1, 0)));
  const T jac_x = dAdx[c] * (T(0.5) * (dyBx_c + dyBx_m))
                  - iDAdy * ((Bx0 - Bx_im) / p.dx);

  const T By0 = By[c], By_jm = at(By, 0, -1);
  const T dxBy_c = T(0.5) * ((By0 - at(By, -1, 0)) / p.dx
                             + (By_jm - at(By, -1, -1)) / p.dx);
  const T dxBy_p = last_x ? dxBy_c
                          : T(0.5) * ((at(By, 1, 0) - By0) / p.dx
                                      + (at(By, 1, -1) - By_jm) / p.dx);
  const T iDAdx = T(0.5) * (T(0.5) * (at(dAdx, 1, 0) + at(dAdx, 1, -1))
                            + T(0.5) * (dAdx[c] + at(dAdx, 0, -1)));
  const T jac_y = iDAdx * ((By0 - By_jm) / p.dy)
                  - dAdy0 * (T(0.5) * (dxBy_p + dxBy_c));

  Gu = Gu + jac_x / (T(0.5) * (h0 + at(h, -1, 0)));
  Gv = Gv + jac_y / (T(0.5) * (h0 + at(h, 0, -1)));

  mask_and_update<WX, WY>(Gh, Gu, Gv, GA, i, j, c, co, p, s, g_prev, s_out,
                          g_out, dt, gk, zk);
}

template <bool Opt>
struct Run {
  template <typename T, Axis X, Axis Y>
  static cudaError_t go(const Launch<T>& a) {
    const dim3 block = block_dims();
    face_fluxes<T, X, Y, Opt><<<grid_dims(a.p.nx, a.p.ny), block, 0,
                                a.stream>>>(a.s_in, a.tmp, a.p);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    tendency_update<T, X, Y, Opt><<<grid_dims(a.p.nx - 2 * a.p.hx,
                                              a.p.ny - 2 * a.p.hy),
                                    block, 0, a.stream>>>(
        a.s_in, a.tmp, a.g_prev, a.s_out, a.g_out, a.p, a.dt, a.gk, a.zk);
    return cudaGetLastError();
  }
};

}  // namespace

template <typename T>
cudaError_t launch_vector_invariant(const Launch<T>& a) {
  const Params<T>& p = a.p;
  const bool opt = p.closure != kNoClosure || p.momentum != kWeno5
                   || p.mass != kWeno5 || p.tracer != kWeno5
                   || p.stencil != kVelocityStencil;
  return opt ? dispatch_axes<Run<true>>(a) : dispatch_axes<Run<false>>(a);
}

template cudaError_t launch_vector_invariant<float>(const Launch<float>&);
template cudaError_t launch_vector_invariant<double>(const Launch<double>&);

}  // namespace swmhd

// One Le–Moin RK3 substage of the vector-invariant shallow-water MHD model
// (WENO5-Z mass/tracer/vorticity reconstruction with VelocityStencil
// weights, Bernoulli gradient, f-plane Coriolis, hA-conservative tracer with
// a linear background gradient, jacobian-form Lorentz force), for a grid
// that is periodic in both axes, written by hand for Hopper (sm_90a).
//
// Replaces the two Pallas TPU kernels of swmhd_tpu/ops/fused_step.py:
//   - build_fused_calls / fused_step_fn (one windowed substage per launch)
//     -> swmhd_substage_{f32,f64};
//   - resident_step_fn (3·n substages in one launch, state resident in
//     on-chip memory) -> swmhd_multistep_{f32,f64}.
// Both TPU kernels evaluate the same arithmetic; what differed was how the
// TPU kept data on chip, and neither layout carries over: a 128² state with
// its G and temporaries exceeds one SM's 227 KB of shared memory, and the
// TPU's full-row windows, 8-row halo and 128-lane rules are alignment rules
// of that compiler, not of the scheme.
//
// What bounds it on this card. One substage costs about 1074 flop per
// point in fp32 on the CUDA cores (the analytic count in PERFORMANCE.md),
// against the bytes this first cut moves through device memory per point:
// face_fluxes reads the 4 state fields and writes 12 intermediates,
// tendency_update reads the 12 intermediates, the state and G_prev and
// writes the state and G, about 44 words (176 B in fp32) per point and
// substage when neighbour reads hit L1/L2. That is about 6 flop/B, under
// the card's fp32 balance of about 20 flop/B (67 TFLOP/s over 3.35 TB/s),
// so the split is bound by memory traffic by design. Fusing the two
// kernels into one shared-memory tile with a halo of 6 moves only the
// state, G_prev, the new state and G (16 words per point) and is the
// performance work that follows this cut.
//
// Design. Two __global__ kernels pass intermediates through device memory;
// no shared memory; blocks of 32 threads along y (the contiguous axis) by
// 8 along x, so a warp reads 32 neighbouring words; neighbour reads wrap
// periodically without a negative modulo. Expressions keep the operation
// order of the PyTorch version, including the upwind select
// 0.5·((ũ+|ũ|)ψᴸ + (ũ−|ũ|)ψᴿ) as arithmetic rather than a branch. fp32
// rescales the WENO smoothness indicators by a power of two read off the
// exponent bits (clamped at 2^-126), so a constant field gives finite
// weights; fp64 skips that step, as the reference does.
//
// swmhd_multistep runs its substages as a loop of launches on the caller's
// stream, with ping-pong buffers the caller allocates: this stands in for
// the TPU kernel's on-chip residency, which does not fit an SM. A
// persistent cooperative kernel, or a thread-block cluster holding a 128²
// state in distributed shared memory, is later work to be measured
// against this loop.
//
// Layout: every field is (Nx, Ny) row-major, index i*Ny + j, i along x.
// Face i is the left edge of cell i. Each entry point returns
// cudaGetLastError() after its launches.

#include <cuda_runtime.h>

#include <cstddef>
#include <type_traits>

namespace {

constexpr int kBlockY = 32;
constexpr int kBlockX = 8;

// Intermediates written by face_fluxes, in this order, each (Nx, Ny).
enum Tmp {
  kUf, kVf,        // mass fluxes u·h̃ at (f,c), v·h̃ at (c,f)
  kFx, kFy,        // tracer fluxes Uf·Ã, Vf·Ã
  kZeta,           // ζ = ∂x v − ∂y u at (f,f)
  kUff, kVff,      // ℑyᶠu, ℑxᶠv at (f,f)
  kKB,             // K + g h at (c,c)
  kDAdx, kDAdy,    // ∂xᶠA at (f,c), ∂yᶠA + γ at (c,f)
  kBx, kBy,        // B at (c,c)
  kNumTmp
};

template <typename T>
struct Params {
  int nx, ny;
  T dx, dy, g, f, gam_bg;
};

__device__ __forceinline__ int wrap(int i, int n) {
  return i < 0 ? i + n : (i >= n ? i - n : i);
}

template <typename T>
__device__ __forceinline__ T sq(T x) { return x * x; }

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

template <typename T>
__device__ __forceinline__ void cands_left(T cm3, T cm2, T cm1, T c0, T cp1,
                                           T& p0, T& p1, T& p2) {
  p0 = (T(2) * cm3 - T(7) * cm2 + T(11) * cm1) / T(6);
  p1 = (-cm2 + T(5) * cm1 + T(2) * c0) / T(6);
  p2 = (T(2) * cm1 + T(5) * c0 - cp1) / T(6);
}

template <typename T>
__device__ __forceinline__ void cands_right(T cm2, T cm1, T c0, T cp1, T cp2,
                                            T& p0, T& p1, T& p2) {
  p0 = (T(2) * cp2 - T(7) * cp1 + T(11) * c0) / T(6);
  p1 = (-cp1 + T(5) * c0 + T(2) * cm1) / T(6);
  p2 = (T(2) * c0 + T(5) * cm1 - cm2) / T(6);
}

// WENO-Z weights in the divide-free rational form, eps = 1e-8,
// linear weights (0.1, 0.6, 0.3).
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
template <typename T>
__device__ __forceinline__ void weno_pair(const T* c, T& left, T& right) {
  T b0, b1, b2, r0, r1, r2, p0, p1, p2;
  betas_left(c[0], c[1], c[2], c[3], c[4], b0, b1, b2);
  cands_left(c[0], c[1], c[2], c[3], c[4], p0, p1, p2);
  left = weno_combine(p0, p1, p2, b0, b1, b2);
  betas_left(c[1], c[2], c[3], c[4], c[5], r0, r1, r2);
  cands_right(c[1], c[2], c[3], c[4], c[5], p0, p1, p2);
  right = weno_combine(p0, p1, p2, r2, r1, r0);
}

// VelocityStencil reconstruction of ζ onto the flux point from windows
// z[k], uf[k], vf[k] = value at offset k - 2 (k = 0..5) along the
// reconstruction axis: candidates from ζ, weights from the averaged betas
// of ℑu and ℑv at (f,f).
template <typename T>
__device__ __forceinline__ void vorticity_pair(const T* z, const T* uf,
                                               const T* vf, T& zl, T& zr) {
  T ua0, ua1, ua2, va0, va1, va2, ub0, ub1, ub2, vb0, vb1, vb2;
  betas_left(uf[0], uf[1], uf[2], uf[3], uf[4], ua0, ua1, ua2);
  betas_left(vf[0], vf[1], vf[2], vf[3], vf[4], va0, va1, va2);
  betas_left(uf[1], uf[2], uf[3], uf[4], uf[5], ub0, ub1, ub2);
  betas_left(vf[1], vf[2], vf[3], vf[4], vf[5], vb0, vb1, vb2);
  T p0, p1, p2;
  cands_left(z[0], z[1], z[2], z[3], z[4], p0, p1, p2);
  zl = weno_combine(p0, p1, p2, T(0.5) * (ua0 + va0), T(0.5) * (ua1 + va1),
                    T(0.5) * (ua2 + va2));
  cands_right(z[1], z[2], z[3], z[4], z[5], p0, p1, p2);
  zr = weno_combine(p0, p1, p2, T(0.5) * (ub2 + vb2), T(0.5) * (ub1 + vb1),
                    T(0.5) * (ub0 + vb0));
}

template <typename T>
__global__ void __launch_bounds__(kBlockX * kBlockY)
face_fluxes(const T* __restrict__ s, T* __restrict__ tmp, Params<T> p) {
  const int j = blockIdx.x * kBlockY + threadIdx.x;
  const int i = blockIdx.y * kBlockX + threadIdx.y;
  if (i >= p.nx || j >= p.ny) return;
  const size_t n = static_cast<size_t>(p.nx) * p.ny;
  const T* h = s;
  const T* u = s + n;
  const T* v = s + 2 * n;
  const T* A = s + 3 * n;
  auto at = [&](const T* a, int di, int dj) {
    return a[static_cast<size_t>(wrap(i + di, p.nx)) * p.ny
             + wrap(j + dj, p.ny)];
  };
  const size_t c = static_cast<size_t>(i) * p.ny + j;

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
  weno_pair(hx, l, r);
  const T Uf = upwind(u0, l, r);
  weno_pair(hy, l, r);
  const T Vf = upwind(v0, l, r);
  weno_pair(ax, l, r);
  const T fx = upwind(Uf, l, r);
  weno_pair(ay, l, r);
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

  const T dAdx = (ax[3] - ax[2]) / p.dx;
  const T dAdx_ip = (ax[4] - ax[3]) / p.dx;
  const T dAdy = (ay[3] - ay[2]) / p.dy + p.gam_bg;
  const T dAdy_jp = (ay[4] - ay[3]) / p.dy + p.gam_bg;
  const T Bx = -(T(0.5) * (dAdy_jp + dAdy)) / h0;
  const T By = T(0.5) * (dAdx_ip + dAdx) / h0;

  const T out[kNumTmp] = {Uf, Vf, fx, fy, zeta, u_ff, v_ff, KB,
                          dAdx, dAdy, Bx, By};
#pragma unroll
  for (int k = 0; k < kNumTmp; ++k) tmp[k * n + c] = out[k];
}

template <typename T>
__global__ void __launch_bounds__(kBlockX * kBlockY)
tendency_update(const T* __restrict__ s, const T* __restrict__ tmp,
                const T* __restrict__ g_prev, T* __restrict__ s_out,
                T* __restrict__ g_out, Params<T> p, T dt, T gk, T zk) {
  const int j = blockIdx.x * kBlockY + threadIdx.x;
  const int i = blockIdx.y * kBlockX + threadIdx.y;
  if (i >= p.nx || j >= p.ny) return;
  const size_t n = static_cast<size_t>(p.nx) * p.ny;
  auto at = [&](const T* a, int di, int dj) {
    return a[static_cast<size_t>(wrap(i + di, p.nx)) * p.ny
             + wrap(j + dj, p.ny)];
  };
  const size_t c = static_cast<size_t>(i) * p.ny + j;
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

  // mass
  const T Vf0 = Vf[c], Vf_jp = at(Vf, 0, 1);
  const T divU = (at(Uf, 1, 0) - Uf[c]) / p.dx + (Vf_jp - Vf0) / p.dy;
  const T Gh = -divU;

  // vorticity flux: u-equation along y, onto (f,c) — the window of the
  // reconstruction at j is ζ(j-2 .. j+3), the face form shifted by one
  T z[6], uw[6], vw[6];
#pragma unroll
  for (int k = 0; k < 6; ++k) {
    z[k] = at(zeta, 0, k - 2);
    uw[k] = at(uff, 0, k - 2);
    vw[k] = at(vff, 0, k - 2);
  }
  T zl, zr;
  vorticity_pair(z, uw, vw, zl, zr);
  const T v_hat = T(0.5) * (T(0.5) * (at(v, 0, 1) + v[c])
                            + T(0.5) * (at(v, -1, 1) + at(v, -1, 0)));
  const T vort_u = upwind(v_hat, zl, zr);

  // v-equation along x, onto (c,f)
#pragma unroll
  for (int k = 0; k < 6; ++k) {
    z[k] = at(zeta, k - 2, 0);
    uw[k] = at(uff, k - 2, 0);
    vw[k] = at(vff, k - 2, 0);
  }
  vorticity_pair(z, uw, vw, zl, zr);
  const T u_hat = T(0.5) * (uw[3] + uw[2]);
  const T vort_v = -upwind(u_hat, zl, zr);

  // Bernoulli gradient and Coriolis
  const T KB0 = KB[c];
  T Gu = vort_u - (KB0 - at(KB, -1, 0)) / p.dx;
  T Gv = vort_v - (KB0 - at(KB, 0, -1)) / p.dy;
  Gu = Gu + p.f * v_hat;
  Gv = Gv + (-p.f) * u_hat;

  // tracer, hA-flux form, with the background-gradient source
  const T div_flux = (at(fx, 1, 0) - fx[c]) / p.dx
                     + (at(fy, 0, 1) - fy[c]) / p.dy;
  T GA = (A[c] * divU - div_flux) / h0;
  if (p.gam_bg != T(0)) GA = GA - p.gam_bg * (T(0.5) * (Vf_jp + Vf0)) / h0;

  // jacobian Lorentz force
  const T Bx0 = Bx[c], Bx_im = at(Bx, -1, 0);
  const T dyBx_c = T(0.5) * ((at(Bx, 0, 1) - Bx0) / p.dy
                             + (Bx0 - at(Bx, 0, -1)) / p.dy);
  const T dyBx_m = T(0.5) * ((at(Bx, -1, 1) - Bx_im) / p.dy
                             + (Bx_im - at(Bx, -1, -1)) / p.dy);
  const T dAdy0 = dAdy[c];
  const T iDAdy = T(0.5) * (T(0.5) * (at(dAdy, 0, 1) + dAdy0)
                            + T(0.5) * (at(dAdy, -1, 1) + at(dAdy, -1, 0)));
  const T jac_x = dAdx[c] * (T(0.5) * (dyBx_c + dyBx_m))
                  - iDAdy * ((Bx0 - Bx_im) / p.dx);

  const T By0 = By[c], By_jm = at(By, 0, -1);
  const T dxBy_c = T(0.5) * ((By0 - at(By, -1, 0)) / p.dx
                             + (By_jm - at(By, -1, -1)) / p.dx);
  const T dxBy_p = T(0.5) * ((at(By, 1, 0) - By0) / p.dx
                             + (at(By, 1, -1) - By_jm) / p.dx);
  const T iDAdx = T(0.5) * (T(0.5) * (at(dAdx, 1, 0) + at(dAdx, 1, -1))
                            + T(0.5) * (dAdx[c] + at(dAdx, 0, -1)));
  const T jac_y = iDAdx * ((By0 - By_jm) / p.dy)
                  - dAdy0 * (T(0.5) * (dxBy_p + dxBy_c));

  Gu = Gu + jac_x / (T(0.5) * (h0 + at(h, -1, 0)));
  Gv = Gv + jac_y / (T(0.5) * (h0 + at(h, 0, -1)));

  // Le–Moin update s' = s + dt (γ G + ζ G_prev)
  const T G[4] = {Gh, Gu, Gv, GA};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const size_t o = k * n + c;
    const T inc = g_prev ? gk * G[k] + zk * g_prev[o] : gk * G[k];
    s_out[o] = s[o] + dt * inc;
    if (g_out) g_out[o] = G[k];
  }
}

template <typename T>
Params<T> make_params(int nx, int ny, double dx, double dy, double g,
                      double f, double gam_bg) {
  return Params<T>{nx, ny, T(dx), T(dy), T(g), T(f), T(gam_bg)};
}

template <typename T>
cudaError_t launch_substage(const T* s_in, const T* g_prev, T* s_out,
                            T* g_out, T* tmp, const Params<T>& p, double dt,
                            double gk, double zk, cudaStream_t stream) {
  const dim3 block(kBlockY, kBlockX);
  const dim3 grid((p.ny + kBlockY - 1) / kBlockY,
                  (p.nx + kBlockX - 1) / kBlockX);
  face_fluxes<T><<<grid, block, 0, stream>>>(s_in, tmp, p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  tendency_update<T><<<grid, block, 0, stream>>>(
      s_in, tmp, g_prev, s_out, g_out, p, T(dt), T(gk), T(zk));
  return cudaGetLastError();
}

// Le–Moin coefficients (γ_k, ζ_k).
constexpr double kRkGamma[3] = {8.0 / 15.0, 5.0 / 12.0, 3.0 / 4.0};
constexpr double kRkZeta[3] = {0.0, -17.0 / 60.0, -5.0 / 12.0};

// n_steps RK3 steps: substage m reads the previous substage's output (the
// input state for m = 0) and writes `out` or `work`, alternating so that
// the last substage lands in `out`; `in` is never written. G of stage 0
// goes to gbuf[0], G of stage 1 to gbuf[1].
template <typename T>
cudaError_t launch_multistep(const T* in, T* out, T* work, T* gbuf, T* tmp,
                             const Params<T>& p, double dt, int n_steps,
                             cudaStream_t stream) {
  const size_t n4 = 4 * static_cast<size_t>(p.nx) * p.ny;
  const int total = 3 * n_steps;
  const T* src = in;
  for (int m = 0; m < total; ++m) {
    const int stage = m % 3;
    T* dst = ((total - 1 - m) % 2 == 0) ? out : work;
    const T* gp = stage == 0 ? nullptr : gbuf + (stage - 1) * n4;
    T* go = stage == 2 ? nullptr : gbuf + stage * n4;
    const cudaError_t err = launch_substage<T>(
        src, gp, dst, go, tmp, p, dt, kRkGamma[stage], kRkZeta[stage], stream);
    if (err != cudaSuccess) return err;
    src = dst;
  }
  return cudaSuccess;
}

}  // namespace

#define SWMHD_ENTRY_POINTS(T, SUFFIX)                                        \
  extern "C" int swmhd_substage_##SUFFIX(                                    \
      const T* s_in, const T* g_prev, T* s_out, T* g_out, T* tmp, int nx,    \
      int ny, double dx, double dy, double g, double f, double gam_bg,       \
      double dt, double gk, double zk, void* stream) {                       \
    return static_cast<int>(launch_substage<T>(                              \
        s_in, g_prev, s_out, g_out, tmp,                                     \
        make_params<T>(nx, ny, dx, dy, g, f, gam_bg), dt, gk, zk,            \
        static_cast<cudaStream_t>(stream)));                                 \
  }                                                                          \
  extern "C" int swmhd_multistep_##SUFFIX(                                   \
      const T* s_in, T* s_out, T* work, T* gbuf, T* tmp, int nx, int ny,     \
      double dx, double dy, double g, double f, double gam_bg, double dt,    \
      int n_steps, void* stream) {                                           \
    return static_cast<int>(launch_multistep<T>(                             \
        s_in, s_out, work, gbuf, tmp,                                        \
        make_params<T>(nx, ny, dx, dy, g, f, gam_bg), dt, n_steps,           \
        static_cast<cudaStream_t>(stream)));                                 \
  }

SWMHD_ENTRY_POINTS(float, f32)
SWMHD_ENTRY_POINTS(double, f64)

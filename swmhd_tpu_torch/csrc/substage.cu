// One Le–Moin RK3 substage of the shallow-water MHD model, in either
// formulation and for any pair of periodic/bounded axes, with any of the
// model's advection schemes, vorticity stencils and closures, written by
// hand for Hopper (sm_90a): the entry points. The vector-invariant
// substage (vorticity flux, jacobian Lorentz force) is one kernel over 2-D
// tiles in vi_tile.cuh, instantiated in vector_invariant.cu (float) and
// vector_invariant_f64.cu (double); the conservative one (flux-form
// momentum, divergence-form Lorentz force) is conservative.cu; shared
// pieces (reconstructions, Laplacians) in substage.cuh.
//
// Replaces three Pallas TPU kernels:
//   - build_fused_calls / fused_step_fn of swmhd_tpu/ops/fused_step.py
//     (one windowed substage per launch) -> swmhd_substage_{f32,f64} with
//     no halo;
//   - resident_step_fn of the same file (3·n substages in one launch,
//     state resident in on-chip memory) -> swmhd_multistep_{f32,f64};
//   - DomainDecomposition.fused_step_fn of
//     swmhd_tpu/parallel/decomposition.py (the windowed substage on each
//     tile of a decomposed domain, padded with a halo exchanged from its
//     neighbours) -> swmhd_substage_{f32,f64} with a halo.
// Both TPU kernels evaluate the same arithmetic; what differed was how the
// TPU kept data on chip, and neither layout carries over: a 128² state with
// its G and temporaries exceeds one SM's 227 KB of shared memory, and the
// TPU's full-row windows, 8-row halo and 128-lane rules are alignment rules
// of that compiler, not of the scheme.
//
// What bounds it on this card. One substage costs about 1100 fp32
// operations per point on the CUDA cores against 16 words of state,
// G_prev, new state and G that it must move: operations. The
// vector-invariant kernel keeps its intermediates in shared memory over
// 2-D tiles (vi_tile.cuh says how). The conservative substage is still
// three kernels passing 16 intermediates through device memory (about 52
// words a point, 19 with a biharmonic closure's three inner Laplacians),
// blocks of 32 threads along y (the contiguous axis) by 8 along x; moving
// it onto the tile machinery of vi_tile.cuh is the work that follows.
//
// Each kernel is templated on the value type and on each axis' mode
// (substage.cuh), so the periodic code carries no wall logic; neighbour
// reads wrap (periodic), clamp (bounded) or go into the halo (exchanged).
// The advection schemes, the vorticity stencil and the closure are fields
// of Params, the same for every thread of a launch, so a branch on them
// never diverges a warp. The conservative kernels read them at run time
// for every model. The vector-invariant kernel is also templated on Opt:
// the default model (no closure, WENO5, VelocityStencil) runs it without,
// where those fields are constants, any other model with it; read at run
// time in every model, they had made the default step 12% longer on the
// card (PERF.md). Expressions keep the operation order of the PyTorch
// version. A tile matches the whole-grid kernel bit for bit as long as
// nvcc contracts multiplies and adds into fmas alike in both
// instantiations; the card's tile tests check that.
//
// swmhd_multistep runs its substages as a loop of launches on the caller's
// stream, with ping-pong buffers the caller allocates: this stands in for
// the TPU kernel's on-chip residency, which does not fit an SM. A
// persistent cooperative kernel, or a thread-block cluster holding a 128²
// state in distributed shared memory, is later work to be measured
// against this loop.
//
// With a halo, swmhd_substage runs the same kernels on a tile padded by
// (hx, hy) cells, each padded axis in the exchanged mode (substage.cuh):
// every unpadded point runs the expressions of the whole-domain substage
// in the same order and matches it bit for bit. The TPU kernel's 8-row
// halo and 128-lane y pad were alignment rules of that compiler; here any
// halo of at least the composed radius (3 vector-invariant, 4
// conservative) works; the decomposition pads by the model's
// exchange_halo, 6 (7 with a biharmonic closure).
//
// Each entry point returns cudaGetLastError() after its launches.

#include "substage.cuh"

namespace swmhd {
namespace {

// nx, ny: the unpadded extents; the arrays the first kernels read are
// (nx + 2hx, ny + 2hy).
template <typename T>
Params<T> make_params(int nx, int ny, int hx, int hy, int mode_x,
                      int mode_y, int closure, int momentum, int mass,
                      int tracer, int stencil, double dx, double dy,
                      double g, double f, double gam_bg, double nu,
                      double kappa) {
  return Params<T>{nx + 2 * hx, ny + 2 * hy, hx, hy, mode_x, mode_y,
                   closure, momentum, mass, tracer, stencil,
                   T(dx), T(dy), T(g), T(f), T(gam_bg), T(dx * dy),
                   T(nu), T(kappa)};
}

template <typename T>
cudaError_t launch_substage(const Launch<T>& a, int conservative) {
  return conservative ? launch_conservative<T>(a)
                      : launch_vector_invariant<T>(a);
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
                             const Params<T>& p, int conservative, double dt,
                             int n_steps, int tile_x, cudaStream_t stream) {
  const size_t n4 = 4 * static_cast<size_t>(p.nx) * p.ny;
  const int total = 3 * n_steps;
  const T* src = in;
  for (int m = 0; m < total; ++m) {
    const int stage = m % 3;
    T* dst = ((total - 1 - m) % 2 == 0) ? out : work;
    const Launch<T> a{src, stage == 0 ? nullptr : gbuf + (stage - 1) * n4,
                      dst, stage == 2 ? nullptr : gbuf + stage * n4, tmp, p,
                      T(dt), T(kRkGamma[stage]), T(kRkZeta[stage]), tile_x,
                      stream};
    const cudaError_t err = launch_substage<T>(a, conservative);
    if (err != cudaSuccess) return err;
    src = dst;
  }
  return cudaSuccess;
}

}  // namespace
}  // namespace swmhd

// closure, momentum, mass, tracer, stencil: the Closure, Scheme and
// Stencil ids of substage.cuh; tile_x: the rows of the vector-invariant
// kernel's tiles (ops/substage.py vi_tile_shape; the conservative kernels
// ignore it); nu, kappa: the closure's diffusivities. tmp: the
// conservative kernels' intermediates (null for the vector-invariant
// formulation).
#define SWMHD_ENTRY_POINTS(T, SUFFIX)                                        \
  extern "C" int swmhd_substage_##SUFFIX(                                    \
      const T* s_in, const T* g_prev, T* s_out, T* g_out, T* tmp, int nx,    \
      int ny, int hx, int hy, int conservative, int mode_x, int mode_y,      \
      int closure, int momentum, int mass, int tracer, int stencil,          \
      int tile_x, double dx, double dy, double g, double f, double gam_bg,   \
      double nu, double kappa, double dt, double gk, double zk,              \
      void* stream) {                                                        \
    const swmhd::Launch<T> a{                                                \
        s_in, g_prev, s_out, g_out, tmp,                                     \
        swmhd::make_params<T>(nx, ny, hx, hy, mode_x, mode_y, closure,       \
                              momentum, mass, tracer, stencil, dx, dy, g, f, \
                              gam_bg, nu, kappa),                            \
        T(dt), T(gk), T(zk), tile_x, static_cast<cudaStream_t>(stream)};     \
    return static_cast<int>(swmhd::launch_substage<T>(a, conservative));     \
  }                                                                          \
  extern "C" int swmhd_multistep_##SUFFIX(                                   \
      const T* s_in, T* s_out, T* work, T* gbuf, T* tmp, int nx, int ny,     \
      int conservative, int wall_x, int wall_y, int closure, int momentum,   \
      int mass, int tracer, int stencil, int tile_x, double dx, double dy,   \
      double g, double f, double gam_bg, double nu, double kappa, double dt, \
      int n_steps, void* stream) {                                           \
    return static_cast<int>(swmhd::launch_multistep<T>(                      \
        s_in, s_out, work, gbuf, tmp,                                        \
        swmhd::make_params<T>(nx, ny, 0, 0, wall_x, wall_y, closure,         \
                              momentum, mass, tracer, stencil, dx, dy, g, f, \
                              gam_bg, nu, kappa),                            \
        conservative, dt, n_steps, tile_x,                                   \
        static_cast<cudaStream_t>(stream)));                                 \
  }

SWMHD_ENTRY_POINTS(float, f32)
SWMHD_ENTRY_POINTS(double, f64)

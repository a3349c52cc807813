// One Le–Moin RK3 substage of the shallow-water MHD model, in either
// formulation and for any pair of periodic/bounded axes, with any of the
// model's advection schemes, vorticity stencils and closures, written by
// hand for Hopper (sm_90a): the entry points. Each formulation's substage
// is one kernel over 2-D tiles in shared memory: the vector-invariant one
// (vorticity flux, jacobian Lorentz force) in vi_tile.cuh, instantiated in
// vector_invariant.cu (float) and vector_invariant_f64.cu (double); the
// conservative one (flux-form momentum, divergence-form Lorentz force) in
// cons_tile.cuh, instantiated in conservative.cu and conservative_f64.cu;
// each formulation's resident kernel (n steps in one launch) instantiated
// in vi_resident.cu, cons_resident.cu and their _f64 twins; shared pieces
// in tile.cuh (index maps, region loops, window loads,
// launches) and substage.cuh (parameters, reconstructions).
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
// What bounds it on this card. One substage costs about 1000–1100 fp32
// operations per point on the CUDA cores against 16 words of state,
// G_prev, new state and G that it must move: operations. Both kernels
// keep their intermediates in shared memory over 2-D tiles of (TX, 32)
// points, TX chosen by the wrapper (ops/substage.py tile_shape), and fuse
// the Le–Moin update (vi_tile.cuh and cons_tile.cuh say how).
//
// Each kernel is templated on the value type and on each axis' mode
// (substage.cuh), so the periodic code carries no wall logic; neighbour
// reads wrap (periodic), clamp (bounded) or go into the halo (exchanged).
// The advection schemes, the vorticity stencil and the closure are fields
// of Params, the same for every thread of a launch, so a branch on them
// never diverges a warp. Each kernel is also templated on Opt: the default
// model (no closure, WENO5 everywhere, VelocityStencil) runs it without,
// where those fields are constants, any other model with it (PERF.md §6
// has what each choice measured). Expressions keep the operation order of
// the PyTorch version. A tile matches the whole-grid kernel bit for bit as
// long as nvcc contracts multiplies and adds into fmas alike in both
// instantiations; the card's tile tests check that.
//
// swmhd_multistep runs its 3·n substages in one cooperative launch of the
// formulation's resident kernel (vi_resident, cons_resident: the same
// tile body as the one-substage kernel, in vi_tile.cuh and cons_tile.cuh):
// a grid of every block the card holds at once, at most one a tile, each
// block walking its tiles with a stride of the grid, a grid barrier
// between substages (tile.cuh resident_substages). The state is not held
// on chip: it ping-pongs between two buffers the caller allocates, with G
// in two more, 16 words a point, which at 128² (1 MB in f32, 2 MB in f64)
// stay in the 50 MB L2 between substages, the counterpart of the TPU
// kernel's VMEM residency; at 2048² they do not, and the kernel is a
// persistent form of one launch a substage. It computes what 3·n
// swmhd_substage launches compute, the same expressions in the same
// order. A grid the card refuses returns its error; there is no loop of
// launches to fall back on.
//
// With a halo, swmhd_substage runs the same kernel on a tile padded by
// (hx, hy) cells, each padded axis in the exchanged mode (substage.cuh):
// every unpadded point runs the expressions of the whole-domain substage
// in the same order and matches it bit for bit. The TPU kernel's 8-row
// halo and 128-lane y pad were alignment rules of that compiler; here any
// halo of at least the composed radius (3 vector-invariant, 4
// conservative) works; the decomposition pads by the model's
// exchange_halo, 6 (7 with a biharmonic closure).
//
// Given strides, a launch reads a slab of a padded tile and writes its
// region of whole-tile buffers in place: the decomposition's overlap
// split (parallel/decomposition.py split_substage) launches the interior
// on the unpadded tile, whose own outer ring serves as its halo, then a
// band on each exchanged edge, with no copy in or out. A point's
// arithmetic does not depend on the region, so the split is bit for bit
// the one launch on the padded tile.
//
// Each entry point returns the error of its launch.

#include "substage.cuh"

namespace swmhd {
namespace {

// nx, ny: the unpadded extents; the state the kernel reads is (nx + 2hx,
// ny + 2hy); all arrays contiguous.
template <typename T>
Params<T> make_params(int nx, int ny, int hx, int hy, int mode_x,
                      int mode_y, int closure, int momentum, int mass,
                      int tracer, int stencil, double dx, double dy,
                      double g, double f, double gam_bg, double nu,
                      double kappa) {
  const size_t px = nx + 2 * hx, py = ny + 2 * hy;
  return Params<T>{nx + 2 * hx, ny + 2 * hy, hx, hy, mode_x, mode_y,
                   closure, momentum, mass, tracer, stencil,
                   T(dx), T(dy), T(g), T(f), T(gam_bg), T(dx * dy),
                   T(nu), T(kappa), py, px * py, static_cast<size_t>(ny),
                   static_cast<size_t>(nx) * ny};
}

// Whether the strides of p leave the rows and fields of each array apart:
// no stride shorter than the extent it steps over.
template <typename T>
bool strides_ok(const Params<T>& p) {
  const size_t mx = p.nx - 2 * p.hx, my = p.ny - 2 * p.hy;
  return p.in_row >= static_cast<size_t>(p.ny)
         && p.in_plane >= p.in_row * (p.nx - 1) + p.ny
         && p.out_row >= my && p.out_plane >= p.out_row * (mx - 1) + my;
}

template <typename T>
cudaError_t launch_substage(const Launch<T>& a, int conservative) {
  return conservative ? launch_conservative<T>(a)
                      : launch_vector_invariant<T>(a);
}

template <typename T>
cudaError_t launch_resident_steps(const Resident<T>& a, int conservative) {
  return conservative ? launch_cons_resident<T>(a)
                      : launch_vi_resident<T>(a);
}

}  // namespace
}  // namespace swmhd

// nx, ny: the unpadded extents of the output; hx, hy: the halo the state
// carries around it; in_row, in_plane: the state's strides (a slab of a
// padded tile: every row and field of it with room for nx + 2hx rows of
// ny + 2hy values); out_row, out_plane: the strides of G_prev, s_out and
// g_out, the pointers the output region's first point (a region of a
// whole tile: substage.cuh Params). cudaErrorInvalidValue for strides
// shorter than the extents they step over.
// closure, momentum, mass, tracer, stencil: the Closure, Scheme and
// Stencil ids of substage.cuh; tile_x: the rows of the kernel's tiles
// (ops/substage.py tile_shape); nu, kappa: the closure's diffusivities;
// sms: the card's SMs (the resident grid).
// swmhd_tile_info: shared memory bytes a block, registers a thread and
// resident blocks an SM (tile.cuh tile_kernel_info) into out[0..2] for
// the kernel a launch of these arguments takes (opt: a model off the
// default's options; biharmonic: its closure); swmhd_resident_info the
// same for the resident kernel, with out[3] its grid over `tiles` tiles,
// and readies the kernel (shared memory limit, blocks an SM) so that a
// later launch, in a stream capture too, makes no runtime query.
#define SWMHD_ENTRY_POINTS(T, SUFFIX)                                        \
  extern "C" int swmhd_substage_##SUFFIX(                                    \
      const T* s_in, const T* g_prev, T* s_out, T* g_out, int nx, int ny,    \
      int hx, int hy, long long in_row, long long in_plane,                  \
      long long out_row, long long out_plane, int conservative, int mode_x,  \
      int mode_y, int closure, int momentum, int mass, int tracer,           \
      int stencil, int tile_x, double dx, double dy, double g, double f,     \
      double gam_bg, double nu, double kappa, double dt, double gk,          \
      double zk, void* stream) {                                             \
    swmhd::Params<T> p = swmhd::make_params<T>(                              \
        nx, ny, hx, hy, mode_x, mode_y, closure, momentum, mass, tracer,     \
        stencil, dx, dy, g, f, gam_bg, nu, kappa);                           \
    p.in_row = in_row;                                                       \
    p.in_plane = in_plane;                                                   \
    p.out_row = out_row;                                                     \
    p.out_plane = out_plane;                                                 \
    if (nx < 1 || ny < 1 || !swmhd::strides_ok(p)) {                         \
      return static_cast<int>(cudaErrorInvalidValue);                        \
    }                                                                        \
    const swmhd::Launch<T> a{s_in,  g_prev, s_out,  g_out,                   \
                             p,     T(dt),  T(gk),  T(zk),                   \
                             tile_x, static_cast<cudaStream_t>(stream)};     \
    return static_cast<int>(swmhd::launch_substage<T>(a, conservative));     \
  }                                                                          \
  extern "C" int swmhd_multistep_##SUFFIX(                                   \
      const T* s_in, T* s_out, T* work, T* gbuf, int nx, int ny,             \
      int conservative, int wall_x, int wall_y, int closure, int momentum,   \
      int mass, int tracer, int stencil, int tile_x, double dx, double dy,   \
      double g, double f, double gam_bg, double nu, double kappa, double dt, \
      int n_steps, int sms, void* stream) {                                  \
    const swmhd::Resident<T> a{                                              \
        s_in, s_out, work, gbuf,                                             \
        swmhd::make_params<T>(nx, ny, 0, 0, wall_x, wall_y, closure,         \
                              momentum, mass, tracer, stencil, dx, dy, g, f, \
                              gam_bg, nu, kappa),                            \
        T(dt), n_steps, tile_x, sms, static_cast<cudaStream_t>(stream)};     \
    return static_cast<int>(                                                 \
        swmhd::launch_resident_steps<T>(a, conservative));                   \
  }                                                                          \
  extern "C" int swmhd_resident_info_##SUFFIX(                               \
      int conservative, int mode_x, int mode_y, int opt, int tile_x,         \
      int biharmonic, int tiles, int sms, int* out) {                        \
    return conservative                                                      \
               ? swmhd::cons_resident_info<T>(mode_x, mode_y, opt, tile_x,   \
                                              tiles, sms, out)               \
               : swmhd::vi_resident_info<T>(mode_x, mode_y, opt, tile_x,     \
                                            biharmonic, tiles, sms, out);    \
  }                                                                          \
  extern "C" int swmhd_tile_info_##SUFFIX(int conservative, int mode_x,      \
                                          int mode_y, int opt, int tile_x,   \
                                          int biharmonic, int* out) {        \
    return conservative                                                      \
               ? swmhd::cons_tile_info<T>(mode_x, mode_y, opt, tile_x, out)  \
               : swmhd::vi_tile_info<T>(mode_x, mode_y, opt, tile_x,         \
                                        biharmonic, out);                    \
  }

SWMHD_ENTRY_POINTS(float, f32)
SWMHD_ENTRY_POINTS(double, f64)

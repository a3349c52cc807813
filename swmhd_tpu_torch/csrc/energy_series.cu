// The CLI's energy series of one state in one launch: kinetic, magnetic
// and potential energy, their total and the cross-helicity, the five
// values of swmhd_tpu_torch/cli.py energies (the plain version is
// ops/energies.py energy_series_reference), in float and double.
//
// Replaces no Pallas kernel: the JAX CLI keeps the same five values of
// diagnostics.energy_report under jax.jit, where XLA fuses them into the
// chunk it compiles. Run eagerly, or captured into the port's CUDA graphs
// (ops/substage.py GraphChunk), the plain version is some 77 PyTorch
// kernels a state (rolls, elementwise products, five reductions), 155 with
// a bounded axis (each shift an index_select over a torch.where index).
//
// What bounds it on this card. It reads h, u, v, A and the initial height
// h0 once, 20 B a point in float (a 128² state: 0.33 MB, which the step
// just wrote to L2; 2048²: 84 MB from device memory, 25 µs at 3.35 TB/s),
// and does some 60 operations a point: bytes at 2048²; at 128² the floor is
// the latency of one launch and of one reduction across blocks. So the
// design is about launches: one a state, no second pass, no host sync.
//
// Design. Each block takes a fixed band of rows (the wrapper's rows, from
// the grid's shape alone) and its threads walk the band's points; a point
// computes its four densities in the field type, with the discretisation
// and operation order of the plain version (the interpolations to centres,
// B at centres from A and the background gradient, for the conservative
// formulation the velocities uh / ℑxᶠh and vh / ℑyᶠh at the faces it
// reads), and adds them to sums in double. The block reduces its sums in a
// fixed order and writes them to the scratch; a ticket counter in the
// scratch picks the last block to finish, which adds the blocks' sums in
// block order, scales them to the integrals (mean · Lx · Ly), writes the
// five values in the field type and resets the ticket for the next launch.
// Every sum is taken in the same order each launch, so a launch is
// deterministic: eager calls and graph replays agree bit for bit. Launches
// that share a scratch must be ordered on one stream.
//
// Each axis wraps (periodic) or clamps at the walls (bounded), the axis
// modes of the substage kernels (substage.cuh Axis); the formulation and
// the two modes are template parameters of the kernel (energy_series.cuh).

#include "energy_series.cuh"

// h, u, v, A, h0: contiguous (nx, ny) fields (u, v the transports uh, vh
// when conservative); out: 5 values; scratch: 4 doubles a block and one
// more, zero before the first launch (the last block leaves the ticket at
// zero); rows: the rows of a block's band, the grid ⌈nx / rows⌉ blocks;
// mode_x, mode_y: Axis periodic (0) or bounded (1); lx, ly: the domain's
// extents; g: gravity; gam_bg: the background gradient of A in y.
// cudaErrorInvalidValue for an empty grid or band or another axis mode;
// else the launch's error.
#define SWMHD_ENERGY_SERIES(T, SUFFIX)                                        \
  extern "C" int swmhd_energy_series_##SUFFIX(                                \
      const T* h, const T* u, const T* v, const T* A, const T* h0, T* out,    \
      double* scratch, int nx, int ny, int rows, int conservative,            \
      int mode_x, int mode_y, double dx, double dy, double lx, double ly,     \
      double g, double gam_bg, void* stream) {                                \
    const auto k = conservative                                               \
                       ? swmhd::series_kernel<T, true>(mode_x, mode_y)        \
                       : swmhd::series_kernel<T, false>(mode_x, mode_y);      \
    if (nx < 1 || ny < 1 || rows < 1 || k == nullptr) {                       \
      return static_cast<int>(cudaErrorInvalidValue);                         \
    }                                                                         \
    const swmhd::SeriesArgs<T> a{h,     u,     v,     A,  h0,                 \
                                 out,   scratch, nx,  ny, rows,               \
                                 T(dx), T(dy), T(0.5 * g), T(gam_bg),         \
                                 lx,    ly};                                  \
    k<<<(nx + rows - 1) / rows, swmhd::kSeriesThreads, 0,                     \
        static_cast<cudaStream_t>(stream)>>>(a);                              \
    return static_cast<int>(cudaGetLastError());                              \
  }

SWMHD_ENERGY_SERIES(float, f32)
SWMHD_ENERGY_SERIES(double, f64)

// The vector-invariant substage in float: the instantiations of the tile
// kernel of vi_tile.cuh (its f64 twin is vector_invariant_f64.cu, so the
// two build in parallel).

#include "vi_tile.cuh"

namespace swmhd {
template cudaError_t launch_vector_invariant<float>(const Launch<float>&);
}  // namespace swmhd

// out: shared memory bytes a block, registers a thread, resident blocks an
// SM of the kernel a launch with these arguments takes.
extern "C" int swmhd_vi_tile_info_f32(int mode_x, int mode_y, int opt,
                                      int tile_x, int biharmonic, int* out) {
  return swmhd::vi_tile_info<float>(mode_x, mode_y, opt, tile_x, biharmonic,
                                    out);
}

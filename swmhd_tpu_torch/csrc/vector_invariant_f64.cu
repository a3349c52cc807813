// The vector-invariant substage in double: the instantiations of the tile
// kernel of vi_tile.cuh (see vector_invariant.cu).

#include "vi_tile.cuh"

namespace swmhd {
template cudaError_t launch_vector_invariant<double>(const Launch<double>&);
}  // namespace swmhd

extern "C" int swmhd_vi_tile_info_f64(int mode_x, int mode_y, int opt,
                                      int tile_x, int biharmonic, int* out) {
  return swmhd::vi_tile_info<double>(mode_x, mode_y, opt, tile_x,
                                     biharmonic, out);
}

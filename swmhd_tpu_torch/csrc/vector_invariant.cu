// The vector-invariant substage in float: the instantiations of the tile
// kernel of vi_tile.cuh (its f64 twin is vector_invariant_f64.cu, so the
// two build in parallel).

#include "vi_tile.cuh"

namespace swmhd {
template cudaError_t launch_vector_invariant<float>(const Launch<float>&);
template int vi_tile_info<float>(int, int, int, int, int, int*);
}  // namespace swmhd

// The vector-invariant substage in double: the instantiations of the tile
// kernel of vi_tile.cuh (see vector_invariant.cu).

#include "vi_tile.cuh"

namespace swmhd {
template cudaError_t launch_vector_invariant<double>(const Launch<double>&);
template int vi_tile_info<double>(int, int, int, int, int, int*);
}  // namespace swmhd

// The conservative substage in double: the instantiations of the tile
// kernel of cons_tile.cuh (see conservative.cu).

#include "cons_tile.cuh"

namespace swmhd {
template cudaError_t launch_conservative<double>(const Launch<double>&);
template int cons_tile_info<double>(int, int, int, int, int*);
}  // namespace swmhd

// The conservative substage in float: the instantiations of the tile
// kernel of cons_tile.cuh (its f64 twin is conservative_f64.cu, so the
// two build in parallel).

#include "cons_tile.cuh"

namespace swmhd {
template cudaError_t launch_conservative<float>(const Launch<float>&);
template int cons_tile_info<float>(int, int, int, int, int*);
}  // namespace swmhd

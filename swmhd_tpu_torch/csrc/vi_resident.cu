// The vector-invariant resident kernel in float: the instantiations of
// vi_resident (vi_tile.cuh), n RK3 steps in one cooperative launch (its
// f64 twin is vi_resident_f64.cu; both build apart from the one-substage
// kernels, so the four build in parallel).

#include "vi_tile.cuh"

namespace swmhd {
template cudaError_t launch_vi_resident<float>(const Resident<float>&);
template int vi_resident_info<float>(int, int, int, int, int, int, int,
                                     int*);
}  // namespace swmhd

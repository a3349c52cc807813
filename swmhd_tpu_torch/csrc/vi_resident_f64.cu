// The vector-invariant resident kernel in double (see vi_resident.cu).

#include "vi_tile.cuh"

namespace swmhd {
template cudaError_t launch_vi_resident<double>(const Resident<double>&);
template int vi_resident_info<double>(int, int, int, int, int, int, int,
                                      int*);
}  // namespace swmhd

// The conservative resident kernel in double (see cons_resident.cu).

#include "cons_tile.cuh"

namespace swmhd {
template cudaError_t launch_cons_resident<double>(const Resident<double>&);
template int cons_resident_info<double>(int, int, int, int, int, int, int*);
}  // namespace swmhd

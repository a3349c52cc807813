// The conservative resident kernel in float: the instantiations of
// cons_resident (cons_tile.cuh), n RK3 steps in one cooperative launch
// (its f64 twin is cons_resident_f64.cu).

#include "cons_tile.cuh"

namespace swmhd {
template cudaError_t launch_cons_resident<float>(const Resident<float>&);
template int cons_resident_info<float>(int, int, int, int, int, int, int*);
}  // namespace swmhd

// Host stand-in for the CUDA runtime header, for a g++ (-std=c++20) build
// of the vector-invariant tile kernel (vi_host.cpp): the qualifiers are
// empty, threadIdx and blockIdx are per host thread, __syncthreads waits
// at the block's std::barrier, and the runtime calls of the launchers are
// stubs (no launch goes through them).
#pragma once
#include <algorithm>
#include <barrier>
#include <cmath>
#include <cstddef>
#include <cstring>
using std::fabs;
using std::max;
using std::min;
#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __shared__
#define __align__(n) __attribute__((aligned(n)))
#define __launch_bounds__(...)
struct dim3 {
  unsigned x = 1, y = 1, z = 1;
  dim3() {}
  dim3(unsigned a, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
extern thread_local dim3 threadIdx, blockIdx;
extern std::barrier<>* block_barrier;
inline void __syncthreads() { block_barrier->arrive_and_wait(); }
inline int __float_as_int(float f) {
  int i;
  std::memcpy(&i, &f, 4);
  return i;
}
inline float __int_as_float(int i) {
  float f;
  std::memcpy(&f, &i, 4);
  return f;
}
typedef int cudaError_t;
typedef void* cudaStream_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
enum {
  cudaDevAttrMaxSharedMemoryPerBlockOptin = 97,
  cudaFuncAttributeMaxDynamicSharedMemorySize = 8
};
struct cudaFuncAttributes { int numRegs; };
inline cudaError_t cudaGetDevice(int* d) { *d = 0; return 1; }
inline cudaError_t cudaDeviceGetAttribute(int* v, int, int) {
  *v = 0;
  return 1;
}
inline cudaError_t cudaFuncSetAttribute(const void*, int, int) { return 1; }
inline cudaError_t cudaFuncGetAttributes(cudaFuncAttributes*, const void*) {
  return 1;
}
inline cudaError_t cudaOccupancyMaxActiveBlocksPerMultiprocessor(
    int*, const void*, int, size_t) {
  return 1;
}
inline cudaError_t cudaLaunchKernel(const void*, dim3, dim3, void**, size_t,
                                    cudaStream_t) {
  return 1;
}
inline cudaError_t cudaGetLastError() { return 0; }

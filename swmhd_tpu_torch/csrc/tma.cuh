// Hopper's Tensor Memory Accelerator (TMA) and transaction barriers
// (mbarrier), as thin wrappers of their PTX, and the host-side encoding of
// a 2-D float32 tensor map.
//
// A TMA load copies a box of a tensor described by a CUtensorMap from
// device memory to shared memory and reports the bytes it wrote to an
// mbarrier in shared memory (a TMA store copies a box back, tracked by
// the issuing thread's bulk groups): one thread arms the barrier with the bytes
// it expects (arrive.expect_tx) and issues the copy; every thread that
// reads the box waits on the barrier's phase. A barrier initialised with
// an arrival count of 1 completes a phase when that one arrival and all
// expected bytes are in; its phases alternate parity 0, 1, 0, …
//
// Rules the callers keep (the hardware's):
//   - a box is at most 256 elements along each dimension, and its inner
//     extent in bytes a multiple of 16;
//   - the tensor's base address is 16-byte aligned and its row pitch a
//     multiple of 16 bytes;
//   - a box's shared-memory destination is 128-byte aligned;
//   - no thread reads a box before its barrier phase completes; a
//     thread's own writes to shared memory that the async proxy (a TMA
//     store) will read are fenced with fence_proxy_async first, as is an
//     mbarrier.init before a TMA copy completes on it.
//
// cuTensorMapEncodeTiled is a driver function. It is reached through the
// runtime's driver entry point, so the library links no libcuda (the
// build links with nvcc -shared and the runtime alone).

#pragma once

#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace swmhd {
namespace tma {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbarrier_init(uint64_t* bar,
                                              uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;"
               :: "r"(smem_addr(bar)), "r"(count) : "memory");
}

// Makes this thread's generic-proxy writes to shared memory (an
// mbarrier.init, data a TMA store reads) visible to the async proxy.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// Arrives on the barrier and adds `bytes` to the transaction count its
// current phase waits for.
__device__ __forceinline__ void arrive_expect_tx(uint64_t* bar,
                                                 uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               :: "r"(smem_addr(bar)), "r"(bytes) : "memory");
}

// Spins until the barrier's phase of parity `phase` has completed.
__device__ __forceinline__ void wait_parity(uint64_t* bar, uint32_t phase) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n"
        " .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n"
        "}"
        : "=r"(done) : "r"(smem_addr(bar)), "r"(phase) : "memory");
  } while (!done);
}

// Copies the box at element coordinates (col, row) of `map` to `dst`
// (128-byte aligned shared memory); completes on `bar` by the box's bytes.
__device__ __forceinline__ void load_2d(void* dst, const CUtensorMap* map,
                                        int col, int row, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];"
      :: "r"(smem_addr(dst)), "l"(reinterpret_cast<uint64_t>(map)),
         "r"(col), "r"(row), "r"(smem_addr(bar))
      : "memory");
}

// Copies the dense box at `src` (128-byte aligned shared memory) to
// element coordinates (col, row) of `map`, in this thread's bulk group;
// the thread's own writes to `src` are fenced (fence_proxy_async) and the
// block's are behind a barrier first.
__device__ __forceinline__ void store_2d(const CUtensorMap* map, int col,
                                         int row, const void* src) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group"
      " [%0, {%1, %2}], [%3];"
      :: "l"(reinterpret_cast<uint64_t>(map)), "r"(col), "r"(row),
         "r"(smem_addr(src))
      : "memory");
  asm volatile("cp.async.bulk.commit_group;" ::: "memory");
}

// Waits until this thread's bulk stores have read their shared memory
// (which may then be reused or released).
__device__ __forceinline__ void store_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
}

// The driver's cuTensorMapEncodeTiled, or nullptr where the driver has
// none (looked up once).
inline PFN_cuTensorMapEncodeTiled encode_tiled() {
  static PFN_cuTensorMapEncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<PFN_cuTensorMapEncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// Encodes `map` for the row-major float32 array `base` of rows × cols
// elements with a row pitch of `pitch` elements, copied in boxes of
// box_rows × box_cols: no swizzle, element strides 1, no out-of-bounds
// fill. false where the driver refuses (see the rules above).
inline bool encode_f32(CUtensorMap* map, const float* base, uint64_t rows,
                       uint64_t cols, uint64_t pitch, uint32_t box_rows,
                       uint32_t box_cols) {
  const PFN_cuTensorMapEncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[2] = {cols, rows};                 // innermost first
  const cuuint64_t strides[1] = {pitch * sizeof(float)};   // bytes, dim 1
  const cuuint32_t box[2] = {box_cols, box_rows};
  const cuuint32_t elem[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2,
                const_cast<float*>(base), dims, strides, box, elem,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                CU_TENSOR_MAP_L2_PROMOTION_NONE,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace tma
}  // namespace swmhd

// The 2-D tile probes, written by hand for Hopper (sm_90a): a window load,
// a periodic wrap-halo load (both here), and the entry points of the
// whole vector-invariant tendency of the bench.py model evaluated in one
// kernel over 2-D tiles staged in shared memory (tendency_tile.cuh).
//
// Replaces three Pallas TPU kernels of benchmarks/:
//   - probe (exp_dma.py:21): DMA a (TX+2HX, TY+2HY) window of a
//     wrap-padded array into VMEM, write its (TX, TY) interior + 1
//     -> swmhd_window_probe_f32;
//   - probe(case) (exp_dma2.py:22): copy a 48-row window of full rows by
//     four slice patterns, write its 32 interior rows + 1
//     -> swmhd_wrap_probe_f32;
//   - make_probe (exp_fused2d.py:72): DMA the four (TX+16, TY+2HY)
//     windows of the wrap-padded h, u, v, A, evaluate model.tendencies on
//     them, write the (TX, TY) interior of G (all of it, the momentum
//     part or the mass and tracer part) -> swmhd_tendency_tile_{f32,f64}.
// None is carried over block by block: the TPU probes' 8-row and 128-lane
// alignments, their batch dimension on the scratch buffer and their VMEM
// limits are Mosaic rules. Here a block stages its window in dynamic
// shared memory. Each entry point reads the card's opt-in limit
// (cudaDevAttrMaxSharedMemoryPerBlockOptin, 232,448 B on an H100) and
// returns kSmemRefused for a window that does not fit, the counterpart of
// the Mosaic refusals the JAX probes printed as FAILED; a window over the
// default 48 KB gets cudaFuncSetAttribute first.
//
// What bounds them. The two load probes need only the padded input's
// interior, read once, and the output, written once: bytes. Each has two branches, chosen by shape
// (ops/tile.py load_plan, which the wrappers pass down):
//   - "tma" (box_probe), for a 16-byte aligned input with a row pitch of
//     a multiple of 16 bytes. A tile's window is cut into P blocks (row
//     bands of a window-probe tile, each with its halo rows; runs of
//     column boxes of a wrap-probe window), so 128–256 blocks fill the
//     132 SMs where one block a tile gave 32 or 64. A block's part is
//     boxes of at most 256 × 256 elements. Load 1 copies each box with
//     one TMA load (cp.async.bulk.tensor, tma.cuh) on its own mbarrier,
//     all issued at once by one thread, and the block writes a box's
//     interior + 1 as soon as its barrier completes, while later boxes
//     are in flight: by 16-byte stores from its threads (the window
//     probe), or + 1 in place and one TMA store a box (the wrap probe,
//     whose boxes' interior rows are dense). Load 0 copies the same
//     boxes through registers, 16 bytes a thread.
//   - "cp.async" (window_probe, wrap_probe), for any other input: one
//     block a tile stages its whole window by cp.async
//     (__pipeline_memcpy_async, 16 B a copy where rows are 16-byte
//     aligned, else one element) or through registers, waits, writes.
// The tile tendency is the vector-invariant substage kernel's phases
// with an epilogue that writes G (tendency_tile.cuh says how and why);
// this file holds its entry points. Its windows are `halo` points wide; a
// halo below the composed read radius 3 (kTileRadius) is refused, a wider
// one is loaded and not read.
//
// Each entry point returns cudaGetLastError() after its launch, or
// kSmemRefused, or cudaErrorInvalidValue for arguments it does not take.

#include <cuda_pipeline.h>

#include <cstdint>

#include "substage.cuh"
#include "tendency_tile.cuh"
#include "tile.cuh"
#include "tma.cuh"

namespace swmhd {
namespace {

constexpr int kSmemRefused = -2;   // ops/tile.py SMEM_REFUSED

// kSmemRefused for a window over the opt-in limit; else raises the
// kernel's dynamic shared memory limit to `bytes`.
template <typename K>
int allow_smem(K kernel, size_t bytes) {
  if (bytes > static_cast<size_t>(smem_optin_limit())) return kSmemRefused;
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes)));
}

// Copies a rows × cols block of src (row stride ss) to shared memory dst
// (row stride ds), the threads of the block taking strided shares:
// asynchronously (cp.async; the caller commits and waits) or through
// registers. 16-byte pieces where every row starts 16-byte aligned, else
// one float at a time.
template <bool Async>
__device__ void copy_block(float* dst, int ds, const float* src, size_t ss,
                           int rows, int cols) {
  const bool vec = cols % 4 == 0 && ds % 4 == 0 && ss % 4 == 0
                   && (reinterpret_cast<uintptr_t>(src) & 15) == 0
                   && (reinterpret_cast<uintptr_t>(dst) & 15) == 0;
  const int w = vec ? 4 : 1;
  const int per_row = cols / w;
  for (int e = threadIdx.x; e < rows * per_row; e += blockDim.x) {
    const int r = e / per_row;
    const int c = (e - r * per_row) * w;
    float* d = dst + static_cast<size_t>(r) * ds + c;
    const float* s = src + r * ss + c;
    if constexpr (Async) {
      __pipeline_memcpy_async(d, s, vec ? 16 : 4);
    } else if (vec) {
      *reinterpret_cast<float4*>(d) = *reinterpret_cast<const float4*>(s);
    } else {
      *d = *s;
    }
  }
}

// -- K4 and K5: the load probes ----------------------------------------------
//
// exp_dma2.py's four cases (ops/tile.py WRAP_CASES). The probe's point is
// their order of copies: "window" and "dst3d" load the window once;
// "src8" loads the h-row halo slice at the window's top first and waits,
// then the window; "when" does the same with the halo taken from rows
// n − h … for tile 0.
enum WrapCase : int { kWindow = 0, kDst3d = 1, kSrc8 = 2, kWhen = 3 };
// ops/tile.py BRANCHES
enum LoadBranch : int { kTmaBranch = 0, kCpAsyncBranch = 1 };

// The "cp.async" branch, window probe. x: the (nx + 2hx, ny + 2hy)
// wrap-padded input; out: (nx, ny). Block (blockIdx.y, blockIdx.x) = tile
// (i, j) stages the window of padded rows i·tx … i·tx + tx + 2hx and
// columns j·ty … j·ty + ty + 2hy.
template <bool Async>
__global__ void __launch_bounds__(kTileThreads)
window_probe(const float* __restrict__ x, float* __restrict__ out, int ny,
             int tx, int ty, int hx, int hy) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* buf = reinterpret_cast<float*>(smem);
  const int px = tx + 2 * hx, py = ty + 2 * hy;
  const size_t nyp = static_cast<size_t>(ny) + 2 * hy;
  const int i = blockIdx.y, j = blockIdx.x;
  copy_block<Async>(buf, py,
                    x + static_cast<size_t>(i) * tx * nyp
                        + static_cast<size_t>(j) * ty,
                    nyp, px, py);
  if constexpr (Async) {
    wait_copies();
  } else {
    __syncthreads();
  }
  for (int e = threadIdx.x; e < tx * ty; e += blockDim.x) {
    const int a = e / ty, b = e - a * ty;
    out[static_cast<size_t>(i * tx + a) * ny + j * ty + b] =
        buf[(hx + a) * py + hy + b] + 1.0f;
  }
}

// The "cp.async" branch, wrap probe. x: the (n + 2h, m) input padded along
// rows; out: (n, m). Block blockIdx.y = i copies the window of padded rows
// i·tx … i·tx + tx + 2h, all m columns, into shared memory by one of the
// four cases, then writes its rows h … h + tx, + 1.
__global__ void __launch_bounds__(kTileThreads)
wrap_probe(const float* __restrict__ x, float* __restrict__ out, int n,
           int m, int tx, int h, int wrap_case) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* buf = reinterpret_cast<float*>(smem);
  const int px = tx + 2 * h;
  const int i = blockIdx.y;
  const float* window = x + static_cast<size_t>(i) * tx * m;
  switch (wrap_case) {
    case kDst3d: {
      // the same copy into a view of the buffer: batch 0 of a (1, px, m)
      // buffer, rows from 0
      float* view = buf + static_cast<size_t>(0) * px * m;
      copy_block<true>(view, m, window, m, px, m);
      wait_copies();
      break;
    }
    case kSrc8:
      // the h-row halo slice first, then the whole window
      copy_block<true>(buf, m, window, m, h, m);
      wait_copies();
      copy_block<true>(buf, m, window, m, px, m);
      wait_copies();
      break;
    case kWhen: {
      // the halo copy started under a per-tile condition (tile 0 reads
      // rows n − h …), waited on unconditionally; then the whole window
      const size_t row0 = i > 0 ? static_cast<size_t>(i) * tx
                                : static_cast<size_t>(n - h);
      copy_block<true>(buf, m, x + row0 * m, m, h, m);
      wait_copies();
      copy_block<true>(buf, m, window, m, px, m);
      wait_copies();
      break;
    }
    default:   // kWindow: one copy of the window
      copy_block<true>(buf, m, window, m, px, m);
      wait_copies();
  }
  for (int e = threadIdx.x; e < tx * m; e += blockDim.x) {
    const int r = e / m, c = e - r * m;
    out[static_cast<size_t>(i * tx + r) * m + c] = buf[(h + r) * m + c] + 1.0f;
  }
}

// The "tma" branch's launch plan (ops/tile.py LoadPlan). Tile (i, j)'s
// window is padded rows i·tx … i·tx + tx + 2hx, columns j·ty … j·ty + ty +
// 2hy; the wrap probe is the window probe with hy = 0 and one tile of ty =
// m columns a row. Block (blockIdx.x, blockIdx.y) = (j·pc + qc, i·pr + qr)
// takes row band qr of pr (tx / pr interior rows and hx halo rows on each
// side) and run qc of pc of the window's column boxes (kc boxes of bc
// columns each); the band is nr boxes of br rows. Box b = k·nr + a of the
// block starts at padded row row0 + a·br and column col0 + k·bc.
struct BoxPlan {
  int pitch;            // the padded input's columns (its row pitch)
  int out_cols;         // the output's columns
  int n;                // the output's rows ("when": tile 0's halo row n − hx)
  int tx, ty, hx, hy;
  int pr, pc;           // row bands and column runs a tile
  int br, bc, nr, kc;   // box rows and columns; boxes a band, column runs
  int wrap_case;        // kSrc8 / kWhen: the halo rows first
};

__host__ __device__ constexpr int round_up(int v, int m) {
  return (v + m - 1) / m * m;
}

// Bytes of a "tma" block's shared memory: one 8-byte mbarrier a box, then
// the boxes, each 128-byte aligned (ops/tile.py LoadPlan.smem_bytes).
__host__ __device__ constexpr int box_offset(const BoxPlan& p) {
  return round_up(8 * p.nr * p.kc, 128);
}
__host__ __device__ constexpr int box_stride(const BoxPlan& p) {
  return round_up(4 * p.br * p.bc, 128);
}
__host__ __device__ constexpr int box_smem_bytes(const BoxPlan& p) {
  return box_offset(p) + p.nr * p.kc * box_stride(p);
}

// Writes the part of the tile's interior that box s (padded rows r0 …,
// columns c0 …) holds, + 1, 16 bytes a store where rows allow it.
__device__ void write_box(const BoxPlan& p, const float* s, int r0, int c0,
                          int in_r0, int in_c0, int rows, int cols,
                          float* __restrict__ out) {
  const int ir0 = max(r0, in_r0), ir1 = min(r0 + p.br, in_r0 + rows);
  const int ic0 = max(c0, in_c0), ic1 = min(c0 + p.bc, in_c0 + cols);
  if (ir0 >= ir1 || ic0 >= ic1) return;
  const int w = ic1 - ic0;
  const bool vec = (ic0 - c0) % 4 == 0 && (ic0 - p.hy) % 4 == 0
                   && w % 4 == 0 && p.out_cols % 4 == 0
                   && (reinterpret_cast<uintptr_t>(out) & 15) == 0;
  const int step = vec ? 4 : 1, per_row = w / step;
  for (int e = threadIdx.x; e < (ir1 - ir0) * per_row; e += blockDim.x) {
    const int r = ir0 + e / per_row;
    const int c = ic0 + (e % per_row) * step;
    const float* src = s + (r - r0) * p.bc + (c - c0);
    float* dst = out + static_cast<size_t>(r - p.hx) * p.out_cols
                 + (c - p.hy);
    if (vec) {
      float4 v = *reinterpret_cast<const float4*>(src);
      v.x += 1.0f; v.y += 1.0f; v.z += 1.0f; v.w += 1.0f;
      *reinterpret_cast<float4*>(dst) = v;
    } else {
      *dst = *src + 1.0f;
    }
  }
}

// The "tma" branch of both probes: Tma loads the boxes by TMA (load 1),
// else through registers, 16 bytes a thread (load 0). Store (the wrap
// probe, whose boxes' interior rows are all of it: hy = 0, nr = 1): the
// interior goes back by TMA store, + 1 in place first; else (the window
// probe) threads store it, 16 bytes each. The maps are of the
// padded input in boxes of br × bc (window_map) and hx × bc (halo_map,
// src8 and when), and of the output in boxes of tx / pr × bc (out_map).
template <bool Tma, bool Store>
__global__ void __launch_bounds__(kTileThreads)
box_probe(__grid_constant__ const CUtensorMap window_map,
          __grid_constant__ const CUtensorMap halo_map,
          __grid_constant__ const CUtensorMap out_map,
          const float* __restrict__ x, float* __restrict__ out,
          const BoxPlan p) {
  extern __shared__ __align__(128) unsigned char box_smem[];
  uint64_t* bars = reinterpret_cast<uint64_t*>(box_smem);
  float* boxes = reinterpret_cast<float*>(box_smem + box_offset(p));
  const int stride = box_stride(p) / 4, nbox = p.nr * p.kc;
  const int i = blockIdx.y / p.pr, qr = blockIdx.y % p.pr;
  const int j = blockIdx.x / p.pc, qc = blockIdx.x % p.pc;
  const int band = p.tx / p.pr;
  const int row0 = i * p.tx + qr * band;
  const int col0 = j * p.ty + qc * p.kc * p.bc;
  // the tile interior's part this block writes, in padded coordinates
  const int in_r0 = row0 + p.hx, in_c0 = j * p.ty + p.hy;
  uint32_t phase = 0;
  if constexpr (Tma) {
    if (threadIdx.x == 0) {
      for (int b = 0; b < nbox; ++b) tma::mbarrier_init(&bars[b], 1);
      tma::fence_proxy_async();
    }
    __syncthreads();
    if (p.wrap_case == kSrc8 || p.wrap_case == kWhen) {
      // the halo boxes (nr = 1), each on its box's barrier, phase 0
      const int hrow = p.wrap_case == kWhen && i == 0 ? p.n - p.hx
                                                     : i * p.tx;
      if (threadIdx.x == 0) {
        for (int k = 0; k < p.kc; ++k) {
          tma::arrive_expect_tx(&bars[k], 4 * p.hx * p.bc);
          tma::load_2d(boxes + k * stride, &halo_map, col0 + k * p.bc,
                       hrow, &bars[k]);
        }
      }
      for (int k = 0; k < p.kc; ++k) tma::wait_parity(&bars[k], 0);
      // every thread is past phase 0 before phase 1 can complete
      __syncthreads();
      phase = 1;
    }
    if (threadIdx.x == 0) {
      for (int b = 0; b < nbox; ++b) {
        const int k = b / p.nr, a = b - k * p.nr;
        tma::arrive_expect_tx(&bars[b], 4 * p.br * p.bc);
        tma::load_2d(boxes + b * stride, &window_map, col0 + k * p.bc,
                     row0 + a * p.br, &bars[b]);
      }
    }
  } else {
    const int per_row = p.bc / 4;
    for (int b = 0; b < nbox; ++b) {
      const int k = b / p.nr, a = b - k * p.nr;
      const float* src = x + static_cast<size_t>(row0 + a * p.br) * p.pitch
                         + col0 + k * p.bc;
      for (int e = threadIdx.x; e < p.br * per_row; e += blockDim.x) {
        const int r = e / per_row, c = (e - r * per_row) * 4;
        *reinterpret_cast<float4*>(boxes + b * stride + r * p.bc + c) =
            *reinterpret_cast<const float4*>(
                src + static_cast<size_t>(r) * p.pitch + c);
      }
    }
    __syncthreads();
  }
  for (int b = 0; b < nbox; ++b) {
    const int k = b / p.nr, a = b - k * p.nr;
    if constexpr (Tma) tma::wait_parity(&bars[b], phase);
    if constexpr (Store) {
      float4* s = reinterpret_cast<float4*>(boxes + b * stride
                                            + p.hx * p.bc);
      for (int e = threadIdx.x; e < band * p.bc / 4; e += blockDim.x) {
        float4 v = s[e];
        v.x += 1.0f; v.y += 1.0f; v.z += 1.0f; v.w += 1.0f;
        s[e] = v;
      }
      tma::fence_proxy_async();
      __syncthreads();
      if (threadIdx.x == 0) {
        tma::store_2d(&out_map, col0 + k * p.bc - p.hy, row0, s);
      }
    } else {
      write_box(p, boxes + b * stride, row0 + a * p.br, col0 + k * p.bc,
                in_r0, in_c0, band, p.ty, out);
    }
  }
  if constexpr (Store) {
    if (threadIdx.x == 0) tma::store_wait_read();
  }
}

// Checks a "tma" plan against the input and launches it; x: (rows,
// p.pitch); store: the interior by TMA store (the wrap probe: tma loads,
// hy = 0, nr = 1).
int launch_box_probe(const float* x, float* out, int rows, const BoxPlan& p,
                     bool tma, bool store, int grid_x, int grid_y,
                     cudaStream_t stream) {
  const bool halo = p.wrap_case == kSrc8 || p.wrap_case == kWhen;
  const int band = p.tx / p.pr;
  if ((reinterpret_cast<uintptr_t>(x) & 15) != 0 || p.pitch % 4 != 0
      || p.ty % 4 != 0 || p.br < 1 || p.br > 256 || p.bc < 4 || p.bc > 256
      || p.bc % 4 != 0 || (halo && (p.nr != 1 || p.hx < 1 || p.hx > p.br))
      || (store && (!tma || p.hy != 0 || p.nr != 1 || band > 256
                    || (p.hx * p.bc) % 32 != 0
                    || (reinterpret_cast<uintptr_t>(out) & 15) != 0))
      || grid_y > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  CUtensorMap window_map{}, halo_map{}, out_map{};
  if (tma) {
    if (!tma::encode_f32(&window_map, x, rows, p.pitch, p.pitch, p.br, p.bc)
        || (halo && !tma::encode_f32(&halo_map, x, rows, p.pitch, p.pitch,
                                     p.hx, p.bc))
        || (store && !tma::encode_f32(&out_map, out, p.n, p.out_cols,
                                      p.out_cols, band, p.bc))) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  auto kernel = store ? &box_probe<true, true>
                      : (tma ? &box_probe<true, false>
                             : &box_probe<false, false>);
  const int bytes = box_smem_bytes(p);
  const int err = allow_smem(kernel, bytes);
  if (err != 0) return err;
  kernel<<<dim3(grid_x, grid_y), kTileThreads, bytes, stream>>>(
      window_map, halo_map, out_map, x, out, p);
  return static_cast<int>(cudaGetLastError());
}

// -- K6: the tile tendency (tendency_tile.cuh) --------------------------

template <typename T>
int tendency_tile_entry(const T* s, T* out, int nx, int ny, int tx, int ty,
                        int halo, int split, double dx, double dy, double g,
                        double f, void* stream) {
  const auto kernel = tendency_kernel<T>(split, ty);
  if (kernel == nullptr || !tendency_args_ok(nx, ny, tx, ty, halo)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t bytes = tendency_smem_bytes(sizeof(T), tx, ty, halo, split);
  const int err = allow_smem(kernel, bytes);
  if (err != 0) return err;
  kernel<<<dim3(ny / ty, nx / tx), kTileThreads, bytes,
           static_cast<cudaStream_t>(stream)>>>(
      s, out, tendency_params<T>(nx, ny, dx, dy, g, f), tx, halo);
  return static_cast<int>(cudaGetLastError());
}

// tile_kernel_info (tile.cuh) of the kernel a launch with these arguments
// takes, ready for its shared memory.
template <typename T>
int tendency_info_entry(int tx, int ty, int halo, int split, int* out) {
  const auto kernel = tendency_kernel<T>(split, ty);
  if (kernel == nullptr || tx < 1 || tx > kViMaxTileX
      || halo < kTileRadius) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t bytes = tendency_smem_bytes(sizeof(T), tx, ty, halo, split);
  const int err = allow_smem(kernel, bytes);
  if (err != 0) return err;
  return tile_kernel_info(reinterpret_cast<const void*>(kernel), bytes, out);
}

}  // namespace
}  // namespace swmhd

// The card's opt-in shared memory limit per block, in bytes.
extern "C" int swmhd_smem_limit() { return swmhd::smem_optin_limit(); }

// x_padded: (nx + 2hx, ny + 2hy); out: (nx, ny); async: 1 asynchronous
// copies, 0 loads through registers; branch: LoadBranch; p row bands a
// tile ("tma"; 1 for "cp.async"); box_rows × box_cols: a band's boxes
// ("tma"; the whole window for "cp.async").
extern "C" int swmhd_window_probe_f32(const float* x_padded, float* out,
                                      int nx, int ny, int tx, int ty, int hx,
                                      int hy, int async, int branch, int p,
                                      int box_rows, int box_cols,
                                      void* stream) {
  using namespace swmhd;
  const int px = tx + 2 * hx, py = ty + 2 * hy;
  if (tx < 1 || ty < 1 || hx < 0 || hy < 0 || nx % tx != 0 || ny % ty != 0
      || nx / tx > 65535 || (p != 1 && p != 2 && p != 4) || tx % p != 0
      || box_rows < 1 || box_cols < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t bytes = sizeof(float) * static_cast<size_t>(px) * py;
  if (bytes > static_cast<size_t>(smem_optin_limit())) return kSmemRefused;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (branch == kTmaBranch) {
    const int band = tx / p + 2 * hx;
    if (band % box_rows != 0 || py % box_cols != 0) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    const BoxPlan plan{ny + 2 * hy, ny, nx, tx, ty, hx, hy, p, 1,
                       box_rows, box_cols, band / box_rows,
                       py / box_cols, kWindow};
    return launch_box_probe(x_padded, out, nx + 2 * hx, plan, async != 0,
                            false, ny / ty, nx / tx * p, st);
  }
  if (branch != kCpAsyncBranch || p != 1 || box_rows != px
      || box_cols != py) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto kernel = async ? &window_probe<true> : &window_probe<false>;
  const int err = allow_smem(kernel, bytes);
  if (err != 0) return err;
  kernel<<<dim3(ny / ty, nx / tx), kTileThreads, bytes, st>>>(
      x_padded, out, ny, tx, ty, hx, hy);
  return static_cast<int>(cudaGetLastError());
}

// x_padded: (n + 2h, m), padded along rows; out: (n, m); wrap_case: the
// WrapCase; branch: LoadBranch; p column runs a window ("tma"; 1 for
// "cp.async"); box_rows × box_cols: the window's boxes ("tma", whose
// interior goes back by TMA store; the whole window for "cp.async").
extern "C" int swmhd_wrap_probe_f32(const float* x_padded, float* out,
                                    int n, int m, int tx, int h,
                                    int wrap_case, int branch, int p,
                                    int box_rows, int box_cols,
                                    void* stream) {
  using namespace swmhd;
  const int px = tx + 2 * h;
  if (tx < 1 || h < 0 || h > n || n % tx != 0 || n / tx > 65535
      || wrap_case < kWindow || wrap_case > kWhen
      || (p != 1 && p != 2 && p != 4) || box_rows < 1 || box_cols < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t bytes = sizeof(float) * static_cast<size_t>(px) * m;
  if (bytes > static_cast<size_t>(smem_optin_limit())) return kSmemRefused;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (branch == kTmaBranch) {
    if (px % box_rows != 0 || m % box_cols != 0
        || (m / box_cols) % p != 0) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    const BoxPlan plan{m, m, n, tx, m, h, 0, 1, p, box_rows, box_cols,
                       px / box_rows, m / box_cols / p, wrap_case};
    return launch_box_probe(x_padded, out, n + 2 * h, plan, true, true, p,
                            n / tx, st);
  }
  if (branch != kCpAsyncBranch || p != 1 || box_rows != px
      || box_cols != m) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int err = allow_smem(wrap_probe, bytes);
  if (err != 0) return err;
  wrap_probe<<<dim3(1, n / tx), kTileThreads, bytes, st>>>(
      x_padded, out, n, m, tx, h, wrap_case);
  return static_cast<int>(cudaGetLastError());
}

// s: (4, nx, ny) h, u, v, A; out: (4 | 2, nx, ny), the split's fields of
// G; ty one of 8, 16, 32, 64; tx at most 64. swmhd_tendency_tile_info:
// shared memory bytes a block, registers a thread and resident blocks an
// SM into out[0..2] for the kernel of (tx, ty, halo, split).
#define SWMHD_TILE_ENTRY(T, SUFFIX)                                         \
  extern "C" int swmhd_tendency_tile_##SUFFIX(                              \
      const T* s, T* out, int nx, int ny, int tx, int ty, int halo,         \
      int split, double dx, double dy, double g, double f, void* stream) {  \
    return swmhd::tendency_tile_entry<T>(s, out, nx, ny, tx, ty, halo,      \
                                         split, dx, dy, g, f, stream);      \
  }                                                                         \
  extern "C" int swmhd_tendency_tile_info_##SUFFIX(int tx, int ty,          \
                                                   int halo, int split,     \
                                                   int* out) {              \
    return swmhd::tendency_info_entry<T>(tx, ty, halo, split, out);         \
  }

SWMHD_TILE_ENTRY(float, f32)
SWMHD_TILE_ENTRY(double, f64)

// Shared device code of the blocked-MTTKRP kernels (sm_90a).
//
// Every kernel of this directory reduces one block of `n` entries into
// rows of a (width, cols) tile: entry j carries an output row id and an
// R-vector (a gathered Hadamard product, or a precomputed product read
// from memory), and the tile row of that id gains the vector.  Ids
// outside [0, width) are padding and add nothing (their products are
// still formed, and dropped at the flush).
//
// warp_runs<NR>() is that reduction for one CTA of kWarps warps, as the
// reductions of precomputed products (onehot_reduce.cu) walk it; the
// kernels that gather table rows walk gather_walk.cuh's walk_rows.  Each
// warp takes a contiguous run of the block's entries; its lanes load 32
// entries' ids at once (coalesced) and the warp walks them one by one
// with the id broadcast by shuffles and the lanes spread over the rank
// tile: lane l holds columns l, l+32, ..., l+32*(NR-1).  A warp keeps a
// running row sum in registers and flushes it with atomicAdd only when
// the id changes, so ids sorted inside a block cost one flush per row
// run, and unsorted ids still give the right sum.
//
// A "source" supplies the entries:
//   void load(int j, bool ok)   lane loads entry j (ok: j < n); every lane
//                               of the warp calls it, with j rising by 32
//                               from call to call over the warp's run
//   int row(int t)              entry t of the 32 loaded (warp-uniform)
//   void product<NR>(int t, int j, int lane, float (&p)[NR])
//                               entry t's vector, which is entry j
//
// Tables may be float or bf16 (T below).  A bf16 product is rounded to
// bf16 after each multiply, as PyTorch's bf16 `prod * rows` rounds it;
// only the running row sums are f32.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace splatt {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxOther = 7;   // MAX_NMODES - 1
constexpr int kMaxModes = kMaxOther + 1;
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;

// CTAs per SM the reductions of streamed products are built for: their
// __launch_bounds__ minimum, which caps registers at 65536 / (kThreads *
// n).  They wait on streamed loads, so their time follows the warps in
// flight; left to itself, nvcc gave near-identical bodies anywhere from 40
// to 62 registers.
constexpr int stream_min_blocks(int nr) { return nr <= 3 ? 8 : 4; }

// Element `i` of a float or bf16 array, as float (read-only cache).
__device__ __forceinline__ float ld(const float* p, long long i) {
  return __ldg(p + i);
}
__device__ __forceinline__ float ld(const __nv_bfloat16* p, long long i) {
  const unsigned short bits =
      __ldg(reinterpret_cast<const unsigned short*>(p) + i);
  return __uint_as_float(static_cast<unsigned>(bits) << 16);
}

// x rounded to the table type T (round to nearest even for bf16).
template <class T>
__device__ __forceinline__ float to_t(float x) {
  return x;
}
template <>
__device__ __forceinline__ float to_t<__nv_bfloat16>(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// A value of a float or bf16 value stream, rounded to the table type T.
template <class T>
__device__ __forceinline__ float load_val(const void* vals, int vals_bf16,
                                          long long i) {
  return to_t<T>(vals_bf16 ? ld(static_cast<const __nv_bfloat16*>(vals), i)
                           : ld(static_cast<const float*>(vals), i));
}

// The contiguous run [j0, j1) of a block's n entries that warp `warp`
// walks.
__device__ __forceinline__ void warp_range(int n, int warp, int& j0,
                                           int& j1) {
  const int per = (n + kWarps - 1) / kWarps;
  j0 = min(warp * per, n);
  j1 = min(j0 + per, n);
}

template <int NR>
__device__ __forceinline__ void flush_row(float* dst, long long ld, int row,
                                          int cols, int lane,
                                          const float (&acc)[NR]) {
  float* r = dst + (long long)row * ld;
#pragma unroll
  for (int i = 0; i < NR; ++i) {
    const int c = lane + 32 * i;
    if (c < cols) atomicAdd(r + c, acc[i]);
  }
}

template <int NR, class Src>
__device__ __forceinline__ void warp_runs(Src& src, int n, float* dst,
                                          long long ld, int width,
                                          int cols) {
  const int lane = threadIdx.x & 31;
  int j0, j1;
  warp_range(n, threadIdx.x >> 5, j0, j1);

  float acc[NR];
#pragma unroll
  for (int i = 0; i < NR; ++i) acc[i] = 0.f;
  // the open run's row; a run outside [0, width) (padding, or -1: none
  // open yet) is summed like any other and never flushed.  (Testing each
  // entry's row and skipping padding before its product ran slower on the
  // card.)
  int cur = -1;

  for (int c = j0; c < j1; c += 32) {
    const int m = min(32, j1 - c);
    src.load(c + lane, lane < m);
    for (int t = 0; t < m; ++t) {
      const int row = src.row(t);
      float p[NR];
      src.template product<NR>(t, c + t, lane, p);
      if (row != cur) {
        if (cur >= 0 && cur < width)
          flush_row<NR>(dst, ld, cur, cols, lane, acc);
        cur = row;
#pragma unroll
        for (int i = 0; i < NR; ++i) acc[i] = 0.f;
      }
#pragma unroll
      for (int i = 0; i < NR; ++i) acc[i] += p[i];
    }
  }
  if (cur >= 0 && cur < width) flush_row<NR>(dst, ld, cur, cols, lane, acc);
}

// Zero a CTA's shared (width, cols) tile before its runs flush into it.
__device__ __forceinline__ void zero_tile(float* tile, long long elems) {
  for (long long i = threadIdx.x; i < elems; i += kThreads) tile[i] = 0.f;
  __syncthreads();
}

// Write a CTA's shared (width, cols) tile into rows [0, width) and
// columns [r0, r0 + cols) of a (width, R) slab of the output.
__device__ __forceinline__ void store_tile(const float* tile, float* out,
                                           int width, int cols, int R,
                                           int r0) {
  __syncthreads();
  const long long elems = (long long)width * cols;
  for (long long i = threadIdx.x; i < elems; i += kThreads) {
    const long long s = i / cols;
    const int c = (int)(i - s * cols);
    out[s * R + r0 + c] = tile[i];
  }
  __syncthreads();  // the tile may be zeroed again for the next block
}

// Raise the dynamic shared-memory cap of `kernel` when `smem` needs it.
template <class K>
cudaError_t allow_smem(K kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

}  // namespace splatt

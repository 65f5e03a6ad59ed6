// Shared device code of the blocked-MTTKRP kernels (sm_90a).
//
// Every kernel of this directory reduces one block of `n` entries into
// rows of a (width, cols) tile: entry j carries an output row id and an
// R-vector (a gathered Hadamard product, or a precomputed product read
// from memory), and the tile row of that id gains the vector.  Ids
// outside [0, width) are padding and add nothing (their products are
// still formed, and dropped at the flush).
//
// warp_runs<NR>() is that reduction for one CTA of kWarps warps.  Each
// warp takes a contiguous run of the block's entries; its lanes load 32
// entries' ids at once (coalesced) and the warp walks them one by one
// with the id broadcast by shuffles and the lanes spread over the rank
// tile: lane l holds columns l, l+32, ..., l+32*(NR-1).  A warp keeps a
// running row sum in registers and flushes it with atomicAdd only when
// the id changes, so ids sorted inside a block cost one flush per row
// run, and unsorted ids still give the right sum.
//
// A "source" supplies the entries:
//   void load(int j, bool ok)   lane loads entry j (ok: j < n)
//   int row(int t)              entry t of the 32 loaded (warp-uniform)
//   void product<NR>(int t, int j, int lane, float (&p)[NR])
//                               entry t's vector, which is entry j

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace splatt {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxOther = 7;   // MAX_NMODES - 1
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;

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
  const int warp = threadIdx.x >> 5;
  const int per = (n + kWarps - 1) / kWarps;
  const int j0 = warp * per;
  const int j1 = min(j0 + per, n);

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

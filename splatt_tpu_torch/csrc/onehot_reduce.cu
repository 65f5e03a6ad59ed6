// Segment sums of precomputed products for Hopper (sm_90a): the unfused
// MTTKRP reduction, two entries, one walk.
//
// Replaces the TPU kernels of splatt_tpu/ops/pallas_kernels.py
//   onehot_reduce_sorted (entry :148, body _sorted_kernel :98)
//       -> splatt_onehot_reduce_sorted
//   onehot_reduce_full   (entry :1415, body _full_kernel :111)
//       -> splatt_onehot_reduce_full
// and keeps their contract.  For (nb, B) int32 ids and (nb, B, R) f32 or
// bf16 products (the gather products, computed outside the kernel as the
// JAX package computes them outside its kernel):
//
//   sorted: out[b, s, :] = sum over j with ids[b, j] == s of prod[b, j, :]
//           out is (nb, S, R); every row is written, zeros included.
//   full:   out[w, :]    = sum over b, j with ids[b, j] == w of prod[b, j, :]
//           out is (width, R), zeroed by the caller.
//
// Ids outside [0, S) (or [0, width)) add nothing: -1 pads, and sentinel ids
// past the last row.  A sentinel entry whose id lands inside the range
// carries value 0 and adds an exact 0.  The accumulator is f32; bf16
// products are read as bf16 and added in f32.
//
// What bounds them on this card: bytes.  Each entry reads 4 B of id and
// 4 * R B of product (2 * R in bf16) once and does R additions; the output
// is small beside the (nb * B, R) product stream: at R = 50 and 20M
// nonzeros 4.1 GB in f32, a 1.22 ms bound at 3.35 TB/s (0.62 in bf16).
// The sorted contract's ids come in long runs (a block of 4096 spans a few
// rows of a NELL-2-shaped mode), so it flushes rarely, into a shared tile.
// The full contract's ids (another mode's, on this layout) change at
// almost every entry, so each entry flushes its R sums into the output in
// device memory: about 20M x R f32 atomics a launch.
//
// What the runs showed (PERF.md section 6; H100 80GB HBM3, 700 W; R = 50,
// 20M nonzeros).  The one-entry walk this replaced (one product row in
// flight per warp, scalar loads, one scalar atomic per column per flush)
// took 1.65 ms a sorted launch in f32 and 1.34 in bf16: half the bytes
// bought 1.2x, so latency, not bytes, set its pace.  On this walk the
// sorted launch takes 1.34 ms (91% of its bound) and 0.93 in bf16.  The
// full launch takes 2.35 ms, 1.33 with every id out of range (the walk
// with every flush dropped): the flushes, not the stream, set its pace,
// and float2 atomics cost as much as the scalar atomics they replaced
// (2.57 against 1.60 on the old walk): what costs is the number of
// flushes and the sectors they touch (about 7 of 32 bytes a 200-byte
// row), not the atomics' width.  Fewer flushes need the entries grouped
// by output row first; this design adds no such pass.
//
// What the design does: gather_walk.cuh's walk_rows with a source,
// ProductRows, whose one table is the block's products at the rank tile's
// first column and whose gather id for entry j is j: a warp keeps the
// product rows of 4 entries in flight, each lane loads its chunks of vec
// columns with one 8- or 16-byte load where R and the products' address
// allow (ops/kernels.py gather_vec; every block's base is a multiple of R
// elements, so one check of the products' address covers them all),
// fetches the next 32 entries' ids ahead, and flushes device memory with
// float2/float4 atomics.  Grid (nb, ceil(R / rtile)), one CTA per block and
// rank tile of rtile columns (ops/kernels.py reduce_rank_tile).  The
// sorted contract flushes into a shared (S, cols) tile after the warps'
// entry indices, written out once (device memory when the tile does not
// fit, into a zeroed output); the full contract flushes into the zeroed
// global output.  The TPU kernels' one-hot matmul had a matrix unit to
// run on; here it would be S or width redundant multiply-adds per entry.

#include <algorithm>

#include "gather_walk.cuh"

using namespace splatt;

namespace {

// shared ints before the sorted contract's tile: each warp's entry
// indices of its current 32 entries
constexpr int kIdxInts = kWarps * 32;

struct Args {
  const int* ids;      // (nb, B)
  const void* prod;    // (nb, B, R), f32 or bf16
  int nb;
  int block;
  int R;
  int width;           // S (sorted) or the output rows (full)
  int full;
  int use_smem;
  int rtile;           // columns of a rank tile
  float* out;
};

// Entries of one block as a gather source of walk_rows: row ids from the
// id stream, one "table" (the block's products at column r0) whose row for
// entry j is j, and the value 1.  fetch reads entry j's id a load ahead;
// commit makes the fetched 32 entries the current ones, their indices (j,
// clamped into the block for entries past the real ones) in the warp's
// shared slots.
template <class T>
struct ProductRows {
  const int* ids;      // the block's ids
  const T* prod;       // the block's products at the rank tile
  int n;               // entries in the block
  int R;
  int* idx;            // shared: this warp's 32 entry indices
  int my_row;
  int f_row;
  int f_idx;

  __device__ __forceinline__ void fetch(int j, bool ok) {
    f_row = ok ? ids[j] : -1;
    f_idx = min(j, n - 1);
  }

  __device__ __forceinline__ void commit() {
    __syncwarp();   // the warp is done with the previous 32 entries
    my_row = f_row;
    idx[threadIdx.x & 31] = f_idx;
    __syncwarp();
  }

  __device__ __forceinline__ int row(int t) const {
    return __shfl_sync(kFull, my_row, t);
  }
  __device__ __forceinline__ float val(int) const { return 1.f; }
  __device__ __forceinline__ const int* ids_of(int) const { return idx; }
  __device__ __forceinline__ const T* table(int) const { return prod; }
  __device__ __forceinline__ int pitch() const { return R; }
  __device__ __forceinline__ int ntables() const { return 1; }
};

// Block blockIdx.x, rank tile blockIdx.y: NV chunks of VEC columns per
// lane.
template <class T, int NV, int VEC>
__global__ void __launch_bounds__(kThreads, walk_min_blocks(NV * VEC))
reduce_kernel(const Args a) {
  extern __shared__ float smem[];
  const int b = blockIdx.x;
  const int r0 = blockIdx.y * a.rtile;
  const int cols = min(a.rtile, a.R - r0);
  const long long base = (long long)b * a.block;
  int* idx = reinterpret_cast<int*>(smem) + (threadIdx.x >> 5) * 32;
  float* tile = smem + kIdxInts;
  ProductRows<T> src{a.ids + base,
                     static_cast<const T*>(a.prod) + base * a.R + r0,
                     a.block, a.R, idx};
  if (a.full) {
    walk_rows<T, NV, VEC, false>(src, a.block, a.out + r0, a.R, a.width,
                                 cols);
    return;
  }
  float* slab = a.out + (long long)b * a.width * a.R;
  if (!a.use_smem) {
    walk_rows<T, NV, VEC, false>(src, a.block, slab + r0, a.R, a.width,
                                 cols);
    return;
  }
  zero_tile(tile, (long long)a.width * cols);
  walk_rows<T, NV, VEC, false>(src, a.block, tile, cols, a.width, cols);
  store_tile(tile, slab, a.width, cols, a.R, r0);
}

// Dynamic shared memory of a launch: the entry indices, then the sorted
// contract's (S, cols) tile when it fits.
size_t smem_bytes(const Args& a) {
  const int cols = std::min(a.rtile, a.R);
  return kIdxInts * sizeof(int) +
         ((!a.full && a.use_smem) ? (size_t)a.width * cols * sizeof(float)
                                  : 0);
}

template <class T>
struct Launch {
  const Args& a;
  cudaStream_t stream;
  template <int NV, int VEC>
  cudaError_t run() const {
    const size_t smem = smem_bytes(a);
    const cudaError_t e = allow_smem(reduce_kernel<T, NV, VEC>, smem);
    if (e != cudaSuccess) return e;
    const dim3 grid(a.nb, (a.R + a.rtile - 1) / a.rtile);
    reduce_kernel<T, NV, VEC><<<grid, kThreads, smem, stream>>>(a);
    return cudaGetLastError();
  }
};

// cudaErrorInvalidValue on an operand out of range, or when (nv, vec) does
// not cover the rank tile in whole aligned loads (ops/kernels.py
// gather_vec).
int run(const void* ids, const void* prod, int prod_bf16, int nb, int block,
        int R, int width, int full, int use_smem, int rtile, int nv,
        int vec, void* out, void* stream) {
  const int cols = std::min(rtile, R);
  if (nb < 1 || block < 1 || R < 1 || width < 1 || rtile < 1 || nv < 1 ||
      vec < 1 || R % vec != 0 || 32 * nv * vec < cols ||
      (rtile < R && rtile % (32 * nv * vec) != 0))
    return (int)cudaErrorInvalidValue;
  Args a;
  a.ids = static_cast<const int*>(ids);
  a.prod = prod;
  a.nb = nb;
  a.block = block;
  a.R = R;
  a.width = width;
  a.full = full;
  a.use_smem = use_smem;
  a.rtile = rtile;
  a.out = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(prod_bf16
                   ? dispatch_chunks<__nv_bfloat16>(
                         nv, vec, Launch<__nv_bfloat16>{a, s})
                   : dispatch_chunks<float>(nv, vec, Launch<float>{a, s}));
}

}  // namespace

extern "C" {

// Each returns the cudaError_t of its launch (0 on success), launches on
// `stream`, does not synchronise and allocates nothing.  prod_bf16: the
// products are bf16, else f32; the output is f32.  rtile: columns of a
// rank tile (R itself, or a multiple of 32 * nv * vec); nv, vec: each lane
// walks nv chunks of vec columns (32 * nv * vec covers the tile, vec
// divides R and the tile, the products' address is aligned to vec
// elements; ops/kernels.py gather_vec).

// (nb, B) in-block ids + (nb, B, R) products -> (nb, S, R).  The output
// must be zeroed unless use_smem (every CTA then writes its whole tile).
int splatt_onehot_reduce_sorted(const void* ids, const void* prod,
                                int prod_bf16, int nb, int block, int R,
                                int S, int use_smem, int rtile, int nv,
                                int vec, void* out, void* stream) {
  return run(ids, prod, prod_bf16, nb, block, R, S, 0, use_smem, rtile, nv,
             vec, out, stream);
}

// (nb, B) global ids + (nb, B, R) products -> (width, R) totals into a
// zeroed output.
int splatt_onehot_reduce_full(const void* ids, const void* prod,
                              int prod_bf16, int nb, int block, int R,
                              int width, int rtile, int nv, int vec,
                              void* out, void* stream) {
  return run(ids, prod, prod_bf16, nb, block, R, width, 1, 0, rtile, nv, vec,
             out, stream);
}

}  // extern "C"

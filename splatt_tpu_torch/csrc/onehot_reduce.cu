// Segment sums of precomputed products for Hopper (sm_90a): the unfused
// MTTKRP reduction.
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
// carries value 0 and adds an exact 0.  The accumulator is f32.
//
// What bounds them on this card: bytes.  Each entry reads 4 B of id and
// 4*R B of product (2*R in bf16) once and does R additions; the output is
// small beside the (nb*B, R) product stream.
//
// What the design does about it: grid (nb, ceil(R / RT)) with RT = 32 *
// min(4, R/32), one CTA per block and rank tile, the warp-run reduction of
// warp_runs.cuh: lanes read a product row as whole 128-byte lines, and a
// warp keeps a running row sum in registers, flushed by atomicAdd when the
// id changes.  The sorted contract flushes into a shared (S, RT) tile,
// written out once (device memory when the tile exceeds 227 KB, into a
// zeroed output); the full contract flushes into the zeroed global output.
// The TPU kernels' one-hot matmul had a matrix unit to run on; here it
// would be S or width redundant multiply-adds per entry.

#include <algorithm>

#include "warp_runs.cuh"

using namespace splatt;

namespace {

struct Args {
  const int* ids;      // (nb, B)
  const void* prod;    // (nb, B, R), f32 or bf16
  int nb;
  int block;
  int R;
  int width;           // S (sorted) or the output rows (full)
  int full;
  int use_smem;
  int rtile;
  float* out;
};

// Entries of one block: ids and the rank tile [r0, r0 + cols) of the
// precomputed products, of type T.
template <class T>
struct ProdSrc {
  const int* ids;      // the block's ids
  const T* prod;       // the block's products, offset by r0
  int R;
  int cols;
  int my_row;

  __device__ __forceinline__ void load(int j, bool ok) {
    my_row = ok ? ids[j] : -1;
  }

  __device__ __forceinline__ int row(int t) const {
    return __shfl_sync(kFull, my_row, t);
  }

  template <int NR>
  __device__ __forceinline__ void product(int, int j, int lane,
                                          float (&p)[NR]) const {
    const T* q = prod + (long long)j * R;
#pragma unroll
    for (int i = 0; i < NR; ++i) {
      const int c = lane + 32 * i;
      p[i] = c < cols ? ld(q, c) : 0.f;
    }
  }
};

template <class T, int NR>
__device__ __forceinline__ void reduce_block(const Args& a, float* tile) {
  const int b = blockIdx.x;
  const int r0 = blockIdx.y * a.rtile;
  const int cols = min(a.rtile, a.R - r0);
  const long long base = (long long)b * a.block;
  ProdSrc<T> src{a.ids + base,
                 static_cast<const T*>(a.prod) + base * a.R + r0, a.R,
                 cols, -1};
  if (a.full) {
    warp_runs<NR>(src, a.block, a.out + r0, a.R, a.width, cols);
    return;
  }
  float* slab = a.out + (long long)b * a.width * a.R;
  if (!a.use_smem) {
    warp_runs<NR>(src, a.block, slab + r0, a.R, a.width, cols);
    return;
  }
  zero_tile(tile, (long long)a.width * cols);
  warp_runs<NR>(src, a.block, tile, cols, a.width, cols);
  store_tile(tile, slab, a.width, cols, a.R, r0);
}

template <class T, int NR>
__global__ void __launch_bounds__(kThreads, stream_min_blocks(NR))
onehot_sorted_kernel(const Args a) {
  extern __shared__ float tile[];
  reduce_block<T, NR>(a, tile);
}

template <class T, int NR>
__global__ void __launch_bounds__(kThreads, stream_min_blocks(NR))
onehot_full_kernel(const Args a) {
  reduce_block<T, NR>(a, nullptr);
}

template <class T, int NR>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  const dim3 grid(a.nb, (a.R + a.rtile - 1) / a.rtile);
  if (a.full) {
    onehot_full_kernel<T, NR><<<grid, kThreads, 0, stream>>>(a);
  } else {
    const size_t smem =
        a.use_smem ? (size_t)a.width * std::min(a.rtile, a.R) * sizeof(float)
                   : 0;
    const cudaError_t e = allow_smem(onehot_sorted_kernel<T, NR>, smem);
    if (e != cudaSuccess) return e;
    onehot_sorted_kernel<T, NR><<<grid, kThreads, smem, stream>>>(a);
  }
  return cudaGetLastError();
}

template <class T>
cudaError_t dispatch(const Args& a, cudaStream_t s) {
  switch (a.rtile / 32) {
    case 1: return launch<T, 1>(a, s);
    case 2: return launch<T, 2>(a, s);
    case 3: return launch<T, 3>(a, s);
    default: return launch<T, 4>(a, s);
  }
}

int run(const void* ids, const void* prod, int prod_bf16, int nb, int block,
        int R, int width, int full, int use_smem, void* out, void* stream) {
  if (nb < 1 || block < 1 || R < 1 || width < 1)
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
  a.rtile = 32 * std::min(4, (R + 31) / 32);
  a.out = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(prod_bf16 ? dispatch<__nv_bfloat16>(a, s)
                         : dispatch<float>(a, s));
}

}  // namespace

extern "C" {

// Each returns the cudaError_t of its launch (0 on success), launches on
// `stream`, does not synchronise and allocates nothing.  prod_bf16: the
// products are bf16, else f32; the output is f32.

// (nb, B) in-block ids + (nb, B, R) products -> (nb, S, R).  The output
// must be zeroed unless use_smem (every CTA then writes its whole tile).
int splatt_onehot_reduce_sorted(const void* ids, const void* prod,
                                int prod_bf16, int nb, int block, int R,
                                int S, int use_smem, void* out,
                                void* stream) {
  return run(ids, prod, prod_bf16, nb, block, R, S, 0, use_smem, out,
             stream);
}

// (nb, B) global ids + (nb, B, R) products -> (width, R) totals into a
// zeroed output.
int splatt_onehot_reduce_full(const void* ids, const void* prod,
                              int prod_bf16, int nb, int block, int R,
                              int width, void* out, void* stream) {
  return run(ids, prod, prod_bf16, nb, block, R, width, 1, 0, out, stream);
}

}  // extern "C"

// Fused blocked MTTKRP for Hopper (sm_90a): three entries, one contract.
//
// Replaces the TPU kernels of splatt_tpu/ops/pallas_kernels.py
//   fused_mttkrp_t   (entry :355)  -> splatt_fused_mttkrp_t_f32
//   fused_mttkrp_tg  (entry :507)  -> splatt_fused_mttkrp_tg_f32
//   fused_mttkrp     (entry :1340) -> splatt_fused_mttkrp_f32
// and keeps their contract.  For a layout cut into nb blocks of `block`
// nonzeros (inds (nmodes, nnz_pad) int32 sorted by the layout's mode, vals
// (nnz_pad,) f32, row_start (nb,) int32) and f32 factor tables (d_k, R):
//
//   accumulate == 0:  out[b, s, :] = sum over nonzeros j of block b with
//                     inds[mode][j] - row_start[b] == s of
//                     vals[j] * prod_{k != mode} U_k[clamp(inds[k][j]), :]
//                     out is (nb, width, R), width = the layout's seg_width;
//                     ids outside [0, width) (padding sentinels) are skipped.
//   accumulate == 1:  the same sum over all blocks at global ids
//                     inds[mode][j], out is (width, R), width = ceil8(dim+1).
//
// Gather ids clamp into [0, d_k - 1] (sentinel entries carry value 0).  The
// accumulator is f32.
//
// What bounds them on this card: memory and gathers.  A nonzero streams
// 4 B of index per mode and 4 B of value (16 B for three modes) and
// gathers one R-float row of every other factor, against about nmodes*R
// FLOP, far below the card's ratio of operations to bytes.  Factor tables
// of NELL-2 size (1.8 to 5.8 MB at R = 50) stay resident in the 50 MB L2.
//
// What the design does about it: one CTA per block (per block and rank
// tile for _tg, per `chunk` blocks for the row-major entry), the warp-run
// reduction of warp_runs.cuh with lanes over r, so each factor row is read
// as whole 128-byte lines.  The sorted contract flushes into a shared
// (width, cols) tile written to out[b] once, or straight to device memory
// when the tile does not fit; the accumulate contract flushes into a zeroed
// (width, R) output.  The TPU kernels' transposed R8 x D tables, replicated
// 8-sublane request tiles and one-hot matmul were Mosaic workarounds and
// have no counterpart here; so the three entries differ only in how the
// grid covers blocks and ranks:
//
//   _t   grid (nb): the whole rank in registers, R <= 256 (NR = R/32 sums
//        per lane).
//   _tg  grid (nb, ceil(R / RT)): a rank tile of RT = 32 * min(4, R/32)
//        columns per CTA, so registers and the shared tile (width, RT) do
//        not grow with R; every rank tile re-reads the block's id and value
//        streams.
//   row-major (fused_mttkrp) grid (ceil(nb / chunk)): a CTA walks `chunk`
//        consecutive blocks, R <= 256.

#include <algorithm>

#include "warp_runs.cuh"

using namespace splatt;

namespace {

struct Args {
  const int* inds;             // (nmodes, nnz_pad)
  const float* vals;           // (nnz_pad,)
  const int* row_start;        // (nb,)
  const float* fac[kMaxOther]; // tables of the non-output modes
  int fmode[kMaxOther];        // which mode each table belongs to
  int fdim[kMaxOther];         // rows of each table
  int nother;
  int mode;
  long long nnz_pad;
  int nb;
  int block;
  int R;
  int width;
  int accumulate;
  int use_smem;
  int rtile;                   // columns of a rank tile
  int chunk;                   // blocks per CTA (row-major entry)
  float* out;
};

// Entries of one block: output ids and the gathered Hadamard product of
// the rank tile [r0, r0 + cols).
struct FusedSrc {
  const Args& a;
  long long base;
  int shift;
  int r0;
  int cols;
  int my_row;
  float my_val;
  int my_g[kMaxOther];

  __device__ __forceinline__ void load(int j, bool ok) {
    my_row = -1;
    my_val = 0.f;
    if (ok) {
      my_row = a.inds[(long long)a.mode * a.nnz_pad + base + j] - shift;
      my_val = a.vals[base + j];
    }
#pragma unroll
    for (int k = 0; k < kMaxOther; ++k) {
      my_g[k] = 0;
      if (k < a.nother && ok) {
        const int g = a.inds[(long long)a.fmode[k] * a.nnz_pad + base + j];
        my_g[k] = min(max(g, 0), a.fdim[k] - 1);
      }
    }
  }

  __device__ __forceinline__ int row(int t) const {
    return __shfl_sync(kFull, my_row, t);
  }

  template <int NR>
  __device__ __forceinline__ void product(int t, int, int lane,
                                          float (&p)[NR]) const {
    const float v = __shfl_sync(kFull, my_val, t);
#pragma unroll
    for (int i = 0; i < NR; ++i) p[i] = v;
#pragma unroll
    for (int k = 0; k < kMaxOther; ++k) {
      if (k < a.nother) {
        const int g = __shfl_sync(kFull, my_g[k], t);
        const float* urow = a.fac[k] + (long long)g * a.R + r0;
#pragma unroll
        for (int i = 0; i < NR; ++i) {
          const int c = lane + 32 * i;
          if (c < cols) p[i] *= __ldg(urow + c);
        }
      }
    }
  }
};

// Reduce block b's rank tile starting at column r0 into the output.
template <int NR>
__device__ __forceinline__ void fused_block(const Args& a, int b, int r0,
                                            float* tile) {
  const int cols = min(a.rtile, a.R - r0);
  FusedSrc src{a, (long long)b * a.block,
               a.accumulate ? 0 : a.row_start[b], r0, cols};
  if (a.accumulate) {
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

template <int NR>
__global__ void __launch_bounds__(kThreads) fused_t_kernel(const Args a) {
  extern __shared__ float tile[];
  fused_block<NR>(a, blockIdx.x, 0, tile);
}

template <int NR>
__global__ void __launch_bounds__(kThreads) fused_tg_kernel(const Args a) {
  extern __shared__ float tile[];
  fused_block<NR>(a, blockIdx.x, blockIdx.y * a.rtile, tile);
}

template <int NR>
__global__ void __launch_bounds__(kThreads)
fused_rowmajor_kernel(const Args a) {
  extern __shared__ float tile[];
  const int b0 = blockIdx.x * a.chunk;
  const int b1 = min(b0 + a.chunk, a.nb);
  for (int b = b0; b < b1; ++b) fused_block<NR>(a, b, 0, tile);
}

enum class Grid { kT, kTG, kRowMajor };

template <Grid G, int NR>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  const int cols = std::min(a.rtile, a.R);
  const size_t smem = (!a.accumulate && a.use_smem)
                          ? (size_t)a.width * cols * sizeof(float)
                          : 0;
  cudaError_t e;
  if constexpr (G == Grid::kT) {
    if ((e = allow_smem(fused_t_kernel<NR>, smem)) != cudaSuccess) return e;
    fused_t_kernel<NR><<<a.nb, kThreads, smem, stream>>>(a);
  } else if constexpr (G == Grid::kTG) {
    if ((e = allow_smem(fused_tg_kernel<NR>, smem)) != cudaSuccess) return e;
    const dim3 g(a.nb, (a.R + a.rtile - 1) / a.rtile);
    fused_tg_kernel<NR><<<g, kThreads, smem, stream>>>(a);
  } else {
    if ((e = allow_smem(fused_rowmajor_kernel<NR>, smem)) != cudaSuccess)
      return e;
    fused_rowmajor_kernel<NR>
        <<<(a.nb + a.chunk - 1) / a.chunk, kThreads, smem, stream>>>(a);
  }
  return cudaGetLastError();
}

// Fill Args from the C entry's operands; false on an argument out of range.
bool make_args(Args& a, const void* inds, const void* vals,
               const void* row_start, const void* factors, const void* fdims,
               int nmodes, int mode, long long nnz_pad, int nb, int block,
               int R, int width, int accumulate, int use_smem, void* out) {
  if (nmodes < 2 || nmodes > kMaxOther + 1 || mode < 0 || mode >= nmodes ||
      R < 1 || nb < 1 || block < 1 || width < 1 ||
      nnz_pad != (long long)nb * block)
    return false;
  const float* const* fac = static_cast<const float* const*>(factors);
  const int* dims = static_cast<const int*>(fdims);
  a.inds = static_cast<const int*>(inds);
  a.vals = static_cast<const float*>(vals);
  a.row_start = static_cast<const int*>(row_start);
  int k = 0;
  for (int m = 0; m < nmodes; ++m) {
    if (m == mode) continue;
    a.fac[k] = fac[m];
    a.fmode[k] = m;
    a.fdim[k] = dims[m];
    ++k;
  }
  for (; k < kMaxOther; ++k) {
    a.fac[k] = nullptr;
    a.fmode[k] = 0;
    a.fdim[k] = 1;
  }
  a.nother = nmodes - 1;
  a.mode = mode;
  a.nnz_pad = nnz_pad;
  a.nb = nb;
  a.block = block;
  a.R = R;
  a.width = width;
  a.accumulate = accumulate;
  a.use_smem = use_smem;
  a.rtile = 32 * ((R + 31) / 32);
  a.chunk = 1;
  a.out = static_cast<float*>(out);
  return true;
}

// Launch with NR = ceil(cols / 32) sums per lane: up to 8 for the
// whole-rank grids, up to 4 (one rank tile) for _tg.
template <Grid G>
cudaError_t dispatch(const Args& a, cudaStream_t s) {
  const int nr = (std::min(a.rtile, a.R) + 31) / 32;
  if constexpr (G == Grid::kTG) {
    switch (nr) {
      case 1: return launch<G, 1>(a, s);
      case 2: return launch<G, 2>(a, s);
      case 3: return launch<G, 3>(a, s);
      default: return launch<G, 4>(a, s);
    }
  } else {
    switch (nr) {
      case 1: return launch<G, 1>(a, s);
      case 2: return launch<G, 2>(a, s);
      case 3: return launch<G, 3>(a, s);
      case 4: return launch<G, 4>(a, s);
      case 5: return launch<G, 5>(a, s);
      case 6: return launch<G, 6>(a, s);
      case 7: return launch<G, 7>(a, s);
      default: return launch<G, 8>(a, s);
    }
  }
}

}  // namespace

extern "C" {

// Common operands of the three entries.  factors: host array of nmodes
// device pointers (the output mode's entry is not read); fdims: host array
// of nmodes row counts.  Each returns the cudaError_t of its launch (0 on
// success), launches on `stream`, does not synchronise and allocates
// nothing.  The output must be zeroed unless use_smem (sorted contract,
// every CTA writes its whole tile).

// R <= 256: each lane holds R / 32 running sums in registers.
int splatt_fused_mttkrp_t_f32(const void* inds, const void* vals,
                              const void* row_start, const void* factors,
                              const void* fdims, int nmodes, int mode,
                              long long nnz_pad, int nb, int block, int R,
                              int width, int accumulate, int use_smem,
                              void* out, void* stream) {
  Args a;
  if (!make_args(a, inds, vals, row_start, factors, fdims, nmodes, mode,
                 nnz_pad, nb, block, R, width, accumulate, use_smem, out) ||
      R > 32 * 8)
    return (int)cudaErrorInvalidValue;
  return (int)dispatch<Grid::kT>(a, static_cast<cudaStream_t>(stream));
}

// Any R: rank tiles of rtile = 32 * min(4, ceil(R / 32)) columns.
int splatt_fused_mttkrp_tg_f32(const void* inds, const void* vals,
                               const void* row_start, const void* factors,
                               const void* fdims, int nmodes, int mode,
                               long long nnz_pad, int nb, int block, int R,
                               int width, int accumulate, int use_smem,
                               void* out, void* stream) {
  Args a;
  if (!make_args(a, inds, vals, row_start, factors, fdims, nmodes, mode,
                 nnz_pad, nb, block, R, width, accumulate, use_smem, out))
    return (int)cudaErrorInvalidValue;
  a.rtile = 32 * std::min(4, (R + 31) / 32);
  return (int)dispatch<Grid::kTG>(a, static_cast<cudaStream_t>(stream));
}

// R <= 256, `chunk` consecutive blocks per CTA.
int splatt_fused_mttkrp_f32(const void* inds, const void* vals,
                            const void* row_start, const void* factors,
                            const void* fdims, int nmodes, int mode,
                            long long nnz_pad, int nb, int block, int R,
                            int width, int accumulate, int use_smem,
                            int chunk, void* out, void* stream) {
  Args a;
  if (!make_args(a, inds, vals, row_start, factors, fdims, nmodes, mode,
                 nnz_pad, nb, block, R, width, accumulate, use_smem, out) ||
      R > 32 * 8 || chunk < 1)
    return (int)cudaErrorInvalidValue;
  a.chunk = chunk;
  return (int)dispatch<Grid::kRowMajor>(a,
                                          static_cast<cudaStream_t>(stream));
}

}  // extern "C"

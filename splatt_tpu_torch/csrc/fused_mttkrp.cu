// Fused blocked MTTKRP for Hopper (sm_90a): three entries, one contract.
//
// Replaces the TPU kernels of splatt_tpu/ops/pallas_kernels.py
//   fused_mttkrp_t   (entry :355)  -> splatt_fused_mttkrp_t
//   fused_mttkrp_tg  (entry :507)  -> splatt_fused_mttkrp_tg
//   fused_mttkrp     (entry :1340) -> splatt_fused_mttkrp
// and keeps their contract.  For a layout cut into nb blocks of `block`
// nonzeros (inds (nmodes, nnz_pad) int32 sorted by the layout's mode, vals
// (nnz_pad,) f32 or bf16, row_start (nb,) int32) and factor tables (d_k, R)
// of one type T, f32 or bf16:
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
// product is formed in T (a bf16 product is rounded after each multiply,
// as the plain version's bf16 `prod * rows` is); the accumulator is f32.
//
// What bounds them on this card: memory and gathers.  A nonzero streams
// 4 B of index per mode and 4 B of value (16 B for three modes; 14 B with
// bf16 values) and gathers one R-element row of every other factor,
// against about nmodes*R FLOP, far below the card's ratio of operations to
// bytes.  Factor tables
// of NELL-2 size (1.8 to 5.8 MB at R = 50) stay resident in the 50 MB L2.
//
// What the design does about it: one CTA per block (per block and rank
// tile for _tg, per `chunk` blocks for the row-major entry), the warp-run
// reduction of warp_runs.cuh with lanes over r, so each factor row is read
// as whole 128-byte lines.  A warp's gather ids for its current 32 entries
// sit in a shared scratch (kIdsInts), not in registers: the kernels wait on
// gathers, and registers bound the warps in flight.  The sorted contract
// flushes into a shared (width, cols) tile after the scratch, written to
// out[b] once, or straight to device memory when the tile does not fit;
// the accumulate contract flushes into a zeroed (width, R) output.  The TPU kernels' transposed R8 x D tables, replicated
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

// shared ints before the tile: each warp's gather ids, [mode][32 entries]
constexpr int kIdsInts = kWarps * kMaxOther * 32;

struct Args {
  const int* inds;             // (nmodes, nnz_pad)
  const void* vals;            // (nnz_pad,) f32 or bf16
  int vals_bf16;
  const int* row_start;        // (nb,)
  const void* fac[kMaxOther];  // tables of the non-output modes (T)
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
// the rank tile [r0, r0 + cols), formed in the table type T.
template <class T>
struct FusedSrc {
  const Args& a;
  long long base;
  int shift;
  int r0;
  int cols;
  int* ids;                    // shared: this warp's [mode][32] gather ids
  int my_row;
  float my_val;

  __device__ __forceinline__ void load(int j, bool ok) {
    const int lane = threadIdx.x & 31;
    __syncwarp();   // the warp is done with the previous 32 entries' ids
    my_row = -1;
    my_val = 0.f;
    if (ok) {
      my_row = a.inds[(long long)a.mode * a.nnz_pad + base + j] - shift;
      my_val = load_val<T>(a.vals, a.vals_bf16, base + j);
    }
#pragma unroll
    for (int k = 0; k < kMaxOther; ++k) {
      if (k >= a.nother) break;
      const int g =
          ok ? a.inds[(long long)a.fmode[k] * a.nnz_pad + base + j] : 0;
      ids[k * 32 + lane] = min(max(g, 0), a.fdim[k] - 1);
    }
    __syncwarp();
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
      if (k >= a.nother) break;
      const T* urow = static_cast<const T*>(a.fac[k]) +
                      (long long)ids[k * 32 + t] * a.R + r0;
#pragma unroll
      for (int i = 0; i < NR; ++i) {
        const int c = lane + 32 * i;
        if (c < cols) p[i] = to_t<T>(p[i] * ld(urow, c));
      }
    }
  }
};

// Reduce block b's rank tile starting at column r0 into the output.
template <class T, int NR>
__device__ __forceinline__ void fused_block(const Args& a, int b, int r0,
                                            float* smem) {
  const int cols = min(a.rtile, a.R - r0);
  int* ids = reinterpret_cast<int*>(smem) +
             (threadIdx.x >> 5) * kMaxOther * 32;
  float* tile = smem + kIdsInts;
  FusedSrc<T> src{a, (long long)b * a.block,
                  a.accumulate ? 0 : a.row_start[b], r0, cols, ids};
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

template <class T, int NR>
__global__ void __launch_bounds__(kThreads, gather_min_blocks(NR))
fused_t_kernel(const Args a) {
  extern __shared__ float smem[];
  fused_block<T, NR>(a, blockIdx.x, 0, smem);
}

template <class T, int NR>
__global__ void __launch_bounds__(kThreads, gather_min_blocks(NR))
fused_tg_kernel(const Args a) {
  extern __shared__ float smem[];
  fused_block<T, NR>(a, blockIdx.x, blockIdx.y * a.rtile, smem);
}

template <class T, int NR>
__global__ void __launch_bounds__(kThreads, gather_min_blocks(NR))
fused_rowmajor_kernel(const Args a) {
  extern __shared__ float smem[];
  const int b0 = blockIdx.x * a.chunk;
  const int b1 = min(b0 + a.chunk, a.nb);
  for (int b = b0; b < b1; ++b) fused_block<T, NR>(a, b, 0, smem);
}

enum class Grid { kT, kTG, kRowMajor };

template <Grid G, class T, int NR>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  const int cols = std::min(a.rtile, a.R);
  const size_t smem =
      kIdsInts * sizeof(int) + ((!a.accumulate && a.use_smem)
                                    ? (size_t)a.width * cols * sizeof(float)
                                    : 0);
  cudaError_t e;
  if constexpr (G == Grid::kT) {
    if ((e = allow_smem(fused_t_kernel<T, NR>, smem)) != cudaSuccess)
      return e;
    fused_t_kernel<T, NR><<<a.nb, kThreads, smem, stream>>>(a);
  } else if constexpr (G == Grid::kTG) {
    if ((e = allow_smem(fused_tg_kernel<T, NR>, smem)) != cudaSuccess)
      return e;
    const dim3 g(a.nb, (a.R + a.rtile - 1) / a.rtile);
    fused_tg_kernel<T, NR><<<g, kThreads, smem, stream>>>(a);
  } else {
    if ((e = allow_smem(fused_rowmajor_kernel<T, NR>, smem)) != cudaSuccess)
      return e;
    fused_rowmajor_kernel<T, NR>
        <<<(a.nb + a.chunk - 1) / a.chunk, kThreads, smem, stream>>>(a);
  }
  return cudaGetLastError();
}

// Fill Args from the C entry's operands; false on an argument out of range.
bool make_args(Args& a, const void* inds, const void* vals, int vals_bf16,
               const void* row_start, const void* factors, const void* fdims,
               int nmodes, int mode, long long nnz_pad, int nb, int block,
               int R, int width, int accumulate, int use_smem, void* out) {
  if (nmodes < 2 || nmodes > kMaxOther + 1 || mode < 0 || mode >= nmodes ||
      R < 1 || nb < 1 || block < 1 || width < 1 ||
      nnz_pad != (long long)nb * block)
    return false;
  const void* const* fac = static_cast<const void* const*>(factors);
  const int* dims = static_cast<const int*>(fdims);
  a.inds = static_cast<const int*>(inds);
  a.vals = vals;
  a.vals_bf16 = vals_bf16;
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
template <Grid G, class T>
cudaError_t dispatch_nr(const Args& a, cudaStream_t s) {
  const int nr = (std::min(a.rtile, a.R) + 31) / 32;
  if constexpr (G == Grid::kTG) {
    switch (nr) {
      case 1: return launch<G, T, 1>(a, s);
      case 2: return launch<G, T, 2>(a, s);
      case 3: return launch<G, T, 3>(a, s);
      default: return launch<G, T, 4>(a, s);
    }
  } else {
    switch (nr) {
      case 1: return launch<G, T, 1>(a, s);
      case 2: return launch<G, T, 2>(a, s);
      case 3: return launch<G, T, 3>(a, s);
      case 4: return launch<G, T, 4>(a, s);
      case 5: return launch<G, T, 5>(a, s);
      case 6: return launch<G, T, 6>(a, s);
      case 7: return launch<G, T, 7>(a, s);
      default: return launch<G, T, 8>(a, s);
    }
  }
}

// ... and tables of type T: float, or bf16 with `tabs_bf16`.
template <Grid G>
cudaError_t dispatch(const Args& a, int tabs_bf16, cudaStream_t s) {
  return tabs_bf16 ? dispatch_nr<G, __nv_bfloat16>(a, s)
                   : dispatch_nr<G, float>(a, s);
}

}  // namespace

extern "C" {

// Common operands of the three entries.  vals_bf16: the values are bf16,
// else f32; factors: host array of nmodes device pointers to tables of
// one type (the output mode's entry is not read), bf16 with tabs_bf16,
// else f32; fdims: host array of nmodes row counts.  Each returns the
// cudaError_t of its launch (0 on success), launches on `stream`, does
// not synchronise and allocates nothing.  The output (f32) must be zeroed
// unless use_smem (sorted contract, every CTA writes its whole tile).

// R <= 256: each lane holds R / 32 running sums in registers.
int splatt_fused_mttkrp_t(const void* inds, const void* vals, int vals_bf16,
                          const void* row_start, const void* factors,
                          const void* fdims, int tabs_bf16, int nmodes,
                          int mode, long long nnz_pad, int nb, int block,
                          int R, int width, int accumulate, int use_smem,
                          void* out, void* stream) {
  Args a;
  if (!make_args(a, inds, vals, vals_bf16, row_start, factors, fdims,
                 nmodes, mode, nnz_pad, nb, block, R, width, accumulate,
                 use_smem, out) ||
      R > 32 * 8)
    return (int)cudaErrorInvalidValue;
  return (int)dispatch<Grid::kT>(a, tabs_bf16,
                                 static_cast<cudaStream_t>(stream));
}

// Any R: rank tiles of rtile = 32 * min(4, ceil(R / 32)) columns.
int splatt_fused_mttkrp_tg(const void* inds, const void* vals,
                           int vals_bf16, const void* row_start,
                           const void* factors, const void* fdims,
                           int tabs_bf16, int nmodes, int mode,
                           long long nnz_pad, int nb, int block, int R,
                           int width, int accumulate, int use_smem,
                           void* out, void* stream) {
  Args a;
  if (!make_args(a, inds, vals, vals_bf16, row_start, factors, fdims,
                 nmodes, mode, nnz_pad, nb, block, R, width, accumulate,
                 use_smem, out))
    return (int)cudaErrorInvalidValue;
  a.rtile = 32 * std::min(4, (R + 31) / 32);
  return (int)dispatch<Grid::kTG>(a, tabs_bf16,
                                  static_cast<cudaStream_t>(stream));
}

// R <= 256, `chunk` consecutive blocks per CTA.
int splatt_fused_mttkrp(const void* inds, const void* vals, int vals_bf16,
                        const void* row_start, const void* factors,
                        const void* fdims, int tabs_bf16, int nmodes,
                        int mode, long long nnz_pad, int nb, int block,
                        int R, int width, int accumulate, int use_smem,
                        int chunk, void* out, void* stream) {
  Args a;
  if (!make_args(a, inds, vals, vals_bf16, row_start, factors, fdims,
                 nmodes, mode, nnz_pad, nb, block, R, width, accumulate,
                 use_smem, out) ||
      R > 32 * 8 || chunk < 1)
    return (int)cudaErrorInvalidValue;
  a.chunk = chunk;
  return (int)dispatch<Grid::kRowMajor>(a, tabs_bf16,
                                        static_cast<cudaStream_t>(stream));
}

}  // extern "C"

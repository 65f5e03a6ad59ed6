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
// What bounds them on this card.  A nonzero streams 4 B of index per mode
// and 4 B of value (16 B for three modes; 14 B with bf16 values) and
// gathers one R-element row of every other factor, against about nmodes*R
// FLOP, far below the card's ratio of operations to bytes; the tables (1.8
// to 5.8 MB at R = 50; a rank tile of them at R = 512) stay resident in
// the 50 MB L2.  At R = 512 a launch requests 20M nonzeros x 2 tables x 2
// KB = 81.9 GB of rows, at R = 50 9.0 GB (each 200-byte row touches 7
// sectors of 32 bytes); these count requests, some of which the L1 serves.
// What bounds the walk below was not identified: with every gathered id 0
// (one row, no wait on L2) a launch at R = 512 still takes 5.1 of its 9.9
// ms, so about half of it is per-entry work (ids, values, products,
// flushes), the other half the wait on gathers; a library copy inside L2
// (3.7-4.4 TB/s) and a library row gather (2.2-2.5 TB/s of requested
// sectors) both run below the walk's 8.2 TB/s of requests, so neither
// bounds it (PERF.md section 6; H100 80GB HBM3, 700 W).
//
// What the design does: one walk for all three entries, gather_walk.cuh's
// walk_rows.  A CTA of 8 warps reduces one block at a time; a warp walks a
// contiguous run of the block's entries with the rows of 4 entries in
// flight, each lane loading its chunks of vec columns (8 or 16 bytes where
// R and the tables' alignment allow, ops/kernels.py gather_vec) with the
// next 32 entries' ids fetched ahead, keeps a running row sum in registers
// and flushes it when the sorted id changes.  A warp's gather ids for its
// current 32 entries sit in a shared scratch (kIdsInts).  The sorted
// contract flushes into a shared (width, cols) tile after the scratch,
// written to out[b] once, or straight to device memory when the tile does
// not fit; the accumulate contract flushes into a zeroed (width, R)
// output.  The TPU kernels' transposed R8 x D tables, replicated 8-sublane
// request tiles and one-hot matmul were Mosaic workarounds and have no
// counterpart here.  The entries differ in the grid and the rank tile:
//
//   _t   grid (nb): one CTA per block, the whole rank in one tile, R <=
//        256 (up to 8 columns per lane); the same kernel as _tg with
//        rtile = R, so the block's id and value streams are read once.
//   _tg  grid (nb, ceil(R / rtile)): rank tiles of rtile = 128 columns
//        (the whole rank up to 128; ops/kernels.py tg_rank_tile), so
//        registers and the shared tile (width, rtile) do not grow with R
//        and a launch gathers one tile's columns of the tables; every rank
//        tile re-reads the block's id and value streams.  At R <= 128 it
//        runs _t's launch.
//   row-major (fused_mttkrp) grid ceil(nb / chunk): a CTA walks `chunk`
//        consecutive blocks in turn, the whole rank, R <= 256; each
//        block's walk starts afresh, so no id is fetched past a block.
//
// Measured on the new walk (PERF.md section 6, H100 80GB HBM3, 700 W):
// _tg at R = 512 9.9-10.0 ms a launch (13.3 on the one-entry walk it
// replaced), at R = 50 1.14 (2.04).  A cp.async ring in shared memory ran
// 1.6-2.2x slower and was dropped.

#include <algorithm>

#include "gather_walk.cuh"

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
// the rank tile starting at column r0, formed in the table type T; the
// gather source of gather_walk.cuh's walk_rows.  fetch reads entry j's ids
// and value into registers a load ahead (j < the block's n, so never into
// the next block's stream), commit makes the fetched 32 entries the
// current ones.
template <class T>
struct FusedSrc {
  const Args& a;
  long long base;
  int shift;
  int r0;
  int* ids;                    // shared: this warp's [mode][32] gather ids
  int my_row;
  float my_val;
  int f_row;
  float f_val;
  int f_ids[kMaxOther];

  __device__ __forceinline__ void fetch(int j, bool ok) {
    f_row = ok ? a.inds[(long long)a.mode * a.nnz_pad + base + j] - shift
               : -1;
    f_val = ok ? load_val<T>(a.vals, a.vals_bf16, base + j) : 0.f;
#pragma unroll
    for (int k = 0; k < kMaxOther; ++k) {
      if (k >= a.nother) break;
      f_ids[k] = ok ? a.inds[(long long)a.fmode[k] * a.nnz_pad + base + j]
                    : 0;
    }
  }

  __device__ __forceinline__ void commit() {
    const int lane = threadIdx.x & 31;
    __syncwarp();   // the warp is done with the previous 32 entries' ids
    my_row = f_row;
    my_val = f_val;
#pragma unroll
    for (int k = 0; k < kMaxOther; ++k) {
      if (k >= a.nother) break;
      ids[k * 32 + lane] = min(max(f_ids[k], 0), a.fdim[k] - 1);
    }
    __syncwarp();
  }

  __device__ __forceinline__ int row(int t) const {
    return __shfl_sync(kFull, my_row, t);
  }
  __device__ __forceinline__ float val(int t) const {
    return __shfl_sync(kFull, my_val, t);
  }
  __device__ __forceinline__ const int* ids_of(int k) const {
    return ids + k * 32;
  }
  __device__ __forceinline__ const T* table(int k) const {
    return static_cast<const T*>(a.fac[k]) + r0;
  }
  __device__ __forceinline__ int pitch() const { return a.R; }
  __device__ __forceinline__ int ntables() const { return a.nother; }
};

// Shared bytes before the sorted contract's tile: each warp's gather ids.
constexpr size_t kTileOffset = kIdsInts * sizeof(int);

// Reduce block b's rank tile starting at column r0 into the output, NV
// chunks of VEC columns per lane, TWO or more gathered tables (else one,
// a 2-mode tensor).
template <class T, int NV, int VEC, bool TWO>
__device__ __forceinline__ void fused_block(const Args& a, int b, int r0,
                                            float* smem) {
  const int cols = min(a.rtile, a.R - r0);
  const int warp = threadIdx.x >> 5;
  int* ids = reinterpret_cast<int*>(smem) + warp * kMaxOther * 32;
  float* tile = smem + kTileOffset / sizeof(float);
  FusedSrc<T> src{a, (long long)b * a.block,
                  a.accumulate ? 0 : a.row_start[b], r0, ids};
  if (a.accumulate) {
    walk_rows<T, NV, VEC, TWO>(src, a.block, a.out + r0, a.R, a.width,
                               cols);
    return;
  }
  float* slab = a.out + (long long)b * a.width * a.R;
  if (!a.use_smem) {
    walk_rows<T, NV, VEC, TWO>(src, a.block, slab + r0, a.R, a.width, cols);
    return;
  }
  zero_tile(tile, (long long)a.width * cols);
  walk_rows<T, NV, VEC, TWO>(src, a.block, tile, cols, a.width, cols);
  store_tile(tile, slab, a.width, cols, a.R, r0);
}

// fused_mttkrp_t and _tg: grid (nb, ceil(R / rtile)), block blockIdx.x,
// rank tile blockIdx.y.
template <class T, int NV, int VEC, bool TWO>
__global__ void __launch_bounds__(kThreads, walk_min_blocks(NV * VEC))
fused_tile_kernel(const Args a) {
  extern __shared__ float smem[];
  fused_block<T, NV, VEC, TWO>(a, blockIdx.x, blockIdx.y * a.rtile, smem);
}

// fused_mttkrp: grid ceil(nb / chunk), the whole rank; a CTA walks its
// `chunk` consecutive blocks in turn.
template <class T, int NV, int VEC, bool TWO>
__global__ void __launch_bounds__(kThreads, walk_min_blocks(NV * VEC))
fused_rowmajor_kernel(const Args a) {
  extern __shared__ float smem[];
  const int b0 = blockIdx.x * a.chunk;
  const int b1 = min(b0 + a.chunk, a.nb);
  for (int b = b0; b < b1; ++b) fused_block<T, NV, VEC, TWO>(a, b, 0, smem);
}

// Dynamic shared memory of a launch: the gather ids (kTileOffset), then
// the sorted contract's (width, cols) tile when it fits.
size_t smem_bytes(const Args& a) {
  const int cols = std::min(a.rtile, a.R);
  return kTileOffset +
         ((!a.accumulate && a.use_smem)
              ? (size_t)a.width * cols * sizeof(float)
              : 0);
}

// A launch with NV chunks of VEC columns per lane: the rank-tiled grid of
// fused_mttkrp_t and _tg, or with ROWMAJOR the grid of fused_mttkrp.
template <class T, bool ROWMAJOR>
struct Launch {
  const Args& a;
  cudaStream_t stream;
  template <int NV, int VEC, bool TWO>
  cudaError_t go() const {
    const size_t smem = smem_bytes(a);
    cudaError_t e;
    if constexpr (ROWMAJOR) {
      if ((e = allow_smem(fused_rowmajor_kernel<T, NV, VEC, TWO>, smem)) !=
          cudaSuccess)
        return e;
      fused_rowmajor_kernel<T, NV, VEC, TWO>
          <<<(a.nb + a.chunk - 1) / a.chunk, kThreads, smem, stream>>>(a);
    } else {
      if ((e = allow_smem(fused_tile_kernel<T, NV, VEC, TWO>, smem)) !=
          cudaSuccess)
        return e;
      const dim3 g(a.nb, (a.R + a.rtile - 1) / a.rtile);
      fused_tile_kernel<T, NV, VEC, TWO><<<g, kThreads, smem, stream>>>(a);
    }
    return cudaGetLastError();
  }
  template <int NV, int VEC>
  cudaError_t run() const {
    return a.nother > 1 ? go<NV, VEC, true>() : go<NV, VEC, false>();
  }
};

// Launch on tables of type T (bf16 with `tabs_bf16`, else float) with the
// host's (nv, vec); cudaErrorInvalidValue when (nv, vec) does not cover
// the rank tile in whole aligned loads (ops/kernels.py gather_vec).
template <bool ROWMAJOR>
cudaError_t dispatch(const Args& a, int tabs_bf16, int nv, int vec,
                     cudaStream_t s) {
  const int cols = std::min(a.rtile, a.R);
  if (nv < 1 || vec < 1 || a.R % vec != 0 || 32 * nv * vec < cols ||
      (a.rtile < a.R && a.rtile % (32 * nv * vec) != 0))
    return cudaErrorInvalidValue;
  return tabs_bf16 ? dispatch_chunks<__nv_bfloat16>(
                         nv, vec, Launch<__nv_bfloat16, ROWMAJOR>{a, s})
                   : dispatch_chunks<float>(nv, vec,
                                            Launch<float, ROWMAJOR>{a, s});
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
  a.rtile = R;
  a.chunk = 1;
  a.out = static_cast<float*>(out);
  return true;
}

}  // namespace

extern "C" {

// Common operands of the three entries.  vals_bf16: the values are bf16,
// else f32; factors: host array of nmodes device pointers to tables of
// one type (the output mode's entry is not read), bf16 with tabs_bf16,
// else f32; fdims: host array of nmodes row counts; nv, vec: each lane
// walks nv chunks of vec columns (32 * nv * vec covers the rank tile, vec
// divides R and the tile, the tables' bases are aligned to vec elements;
// ops/kernels.py gather_vec).  Each returns the cudaError_t of its launch
// (0 on success), launches on `stream`, does not synchronise and
// allocates nothing.  The output (f32) must be zeroed unless use_smem
// (sorted contract, every CTA writes its whole tile).

// R <= 256: the whole rank in one tile, one CTA per block.
int splatt_fused_mttkrp_t(const void* inds, const void* vals, int vals_bf16,
                          const void* row_start, const void* factors,
                          const void* fdims, int tabs_bf16, int nmodes,
                          int mode, long long nnz_pad, int nb, int block,
                          int R, int width, int accumulate, int use_smem,
                          int nv, int vec, void* out, void* stream) {
  Args a;
  if (!make_args(a, inds, vals, vals_bf16, row_start, factors, fdims,
                 nmodes, mode, nnz_pad, nb, block, R, width, accumulate,
                 use_smem, out) ||
      R > 32 * 8)
    return (int)cudaErrorInvalidValue;
  return (int)dispatch<false>(a, tabs_bf16, nv, vec,
                              static_cast<cudaStream_t>(stream));
}

// Any R: rank tiles of `rtile` columns (a multiple of 32 * nv * vec, or R
// itself) on grid.y.
int splatt_fused_mttkrp_tg(const void* inds, const void* vals,
                           int vals_bf16, const void* row_start,
                           const void* factors, const void* fdims,
                           int tabs_bf16, int nmodes, int mode,
                           long long nnz_pad, int nb, int block, int R,
                           int width, int accumulate, int use_smem,
                           int rtile, int nv, int vec, void* out,
                           void* stream) {
  Args a;
  if (!make_args(a, inds, vals, vals_bf16, row_start, factors, fdims,
                 nmodes, mode, nnz_pad, nb, block, R, width, accumulate,
                 use_smem, out) ||
      rtile < 1)
    return (int)cudaErrorInvalidValue;
  a.rtile = rtile;
  return (int)dispatch<false>(a, tabs_bf16, nv, vec,
                              static_cast<cudaStream_t>(stream));
}

// R <= 256, the whole rank, `chunk` consecutive blocks per CTA.
int splatt_fused_mttkrp(const void* inds, const void* vals, int vals_bf16,
                        const void* row_start, const void* factors,
                        const void* fdims, int tabs_bf16, int nmodes,
                        int mode, long long nnz_pad, int nb, int block,
                        int R, int width, int accumulate, int use_smem,
                        int chunk, int nv, int vec, void* out,
                        void* stream) {
  Args a;
  if (!make_args(a, inds, vals, vals_bf16, row_start, factors, fdims,
                 nmodes, mode, nnz_pad, nb, block, R, width, accumulate,
                 use_smem, out) ||
      R > 32 * 8 || chunk < 1)
    return (int)cudaErrorInvalidValue;
  a.chunk = chunk;
  return (int)dispatch<true>(a, tabs_bf16, nv, vec,
                             static_cast<cudaStream_t>(stream));
}

}  // extern "C"

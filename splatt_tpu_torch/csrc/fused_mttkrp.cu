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
// On warp_runs' walk the request rate rose with the bytes in flight per SM
// at one latency, ~0.65 us a round trip by Little's law: a latency-bound
// walk.  The redesign below is not bound by one thing that was measured:
// with every gathered id 0 (one row, no wait on L2) a launch at R = 512
// still takes 5.1 of its 9.9 ms, so about half of it is per-entry work
// (ids, values, products, flushes), the other half the wait on gathers.
// No L2 ceiling was measured: a library copy inside L2 reaches 3.7-4.4
// TB/s, under the kernel's 8.2 TB/s of requests, so it bounds nothing
// (PERF.md section 6 gives these and a library gather's rate; H100 80GB
// HBM3, 700 W).
//
// What the design does about it: one CTA per block (per block and rank
// tile for _tg, per `chunk` blocks for the row-major entry); a warp walks
// a contiguous run of the block's entries, keeps a running row sum in
// registers and flushes it when the sorted id changes.  A warp's gather ids
// for its current 32 entries sit in a shared scratch (kIdsInts).  The
// sorted contract flushes into a shared (width, cols) tile after the
// scratch, written to out[b] once, or straight to device memory when the
// tile does not fit; the accumulate contract flushes into a zeroed (width,
// R) output.  The TPU kernels' transposed R8 x D tables, replicated
// 8-sublane request tiles and one-hot matmul were Mosaic workarounds and
// have no counterpart here.  The entries differ in the grid and the walk:
//
//   _t   grid (nb), warp_runs.cuh's walk: the whole rank in registers,
//        R <= 256, lanes over columns (NR = R/32 sums per lane), one
//        entry's rows in flight per warp.
//   _tg  grid (nb, ceil(R / RT)): a rank tile of RT = 128 columns (the
//        whole rank up to 128; ops/kernels.py tg_rank_tile), so registers
//        and the shared tile (width, RT) do not grow with R and a launch
//        gathers one tile's columns of the tables; every rank tile re-reads
//        the block's id and value streams.  Its walk is gather_walk.cuh's:
//        on warp_runs' walk a warp had one entry's rows in flight, each an
//        L2 round trip of ~0.65 us under load by Little's law: 13.3 ms per
//        launch at R = 512 (6.2 TB/s of gathered rows).  The new walk keeps
//        4 entries' rows in flight per warp and loads 16 bytes a lane (8 at
//        R = 50); a first version stopped at 10.2 ms, 8.9 of them left with
//        every gathered id 0, so it also cuts the instructions an entry
//        takes: loads are unconditional, a row's address is one
//        multiply-add, and the next 32 entries' ids are fetched while these
//        are walked.  9.9-10.0 ms at R = 512 (8.2-8.3 TB/s of requested
//        sectors; 5.1 ms with the ids zeroed), 1.13-1.14 ms at R = 50 (2.04
//        before) (PERF.md, H100 80GB HBM3, 700 W).  A cp.async ring in
//        shared memory ran 1.6-2.2x slower and was dropped.
//   row-major (fused_mttkrp) grid (ceil(nb / chunk)), warp_runs' walk: a
//        CTA walks `chunk` consecutive blocks, R <= 256.

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

  // the gather-source interface of gather_walk.cuh (fused_mttkrp_tg):
  // fetch reads entry j's ids and value into registers a load ahead,
  // commit makes the fetched 32 entries the current ones
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

// Shared bytes before the sorted contract's tile: each warp's gather ids.
constexpr size_t kTileOffset = kIdsInts * sizeof(int);

// A block's walk: warp_runs<NR> (one entry in flight per warp, lanes over
// columns) when NV == 0, else gather_walk.cuh's walk_rows<T, NV, VEC,
// TWO>.
template <class T, int NR, int NV, int VEC, bool TWO, class Src>
__device__ __forceinline__ void walk(Src& src, int n, float* dst,
                                     long long ld, int width, int cols) {
  if constexpr (NV == 0)
    warp_runs<NR>(src, n, dst, ld, width, cols);
  else
    walk_rows<T, NV, VEC, TWO>(src, n, dst, ld, width, cols);
}

// Reduce block b's rank tile starting at column r0 into the output.
template <class T, int NR, int NV = 0, int VEC = 0, bool TWO = true>
__device__ __forceinline__ void fused_block(const Args& a, int b, int r0,
                                            float* smem) {
  const int cols = min(a.rtile, a.R - r0);
  const int warp = threadIdx.x >> 5;
  int* ids = reinterpret_cast<int*>(smem) + warp * kMaxOther * 32;
  float* tile = smem + kTileOffset / sizeof(float);
  FusedSrc<T> src{a, (long long)b * a.block,
                  a.accumulate ? 0 : a.row_start[b], r0, cols, ids};
  if (a.accumulate) {
    walk<T, NR, NV, VEC, TWO>(src, a.block, a.out + r0, a.R, a.width,
                              cols);
    return;
  }
  float* slab = a.out + (long long)b * a.width * a.R;
  if (!a.use_smem) {
    walk<T, NR, NV, VEC, TWO>(src, a.block, slab + r0, a.R, a.width, cols);
    return;
  }
  zero_tile(tile, (long long)a.width * cols);
  walk<T, NR, NV, VEC, TWO>(src, a.block, tile, cols, a.width, cols);
  store_tile(tile, slab, a.width, cols, a.R, r0);
}

template <class T, int NR>
__global__ void __launch_bounds__(kThreads, gather_min_blocks(NR))
fused_t_kernel(const Args a) {
  extern __shared__ float smem[];
  fused_block<T, NR>(a, blockIdx.x, 0, smem);
}

// The rank-tiled grid on gather_walk.cuh's walk: NV chunks of VEC columns
// per lane, TWO or more gathered tables (else one, a 2-mode tensor).
template <class T, int NV, int VEC, bool TWO>
__global__ void __launch_bounds__(kThreads, walk_min_blocks(NV * VEC))
fused_tg_kernel(const Args a) {
  extern __shared__ float smem[];
  fused_block<T, 0, NV, VEC, TWO>(a, blockIdx.x, blockIdx.y * a.rtile,
                                  smem);
}

template <class T, int NR>
__global__ void __launch_bounds__(kThreads, gather_min_blocks(NR))
fused_rowmajor_kernel(const Args a) {
  extern __shared__ float smem[];
  const int b0 = blockIdx.x * a.chunk;
  const int b1 = min(b0 + a.chunk, a.nb);
  for (int b = b0; b < b1; ++b) fused_block<T, NR>(a, b, 0, smem);
}

enum class Grid { kT, kRowMajor };

// Dynamic shared memory of a launch: the gather ids (tile_offset), then
// the sorted contract's (width, cols) tile when it fits.
size_t smem_bytes(const Args& a) {
  const int cols = std::min(a.rtile, a.R);
  return kTileOffset +
         ((!a.accumulate && a.use_smem)
              ? (size_t)a.width * cols * sizeof(float)
              : 0);
}

template <Grid G, class T, int NR>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  const size_t smem = smem_bytes(a);
  cudaError_t e;
  if constexpr (G == Grid::kT) {
    if ((e = allow_smem(fused_t_kernel<T, NR>, smem)) != cudaSuccess)
      return e;
    fused_t_kernel<T, NR><<<a.nb, kThreads, smem, stream>>>(a);
  } else {
    if ((e = allow_smem(fused_rowmajor_kernel<T, NR>, smem)) != cudaSuccess)
      return e;
    fused_rowmajor_kernel<T, NR>
        <<<(a.nb + a.chunk - 1) / a.chunk, kThreads, smem, stream>>>(a);
  }
  return cudaGetLastError();
}

// fused_mttkrp_tg's launch: grid (nb, ceil(R / rtile)), NV chunks of VEC
// columns per lane.
template <class T>
struct LaunchTG {
  const Args& a;
  cudaStream_t stream;
  template <int NV, int VEC, bool TWO>
  cudaError_t go() const {
    const size_t smem = smem_bytes(a);
    const cudaError_t e = allow_smem(fused_tg_kernel<T, NV, VEC, TWO>, smem);
    if (e != cudaSuccess) return e;
    const dim3 g(a.nb, (a.R + a.rtile - 1) / a.rtile);
    fused_tg_kernel<T, NV, VEC, TWO><<<g, kThreads, smem, stream>>>(a);
    return cudaGetLastError();
  }
  template <int NV, int VEC>
  cudaError_t run() const {
    return a.nother > 1 ? go<NV, VEC, true>() : go<NV, VEC, false>();
  }
};

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

// Launch with NR = ceil(cols / 32) sums per lane, up to 8.
template <Grid G, class T>
cudaError_t dispatch_nr(const Args& a, cudaStream_t s) {
  switch ((std::min(a.rtile, a.R) + 31) / 32) {
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

// Any R: rank tiles of `rtile` columns (a multiple of 32 * nv * vec, or R
// itself), each lane nv chunks of vec columns (vec divides R and rtile,
// the tables' bases aligned to vec elements; ops/kernels.py gather_vec).
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
      rtile < 1 || nv < 1 || vec < 1 || R % vec != 0 ||
      (rtile < R && rtile % (32 * nv * vec) != 0) ||
      32 * nv * vec < std::min(rtile, R))
    return (int)cudaErrorInvalidValue;
  a.rtile = rtile;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(tabs_bf16
                   ? dispatch_chunks<__nv_bfloat16>(
                         nv, vec, LaunchTG<__nv_bfloat16>{a, s})
                   : dispatch_chunks<float>(nv, vec, LaunchTG<float>{a, s}));
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

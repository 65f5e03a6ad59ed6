// Fused blocked MTTKRP over the compact v2 layout for Hopper (sm_90a).
//
// Replaces the TPU kernel of splatt_tpu/ops/pallas_kernels.py
//   fused_mttkrp_v2 (entry :702, body _fused_v2_kernel :615)
//       -> splatt_fused_mttkrp_v2
// and keeps its contract: fused_mttkrp_t's (gather + Hadamard + row reduce
// of one block per CTA, block partials (nb, width, R) in the sorted
// contract, totals (width, R) in the accumulate contract, f32 output), but
// read from the layout's ENCODED streams at their stored widths and decoded
// in registers.  No decoded int32 copy of a stream exists in device memory.
//
// Per mode k the layout holds a stream of one integer type (u8, u16, i8,
// i16 or i32) and one encoding kind (blocked.STREAM_ENCODINGS):
//   loc / seg  local id = the stored value; global = local + base[k][b]
//   delta      local id = the inclusive within-block sum of the stored
//              differences; global = local + base[k][b]
//   rle        (nb, S) run-length counts of the sorted mode; the segment
//              id of entry j = the number of run ends at or before j
// Both vary by mode at run time (one "auto" layout mixes u16 and i32
// streams), so they travel as per-mode codes in the argument struct and
// the kernel branches on them; the branch is the same across a warp.
//
//   sorted contract:      row = the segment id of the sorted mode
//   accumulate contract:  row = the output mode's global id
// Gather ids clamp into [0, d_k - 1]: the sorted mode's pads decode to the
// block's last real segment id, an all-pad block's to its base `dim`, and
// the other modes' pads to the block base, all with value 0.
//
// Values are f32 or bf16; tables are one type T, f32 or bf16.  The product
// is formed in T, rounded to bf16 after each multiply when T is bf16, as
// the plain version's `prod * rows` is; only the row sums are f32.
//
// What bounds it on this card.  A nonzero streams its encoded ids (1-4 B
// per mode, 2 B per mode on NELL-2-like shapes under "auto") and 4 or 2 B
// of value, and gathers one R-element row of every other factor; the
// tables stay in the 50 MB L2.  At R = 50 a launch over 20M nonzeros
// requests 9.0 GB of rows (each 200-byte row touches 7 sectors of 32
// bytes; some are served from L1).  On the one-entry walk (one entry's rows
// in flight per warp, scalar loads, ~0.65 us a round trip under load by
// Little's law: latency-bound) a launch took 2.29-2.44 ms (3.7-3.9 TB/s of
// requests), slower than fused_mttkrp_t on v1 for all its fewer bytes.
// What bounds the redesign was not identified, as for fused_mttkrp_tg
// (fused_mttkrp.cu): about half of a launch there is per-entry work, and
// no measured L2 rate bounds the 7.5 TB/s of requests below.
//
// What the design does about it: gather_walk.cuh's walk with a source,
// V2Src, that decodes as it commits each 32 entries: 4 entries' rows in
// flight per warp, 8-byte row loads at R = 50 (the 200-byte pitch refuses
// 16), and the next 32 entries' raw streams fetched into registers while
// these are walked, so the decode's loads no longer stall the walk:
// 1.18-1.20 ms per launch on "auto" (7.5 TB/s of requests) against
// fused_mttkrp_t's 2.17-2.19 on v1 in turns; fused_mttkrp_tg on v1, the
// same walk without a decode, 1.13-1.15 (PERF.md, H100 80GB HBM3, 700 W).
// Warps walk
// contiguous runs of a block, so a delta stream, or an RLE count vector,
// needs the prefix before the warp's run.  A CTA prologue gets it without
// staging the block's ids: for a delta stream each warp sums the
// differences of its own run and the 8 sums go to shared memory, whose
// exclusive prefix is the warp's starting carry; the walk then carries a
// warp-wide inclusive scan of each 32-entry load.  For an RLE stream the
// CTA scans the block's S counts into shared run ends, and each lane finds
// its segment by binary search.  The decoded gather ids of a warp's current
// 32 entries, the block bases and the carries sit in shared memory, so
// registers go to the rows in flight.  So shared memory holds
// (kPrologueInts + S) ints before the sorted contract's (width, R) tile,
// which keeps the rest of the 227 KB.  The TPU kernel's transposed tables,
// replicated request tiles and one-hot matmul were Mosaic's way to gather
// and have no counterpart here.

#include <algorithm>

#include "gather_walk.cuh"

using namespace splatt;

namespace {

enum IdType { kU8 = 0, kU16 = 1, kI8 = 2, kI16 = 3, kI32 = 4 };
enum Enc { kLoc = 0, kSeg = 1, kDelta = 2, kRle = 3 };

// shared ints before the tile: per-mode per-warp delta sums, the scan's
// per-warp sums, the block's per-mode bases, per-warp per-mode delta
// carries, per-warp per-mode decoded ids of 32 entries; then the S run
// ends of an RLE stream
constexpr int kPartialAt = 0;
constexpr int kWsumAt = kPartialAt + kMaxModes * kWarps;
constexpr int kBaseAt = kWsumAt + kWarps;
constexpr int kCarryAt = kBaseAt + kMaxModes;
constexpr int kIdsAt = kCarryAt + kWarps * kMaxModes;
constexpr int kPrologueInts = kIdsAt + kWarps * kMaxModes * 32;

struct Args {
  const void* stream[kMaxModes];  // per-mode encoded stream
  const int* base[kMaxModes];     // per-mode (nb,) block bases
  int idtype[kMaxModes];          // IdType of each stream
  int enc[kMaxModes];             // Enc of each stream
  const void* fac[kMaxModes];     // per-mode table (T); the output's unused
  int fdim[kMaxModes];            // rows of each table
  const void* vals;               // (nb * block,) f32 or bf16
  int vals_bf16;
  int nmodes;
  int mode;
  int nb;
  int block;
  int rle_mode;                   // the mode with an RLE stream, or -1
  int scols;                      // S: counts per block of that stream
  int R;
  int width;
  int accumulate;
  int use_smem;
  float* out;
};

__device__ __forceinline__ int load_id(const void* p, int type,
                                       long long i) {
  switch (type) {
    case kU8: return __ldg(static_cast<const unsigned char*>(p) + i);
    case kU16: return __ldg(static_cast<const unsigned short*>(p) + i);
    case kI8: return __ldg(static_cast<const signed char*>(p) + i);
    case kI16: return __ldg(static_cast<const short*>(p) + i);
    default: return __ldg(static_cast<const int*>(p) + i);
  }
}

// Inclusive sum over the warp's lanes.
__device__ __forceinline__ int warp_scan(int x, int lane) {
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(kFull, x, d);
    if (lane >= d) x += y;
  }
  return x;
}

__device__ __forceinline__ int warp_sum(int x) {
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) x += __shfl_xor_sync(kFull, x, d);
  return x;
}

// Number of entries of the nondecreasing ends[0, n) that are <= j.
__device__ __forceinline__ int count_le(const int* ends, int n, int j) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (ends[mid] <= j)
      lo = mid + 1;
    else
      hi = mid;
  }
  return lo;
}

// Inclusive scan of the RLE counts of block b into ends[0, S): each warp
// scans a contiguous run with a carry, then adds the sums of the warps
// before it.
__device__ void scan_counts(const Args& a, int b, int* ends, int* wsum) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int S = a.scols;
  const void* counts = a.stream[a.rle_mode];
  const int type = a.idtype[a.rle_mode];
  int j0, j1;
  warp_range(S, warp, j0, j1);
  int carry = 0;
  for (int c = j0; c < j1; c += 32) {
    const int j = c + lane;
    const int x =
        warp_scan(j < j1 ? load_id(counts, type, (long long)b * S + j) : 0,
                  lane);
    if (j < j1) ends[j] = carry + x;
    carry += __shfl_sync(kFull, x, 31);
  }
  if (lane == 0) wsum[warp] = carry;
  __syncthreads();
  int before = 0;
  for (int w = 0; w < warp; ++w) before += wsum[w];
  for (int j = j0 + lane; j < j1; j += 32) ends[j] += before;
}

// Entries of one block read from the encoded streams; the product in T.
template <class T>
struct V2Src {
  const Args& a;
  long long off;              // b * block
  const int* ends;            // shared: RLE run ends
  const int* gbase;           // shared: base[k][b]
  int* carry;                 // shared: this warp's delta carry per mode
  int* ids;                   // shared: this warp's [mode][32] gather ids
  int my_row;
  float my_val;
  // fetched a load ahead (gather_walk.cuh): the streams' raw values, the
  // value, the entry and whether it is real
  int f_raw[kMaxModes];
  float f_val;
  int f_j;
  bool f_ok;

  // read entry j's raw stream values and value into registers
  __device__ __forceinline__ void fetch(int j, bool ok) {
#pragma unroll
    for (int k = 0; k < kMaxModes; ++k) {
      if (k >= a.nmodes) break;
      f_raw[k] = ok && a.enc[k] != kRle
                     ? load_id(a.stream[k], a.idtype[k], off + j)
                     : 0;
    }
    f_val = ok ? load_val<T>(a.vals, a.vals_bf16, off + j) : 0.f;
    f_j = j;
    f_ok = ok;
  }

  // decode the fetched entries into the current 32 (ids, row, value)
  __device__ __forceinline__ void commit() {
    const int lane = threadIdx.x & 31;
    const int j = f_j;
    const bool ok = f_ok;
    __syncwarp();   // the warp is done with the previous 32 entries' ids
#pragma unroll
    for (int k = 0; k < kMaxModes; ++k) {
      if (k >= a.nmodes) break;
      int id;
      if (a.enc[k] == kRle) {
        id = count_le(ends, a.scols, j);
      } else {
        const int raw = f_raw[k];
        if (a.enc[k] == kDelta) {
          const int s = warp_scan(raw, lane);
          id = carry[k] + s;
          __syncwarp();
          if (lane == 31) carry[k] += s;
        } else {
          id = raw;
        }
      }
      if (k == a.mode)
        my_row = a.accumulate ? id + gbase[k] : id;
      else
        ids[k * 32 + lane] = min(max(id + gbase[k], 0), a.fdim[k] - 1);
    }
    if (!ok) my_row = -1;
    my_val = f_val;
    __syncwarp();
  }

  __device__ __forceinline__ int row(int t) const {
    return __shfl_sync(kFull, my_row, t);
  }

  // the gather-source interface of gather_walk.cuh: table k is the k-th
  // mode other than the output mode
  __device__ __forceinline__ float val(int t) const {
    return __shfl_sync(kFull, my_val, t);
  }
  __device__ __forceinline__ const int* ids_of(int k) const {
    return ids + (k + (k >= a.mode)) * 32;
  }
  __device__ __forceinline__ const T* table(int k) const {
    return static_cast<const T*>(a.fac[k + (k >= a.mode)]);
  }
  __device__ __forceinline__ int pitch() const { return a.R; }
  __device__ __forceinline__ int ntables() const { return a.nmodes - 1; }

};

size_t prologue_bytes(const Args& a) {
  const size_t ints = kPrologueInts + (a.rle_mode >= 0 ? a.scols : 0);
  return (ints * sizeof(int) + 15) / 16 * 16;
}

// NV chunks of VEC columns per lane, TWO or more gathered tables (else
// one, a 2-mode tensor).
template <class T, int NV, int VEC, bool TWO>
__global__ void __launch_bounds__(kThreads, walk_min_blocks(NV * VEC))
fused_v2_kernel(const Args a, size_t tile_at) {
  extern __shared__ __align__(16) unsigned char smem[];
  int* shared = reinterpret_cast<int*>(smem);
  int* partial = shared + kPartialAt;            // [kMaxModes][kWarps]
  int* wsum = shared + kWsumAt;                  // [kWarps]
  int* gbase = shared + kBaseAt;                 // [kMaxModes]
  int* ends = shared + kPrologueInts;            // [scols]
  float* tile = reinterpret_cast<float*>(smem + tile_at);
  const int b = blockIdx.x;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long off = (long long)b * a.block;
  int j0, j1;
  warp_range(a.block, warp, j0, j1);

  // prologue: each warp's sum of its run of every delta stream
#pragma unroll
  for (int k = 0; k < kMaxModes; ++k) {
    if (k >= a.nmodes) break;
    if (a.enc[k] != kDelta) continue;
    int s = 0;
    for (int j = j0 + lane; j < j1; j += 32)
      s += load_id(a.stream[k], a.idtype[k], off + j);
    s = warp_sum(s);
    if (lane == 0) partial[k * kWarps + warp] = s;
  }
  if (a.rle_mode >= 0) scan_counts(a, b, ends, wsum);
  if (threadIdx.x < a.nmodes) gbase[threadIdx.x] = a.base[threadIdx.x][b];
  __syncthreads();

  int* carry = shared + kCarryAt + warp * kMaxModes;
  if (lane < a.nmodes) {
    int c = 0;
    if (a.enc[lane] == kDelta)
      for (int w = 0; w < warp; ++w) c += partial[lane * kWarps + w];
    carry[lane] = c;
  }
  V2Src<T> src{a, off, ends, gbase, carry,
               shared + kIdsAt + warp * kMaxModes * 32};

  if (a.accumulate) {
    walk_rows<T, NV, VEC, TWO>(src, a.block, a.out, a.R, a.width, a.R);
    return;
  }
  float* slab = a.out + (long long)b * a.width * a.R;
  if (!a.use_smem) {
    walk_rows<T, NV, VEC, TWO>(src, a.block, slab, a.R, a.width, a.R);
    return;
  }
  zero_tile(tile, (long long)a.width * a.R);
  walk_rows<T, NV, VEC, TWO>(src, a.block, tile, a.R, a.width, a.R);
  store_tile(tile, slab, a.width, a.R, a.R, 0);
}

template <class T>
struct Launch {
  const Args& a;
  cudaStream_t stream;
  template <int NV, int VEC, bool TWO>
  cudaError_t go() const {
    const size_t tile_at = prologue_bytes(a);
    const size_t smem =
        tile_at + ((!a.accumulate && a.use_smem)
                       ? (size_t)a.width * a.R * sizeof(float)
                       : 0);
    const cudaError_t e =
        allow_smem(fused_v2_kernel<T, NV, VEC, TWO>, smem);
    if (e != cudaSuccess) return e;
    fused_v2_kernel<T, NV, VEC, TWO><<<a.nb, kThreads, smem, stream>>>(
        a, tile_at);
    return cudaGetLastError();
  }
  template <int NV, int VEC>
  cudaError_t run() const {
    return a.nmodes > 2 ? go<NV, VEC, true>() : go<NV, VEC, false>();
  }
};

template <class T>
cudaError_t dispatch(const Args& a, int nv, int vec, cudaStream_t s) {
  return dispatch_chunks<T>(nv, vec, Launch<T>{a, s});
}

}  // namespace

extern "C" {

// streams, bases, factors: host arrays of nmodes device pointers (the
// output mode's table is not read); codes: host array of 2 * nmodes ints,
// the IdType then the Enc of each mode's stream; fdims: host array of
// nmodes table rows; vals_bf16 / tabs_bf16: values / tables are bf16, else
// f32.  scols: S of the RLE stream (0 without one).  R <= 256: each lane
// holds nv chunks of vec columns of the row sums in registers (vec divides
// R, the tables' bases aligned to vec elements; ops/kernels.py
// gather_vec).  Returns the cudaError_t of the
// launch (0 on success), launches on `stream`, does not synchronise and
// allocates nothing.  The f32 output must be zeroed unless use_smem
// (sorted contract, every CTA writes its whole tile).
int splatt_fused_mttkrp_v2(const void* streams, const void* codes,
                           const void* bases, const void* vals, int vals_bf16,
                           const void* factors, const void* fdims,
                           int tabs_bf16, int nmodes, int mode, int nb,
                           int block, int scols, int R, int width,
                           int accumulate, int use_smem, int nv, int vec,
                           void* out, void* stream) {
  if (nmodes < 2 || nmodes > kMaxModes || mode < 0 || mode >= nmodes ||
      R < 1 || R > 32 * 8 || nb < 1 || block < 1 || width < 1 ||
      scols < 0 || nv < 1 || vec < 1 || R % vec != 0 || 32 * nv * vec < R)
    return (int)cudaErrorInvalidValue;
  const void* const* st = static_cast<const void* const*>(streams);
  const void* const* bs = static_cast<const void* const*>(bases);
  const void* const* fac = static_cast<const void* const*>(factors);
  const int* code = static_cast<const int*>(codes);
  const int* dims = static_cast<const int*>(fdims);
  Args a;
  a.rle_mode = -1;
  for (int k = 0; k < kMaxModes; ++k) {
    const bool on = k < nmodes;
    a.stream[k] = on ? st[k] : nullptr;
    a.base[k] = on ? static_cast<const int*>(bs[k]) : nullptr;
    a.idtype[k] = on ? code[2 * k] : kI32;
    a.enc[k] = on ? code[2 * k + 1] : kLoc;
    a.fac[k] = on ? fac[k] : nullptr;
    a.fdim[k] = on ? dims[k] : 1;
    if (on && (a.idtype[k] < kU8 || a.idtype[k] > kI32 ||
               a.enc[k] < kLoc || a.enc[k] > kRle || a.fdim[k] < 1))
      return (int)cudaErrorInvalidValue;
    if (on && a.enc[k] == kRle) {
      if (a.rle_mode >= 0 || scols < 1) return (int)cudaErrorInvalidValue;
      a.rle_mode = k;
    }
  }
  a.vals = vals;
  a.vals_bf16 = vals_bf16;
  a.nmodes = nmodes;
  a.mode = mode;
  a.nb = nb;
  a.block = block;
  a.scols = scols;
  a.R = R;
  a.width = width;
  a.accumulate = accumulate;
  a.use_smem = use_smem;
  a.out = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(tabs_bf16 ? dispatch<__nv_bfloat16>(a, nv, vec, s)
                         : dispatch<float>(a, nv, vec, s));
}

}  // extern "C"

// Dense-mode MTTKRP for Hopper (sm_90a): a mode's unfolding, stored as
// value tiles, times a Khatri-Rao operand the kernel generates.
//
// Replaces splatt_tpu/ops/pallas_kernels.py :: fused_dense (entry :1483,
// body _dense_kernel :1451-1461) -> splatt_fused_dense, and keeps its
// contract.  For the (rows_pad, span) unfolding `tiles` (f32 or bf16, the
// (ntiles, tile, span) layout read as one row-major matrix), the chained
// Khatri-Rao product of the outer factors w (n_outer, R) and the inner
// factor u (inner_pad, R), zero-padded past the inner dim (both built
// outside the kernel, as the JAX entry builds them outside its pallas_call):
//
//   out[r, n] = sum_c tiles[r, c] * (w[c / inner_pad, n] * u[c % inner_pad, n])
//
// for r < rows (the mode's dim; pad rows are zero and skipped), into a
// zeroed (rows, R) f32 output.  Pad columns meet zero u rows and add exact
// zeros, so the pad mask is never read.
//
// What bounds it on this card: operations in f32.  It does 2 R operations
// per cell against 4 bytes (f32) or 2 (bf16) of values read once; at
// R = 50 that is 25 (50) operations per byte, above the f32 FFMA ridge of
// 67 TFLOP/s over 3.35 TB/s (20 per byte).  In bf16 the same exact products
// are available from the tensor cores, so there the least time is the
// bytes term; this kernel does not use them yet.
//
// What the design does about it: a plain tiled f32 FFMA product, IEEE (no
// TF32).  A CTA of 256 threads owns a BM x BN block of (row, rank)
// outputs and a run of BK-column chunks of the span (split-K), so a mode
// with one row tile (ntiles = 1) still fills the card; its f32 partial is
// added into the output with atomics at the end.  Per chunk it stages the
// value sub-tile (BM x BK, widened to f32, transposed) in shared memory and
// builds the KR sub-tile (BK x BN) there from one w row and BK u rows:
// inner_pad is a multiple of 128 and BK divides it, so a chunk lies within
// one outer index, and the (span, R) KR tile never exists in device memory.
// Each thread accumulates a TM x TN micro-tile in registers.  The next
// chunk's values, w entry and u entries are loaded into registers while the
// current chunk is multiplied.  Values stream through with evict-first
// loads; w and u stay in L2.  Offsets into `tiles` are 64-bit (rows * span
// passes 2^31 at real sizes).  Grid: (row blocks x splits, rank tiles).
//
// bf16: a value widens to f32 exactly; a KR entry is the f32 product of the
// two factor entries rounded to bf16 (the factor-dtype multiply of the
// plain version); f32 values meeting bf16 factors are rounded to bf16 (the
// plain version casts the tiles to the factor dtype); products and sums are
// f32.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int BM = 64;    // output rows per CTA
constexpr int BN = 64;    // rank columns per CTA (grid.y tiles the rank)
constexpr int BK = 32;    // span columns per chunk
constexpr int TM = 4;     // rows per thread
constexpr int TN = 4;     // rank columns per thread
constexpr int kThreads = (BM / TM) * (BN / TN);
constexpr int kAStride = BM + 4;   // keeps each transposed row 16-byte aligned
constexpr int kVals = BM * BK / kThreads;   // values a thread stages per chunk
constexpr int kKr = BK * BN / kThreads;     // KR entries a thread builds
static_assert(kThreads == 256 && kVals == 8 && kKr == 8,
              "the load mappings below assume these tile sizes");

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// x rounded to the factor type T and widened back.
template <class T>
__device__ __forceinline__ float round_to(float x) { return x; }
template <>
__device__ __forceinline__ float round_to<__nv_bfloat16>(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// Eight consecutive values of one row, widened to f32.
__device__ __forceinline__ void load8(const float* p, float (&v)[kVals]) {
  const float4 a = __ldcs(reinterpret_cast<const float4*>(p));
  const float4 b = __ldcs(reinterpret_cast<const float4*>(p) + 1);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}
__device__ __forceinline__ void load8(const __nv_bfloat16* p,
                                      float (&v)[kVals]) {
  const uint4 raw = __ldcs(reinterpret_cast<const uint4*>(p));
  const unsigned words[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&words[i]));
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

template <class TV, class TF>
__global__ void __launch_bounds__(kThreads)
dense_kernel(const TV* __restrict__ tiles, const TF* __restrict__ w,
             const TF* __restrict__ u, long long rows, long long span,
             int inner_pad, int R, int row_blocks,
             long long chunks_per_split, float* __restrict__ out) {
  __shared__ __align__(16) float As[BK][kAStride];   // values, transposed
  __shared__ __align__(16) float Bs[BK][BN];         // the KR sub-tile

  const int tid = threadIdx.x;
  const long long rb = blockIdx.x % row_blocks;
  const long long split = blockIdx.x / row_blocks;
  const int n0 = blockIdx.y * BN;
  const long long nchunks = span / BK;
  const long long c_begin = split * chunks_per_split;
  const long long c_end = min(nchunks, c_begin + chunks_per_split);

  // staging: values of row a_row, columns a_col .. a_col + 7 of a chunk;
  // KR entries of rank column b_n, chunk rows b_k + 4 j
  const int a_row = tid >> 2;
  const int a_col = (tid & 3) * kVals;
  const long long g_row = rb * BM + a_row;
  const bool row_ok = g_row < rows;
  const TV* a_ptr = tiles + (row_ok ? g_row : 0) * span + a_col;
  const int b_n = tid % BN;
  const int b_k = tid / BN;
  const bool n_ok = n0 + b_n < R;
  // compute: rows ty * TM .., rank columns tx * TN ..
  const int tx = tid % (BN / TN);
  const int ty = tid / (BN / TN);

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  float a_reg[kVals];
  float w_reg = 0.f;
  float u_reg[kKr];

  auto fetch = [&](long long c) {
    const long long col0 = c * BK;
    if (row_ok) {
      load8(a_ptr + col0, a_reg);
    } else {
#pragma unroll
      for (int j = 0; j < kVals; ++j) a_reg[j] = 0.f;
    }
    const long long o = col0 / inner_pad;
    const long long i0 = col0 - o * inner_pad;
    if (n_ok) {
      w_reg = widen(w[o * R + n0 + b_n]);
#pragma unroll
      for (int j = 0; j < kKr; ++j)
        u_reg[j] = widen(u[(i0 + b_k + 4 * j) * R + n0 + b_n]);
    } else {
      w_reg = 0.f;
#pragma unroll
      for (int j = 0; j < kKr; ++j) u_reg[j] = 0.f;
    }
  };

  if (c_begin < c_end) fetch(c_begin);
  for (long long c = c_begin; c < c_end; ++c) {
#pragma unroll
    for (int j = 0; j < kVals; ++j)
      As[a_col + j][a_row] = round_to<TF>(a_reg[j]);
#pragma unroll
    for (int j = 0; j < kKr; ++j)
      Bs[b_k + 4 * j][b_n] = round_to<TF>(w_reg * u_reg[j]);
    __syncthreads();
    if (c + 1 < c_end) fetch(c + 1);
#pragma unroll
    for (int k = 0; k < BK; ++k) {
      const float4 a = *reinterpret_cast<const float4*>(&As[k][ty * TM]);
      const float4 b = *reinterpret_cast<const float4*>(&Bs[k][tx * TN]);
      const float av[TM] = {a.x, a.y, a.z, a.w};
      const float bv[TN] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }

  if (c_begin >= c_end) return;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const long long r = rb * BM + ty * TM + i;
    if (r >= rows) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int n = n0 + tx * TN + j;
      if (n < R) atomicAdd(&out[r * R + n], acc[i][j]);
    }
  }
}

template <class TV, class TF>
cudaError_t launch(const void* tiles, const void* w, const void* u,
                   long long rows, long long span, int inner_pad, int R,
                   int row_blocks, int splits, long long chunks_per_split,
                   float* out, cudaStream_t s) {
  const dim3 grid((unsigned)row_blocks * (unsigned)splits,
                  (unsigned)((R + BN - 1) / BN));
  dense_kernel<TV, TF><<<grid, kThreads, 0, s>>>(
      static_cast<const TV*>(tiles), static_cast<const TF*>(w),
      static_cast<const TF*>(u), rows, span, inner_pad, R, row_blocks,
      chunks_per_split, out);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Returns the cudaError_t of the launch (0 on success), launches on
// `stream`, does not synchronise and allocates nothing.  tiles_bf16 /
// fac_bf16: the values / the factor operands w and u are bf16, else f32.
// `out` is a zeroed (rows, R) f32 array; `tiles` is 16-byte aligned with
// span and inner_pad multiples of BK; the grid is row_blocks x splits CTAs
// (row_blocks = ceil(rows / 64), each split chunks_per_split chunks of 32
// columns) by ceil(R / 64).
int splatt_fused_dense(const void* tiles, int tiles_bf16, const void* w,
                       const void* u, int fac_bf16, long long rows,
                       long long span, int inner_pad, int R, int row_blocks,
                       int splits, long long chunks_per_split, void* out,
                       void* stream) {
  if (rows < 1 || span < BK || span % BK || inner_pad % BK || R < 1 ||
      row_blocks < 1 || splits < 1 || chunks_per_split < 1 ||
      reinterpret_cast<unsigned long long>(tiles) % 16)
    return (int)cudaErrorInvalidValue;
  float* o = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (tiles_bf16) {
    return (int)(fac_bf16
        ? launch<__nv_bfloat16, __nv_bfloat16>(tiles, w, u, rows, span,
              inner_pad, R, row_blocks, splits, chunks_per_split, o, s)
        : launch<__nv_bfloat16, float>(tiles, w, u, rows, span, inner_pad,
              R, row_blocks, splits, chunks_per_split, o, s));
  }
  return (int)(fac_bf16
      ? launch<float, __nv_bfloat16>(tiles, w, u, rows, span, inner_pad, R,
            row_blocks, splits, chunks_per_split, o, s)
      : launch<float, float>(tiles, w, u, rows, span, inner_pad, R,
            row_blocks, splits, chunks_per_split, o, s));
}

}  // extern "C"

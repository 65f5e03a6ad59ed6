// The walk of a block that every blocked-MTTKRP kernel of this directory
// shares (sm_90a): fused_mttkrp_t, _tg and fused_mttkrp (fused_mttkrp.cu),
// fused_mttkrp_v2 (fused_mttkrp_v2.cu), onehot_reduce_sorted and _full
// (onehot_reduce.cu).
//
// Each kernel reduces one block of `n` entries into rows of a (width,
// cols) tile: entry j carries an output row id and an R-vector (a gathered
// Hadamard product of table rows, or a precomputed product row read from
// memory), and the tile row of that id gains the vector.  Ids outside [0,
// width) are padding and add nothing (their vectors are still formed, and
// dropped at the flush).
//
// The walk it replaced took a warp's entries one at a time: it broadcast
// an entry's ids, loaded its rows with scalar 4-byte loads (lanes over
// columns) and tested the row id before it started the next entry, so a
// warp had one entry's loads in flight, each an L2 or device-memory round
// trip (~0.65 us under load on an H100, PERF.md).  walk_rows<T, NV, VEC,
// TWO>() instead:
//
//   - Batches of K entries.  A warp issues the row loads of its next K
//     entries, two tables at a time, before it consumes the first; it then
//     forms their products and folds them into the running row sum in entry
//     order, so each row's f32 sum adds in entry order.  The rows are held
//     in registers.
//   - Vector row loads.  Lane l owns NV chunks of VEC consecutive columns of
//     the rank tile, chunk v at columns (l + 32 v) * VEC, read with one load
//     of VEC * sizeof(T) bytes (16: f32 float4 or 8 bf16; 8; 4; 2 for a
//     bf16 table whose R or base allows nothing wider).  The host picks VEC
//     so that every chunk starts at a multiple of its width: VEC divides R
//     and the tile, and each table's base is aligned to the load
//     (ops/kernels.py, gather_vec).
//   - Few instructions per entry, which bounded the walk as much as the
//     gathers did: loads are unconditional (past the tile a lane reads its
//     first chunk again; past the loaded entries a batch reads clamped rows
//     it never folds), a row's address is one 32 x 32 -> 64-bit
//     multiply-add, and the next 32 entries' ids are fetched into registers
//     while these are walked.
//
// A warp walks a contiguous run of the block's entries and keeps a running
// row sum in registers, flushed (flush_chunks) only when the row id
// changes, into a shared tile or device memory: ids sorted inside a block
// cost one flush per run of equal ids, and unsorted ids still give the
// right sum, one flush per entry.  A bf16 product is rounded after each
// multiply, in the order value, then table 0, 1, ..., as PyTorch's bf16
// `prod * rows` rounds it; only the row sums are f32.
//
// A "gather source" supplies the entries:
//   void fetch(int j, bool ok)     lane reads entry j's ids and value into
//                                  registers (ok: j < n); every lane of the
//                                  warp calls it, j rising by 32 from call
//                                  to call, one call ahead of the walk
//   void commit()                  the fetched 32 entries become the
//                                  current ones (shared ids, row, value)
//   int row(int t)                 entry t of the 32 current ones (warp-
//                                  uniform); entries past the real ones
//                                  carry row -1, value 0 and clamped ids
//   float val(int t)               its value, rounded to T
//   const int* ids_of(int k)       the current 32 entries' rows of gathered
//                                  table k, clamped (shared memory)
//   const T* table(int k)          gathered table k at the rank tile's
//                                  first column
//   int pitch()                    the tables' row pitch (R)
//   int ntables()                  tables gathered per entry (>= 1)
//
// A reduction of precomputed products is a source with one "table", the
// block's (n, R) products, whose row for entry j is row j itself, and the
// value 1 (exact: a bf16 product times 1 is itself).
//
// Tables may be float or bf16 (T below).

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

// Entries in flight per warp (the batch), chosen by timing K = 2, 4 and 8
// in turns on an H100 (PERF.md section 6).
constexpr int kWalkK = 4;

// CTAs per SM the walk is built for (its __launch_bounds__ minimum), which
// caps registers at 65536 / (kThreads * n): a batch holds 2 * K * C words of
// rows for C = NV * VEC columns per lane, beside C sums and about 40
// registers of ids, pointers and loop state.
constexpr int walk_min_blocks(int c) {
  const int need = 2 * kWalkK * c + c + 40;
  const int n = 65536 / kThreads / need;
  return n < 1 ? 1 : n > 6 ? 6 : n;
}

// One lane's chunk of a table row: VEC elements of T as raw 32-bit words.
template <class T, int VEC>
struct Chunk {
  static constexpr int kBytes = VEC * (int)sizeof(T);
  static constexpr int kWords = kBytes >= 4 ? kBytes / 4 : 1;
  unsigned w[kWords];
};

template <class T, int VEC>
__device__ __forceinline__ void load_chunk(const T* p, Chunk<T, VEC>& c) {
  constexpr int B = Chunk<T, VEC>::kBytes;
  if constexpr (B == 16) {
    const uint4 u = __ldg(reinterpret_cast<const uint4*>(p));
    c.w[0] = u.x;
    c.w[1] = u.y;
    c.w[2] = u.z;
    c.w[3] = u.w;
  } else if constexpr (B == 8) {
    const uint2 u = __ldg(reinterpret_cast<const uint2*>(p));
    c.w[0] = u.x;
    c.w[1] = u.y;
  } else if constexpr (B == 4) {
    c.w[0] = __ldg(reinterpret_cast<const unsigned*>(p));
  } else {
    c.w[0] = __ldg(reinterpret_cast<const unsigned short*>(p));
  }
}

// Element i of a chunk, as float (bf16: element 0 in the low half-word).
template <class T, int VEC>
__device__ __forceinline__ float chunk_elem(const Chunk<T, VEC>& c, int i) {
  if constexpr (sizeof(T) == 4) {
    return __uint_as_float(c.w[i]);
  } else if constexpr (VEC == 1) {
    return __uint_as_float(c.w[0] << 16);
  } else {
    const unsigned w = c.w[i >> 1];
    return __uint_as_float((i & 1) ? (w & 0xffff0000u) : (w << 16));
  }
}

// Add a lane's NV chunks of a row sum into row `row` of dst: in device
// memory one vector atomic per 8 or 16 bytes of a chunk (the host keeps a
// chunk aligned to its bytes, and so its f32 sums to 4 * VEC), so a warp's
// atomics cover whole sectors; in a shared tile (no vector atomics there)
// one per element.
template <int NV, int VEC>
__device__ __forceinline__ void flush_chunks(float* dst, long long ld,
                                             int row, int cols, int lane,
                                             const float (&acc)[NV * VEC]) {
  float* r = dst + (long long)row * ld;
  const bool global = __isGlobal(r);
#pragma unroll
  for (int v = 0; v < NV; ++v) {
    const int c0 = (lane + 32 * v) * VEC;
    if (c0 >= cols) continue;
    const float* x = acc + v * VEC;
    if constexpr (VEC % 4 == 0) {
      if (global) {
#pragma unroll
        for (int i = 0; i < VEC; i += 4)
          atomicAdd(reinterpret_cast<float4*>(r + c0 + i),
                    make_float4(x[i], x[i + 1], x[i + 2], x[i + 3]));
        continue;
      }
    } else if constexpr (VEC == 2) {
      if (global) {
        atomicAdd(reinterpret_cast<float2*>(r + c0), make_float2(x[0], x[1]));
        continue;
      }
    }
#pragma unroll
    for (int i = 0; i < VEC; ++i) atomicAdd(r + c0 + i, x[i]);
  }
}

// A lane's view of one gathered table: its base at the lane's chunks (a
// chunk past the tile's columns reads the tile's first chunk, whose value
// is never flushed, so every load is unconditional) and the row pitch in
// bytes, so a row's address is one 32 x 32 -> 64-bit multiply-add.
template <class T, int NV, int VEC>
struct LaneTable {
  const char* base[NV];
  unsigned pitch;

  __device__ __forceinline__ LaneTable(const T* table, int R, int lane,
                                       int cols)
      : pitch((unsigned)R * (unsigned)sizeof(T)) {
#pragma unroll
    for (int v = 0; v < NV; ++v) {
      const int c0 = (lane + 32 * v) * VEC;
      base[v] = reinterpret_cast<const char*>(table + (c0 < cols ? c0 : 0));
    }
  }

  // row `id` (clamped into the table by the source) of the lane's chunks
  __device__ __forceinline__ void load(int id, Chunk<T, VEC> (&c)[NV]) const {
#pragma unroll
    for (int v = 0; v < NV; ++v)
      load_chunk(reinterpret_cast<const T*>(
                     base[v] + (unsigned long long)(unsigned)id * pitch),
                 c[v]);
  }
};

// TWO: the source gathers two or more tables per entry, else one (a
// 2-mode tensor).  The kernels take it as a template parameter, so the
// one-table walk shares no registers with the other.
template <class T, int NV, int VEC, bool TWO, class Src>
__device__ __forceinline__ void walk_rows(Src& src, int n, float* dst,
                                          long long ld, int width,
                                          int cols) {
  constexpr int C = NV * VEC;
  constexpr int K = kWalkK;
  static_assert(32 % K == 0, "a batch never crosses a 32-entry load");
  const int lane = threadIdx.x & 31;
  int j0, j1;
  warp_range(n, threadIdx.x >> 5, j0, j1);
  const int nt = src.ntables();
  const int R = src.pitch();
  // with one table, tab1 points at table 0 and is never read
  const LaneTable<T, NV, VEC> tab0(src.table(0), R, lane, cols);
  const LaneTable<T, NV, VEC> tab1(src.table(TWO ? 1 : 0), R, lane, cols);
  const int* ids0 = src.ids_of(0);
  const int* ids1 = src.ids_of(TWO ? 1 : 0);

  float acc[C];
#pragma unroll
  for (int i = 0; i < C; ++i) acc[i] = 0.f;
  // the open run's row; a run outside [0, width) (padding, or -1: none
  // open yet) is summed like any other and never flushed
  int cur = -1;

  // the ids of the next 32 entries are fetched while these are walked
  if (j0 < j1) src.fetch(j0 + lane, j0 + lane < j1);
  for (int c = j0; c < j1; c += 32) {
    const int m = min(32, j1 - c);
    src.commit();
    if (c + 32 < j1) src.fetch(c + 32 + lane, c + 32 + lane < j1);
    for (int t0 = 0; t0 < m; t0 += K) {
      // entries past the 32 loaded carry clamped ids and value 0: their
      // rows are loaded with the batch and never folded
      const int kb = min(K, m - t0);
      float p[K][C];
      {
        // tables 0 and 1 of all K entries in flight at once
        Chunk<T, VEC> a[K][NV], b[K][NV];
#pragma unroll
        for (int e = 0; e < K; ++e) {
          tab0.load(ids0[t0 + e], a[e]);
          if constexpr (TWO) tab1.load(ids1[t0 + e], b[e]);
        }
#pragma unroll
        for (int e = 0; e < K; ++e) {
          const float v = src.val(t0 + e);
#pragma unroll
          for (int q = 0; q < NV; ++q)
#pragma unroll
            for (int i = 0; i < VEC; ++i) {
              const float x = to_t<T>(v * chunk_elem(a[e][q], i));
              if constexpr (TWO)
                p[e][q * VEC + i] = to_t<T>(x * chunk_elem(b[e][q], i));
              else
                p[e][q * VEC + i] = x;
            }
        }
      }
      // tables 2.. (tensors of four or more modes), one at a time
      for (int k = 2; TWO && k < nt; ++k) {
        const LaneTable<T, NV, VEC> tab(src.table(k), R, lane, cols);
        Chunk<T, VEC> a[K][NV];
#pragma unroll
        for (int e = 0; e < K; ++e) tab.load(src.ids_of(k)[t0 + e], a[e]);
#pragma unroll
        for (int e = 0; e < K; ++e)
#pragma unroll
          for (int q = 0; q < NV; ++q)
#pragma unroll
            for (int i = 0; i < VEC; ++i)
              p[e][q * VEC + i] =
                  to_t<T>(p[e][q * VEC + i] * chunk_elem(a[e][q], i));
      }
      // fold in entry order
#pragma unroll
      for (int e = 0; e < K; ++e) {
        if (e >= kb) break;
        const int row = src.row(t0 + e);
        if (row != cur) {
          if (cur >= 0 && cur < width)
            flush_chunks<NV, VEC>(dst, ld, cur, cols, lane, acc);
          cur = row;
#pragma unroll
          for (int i = 0; i < C; ++i) acc[i] = 0.f;
        }
#pragma unroll
        for (int i = 0; i < C; ++i) acc[i] += p[e][i];
      }
    }
  }
  if (cur >= 0 && cur < width)
    flush_chunks<NV, VEC>(dst, ld, cur, cols, lane, acc);
}

// Dispatch (NV, VEC) pairs: C = NV * VEC columns per lane, C in {1, 2, 4,
// 8}, VEC a power of two dividing C with VEC * sizeof(T) <= 16.  Calls
// f.template run<NV, VEC>() or returns cudaErrorInvalidValue.
template <class T, class F>
cudaError_t dispatch_chunks(int nv, int vec, F&& f) {
  const int c = nv * vec;
  if (vec * (int)sizeof(T) > 16) return cudaErrorInvalidValue;
#define SPLATT_CHUNK(NV_, VEC_) \
  if (nv == NV_ && vec == VEC_) return f.template run<NV_, VEC_>();
  switch (c) {
    case 1:
      SPLATT_CHUNK(1, 1)
      break;
    case 2:
      SPLATT_CHUNK(2, 1)
      SPLATT_CHUNK(1, 2)
      break;
    case 4:
      SPLATT_CHUNK(4, 1)
      SPLATT_CHUNK(2, 2)
      SPLATT_CHUNK(1, 4)
      break;
    case 8:
      SPLATT_CHUNK(8, 1)
      SPLATT_CHUNK(4, 2)
      SPLATT_CHUNK(2, 4)
      if constexpr (sizeof(T) == 2) {
        SPLATT_CHUNK(1, 8)
      }
      break;
    default:
      break;
  }
#undef SPLATT_CHUNK
  return cudaErrorInvalidValue;
}

}  // namespace splatt

// The two ring kernels of the FINE distributed CPD, for Hopper (sm_90a).
//
// Replaces the TPU kernels of splatt_tpu/parallel/ring_kernels.py
//   _ring_gather_kernel (:152-257; entries _gather_pallas :434,
//       async_ring_gather_rows :507)        -> splatt_ring_gather
//   _ring_reduce_kernel (:260-400; entries _reduce_pallas :465,
//       async_blockwise_reduce_rows :529)   -> splatt_ring_reduce
// and keeps their contract.  A mesh has ndev ranks; rank d holds a
// (block, R) shard of a row-sharded factor and nnz_d nonzeros with int32
// global ids idx_d.
//
//   gather: rows_d[n] = U_{idx_d[n] / block}[idx_d[n] % block], in U's
//           dtype (a pure copy: exact).  The shards travel right: at step
//           s rank d holds shard (d - s) mod ndev and writes the rows of
//           the nonzeros that shard owns.  An id outside [0, ndev*block)
//           (a pad with owner -1) matches no shard and gives a zero row.
//           The kernel reads no id: it walks rank d's ring plan
//           (parallel/ring_kernels.py, build_ring_plans, made on the card
//           once per id tensor), the nonzero positions stable-sorted by
//           global id (pos), so by owner and within each owner by row,
//           each one's within-block row (loc) and the ndev + 2 offsets of
//           the owner buckets, ids of no shard in the last.
//   reduce: out_d = sum over every rank e and nonzero n of e with
//           idx_e[n] / block == d of prod_e[n] at row idx_e[n] % block,
//           (block, R) f32.  The partial of block j starts at rank j+1 and
//           travels right; each holder adds its local sum of block j, and
//           after ndev-1 hops the owner holds its rows.  The schedule of
//           ring_kernels.py:323-326; rounding follows hop order.  It reads
//           the same plan as the gather, not the ids.
//
// One launch per card per ring phase holds the whole ndev-step loop, as the
// Pallas kernel's grid=(ndev,) does.  Every rank of a card runs in that one
// launch (rank slot = blockIdx.y), so virtual ranks sharing a card work as
// cards do.  The launch is cooperative: the card refuses a grid whose CTAs
// cannot all be resident, and a grid-wide barrier ends each step.
//
// The exchange.  Each rank owns a (2, block, R) landing zone (the
// gather's two slots `slot` bytes apart, 256-byte aligned).  A step's
// outgoing block is written by the kernel's own stores straight into the
// right neighbour's slot (s+1)&1, through a CUDA peer pointer when the
// neighbour is another card; the gather's stores fly while the same CTAs
// pick rows from slot s&1, the reduce's while they add the next block's
// local sum.  The credit-before-send protocol of docs/ring.md becomes two
// 64-bit flag words in each rank's memory, written by its neighbours with
// st.release.sys and polled locally with ld.acquire.sys:
//   ready  (written by the left neighbour)  = the step whose block landed;
//   credit (written by the right neighbour) = the steps it has finished,
//          so the slot it last read is free again.
// A flag holds gen * 2^16 + step, gen being a launch generation the
// wrapper increments, so a late flag of launch k never satisfies a wait of
// launch k+1, and the flags need no reset between launches.  Every spin
// has a time bound: when it runs out the CTA writes an error word in
// mapped host memory (shared by every rank and card, so the other ranks
// stop waiting too), keeps taking part in the barriers, and the wrapper
// raises at the next check.  A hang is never an outcome.
//
// What bounds them on this card: bytes.  The gather writes nnz_d * R
// elements per rank and reads its plan (8 bytes per nonzero) once; the
// reduce reads nnz_d * R products and its plan once and adds them into an
// L2-resident (block, R) accumulator.  The hops move (ndev-1) * block * R
// elements per rank over NVLink (or, between virtual ranks, within the
// card's memory).
//
// The gather's design: at step s rank d's warps visit only bucket
// (d - s) mod ndev of its plan, a 1/ndev share, with no integer division;
// the bucket of ids of no shard is zero-filled at step 0.  A warp copies
// several rows at once, 2^log2g lanes per row, each lane a vector of the
// widest size the row bytes and the pointers allow (8 bytes at R = 50 in
// f32, 16 when R * 4 is a multiple of 16), and issues all kUnroll rows'
// loads (ld.global.cg: a landing slot is written by another rank) before
// their stores.  A step writes about every ndev-th row, so a row that
// ends inside a 64-byte DRAM burst shares it with rows of other steps,
// which the card then reads back to merge: the output rows are `pitch`
// bytes apart, a multiple of 64 (the wrapper returns the (nnz, R) view of
// that buffer), and the kernel writes the pad as zeros so each burst is
// written whole, once (on an H100 at R = 50 in f32 this halved the
// gather's time; PERF.md).  Registers are capped so 4 CTAs of 256 threads
// fit an SM.  The hop copies the shard in 16-byte vectors.
//
// The reduce's design: at step s a rank's warps walk only the bucket of
// the block whose partial it adds to, each warp a contiguous range of it.
// The plan is sorted by id, so a row's nonzeros are contiguous: the warp
// keeps a running row sum in registers (lanes over r in the widest vector
// the row allows, kRunroll product rows in flight) and writes each run of
// one row once, with a plain store when the run lies wholly in its range
// and with atomics only for the two runs its range's ends may cut.  At
// hundreds of nonzeros per row that is two orders of magnitude fewer
// atomics than one per product.  Registers are capped as the gather's.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kMaxLocal = 16;      // ranks of one card in one launch
constexpr int kReady = 0;          // flag words, 128 bytes apart
constexpr int kCredit = 16;
constexpr int kMaxCtasPerSm = 4;
constexpr int kUnroll = 8;         // gather rows in flight per lane

struct RankPtrs {
  const void* in;                  // gather: U shard (block, R);
                                   // reduce: products (nnz, R)
  const int* idx;                  // (nnz,) global ids
  void* out;                       // gather: rows (nnz, R);
                                   // reduce: (block, R) f32
  float* acc;                      // reduce: (2, block, R) f32, zero
  void* lz;                        // own landing zone (2, block, R)
  void* lz_right;                  // the right neighbour's landing zone
  unsigned long long* flags;       // own flag words
  unsigned long long* flags_right;
  unsigned long long* flags_left;
  long long nnz;
  long long rank;
  const int* pos;                  // plan: nonzero positions by id
  const int* loc;                  // plan: within-block row of each
  const int* off;                  // plan: ndev + 2 bucket offsets
};

struct RingArgs {
  RankPtrs r[kMaxLocal];
  long long block;
  long long R;
  unsigned long long base;         // gen << 16
  long long timeout_ns;
  volatile int* err;               // mapped host word
  int ndev;
  int exchange;                    // 0: compute only (the overlap probe)
  long long slot;                  // gather: bytes between landing slots
  long long row_bytes;             // gather: R * element size
  int row_vecs;                    // gather: vectors per row
  int pitch_vecs;                  // gather: vectors per output row
  int log2g;                       // gather: log2 of the lanes per row
};

__device__ __forceinline__ unsigned long long ld_acquire_sys(
    const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.acquire.sys.global.u64 %0, [%1];"
               : "=l"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_release_sys(unsigned long long* p,
                                               unsigned long long v) {
  asm volatile("st.release.sys.global.u64 [%0], %1;"
               :: "l"(p), "l"(v) : "memory");
}

__device__ __forceinline__ unsigned long long globaltimer() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// Spin until *p >= want: 0, or 1 when the time bound ran out, or 2 when
// another rank reported an error.
__device__ int wait_geq(const unsigned long long* p, unsigned long long want,
                        const RingArgs& a) {
  unsigned long long t0 = globaltimer();
  for (unsigned it = 0;; ++it) {
    if (ld_acquire_sys(p) >= want) return 0;
    if ((it & 255) == 255) {
      if (*a.err != 0) return 2;
      if ((long long)(globaltimer() - t0) > a.timeout_ns) return 1;
    }
    __nanosleep(64);
  }
}

// Thread 0 of each CTA waits for the step's flags; the CTA then goes on.
// After an error the CTA stops waiting but keeps its place in every
// barrier, so no CTA of any rank is left waiting on it.
__device__ void step_wait(const RingArgs& a, const RankPtrs& me, int s,
                          bool need_ready, bool need_credit, int* aborted) {
  if (threadIdx.x == 0 && !*aborted) {
    int rc = 0;
    int kind = 0;
    if (need_ready) {
      rc = wait_geq(me.flags + kReady, a.base + s, a);
      kind = 1;
    }
    if (rc == 0 && need_credit) {
      rc = wait_geq(me.flags + kCredit, a.base + s, a);
      kind = 2;
    }
    if (rc != 0) {
      *aborted = 1;
      if (rc == 1) {
        *a.err = kind * 1000000 + (int)me.rank * 1000 + s;
        __threadfence_system();
      }
    }
    __threadfence();
  }
  __syncthreads();
}

template <class T>
__device__ __forceinline__ T load_cg(const T* p) {
  return __ldcg(p);
}

__device__ __forceinline__ float to_float(unsigned short v) {
  return __uint_as_float(static_cast<unsigned>(v) << 16);
}

// The hop of a gather step: `bytes` of the shard into the right
// neighbour's landing slot, in the widest vector both addresses allow
// (16 bytes: the slots are 256-byte aligned), the tail byte by byte.
template <class W>
__device__ __forceinline__ void copy_span(char* dst, const char* src,
                                          long long bytes, long long tid,
                                          long long nthreads) {
  const long long nv = bytes / (long long)sizeof(W);
  W* d = reinterpret_cast<W*>(dst);
  const W* s = reinterpret_cast<const W*>(src);
  for (long long i = tid; i < nv; i += nthreads) d[i] = __ldcg(s + i);
  for (long long i = nv * (long long)sizeof(W) + tid; i < bytes;
       i += nthreads)
    dst[i] = __ldcg(src + i);
}

__device__ __forceinline__ void copy_shard(char* dst, const char* src,
                                           long long bytes, long long tid,
                                           long long nthreads) {
  const unsigned long long al = reinterpret_cast<unsigned long long>(dst) |
                                reinterpret_cast<unsigned long long>(src);
  if (!(al & 15))
    copy_span<uint4>(dst, src, bytes, tid, nthreads);
  else if (!(al & 7))
    copy_span<uint2>(dst, src, bytes, tid, nthreads);
  else if (!(al & 3))
    copy_span<unsigned int>(dst, src, bytes, tid, nthreads);
  else if (!(al & 1))
    copy_span<unsigned short>(dst, src, bytes, tid, nthreads);
  else
    copy_span<unsigned char>(dst, src, bytes, tid, nthreads);
}

// One bucket's rows: entry e in [b0, b1) of the plan copies source row
// loc[e] to output row pos[e] (kZero: writes a zero row).  A warp takes
// kUnroll * (32 >> log2g) entries per pass: 2^log2g lanes per row, each
// lane a V vector of the row at a time, and the kUnroll rows' loads are
// issued before any store, so each lane keeps kUnroll loads in flight.
template <class V, bool kZero>
__device__ __forceinline__ void move_rows(V* rows, const V* src,
                                          const int* pos, const int* loc,
                                          long long b0, long long b1,
                                          int vpr, int pitch, int log2g,
                                          long long warp, long long nwarps,
                                          int lane) {
  const int g = 1 << log2g;
  const int sub = lane >> log2g;
  const int k0 = lane & (g - 1);
  const int per = 32 >> log2g;
  const long long chunk = (long long)per * kUnroll;
  for (long long e0 = b0 + warp * chunk; e0 < b1; e0 += nwarps * chunk) {
    int dst[kUnroll];
    int from[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long e = e0 + u * per + sub;
      dst[u] = e < b1 ? __ldg(pos + e) : -1;
      from[u] = (!kZero && e < b1) ? __ldg(loc + e) : 0;
    }
    // the output row is `pitch` vectors: the row's own, then zeros up to
    // a whole number of 64-byte bursts, so no burst is written in part
    for (int k = k0; k < pitch; k += g) {
      V v[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
        v[u] = (!kZero && dst[u] >= 0 && k < vpr)
                   ? __ldcg(src + (long long)from[u] * vpr + k)
                   : V{};
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
        if (dst[u] >= 0) rows[(long long)dst[u] * pitch + k] = v[u];
    }
  }
}

// V: the row copy's vector (2, 4, 8 or 16 bytes; the gather only copies).
template <class V>
__global__ void __launch_bounds__(kThreads, kMaxCtasPerSm)
    ring_gather_kernel(const __grid_constant__ RingArgs a) {
  cg::grid_group grid = cg::this_grid();
  __shared__ int s_abort;
  const RankPtrs me = a.r[blockIdx.y];
  const int ndev = a.ndev;
  const int d = static_cast<int>(me.rank);
  const long long shard_bytes = a.block * a.row_bytes;
  const char* own = static_cast<const char*>(me.in);
  const char* lz = static_cast<const char*>(me.lz);
  V* rows = static_cast<V*>(me.out);
  const int lane = threadIdx.x & 31;
  const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long nthreads = (long long)gridDim.x * blockDim.x;
  const long long warp = tid >> 5;
  const long long nwarps = nthreads >> 5;
  const bool ex = a.exchange != 0;
  if (threadIdx.x == 0) {
    s_abort = 0;
    // entering this launch frees both of my landing slots
    if (ex && blockIdx.x == 0) st_release_sys(me.flags_left + kCredit, a.base);
  }
  __syncthreads();
  for (int s = 0; s < ndev; ++s) {
    const bool send = ex && s <= ndev - 2;
    const char* src = (!ex || s == 0) ? own : lz + (s & 1) * a.slot;
    step_wait(a, me, s, ex && s >= 1, send, &s_abort);
    if (send) {
      // my CTA's share of the hop: the block into the right neighbour's
      // slot (s+1)&1; the stores fly while the rows below are copied
      char* dst = static_cast<char*>(me.lz_right) + ((s + 1) & 1) * a.slot;
      copy_shard(dst, src, shard_bytes, tid, nthreads);
    }
    // the bucket of the shard I hold: no scan of the other ranks' ids
    const int b = (d - s + ndev) % ndev;
    move_rows<V, false>(rows, reinterpret_cast<const V*>(src), me.pos,
                        me.loc, me.off[b], me.off[b + 1], a.row_vecs,
                        a.pitch_vecs, a.log2g, warp, nwarps, lane);
    if (s == 0)   // ids of no shard: zero rows, once
      move_rows<V, true>(rows, nullptr, me.pos, me.loc, me.off[ndev],
                         me.off[ndev + 1], a.row_vecs, a.pitch_vecs,
                         a.log2g, warp, nwarps, lane);
    if (send) __threadfence_system();
    grid.sync();
    if (ex && blockIdx.x == 0 && threadIdx.x == 0) {
      if (send) st_release_sys(me.flags_right + kReady, a.base + s + 1);
      st_release_sys(me.flags_left + kCredit, a.base + s + 1);
    }
  }
}

// VW consecutive products of a row as f32 (P: float or unsigned short,
// bf16 bits): one vector load of VW * sizeof(P) bytes, read once
// (evict-first).
template <class P, int VW>
struct RowVec;
template <>
struct RowVec<float, 1> {
  static __device__ __forceinline__ void load(const float* p, float* v) {
    v[0] = __ldcs(p);
  }
};
template <>
struct RowVec<float, 2> {
  static __device__ __forceinline__ void load(const float* p, float* v) {
    const float2 x = __ldcs(reinterpret_cast<const float2*>(p));
    v[0] = x.x;
    v[1] = x.y;
  }
};
template <>
struct RowVec<float, 4> {
  static __device__ __forceinline__ void load(const float* p, float* v) {
    const float4 x = __ldcs(reinterpret_cast<const float4*>(p));
    v[0] = x.x;
    v[1] = x.y;
    v[2] = x.z;
    v[3] = x.w;
  }
};
__device__ __forceinline__ void bf16_pair(unsigned w, float* v) {
  v[0] = __uint_as_float(w << 16);
  v[1] = __uint_as_float(w & 0xffff0000u);
}
template <>
struct RowVec<unsigned short, 1> {
  static __device__ __forceinline__ void load(const unsigned short* p,
                                              float* v) {
    v[0] = to_float(__ldcs(p));
  }
};
template <>
struct RowVec<unsigned short, 2> {
  static __device__ __forceinline__ void load(const unsigned short* p,
                                              float* v) {
    bf16_pair(__ldcs(reinterpret_cast<const unsigned*>(p)), v);
  }
};
template <>
struct RowVec<unsigned short, 4> {
  static __device__ __forceinline__ void load(const unsigned short* p,
                                              float* v) {
    const uint2 x = __ldcs(reinterpret_cast<const uint2*>(p));
    bf16_pair(x.x, v);
    bf16_pair(x.y, v + 2);
  }
};
template <>
struct RowVec<unsigned short, 8> {
  static __device__ __forceinline__ void load(const unsigned short* p,
                                              float* v) {
    const uint4 x = __ldcs(reinterpret_cast<const uint4*>(p));
    bf16_pair(x.x, v);
    bf16_pair(x.y, v + 2);
    bf16_pair(x.z, v + 4);
    bf16_pair(x.w, v + 6);
  }
};

// A run's sum of one row: stored when the warp holds the whole run (the
// accumulator row is zero), else added with atomics.
template <int VW>
__device__ __forceinline__ void flush_run(float* dst, const float* sum,
                                          bool atomic) {
  if (atomic) {
#pragma unroll
    for (int i = 0; i < VW; ++i) atomicAdd(dst + i, sum[i]);
  } else if constexpr (VW % 4 == 0) {
#pragma unroll
    for (int i = 0; i < VW; i += 4)
      *reinterpret_cast<float4*>(dst + i) =
          make_float4(sum[i], sum[i + 1], sum[i + 2], sum[i + 3]);
  } else if constexpr (VW == 2) {
    *reinterpret_cast<float2*>(dst) = make_float2(sum[0], sum[1]);
  } else {
    dst[0] = sum[0];
  }
}

// One bucket's local sum: entries [b0, b1) of a rank's id-sorted plan add
// product row pos[e] into accumulator row loc[e].  Each warp takes a
// contiguous range of the bucket, lanes over the row in VW-wide vectors,
// and keeps a running row sum in registers while loc stays the same;
// kRunroll rows' loads are in flight before they are summed, and the
// next 32 plan entries' while these are.  A run that lies wholly in the
// warp's range is stored; the runs cut by the range's two ends (another
// warp holds the rest) are added with atomics.
template <class P, int VW>
__device__ __forceinline__ void reduce_bucket(const P* prod, const int* pos,
                                              const int* loc, long long b0,
                                              long long b1, float* acc,
                                              long long R, long long warp,
                                              long long nwarps, int lane) {
  // 16 floats of loads in flight per lane: under the 64-register cap of 4
  // CTAs per SM, 32 spilled, and the reduce ran 1.5x longer (PERF.md)
  constexpr int kRunroll = VW >= 2 ? 16 / VW : 8;
  const long long len = b1 - b0;
  if (len <= 0) return;
  const long long per = (len + nwarps - 1) / nwarps;
  const long long e0 = b0 + warp * per;
  const long long e1 = min(b1, e0 + per);
  if (e0 >= e1) return;
  const bool cut_front = e0 > b0 && __ldg(loc + e0 - 1) == __ldg(loc + e0);
  const bool cut_back = e1 < b1 && __ldg(loc + e1) == __ldg(loc + e1 - 1);
  const long long vpr = R / VW;
  for (long long k0 = 0; k0 < vpr; k0 += 32) {
    const long long k = k0 + lane;
    const bool on = k < vpr;
    float sum[VW];
#pragma unroll
    for (int i = 0; i < VW; ++i) sum[i] = 0.0f;
    int cur = -1;
    bool front = cut_front;
    // the plan entries of the next 32 are loaded while these are summed
    int next_pos = lane < e1 - e0 ? __ldg(pos + e0 + lane) : 0;
    int next_loc = lane < e1 - e0 ? __ldg(loc + e0 + lane) : -1;
    for (long long base = e0; base < e1; base += 32) {
      const int n = static_cast<int>(min(32LL, e1 - base));
      const int my_pos = next_pos;
      const int my_loc = next_loc;
      const long long ahead = base + 32 + lane;
      next_pos = ahead < e1 ? __ldg(pos + ahead) : 0;
      next_loc = ahead < e1 ? __ldg(loc + ahead) : -1;
      for (int u0 = 0; u0 < n; u0 += kRunroll) {
        float v[kRunroll][VW];
#pragma unroll
        for (int u = 0; u < kRunroll; ++u) {
          const int src = __shfl_sync(0xffffffffu, my_pos, (u0 + u) & 31);
          if (on && u0 + u < n) {
            RowVec<P, VW>::load(prod + src * R + k * VW, v[u]);
          } else {
#pragma unroll
            for (int i = 0; i < VW; ++i) v[u][i] = 0.0f;
          }
        }
#pragma unroll
        for (int u = 0; u < kRunroll; ++u) {
          const int row = __shfl_sync(0xffffffffu, my_loc, (u0 + u) & 31);
          if (u0 + u < n) {       // uniform over the warp
            if (row != cur) {
              if (cur >= 0 && on)
                flush_run<VW>(acc + cur * R + k * VW, sum, front);
              if (cur >= 0) front = false;
              cur = row;
#pragma unroll
              for (int i = 0; i < VW; ++i) sum[i] = 0.0f;
            }
#pragma unroll
            for (int i = 0; i < VW; ++i) sum[i] += v[u][i];
          }
        }
      }
    }
    if (on) flush_run<VW>(acc + cur * R + k * VW, sum, front || cut_back);
  }
}

// P: float or unsigned short (bf16 bits); VW: products a lane loads at once.
template <class P, int VW>
__global__ void __launch_bounds__(kThreads, kMaxCtasPerSm)
    ring_reduce_kernel(const __grid_constant__ RingArgs a) {
  cg::grid_group grid = cg::this_grid();
  __shared__ int s_abort;
  const RankPtrs me = a.r[blockIdx.y];
  const int ndev = a.ndev;
  const int d = static_cast<int>(me.rank);
  const long long blk = a.block;
  const long long R = a.R;
  const long long shard_elems = blk * R;
  const P* prod = static_cast<const P*>(me.in);
  const float* lz = static_cast<const float*>(me.lz);
  const int lane = threadIdx.x & 31;
  const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long nthreads = (long long)gridDim.x * blockDim.x;
  const long long warp = tid >> 5;
  const long long nwarps = nthreads >> 5;
  const bool ex = a.exchange != 0;
  if (threadIdx.x == 0) {
    s_abort = 0;
    if (ex && blockIdx.x == 0) st_release_sys(me.flags_left + kCredit, a.base);
  }
  __syncthreads();
  for (int s = 0; s < ndev; ++s) {
    const int j = (d - 1 - s + 2 * ndev) % ndev;
    float* acc = me.acc + (s & 1) * shard_elems;
    // my local sum of block j, its bucket alone; the previous step's
    // outgoing stores fly
    reduce_bucket<P, VW>(prod, me.pos, me.loc, me.off[j], me.off[j + 1], acc,
                         R, warp, nwarps, lane);
    if (ex && s >= 1) __threadfence_system();
    grid.sync();
    if (ex && s >= 1 && blockIdx.x == 0 && threadIdx.x == 0) {
      // step s-1's block has landed on the right; my slot (s-1)&1 is free
      st_release_sys(me.flags_right + kReady, a.base + s);
      st_release_sys(me.flags_left + kCredit, a.base + s);
    }
    const bool send = ex && s <= ndev - 2;
    step_wait(a, me, s, ex && s >= 1, send, &s_abort);
    // the travelling partial: my sum plus the one that arrived, to the
    // right neighbour's slot (s+1)&1, or at the last step into my output
    const float* in = lz + (s & 1) * shard_elems;
    float* dst = send ? static_cast<float*>(me.lz_right)
                            + ((s + 1) & 1) * shard_elems
                      : static_cast<float*>(me.out);
    for (long long e = tid; e < shard_elems; e += nthreads) {
      float v = load_cg(acc + e);
      if (ex && s >= 1) v += load_cg(in + e);
      acc[e] = 0.0f;
      dst[e] = v;
    }
  }
}

template <class K>
int launch(K kernel, int dev, const RingArgs& args, int nlocal,
           void* stream) {
  int prev = 0;
  cudaGetDevice(&prev);
  cudaError_t err = cudaSetDevice(dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  int sms = 0;
  int per_sm = 0;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, kernel, kThreads, 0);
  if (err == cudaSuccess) {
    if (per_sm > kMaxCtasPerSm) per_sm = kMaxCtasPerSm;
    const int ctas = per_sm * sms / nlocal;
    if (ctas < 1) {
      err = cudaErrorCooperativeLaunchTooLarge;
    } else {
      RingArgs a = args;
      void* params[] = {&a};
      err = cudaLaunchCooperativeKernel(
          reinterpret_cast<const void*>(kernel), dim3(ctas, nlocal),
          dim3(kThreads), params, 0,
          static_cast<cudaStream_t>(stream));
    }
  }
  cudaSetDevice(prev);
  return static_cast<int>(err);
}

int fill(RingArgs* a, const void* ranks, int nlocal, int ndev,
         long long block, long long R, long long gen, void* err,
         long long timeout_ns, int exchange) {
  if (nlocal < 1 || nlocal > kMaxLocal || ndev < 1 || block < 1 || R < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  for (int i = 0; i < nlocal; ++i)
    a->r[i] = static_cast<const RankPtrs*>(ranks)[i];
  a->block = block;
  a->R = R;
  a->base = static_cast<unsigned long long>(gen) << 16;
  a->timeout_ns = timeout_ns;
  a->err = static_cast<volatile int*>(err);
  a->ndev = ndev;
  a->exchange = exchange;
  a->slot = 0;
  a->row_bytes = 0;
  a->row_vecs = 0;
  a->pitch_vecs = 0;
  a->log2g = 0;
  return 0;
}

}  // namespace

extern "C" {

// Each launch entry returns the cudaError_t of its launch (0 on success),
// launches on `stream` of card `dev`, does not synchronise and allocates
// nothing.  `ranks` is an array of the card's ranks' RankPtrs (a type
// local to this file, so the C interface takes it untyped); `err` is the
// device address of a mapped host word (splatt_ring_alloc_host).  Both
// kernels read each rank's plan (pos, loc, off) and not its ids; `slot` is
// the byte offset of its landing zone's second slot, `pitch` the bytes
// between output rows (at least R * esize; the bytes past a row are
// written as zeros).

int splatt_ring_gather(int dev, const void* ranks, int nlocal, int ndev,
                       long long block, long long R, int esize, long long gen,
                       void* err, long long timeout_ns, int exchange,
                       long long slot, long long pitch, void* stream) {
  RingArgs a;
  int rc = fill(&a, ranks, nlocal, ndev, block, R, gen, err, timeout_ns,
                exchange);
  if (rc != 0) return rc;
  if (esize != 2 && esize != 4 && esize != 8)
    return static_cast<int>(cudaErrorInvalidValue);
  // the widest vector that the row bytes, the slot stride and every
  // rank's shard, output and landing zones are aligned to
  const long long row_bytes = R * esize;
  if (pitch < row_bytes) return static_cast<int>(cudaErrorInvalidValue);
  int vb = 16;
  for (; vb > esize; vb /= 2) {
    unsigned long long al =
        static_cast<unsigned long long>(row_bytes | slot | pitch);
    for (int i = 0; i < nlocal; ++i)
      al |= reinterpret_cast<unsigned long long>(a.r[i].in) |
            reinterpret_cast<unsigned long long>(a.r[i].out) |
            reinterpret_cast<unsigned long long>(a.r[i].lz) |
            reinterpret_cast<unsigned long long>(a.r[i].lz_right);
    if (al % vb == 0) break;
  }
  const long long vpr = row_bytes / vb;
  const long long pv = pitch / vb;
  int log2g = 0;
  while (log2g < 5 && (1LL << log2g) < pv) ++log2g;
  a.slot = slot;
  a.row_bytes = row_bytes;
  a.row_vecs = static_cast<int>(vpr);
  a.pitch_vecs = static_cast<int>(pv);
  a.log2g = log2g;
  if (vb == 2)
    return launch(ring_gather_kernel<unsigned short>, dev, a, nlocal, stream);
  if (vb == 4)
    return launch(ring_gather_kernel<unsigned int>, dev, a, nlocal, stream);
  if (vb == 8) return launch(ring_gather_kernel<uint2>, dev, a, nlocal, stream);
  return launch(ring_gather_kernel<uint4>, dev, a, nlocal, stream);
}

// prod_bf16: the products are bf16, else f32; the output is f32.  The
// reduce reads each rank's id-sorted plan (pos, loc, off) and not its ids.
int splatt_ring_reduce(int dev, const void* ranks, int nlocal, int ndev,
                       long long block, long long R, int prod_bf16,
                       long long gen, void* err, long long timeout_ns,
                       int exchange, void* stream) {
  RingArgs a;
  int rc = fill(&a, ranks, nlocal, ndev, block, R, gen, err, timeout_ns,
                exchange);
  if (rc != 0) return rc;
  // the widest product vector the row length and every rank's products
  // allow (the accumulator rows are then aligned to it too)
  const int esize = prod_bf16 ? 2 : 4;
  int vw = prod_bf16 ? 8 : 4;
  for (; vw > 1; vw /= 2) {
    unsigned long long al = 0;
    for (int i = 0; i < nlocal; ++i)
      al |= reinterpret_cast<unsigned long long>(a.r[i].in) |
            reinterpret_cast<unsigned long long>(a.r[i].acc);
    if (R % vw == 0 && al % (vw * esize) == 0 && al % (vw * 4) == 0) break;
  }
  for (int i = 0; i < nlocal; ++i)
    if (a.r[i].pos == nullptr || a.r[i].loc == nullptr ||
        a.r[i].off == nullptr)
      return static_cast<int>(cudaErrorInvalidValue);
  if (prod_bf16) {
    if (vw == 8)
      return launch(ring_reduce_kernel<unsigned short, 8>, dev, a, nlocal,
                    stream);
    if (vw == 4)
      return launch(ring_reduce_kernel<unsigned short, 4>, dev, a, nlocal,
                    stream);
    if (vw == 2)
      return launch(ring_reduce_kernel<unsigned short, 2>, dev, a, nlocal,
                    stream);
    return launch(ring_reduce_kernel<unsigned short, 1>, dev, a, nlocal,
                  stream);
  }
  if (vw == 4)
    return launch(ring_reduce_kernel<float, 4>, dev, a, nlocal, stream);
  if (vw == 2)
    return launch(ring_reduce_kernel<float, 2>, dev, a, nlocal, stream);
  return launch(ring_reduce_kernel<float, 1>, dev, a, nlocal, stream);
}

// Enable access from card `dev` to card `peer`'s memory: 0, or -1 when the
// pair has no peer access, or the cudaError_t.
int splatt_ring_enable_peer(int dev, int peer) {
  int can = 0;
  cudaError_t err = cudaDeviceCanAccessPeer(&can, dev, peer);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (!can) return -1;
  int prev = 0;
  cudaGetDevice(&prev);
  err = cudaSetDevice(dev);
  if (err == cudaSuccess) {
    err = cudaDeviceEnablePeerAccess(peer, 0);
    if (err == cudaErrorPeerAccessAlreadyEnabled) {
      cudaGetLastError();
      err = cudaSuccess;
    }
  }
  cudaSetDevice(prev);
  return static_cast<int>(err);
}

// `bytes` of zeroed host memory mapped into every card's address space:
// its host address in *host and its device address in *device.
int splatt_ring_alloc_host(long long bytes, void** host, void** device) {
  cudaError_t err = cudaHostAlloc(
      host, static_cast<size_t>(bytes),
      cudaHostAllocMapped | cudaHostAllocPortable);
  if (err != cudaSuccess) return static_cast<int>(err);
  for (long long i = 0; i < bytes; ++i) static_cast<char*>(*host)[i] = 0;
  return static_cast<int>(cudaHostGetDevicePointer(device, *host, 0));
}

}  // extern "C"

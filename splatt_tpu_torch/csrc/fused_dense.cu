// Dense-mode MTTKRP for Hopper (sm_90a): a mode's unfolding, stored as
// value tiles, times a Khatri-Rao operand the kernel generates, on the
// tensor cores.
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
// for r < rows (the mode's dim; pad rows are zero and never read), into a
// zeroed (rows, R) f32 output.  Pad columns meet zero u rows and add exact
// zeros, so the pad mask is never read.
//
// What bounds it on this card: bytes.  It reads each value once (4 bytes
// in f32, 2 in bf16) and does 2 R operations on it.  On the tensor cores
// that is below the ridge even in f32 made of three TF32 products: at
// R = 50, 3 x 2 x 50 operations per 4 bytes is 75 per byte against
// 495 TFLOP/s over 3.35 TB/s = 148; in bf16 50 per byte against 295.
// The least time is the values over the HBM rate.
//
// The design.  A CTA of four warpgroups owns 128 output rows, a tile of N
// rank columns (R rounded up to 8, 16, 32, 64 or 96, more rank tiles on
// grid.y: N = 128 with bf16 values and factors faulted with an illegal
// instruction on an H100, so it is not built) and a share of
// the span's chunks (split-K, so a mode with one row block still fills
// the card; see Schedule); its f32 partial is added into the output with
// atomics at the end.  A chunk is kBk columns, one 128-byte row of the
// narrower operand type, inside one outer index since inner_pad is a
// multiple of 128.
//  - Warpgroups 0-1 produce.  Thread 0 loads the chunk's (128 x kBk)
//    value box with TMA (a 2-D tensor map, 128-byte swizzle; rows past
//    `rows` come back as zeros) into a ring of stages in shared memory,
//    signalled by mbarriers.  The 256 threads build the chunk's Khatri-Rao
//    sub-tile B (kBk x N) from one w row and kBk u rows, K-major in the
//    same swizzle, the layout wgmma reads B in; with f32 factors B is
//    stored twice, as its TF32 part and the TF32 part of the remainder.
//    The u rows stay in shared memory while the CTA's chunks share them,
//    and cp.async brings the w rows several chunks ahead: B built from
//    loads straight from L2 cost one round trip per chunk and made the
//    producer the bound (on an H100 at R = 50, PERF.md).  The (span, R)
//    Khatri-Rao operand never exists in device memory.
//  - Warpgroups 2 and 3 consume, 64 rows each: they read their value
//    fragments from shared memory into registers and issue wgmma with A
//    from registers and B from shared memory:
//      bf16 factors: one bf16 product (f32 values rounded to bf16 first,
//        as the plain version casts the tiles to the factor type);
//      f32 factors: 3xTF32, x = big + small with big = tf32(x) and
//        small = tf32(x - big), acc += a_big b_big + a_big b_small +
//        a_small b_big, about 2^-21 relative per product; bf16 values are
//        exact in TF32 (their small part is zero), so they take two.
//    The tensor cores' f32 accumulation does not round to nearest, so its
//    error grows with the products one accumulator takes (over a 16k-
//    column share, 5.6e-5 of the largest output on an H100): every
//    kFlush chunks each thread adds its accumulators into f32 sums of its
//    own in shared memory (IEEE adds) and restarts them from zero.
// Offsets are 64-bit; the kernel allocates nothing.  Every mbarrier wait is
// bounded (kSpinNs): a wait that runs out traps, so a fault in the
// protocol ends the launch with an error instead of a hang.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "wgmma_rs.cuh"

namespace {

constexpr int kRows = 128;          // output rows per CTA: 2 x 64
constexpr int kProducers = 256;     // warpgroups 0-1 produce, 2-3 consume
constexpr int kThreads = kProducers + 256;
constexpr int kRowBytes = 128;      // a swizzled shared row, one TMA box row
constexpr int kSmemBudget = 232448 - 1024 - 256;  // stages, u and w rows
constexpr int kMaxStages = 8;
constexpr int kWSlots = 5;
constexpr int kFullArrivals = kProducers + 1;  // + the TMA's expect_tx
constexpr int kEmptyArrivals = 8;   // one per consumer warp
constexpr int kConsumers = kThreads - kProducers;
constexpr int kFlush = 8;           // chunks an accumulator takes, at most
constexpr unsigned long long kSpinNs = 4000000000ull;

constexpr int cmin(int a, int b) { return a < b ? a : b; }

// The shapes of one instantiation: TV the value type, TF the factor type,
// N the rank columns of the tile.
template <class TV, class TF, int N>
struct Tile {
  static constexpr int kSa = sizeof(TV);
  static constexpr int kSb = sizeof(TF);
  static constexpr bool kTf32 = kSb == 4;            // else bf16 products
  static constexpr bool kSplitA = kTf32 && kSa == 4;  // A has a small part
  static constexpr int kBk = kRowBytes / (kSa < kSb ? kSa : kSb);
  static constexpr int kASub = kBk * kSa / kRowBytes;  // TMA boxes a chunk
  static constexpr int kBSub = kBk * kSb / kRowBytes;  // B row tiles a half
  static constexpr int kHalves = kTf32 ? 2 : 1;        // big (and small)
  static constexpr int kABytes = kASub * kRows * kRowBytes;
  static constexpr int kBBytes = N * kRowBytes;        // one B row tile
  static constexpr int kStage = kABytes + kHalves * kBSub * kBBytes;
  // the producer's own buffers: the kBk u rows of its current u block,
  // and a ring of w rows copied kWSlots - 1 chunks ahead with cp.async
  static constexpr int kURow = N * kSb;
  static constexpr int kUBytes = (kBk * kURow + 127) / 128 * 128;
  static constexpr int kWSlot = (kURow + 127) / 128 * 128;
  // the consumers' flushed sums, N / 2 a thread
  static constexpr int kSumBytes = kConsumers * (N / 2) * 4;
  static constexpr int kStages =
      cmin(kMaxStages,
           (kSmemBudget - kUBytes - kWSlots * kWSlot - kSumBytes) / kStage);
  static constexpr int kKm = kTf32 ? 8 : 16;           // wgmma K
  static constexpr int kSteps = kBk / kKm;             // 32 bytes of B each
  static constexpr int kVec = 16 / kSb;                // B entries a store
  static constexpr int kPieces = N * kBSub * (kRowBytes / 16);
  static constexpr int kSmem = kStages * kStage + kUBytes +
                               kWSlots * kWSlot + 1024 + 2 * kStages * 8 +
                               kSumBytes;
  static_assert(N % 8 == 0 && N >= 8 && N <= 96, "wgmma N");
  static_assert(kStages >= 2, "the ring needs two stages");
  static_assert(kBk % kKm == 0 && kSteps * 32 == kBk * kSb, "steps");
  static_assert(kURow % 16 == 0, "u rows in 16-byte copies");
};

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ unsigned long long globaltimer() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;"
               :: "r"(smem_u32(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];"
               :: "r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ void mbar_arrive_tx(uint64_t* bar,
                                               unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}

// Wait for the phase of `bar` with this parity to complete; trap after
// kSpinNs.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  const unsigned a = smem_u32(bar);
  unsigned long long t0 = 0;
  for (unsigned it = 0;; ++it) {
    unsigned done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(a), "r"(parity) : "memory");
    if (done) return;
    if (it == 0) t0 = globaltimer();
    else if ((it & 1023) == 0 && globaltimer() - t0 > kSpinNs) __trap();
  }
}

// L2 policies: the value tiles stream through once (evict first), the
// w and u rows are read by every CTA (evict last).  Without them the
// stream evicted u and its rows came from DRAM, a fifth of the time.
__device__ __forceinline__ uint64_t evict_first() {
  uint64_t p;
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;"
               : "=l"(p));
  return p;
}

__device__ __forceinline__ uint64_t evict_last() {
  uint64_t p;
  asm volatile("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;"
               : "=l"(p));
  return p;
}

__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int x, int y,
                                         uint64_t policy) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes.L2::cache_hint [%0], [%1, {%3, %4}], [%2], %5;"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)),
         "r"(smem_u32(bar)), "r"(x), "r"(y), "l"(policy)
      : "memory");
}

// The descriptor of a K-major operand in 128-byte-swizzled rows: 8-row
// groups 1024 bytes apart (SBO); the leading offset is unused when a
// step's 32 bytes lie inside the swizzle span.
__device__ __forceinline__ unsigned long long sw128_desc(const void* p) {
  return static_cast<unsigned long long>((smem_u32(p) & 0x3FFFF) >> 4) |
         (1ull << 16) | (64ull << 32) | (1ull << 62);
}

// Byte offset of byte `b` of row `r` in 128-byte rows swizzled as TMA's
// CU_TENSOR_MAP_SWIZZLE_128B stores them (16-byte chunk ^ row % 8).
__device__ __forceinline__ int swz(int r, int b) {
  return r * kRowBytes + ((((b >> 4) ^ r) & 7) << 4) + (b & 15);
}

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

__device__ __forceinline__ unsigned tf32(float x) {
  unsigned r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

__device__ __forceinline__ unsigned bf16x2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&v);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           uint64_t policy) {
  asm volatile("cp.async.cg.shared.global.L2::cache_hint [%0], [%1], 16, %2;"
               :: "r"(smem_u32(dst)), "l"(src), "l"(policy) : "memory");
}

// The producer threads alone (named barrier 1).
__device__ __forceinline__ void producer_sync() {
  asm volatile("bar.sync 1, %0;" :: "n"(kProducers) : "memory");
}

// The chunks of one CTA, u-stationary.  Chunk (o, ib) is the span's
// columns (o nib + ib) kBk .. + kBk - 1: outer index o, inner rows
// ib kBk ...  Split s of a row block takes u block(s) ib and for each a
// range of o, so consecutive chunks share their kBk u rows, which the
// producer keeps in shared memory, and differ only in the w row: with
// splits <= nib, blocks s, s + splits, .. and every o; with splits a
// multiple of nib, block s % nib and part s / nib of the o range.  At
// any time the CTAs of a row block read neighbouring 128-byte pieces of
// the same rows.  (Each chunk's u rows fetched from L2 cost a fifth of
// the time on an H100 at R = 50: PERF.md.)
struct Schedule {
  int ib0, ib_step, n_ib, o_lo, o_n;
  __device__ Schedule(int nib, int n_outer, int split, int splits) {
    if (splits <= nib) {
      ib0 = split;
      ib_step = splits;
      n_ib = (nib - split + splits - 1) / splits;
      o_lo = 0;
      o_n = n_outer;
    } else {
      const int parts = splits / nib;
      const int part = split / nib;
      ib0 = split % nib;
      ib_step = nib;
      n_ib = 1;
      o_lo = static_cast<int>((long long)n_outer * part / parts);
      o_n = static_cast<int>((long long)n_outer * (part + 1) / parts) - o_lo;
    }
  }
  __device__ int count() const { return n_ib * o_n; }
  __device__ int ib(int j) const { return ib0 + j / o_n * ib_step; }
  __device__ int o(int j) const { return o_lo + j % o_n; }
};

// Warpgroups 0-1.  Per chunk, into the next free stage: the value box by
// TMA, and the Khatri-Rao sub-tile B built from the u rows of the chunk's
// u block (copied when the block changes) and its w row (copied kWSlots -
// 1 chunks ahead), so the producer waits on no global load.  B is stored
// K-major in the 128-byte swizzle, as TF32 parts (big, then the
// remainder's) or as bf16: piece p is rank column n = p % N, k = (p / N)
// kVec .. + kVec - 1.
template <class TV, class TF, int N>
__device__ __forceinline__ void produce(
    const CUtensorMap* map, const TF* __restrict__ w,
    const TF* __restrict__ u, int nib, int ld, int n0, int row0,
    const Schedule& sched, unsigned char* smem, unsigned char* ubuf,
    unsigned char* wring, uint64_t* full, uint64_t* empty) {
  using T = Tile<TV, TF, N>;
  constexpr int kAhead = kWSlots - 1;
  constexpr int kRowVecs = T::kURow / 16;
  const int t = threadIdx.x;
  const int count = sched.count();
  const uint64_t stream = evict_first();
  const uint64_t keep = evict_last();
  auto fetch_w = [&](int j) {
    const char* src =
        reinterpret_cast<const char*>(w + (long long)sched.o(j) * ld + n0);
    for (int i = t; i < kRowVecs; i += kProducers)
      cp_async16(wring + (j % kWSlots) * T::kWSlot + i * 16, src + i * 16,
                 keep);
  };
#pragma unroll 1
  for (int j = 0; j < kAhead; ++j) {
    if (j < count) fetch_w(j);
    asm volatile("cp.async.commit_group;" ::: "memory");
  }
  int stage = 0;
  unsigned phase = 0;
  int cur_ib = -1;
  for (int j = 0; j < count; ++j) {
    const int ib = sched.ib(j);
    if (ib != cur_ib) {
      // a new u block, once every producer is done with the last one
      producer_sync();
      const long long i0 = (long long)ib * T::kBk;
      for (int i = t; i < T::kBk * kRowVecs; i += kProducers) {
        const int r = i / kRowVecs;
        cp_async16(ubuf + r * T::kURow + (i % kRowVecs) * 16,
                   reinterpret_cast<const char*>(u + (i0 + r) * ld + n0) +
                       (i % kRowVecs) * 16,
                   keep);
      }
      asm volatile("cp.async.commit_group;" ::: "memory");
      asm volatile("cp.async.wait_group 0;" ::: "memory");
      cur_ib = ib;
    }
    // chunk j's w row (mine, then everyone's copies) has landed, and
    // everyone is done with the slot the next fetch overwrites
    asm volatile("cp.async.wait_group %0;" :: "n"(kAhead - 1) : "memory");
    producer_sync();
    if (j + kAhead < count) fetch_w(j + kAhead);
    asm volatile("cp.async.commit_group;" ::: "memory");
    const long long c = (long long)sched.o(j) * nib + ib;
    const TF* us = reinterpret_cast<const TF*>(ubuf);
    const TF* ws = reinterpret_cast<const TF*>(wring + (j % kWSlots) *
                                                           T::kWSlot);
    mbar_wait(empty + stage, phase ^ 1);
    unsigned char* st = smem + stage * T::kStage;
    if (t == 0) {
      mbar_arrive_tx(full + stage, T::kABytes);
#pragma unroll
      for (int a = 0; a < T::kASub; ++a)
        tma_load(st + a * kRows * kRowBytes, map, full + stage,
                 static_cast<int>(c * T::kBk) + a * (kRowBytes / T::kSa),
                 row0, stream);
    }
    unsigned char* b = st + T::kABytes;
    // rounds of up to 4 pieces a thread: every shared-memory read of the
    // round first, then the products and stores (the reads and the stores
    // may alias as far as the compiler knows, so it would not overlap them)
    constexpr int kPer = (T::kPieces + kProducers - 1) / kProducers;
    constexpr int kRound = kPer < 4 ? kPer : 4;
#pragma unroll
    for (int j0 = 0; j0 < kPer; j0 += kRound) {
      float wn[kRound];
      float x[kRound][T::kVec];
#pragma unroll
      for (int i = 0; i < kRound; ++i) {
        const int p = t + kProducers * (j0 + i);
        const int n = p < T::kPieces ? p % N : 0;
        const int q = p < T::kPieces ? p / N : 0;
        wn[i] = widen(ws[n]);
#pragma unroll
        for (int v = 0; v < T::kVec; ++v)
          x[i][v] = widen(us[(q * T::kVec + v) * N + n]);
      }
#pragma unroll
      for (int i = 0; i < kRound; ++i) {
        const int p = t + kProducers * (j0 + i);
        if (p >= T::kPieces) continue;
        const int off = (p / N >> 3) * T::kBBytes +
                        swz(p % N, ((p / N) & 7) << 4);
        float kr[T::kVec];
#pragma unroll
        for (int v = 0; v < T::kVec; ++v)
          kr[v] = round_to<TF>(wn[i] * x[i][v]);
        if constexpr (T::kTf32) {
          unsigned bg[4];
          unsigned sm[4];
#pragma unroll
          for (int v = 0; v < 4; ++v) {
            bg[v] = tf32(kr[v]);
            sm[v] = tf32(kr[v] - __uint_as_float(bg[v]));
          }
          *reinterpret_cast<uint4*>(b + off) =
              make_uint4(bg[0], bg[1], bg[2], bg[3]);
          *reinterpret_cast<uint4*>(b + T::kBSub * T::kBBytes + off) =
              make_uint4(sm[0], sm[1], sm[2], sm[3]);
        } else {
          unsigned pk[4];
#pragma unroll
          for (int v = 0; v < 4; ++v)
            pk[v] = bf16x2(kr[2 * v], kr[2 * v + 1]);
          *reinterpret_cast<uint4*>(b + off) =
              make_uint4(pk[0], pk[1], pk[2], pk[3]);
        }
      }
    }
    // the generic-proxy stores above are read by wgmma (the async proxy)
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    mbar_arrive(full + stage);
    if (++stage == T::kStages) {
      stage = 0;
      phase ^= 1;
    }
  }
  asm volatile("cp.async.wait_group 0;" ::: "memory");
}

// One consumer warpgroup's A fragment of step s: rows r and r + 8 of the
// CTA tile, the thread's columns of the step, as wgmma takes them from
// registers.  `hi` gets the value (TF32 part), `lo` the TF32 remainder.
template <class TV, class TF, int N>
__device__ __forceinline__ void load_a(const unsigned char* a, int r, int s,
                                       int tq, unsigned (&hi)[4],
                                       unsigned (&lo)[4]) {
  using T = Tile<TV, TF, N>;
  if constexpr (T::kTf32) {
    // a0 (r, k), a1 (r + 8, k), a2 (r, k + 4), a3 (r + 8, k + 4)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = r + (i & 1) * 8;
      const int col = s * 8 + tq + (i >> 1) * 4;
      const int byte = col * T::kSa;
      const unsigned char* p = a + (byte >> 7) * kRows * kRowBytes +
                               swz(row, byte & 127);
      float x;
      if constexpr (T::kSa == 4) {
        x = *reinterpret_cast<const float*>(p);
      } else {
        x = __uint_as_float(
            static_cast<unsigned>(*reinterpret_cast<const unsigned short*>(p))
            << 16);
      }
      hi[i] = tf32(x);
      if constexpr (T::kSplitA) lo[i] = tf32(x - __uint_as_float(hi[i]));
    }
  } else {
    // a0 (r, 2k..), a1 (r + 8, 2k..), a2 (r, 2k + 8..), a3 (r + 8, 2k + 8..)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = r + (i & 1) * 8;
      const int col = s * 16 + 2 * tq + (i >> 1) * 8;
      const int byte = col * T::kSa;
      const unsigned char* p = a + (byte >> 7) * kRows * kRowBytes +
                               swz(row, byte & 127);
      if constexpr (T::kSa == 2) {
        hi[i] = *reinterpret_cast<const unsigned*>(p);
      } else {
        const float2 x = *reinterpret_cast<const float2*>(p);
        hi[i] = bf16x2(x.x, x.y);
      }
    }
  }
}

template <class TV, class TF, int N>
__device__ __forceinline__ void consume(
    int cw, long long rows, int R, int n0, long long row0, long long count,
    unsigned char* smem, uint64_t* full, uint64_t* empty, float* sums,
    float* __restrict__ out) {
  using T = Tile<TV, TF, N>;
  constexpr Mma kKind = T::kTf32 ? Mma::kTf32 : Mma::kBf16;
  const int warp = (threadIdx.x >> 5) & 3;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int tq = lane & 3;
  const int r = cw * 64 + warp * 16 + g;   // rows r and r + 8 of the tile
  // this thread's sums: entry i at sum[i * kConsumers], conflict-free
  float* sum = sums + (threadIdx.x - kProducers);
  float acc[N / 2];
#pragma unroll
  for (int i = 0; i < N / 2; ++i) {
    acc[i] = 0.f;
    sum[i * kConsumers] = 0.f;
  }
  int stage = 0;
  unsigned phase = 0;
  for (long long j = 0; j < count; ++j) {
    mbar_wait(full + stage, phase);
    // the wait's exit is per thread; wgmma's .aligned needs the warp whole
    __syncwarp();
    const unsigned char* st = smem + stage * T::kStage;
    const unsigned char* b = st + T::kABytes;
    unsigned hi[T::kSteps][4];
    unsigned lo[T::kSteps][4];
#pragma unroll
    for (int s = 0; s < T::kSteps; ++s)
      load_a<TV, TF, N>(st, r, s, tq, hi[s], lo[s]);
    asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
#pragma unroll
    for (int s = 0; s < T::kSteps; ++s) {
      const unsigned char* bs = b + (s >> 2) * T::kBBytes + (s & 3) * 32;
      const unsigned long long big = sw128_desc(bs);
      mma<kKind, N>(acc, hi[s], big);
      if constexpr (T::kTf32) {
        mma<kKind, N>(acc, hi[s], sw128_desc(bs + T::kBSub * T::kBBytes));
        if constexpr (T::kSplitA) mma<kKind, N>(acc, lo[s], big);
      }
    }
    asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
    // the fragments stay live, unchanged, until the products that read
    // them are done (a second set, to wait one chunk later, gained
    // nothing on an H100)
#pragma unroll
    for (int s = 0; s < T::kSteps; ++s)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        asm volatile("" : "+r"(hi[s][i]) :: "memory");
        if constexpr (T::kSplitA)
          asm volatile("" : "+r"(lo[s][i]) :: "memory");
      }
#pragma unroll
    for (int i = 0; i < N / 2; ++i)
      asm volatile("" : "+f"(acc[i]) :: "memory");
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + stage);
    if (++stage == T::kStages) {
      stage = 0;
      phase ^= 1;
    }
    if ((j + 1) % kFlush == 0) {
#pragma unroll
      for (int i = 0; i < N / 2; ++i) {
        sum[i * kConsumers] += acc[i];
        acc[i] = 0.f;
      }
    }
  }
  // d[i]: row r + 8 ((i >> 1) & 1), column (i >> 2) * 8 + 2 tq + (i & 1)
#pragma unroll
  for (int i = 0; i < N / 2; ++i) {
    const long long row = row0 + r + ((i >> 1) & 1) * 8;
    const int n = n0 + (i >> 2) * 8 + 2 * tq + (i & 1);
    if (row < rows && n < R)
      atomicAdd(out + row * R + n, sum[i * kConsumers] + acc[i]);
  }
}

template <class TV, class TF, int N>
__global__ void __launch_bounds__(kThreads, 1)
dense_kernel(const __grid_constant__ CUtensorMap map,
             const TF* __restrict__ w, const TF* __restrict__ u,
             long long rows, int nib, int n_outer, int R, int row_blocks,
             float* __restrict__ out) {
  using T = Tile<TV, TF, N>;
  extern __shared__ unsigned char smem_raw[];
  const unsigned raw = smem_u32(smem_raw);
  unsigned char* smem = smem_raw + (((raw + 1023u) & ~1023u) - raw);
  unsigned char* ubuf = smem + T::kStages * T::kStage;
  unsigned char* wring = ubuf + T::kUBytes;
  uint64_t* full =
      reinterpret_cast<uint64_t*>(wring + kWSlots * T::kWSlot);
  uint64_t* empty = full + T::kStages;
  float* sums = reinterpret_cast<float*>(empty + T::kStages);

  const int rb = blockIdx.x % row_blocks;
  const Schedule sched(nib, n_outer, blockIdx.x / row_blocks,
                       gridDim.x / row_blocks);
  const int n0 = blockIdx.y * N;
  if (sched.count() <= 0) return;   // the whole CTA, before any barrier
  if (threadIdx.x == 0) {
    for (int s = 0; s < T::kStages; ++s) {
      mbar_init(full + s, kFullArrivals);
      mbar_init(empty + s, kEmptyArrivals);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x < kProducers) {
    produce<TV, TF, N>(&map, w, u, nib, gridDim.y * N, n0, rb * kRows, sched,
                       smem, ubuf, wring, full, empty);
  } else {
    consume<TV, TF, N>((threadIdx.x - kProducers) >> 7, rows, R, n0,
                       (long long)rb * kRows, sched.count(), smem, full,
                       empty, sums, out);
  }
}

using EncodeTiled = CUresult (*)(
    CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
    const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
    CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
    CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver the runtime already loaded, so
// the library needs no -lcuda.
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (e == cudaSuccess && q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

template <class TV, class TF, int N>
cudaError_t launch(const void* tiles, const void* w, const void* u,
                   long long rows, long long span, int inner_pad, int R,
                   int rank_tiles, int row_blocks, int splits,
                   float* out, cudaStream_t s) {
  using T = Tile<TV, TF, N>;
  if (span % inner_pad || inner_pad % T::kBk || rank_tiles * N < R)
    return cudaErrorInvalidValue;
  // the u-stationary schedule: splits at most nib, or whole multiples of
  // it up to one part per outer index
  const long long nib = inner_pad / T::kBk;
  const long long n_outer = span / inner_pad;
  if (splits > nib && (splits % nib || splits / nib > n_outer))
    return cudaErrorInvalidValue;
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  // the (rows, span) values: rows past `rows` (the pad rows and the second
  // warpgroup's rows past a short mode) are filled with zeros
  CUtensorMap map;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(span),
                              static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(span) * T::kSa};
  const cuuint32_t box[2] = {kRowBytes / T::kSa, kRows};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult rc = encode(
      &map, T::kSa == 4 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                        : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
      2, const_cast<void*>(tiles), dims, strides, box, elem,
      CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (rc != CUDA_SUCCESS) return cudaErrorInvalidValue;
  const cudaError_t e = cudaFuncSetAttribute(
      dense_kernel<TV, TF, N>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      T::kSmem);
  if (e != cudaSuccess) return e;
  const dim3 grid(static_cast<unsigned>(row_blocks) *
                      static_cast<unsigned>(splits),
                  static_cast<unsigned>(rank_tiles));
  dense_kernel<TV, TF, N><<<grid, kThreads, T::kSmem, s>>>(
      map, static_cast<const TF*>(w), static_cast<const TF*>(u), rows,
      static_cast<int>(nib), static_cast<int>(n_outer), R, row_blocks, out);
  return cudaGetLastError();
}

template <class TV, class TF>
cudaError_t dispatch(int n_tile, const void* tiles, const void* w,
                     const void* u, long long rows, long long span,
                     int inner_pad, int R, int rank_tiles, int row_blocks,
                     int splits, float* out,
                     cudaStream_t s) {
#define SPLATT_DENSE_N(n)                                                  \
  case n:                                                                  \
    return launch<TV, TF, n>(tiles, w, u, rows, span, inner_pad, R,        \
                             rank_tiles, row_blocks, splits,               \
                             out, s);
  switch (n_tile) {
    SPLATT_DENSE_N(8)
    SPLATT_DENSE_N(16)
    SPLATT_DENSE_N(32)
    SPLATT_DENSE_N(64)
    SPLATT_DENSE_N(96)
    default:
      return cudaErrorInvalidValue;
  }
#undef SPLATT_DENSE_N
}

}  // namespace

extern "C" {

// Returns the cudaError_t of the launch (0 on success), launches on
// `stream`, does not synchronise and allocates nothing.  tiles_bf16 /
// fac_bf16: the values / the factor operands w and u are bf16, else f32.
// `out` is a zeroed (rows, R) f32 array; `tiles` is 16-byte aligned,
// inner_pad is a multiple of the chunk (32 columns with f32 values and
// factors, else 64) and span a multiple of inner_pad below 2^31.  n_tile
// is the rank tile N (8, 16, 32, 64 or 96), rank_tiles *
// n_tile >= R; w (n_outer, ld) and u (inner_pad, ld) are 16-byte aligned
// with ld = rank_tiles * n_tile columns, zero past R.  The grid is
// row_blocks x splits CTAs (row_blocks = ceil(rows / 128); splits at most
// nib = inner_pad / chunk, or a multiple of nib at most nib * n_outer:
// Schedule) by rank_tiles.
int splatt_fused_dense(const void* tiles, int tiles_bf16, const void* w,
                       const void* u, int fac_bf16, long long rows,
                       long long span, int inner_pad, int R, int n_tile,
                       int rank_tiles, int row_blocks, int splits,
                       void* out, void* stream) {
  if (rows < 1 || rows >= (1LL << 31) || span < 1 || span >= (1LL << 31) ||
      inner_pad < 1 || R < 1 || rank_tiles < 1 || rank_tiles > 65535 ||
      row_blocks < 1 || splits < 1 ||
      (long long)row_blocks * splits >= (1LL << 31) ||
      (reinterpret_cast<unsigned long long>(tiles) |
       reinterpret_cast<unsigned long long>(w) |
       reinterpret_cast<unsigned long long>(u)) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  float* o = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (tiles_bf16) {
    return static_cast<int>(
        fac_bf16 ? dispatch<__nv_bfloat16, __nv_bfloat16>(
                       n_tile, tiles, w, u, rows, span, inner_pad, R,
                       rank_tiles, row_blocks, splits, o, s)
                 : dispatch<__nv_bfloat16, float>(
                       n_tile, tiles, w, u, rows, span, inner_pad, R,
                       rank_tiles, row_blocks, splits, o,
                       s));
  }
  return static_cast<int>(
      fac_bf16 ? dispatch<float, __nv_bfloat16>(
                     n_tile, tiles, w, u, rows, span, inner_pad, R,
                     rank_tiles, row_blocks, splits, o, s)
               : dispatch<float, float>(n_tile, tiles, w, u, rows, span,
                                        inner_pad, R, rank_tiles, row_blocks,
                                        splits, o, s));
}

}  // extern "C"

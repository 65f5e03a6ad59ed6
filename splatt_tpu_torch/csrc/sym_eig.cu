// Symmetric eigendecomposition of the rank x rank normal-equations matrix,
// for Hopper (sm_90a), with no host synchronisation.
//
// Replaces a library call, not a TPU kernel.  The JAX package's solve
// (splatt_tpu/ops/linalg.py:53-86) calls jnp.linalg.eigh inside one jitted
// sweep that never waits on the host.  torch.linalg.eigh on a card reads
// its solver status on the host: one sync per mode per sweep.  This kernel
// takes its place in splatt_tpu_torch/ops/linalg.py (solve_normals and
// parallel/common.py's solve_normals_many); everything after it (the cut at
// sqrt(eps) max|w|, the pseudo-inverse, the SPD test, the branchless
// select) stays as it was.
//
//   A (R x R, symmetric, f32 or f64, row-major) -> w (R,) ascending and
//   V (R x R, row-major), column k the unit eigenvector of w[k]:
//   A = V diag(w) V^T.
//
// A batch of K such matrices, stored one after another (K, R, R), is one
// launch of K CTAs: CTA b reads the b-th matrix and writes the b-th w, V
// and sweep count, and no CTA reads another's data, so a non-finite
// matrix (whose CTA writes NaN) never moves its neighbours.  The batched
// CPD (splatt_tpu_torch/cpd.py, cpd_als_batched) solves every slot's mode
// with one launch.
//
// The algorithm: parallel cyclic Jacobi in one CTA, A and V in shared
// memory.  R is padded to an even n with a zero row and column (a dummy
// index that never rotates).  A sweep is n - 1 rounds of the round-robin
// ("circle") ordering: index 0 stays, indices 1..n-1 turn, so each round
// holds n/2 disjoint pairs and a sweep visits every pair once.  In a round,
// thread i computes the rotation of pair i (Golub and Van Loan's
// sym.schur2) and writes the pair's diagonal block; after a barrier every
// 2x2 block of A between two pairs becomes Jp^T A[P,S] Js, written with its
// transpose so A stays exactly symmetric, and V becomes V J.  A rotation is
// skipped when |a_pq| <= eps ||A||_F / n, and the sweeps stop when the
// off-diagonal norm is <= eps ||A||_F, which that skip rule guarantees once
// no pair is rotated (the test runs on the card).  A sweep cap stops a run
// that does not converge: the kernel then writes 1 into a mapped host word
// (status) that the host reads after the iteration's fit read, where the
// run raises, and writes max_sweeps + 1 as its sweep count, so a batch's
// caller tells which matrix hit the cap.  A non-finite input gives NaN (as
// eigh does), a sweep count of 0 and no status.
// The matrix is first scaled by a power of two that brings its largest
// entry into [0.5, 1): exact, and no sum of squares can overflow.
//
// What bounds it on this card: neither bytes nor FLOPs.  A sweep is about
// 9 n^3 operations (6 per element of A, 3 per element of V, per round):
// at R = 50, about 1.1 MFLOP, 2.2 us at one SM's share of the f32 FFMA
// rate.  The kernel is bound by its 2 barriers per round, about 50 rounds
// per sweep; a round in which no pair rotates skips its update and second
// barrier.  One CTA per matrix is the point: the solve is a chain of small dependent
// steps, and one SM runs it with no grid-wide synchronisation and no launch
// per step.
//
// Shared memory: 2 n (n + 1) elements (rows padded to an odd stride, so a
// column walk does not hit one bank) and a few small arrays, at most 227 KB:
// f32 up to R = 168, f64 up to R = 118 (ops/linalg.py, sym_eig_fits).  The
// solve takes this kernel only up to R = 96, where it stops beating
// torch.linalg.eigh (ops/linalg.py, solve_takes_sym_eig).

#include <cuda_runtime.h>

#include <cmath>

namespace {

template <class T> struct Eps;
template <> struct Eps<float> {
  static constexpr float v = 1.1920928955078125e-07f;
};
template <> struct Eps<double> {
  static constexpr double v = 2.220446049250313080847e-16;
};

__device__ __forceinline__ float f_sqrt(float x) { return sqrtf(x); }
__device__ __forceinline__ double f_sqrt(double x) { return sqrt(x); }
__device__ __forceinline__ float f_abs(float x) { return fabsf(x); }
__device__ __forceinline__ double f_abs(double x) { return fabs(x); }
__device__ __forceinline__ float f_max(float a, float b) { return fmaxf(a, b); }
__device__ __forceinline__ double f_max(double a, double b) {
  return fmax(a, b);
}
__device__ __forceinline__ float f_copysign(float a, float b) {
  return copysignf(a, b);
}
__device__ __forceinline__ double f_copysign(double a, double b) {
  return copysign(a, b);
}
__device__ __forceinline__ float f_frexp(float x, int* e) {
  return frexpf(x, e);
}
__device__ __forceinline__ double f_frexp(double x, int* e) {
  return frexp(x, e);
}
__device__ __forceinline__ float f_ldexp(float x, int e) {
  return ldexpf(x, e);
}
__device__ __forceinline__ double f_ldexp(double x, int e) {
  return ldexp(x, e);
}

// Dynamic shared memory for an n x n problem (n even): A and V at stride
// n + 1, the rotations C and S, 32 reduction slots, then the pairs P, Q and
// the sort ranks.  ops/linalg.py:sym_eig_smem_bytes mirrors it.
template <class T>
size_t smem_bytes(int n) {
  const size_t h = n / 2;
  return (2 * (size_t)n * (n + 1) + 2 * h + 32) * sizeof(T) +
         (2 * h + n + 4) * sizeof(int);
}

template <class T, class Op>
__device__ T block_reduce(T v, T* red, Op op) {
  for (int o = 16; o > 0; o >>= 1)
    v = op(v, __shfl_down_sync(0xffffffffu, v, o));
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  __syncthreads();  // red may still be read from the previous reduction
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < (int)(blockDim.x >> 5) ? red[lane] : T(0);
    for (int o = 16; o > 0; o >>= 1)
      v = op(v, __shfl_down_sync(0xffffffffu, v, o));
    if (lane == 0) red[0] = v;
  }
  __syncthreads();
  return red[0];
}

template <class T>
__global__ void sym_eig_kernel(const T* __restrict__ a, int R,
                               int max_sweeps, T* __restrict__ w_out,
                               T* __restrict__ v_out, int* sweeps_out,
                               volatile int* status) {
  extern __shared__ __align__(16) unsigned char smem[];
  // this CTA's matrix of the batch
  const size_t slot = blockIdx.x;
  a += slot * R * R;
  v_out += slot * R * R;
  w_out += slot * R;
  if (sweeps_out) sweeps_out += slot;
  const int n = R + (R & 1);
  const int h = n >> 1;
  const int ld = n + 1;
  T* A = reinterpret_cast<T*>(smem);
  T* V = A + (size_t)n * ld;
  T* C = V + (size_t)n * ld;
  T* S = C + h;
  T* red = S + h;
  int* P = reinterpret_cast<int*>(red + 32);
  int* Q = P + h;
  int* rnk = Q + h;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  auto add = [](T x, T y) { return x + y; };
  auto mx = [](T x, T y) { return f_max(x, y); };

  bool bad = false;
  T amax = T(0);
  for (int t = tid; t < n * n; t += nt) {
    const int i = t / n;
    const int j = t - i * n;
    const T x = (i < R && j < R) ? a[(size_t)i * R + j] : T(0);
    bad |= !isfinite(x);
    amax = f_max(amax, f_abs(x));
    A[i * ld + j] = x;
    V[i * ld + j] = i == j ? T(1) : T(0);
  }
  if (__syncthreads_or(bad)) {
    const T nan = T(NAN);
    for (int t = tid; t < R * R; t += nt) v_out[t] = nan;
    for (int t = tid; t < R; t += nt) w_out[t] = nan;
    if (tid == 0 && sweeps_out) *sweeps_out = 0;
    return;
  }
  amax = block_reduce(amax, red, mx);
  int e = 0;
  if (amax > T(0)) f_frexp(amax, &e);
  const T scale = f_ldexp(T(1), -e);
  T fro2 = T(0);
  for (int t = tid; t < n * n; t += nt) {
    const int i = t / n;
    const int j = t - i * n;
    const T x = A[i * ld + j] * scale;
    A[i * ld + j] = x;
    fro2 += x * x;
  }
  fro2 = block_reduce(fro2, red, add);
  const T tol_off = Eps<T>::v * f_sqrt(fro2);
  const T thresh = tol_off / T(n);
  const int m = n - 1;

  int sweep = 0;
  for (;; ++sweep) {
    T off = T(0);
    for (int t = tid; t < n * n; t += nt) {
      const int i = t / n;
      const int j = t - i * n;
      if (i != j) {
        const T x = A[i * ld + j];
        off += x * x;
      }
    }
    off = block_reduce(off, red, add);
    if (off <= tol_off * tol_off) break;
    if (sweep == max_sweeps) {
      if (tid == 0 && status) {
        *status = 1;
        __threadfence_system();
      }
      ++sweep;  // max_sweeps + 1: the cap was hit
      break;
    }
    for (int k = 0; k < m; ++k) {
      bool rot = false;
      if (tid < h) {
        const int x = tid == 0 ? 0 : 1 + (k + tid) % m;
        const int y = tid == 0 ? 1 + k : 1 + (k - tid + m) % m;
        const int p = min(x, y);
        const int q = max(x, y);
        P[tid] = p;
        Q[tid] = q;
        const T apq = A[p * ld + q];
        T c = T(1);
        T s = T(0);
        if (f_abs(apq) > thresh) {
          const T app = A[p * ld + p];
          const T aqq = A[q * ld + q];
          const T theta = (aqq - app) / (T(2) * apq);
          const T t = f_copysign(T(1), theta) /
                      (f_abs(theta) + f_sqrt(theta * theta + T(1)));
          c = T(1) / f_sqrt(t * t + T(1));
          s = t * c;
          A[p * ld + p] = app - t * apq;
          A[q * ld + q] = aqq + t * apq;
          A[p * ld + q] = T(0);
          A[q * ld + p] = T(0);
          rot = s != T(0);
        }
        C[tid] = c;
        S[tid] = s;
      }
      if (!__syncthreads_or(rot)) continue;
      // every block between pair i (rows) and pair j (columns), i < j,
      // and its transpose: Z = Ji^T X Jj
      for (int t = tid; t < h * h; t += nt) {
        const int i = t / h;
        const int j = t - i * h;
        if (i >= j) continue;
        const T si = S[i];
        const T sj = S[j];
        if (si == T(0) && sj == T(0)) continue;
        const T ci = C[i];
        const T cj = C[j];
        const int pi = P[i], qi = Q[i], pj = P[j], qj = Q[j];
        const T xpp = A[pi * ld + pj], xpq = A[pi * ld + qj];
        const T xqp = A[qi * ld + pj], xqq = A[qi * ld + qj];
        const T ypp = cj * xpp - sj * xpq, ypq = sj * xpp + cj * xpq;
        const T yqp = cj * xqp - sj * xqq, yqq = sj * xqp + cj * xqq;
        const T zpp = ci * ypp - si * yqp, zqp = si * ypp + ci * yqp;
        const T zpq = ci * ypq - si * yqq, zqq = si * ypq + ci * yqq;
        A[pi * ld + pj] = zpp;
        A[pj * ld + pi] = zpp;
        A[pi * ld + qj] = zpq;
        A[qj * ld + pi] = zpq;
        A[qi * ld + pj] = zqp;
        A[pj * ld + qi] = zqp;
        A[qi * ld + qj] = zqq;
        A[qj * ld + qi] = zqq;
      }
      for (int t = tid; t < n * h; t += nt) {
        const int r = t / h;
        const int i = t - r * h;
        const T s = S[i];
        if (s == T(0)) continue;
        const T c = C[i];
        const int p = P[i], q = Q[i];
        const T vp = V[r * ld + p], vq = V[r * ld + q];
        V[r * ld + p] = c * vp - s * vq;
        V[r * ld + q] = s * vp + c * vq;
      }
      __syncthreads();
    }
  }

  // ascending order, ties by index; undo the scale (a power of two)
  for (int i = tid; i < R; i += nt) {
    const T di = A[i * ld + i];
    int r = 0;
    for (int j = 0; j < R; ++j) {
      const T dj = A[j * ld + j];
      r += (dj < di) || (dj == di && j < i);
    }
    rnk[i] = r;
    w_out[r] = f_ldexp(di, e);
  }
  __syncthreads();
  for (int t = tid; t < R * R; t += nt) {
    const int row = t / R;
    const int i = t - row * R;
    v_out[(size_t)row * R + rnk[i]] = V[row * ld + i];
  }
  if (tid == 0 && sweeps_out) *sweeps_out = sweep;
}

template <class T>
int launch(const void* a, int R, int batch, int max_sweeps, int threads,
           void* w, void* v, void* sweeps, void* status,
           cudaStream_t stream) {
  const int n = R + (R & 1);
  const size_t bytes = smem_bytes<T>(n);
  cudaError_t err = cudaFuncSetAttribute(
      sym_eig_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (err != cudaSuccess) return (int)err;
  sym_eig_kernel<T><<<batch, threads, bytes, stream>>>(
      static_cast<const T*>(a), R, max_sweeps, static_cast<T*>(w),
      static_cast<T*>(v), static_cast<int*>(sweeps),
      static_cast<volatile int*>(status));
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Returns the cudaError_t of the launch (0 on success), launches `batch`
// CTAs of `threads` threads (a multiple of 32) on `stream`, one per
// matrix, does not synchronise and allocates nothing.  `a` is the
// (batch, R, R) input, f64 if `f64` else f32; `w` (batch, R) and `v`
// (batch, R, R) are outputs of the same dtype; `sweeps` (batch ints on the
// card, or null) receives each matrix's sweeps run (max_sweeps + 1 where
// it hit the cap); `status` (the device address of a mapped host int, or
// null) is set to 1 when a matrix did not converge in `max_sweeps` sweeps.
int splatt_sym_eig(const void* a, int f64, int R, int batch, int max_sweeps,
                   int threads, void* w, void* v, void* sweeps, void* status,
                   void* stream) {
  if (R < 1 || batch < 1 || max_sweeps < 0 || threads < 32 || threads % 32)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (f64)
    return launch<double>(a, R, batch, max_sweeps, threads, w, v, sweeps,
                          status, s);
  return launch<float>(a, R, batch, max_sweeps, threads, w, v, sweeps,
                       status, s);
}

// `bytes` of zeroed host memory mapped into every card's address space:
// its host address in *host and its device address in *device.
int splatt_sym_eig_alloc_host(long long bytes, void** host, void** device) {
  cudaError_t err = cudaHostAlloc(
      host, static_cast<size_t>(bytes),
      cudaHostAllocMapped | cudaHostAllocPortable);
  if (err != cudaSuccess) return (int)err;
  for (long long i = 0; i < bytes; ++i) static_cast<char*>(*host)[i] = 0;
  return (int)cudaHostGetDevicePointer(device, *host, 0);
}

}  // extern "C"

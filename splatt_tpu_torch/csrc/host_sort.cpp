// Host-side lexicographic sort of a coordinate tensor's nonzeros, the
// permutation every blocked-layout build starts from (≙ tt_sort's role in
// the CSF builds, src/sort.c:912-961).
//
// The port's own copy of sort_perm from the JAX package's native runtime
// (native/splatt_native.cpp): a counting bucket on the leading mode, then
// std::sort inside each slice on the remaining modes packed into one
// unsigned 128-bit key (lexicographic compares when the packed span would
// not fit), ties broken on the original position, so the permutation is
// the stable one np.lexsort gives.  The parser, the streamed converter and
// the host MTTKRP of that file are in host_io.cpp.
//
// Plain C interface for ctypes (splatt_tpu_torch/native.py builds it with
// host_io.cpp into one library with g++ -O3 -shared -fPIC at first use):
//   splatt_sort_perm(inds, nnz, nmodes, dims, mode_order, perm) -> 0 on
//   success; 1 on bad arguments, 2 on an index outside [0, dims[m]), 3
//   when its buckets or keys cannot be allocated.
//   inds: int64 [nmodes][nnz] row-major; perm: nnz int64, written.

#include <algorithm>
#include <cstdint>
#include <new>
#include <vector>

namespace {

int sort_perm(const int64_t *inds, int64_t nnz, int nmodes,
              const int64_t *dims, const int *mode_order, int64_t *perm) {
  if (nmodes < 1 || nnz < 0) return 1;
  // every index must lie in [0, dims[m]): the buckets and the packed keys
  // below rely on it, so anything else declines (the caller then sorts
  // with np.lexsort)
  for (int m = 0; m < nmodes; ++m) {
    const int64_t *col = inds + static_cast<int64_t>(m) * nnz;
    const int64_t d = dims[m];
    for (int64_t i = 0; i < nnz; ++i)
      if (col[i] < 0 || col[i] >= d) return 2;
  }
  const int lead = mode_order[0];
  const int64_t lead_dim = dims[lead];
  // bucket offsets by leading-mode index
  std::vector<int64_t> counts(static_cast<size_t>(lead_dim) + 1, 0);
  const int64_t *lead_ind = inds + static_cast<int64_t>(lead) * nnz;
  for (int64_t i = 0; i < nnz; ++i) ++counts[lead_ind[i] + 1];
  for (int64_t s = 0; s < lead_dim; ++s) counts[s + 1] += counts[s];
  std::vector<int64_t> cursor(counts.begin(), counts.end() - 1);
  for (int64_t i = 0; i < nnz; ++i) perm[cursor[lead_ind[i]]++] = i;

  // the secondary key: the remaining modes packed into an unsigned
  // 128-bit integer when their combined span provably fits
  bool packable = true;
  unsigned __int128 span = 1;
  const unsigned __int128 kLimit = static_cast<unsigned __int128>(1) << 126;
  for (int k = 1; k < nmodes; ++k) {
    const unsigned __int128 f =
        static_cast<unsigned __int128>(dims[mode_order[k]]) + 1;
    if (f == 0 || span > kLimit / f) {  // an overflow check that cannot wrap
      packable = false;
      break;
    }
    span *= f;
  }
  if (packable) {
    std::vector<unsigned __int128> keys(nnz);
    for (int64_t i = 0; i < nnz; ++i) {
      unsigned __int128 key = 0;
      for (int k = 1; k < nmodes; ++k) {
        const int m = mode_order[k];
        key = key * (static_cast<unsigned __int128>(dims[m]) + 1) +
              static_cast<unsigned __int128>(
                  inds[static_cast<int64_t>(m) * nnz + i]);
      }
      keys[i] = key;
    }
    for (int64_t s = 0; s < lead_dim; ++s) {
      const int64_t lo = counts[s], hi = counts[s + 1];
      if (hi - lo > 1)
        std::sort(perm + lo, perm + hi, [&](int64_t a, int64_t b) {
          // the original position breaks ties: stable, as np.lexsort
          return keys[a] != keys[b] ? keys[a] < keys[b] : a < b;
        });
    }
    return 0;
  }
  for (int64_t s = 0; s < lead_dim; ++s) {
    const int64_t lo = counts[s], hi = counts[s + 1];
    if (hi - lo > 1)
      std::sort(perm + lo, perm + hi, [&](int64_t a, int64_t b) {
        for (int k = 1; k < nmodes; ++k) {
          const int m = mode_order[k];
          const int64_t ia = inds[static_cast<int64_t>(m) * nnz + a];
          const int64_t ib = inds[static_cast<int64_t>(m) * nnz + b];
          if (ia != ib) return ia < ib;
        }
        return a < b;
      });
  }
  return 0;
}

}  // namespace

extern "C" int splatt_sort_perm(const int64_t *inds, int64_t nnz, int nmodes,
                                const int64_t *dims, const int *mode_order,
                                int64_t *perm) {
  // no exception may cross the C interface
  try {
    return sort_perm(inds, nnz, nmodes, dims, mode_order, perm);
  } catch (const std::bad_alloc &) {
    return 3;
  }
}

// Host-side tensor I/O and the host MTTKRP engine (≙ the text parser of
// src/io.c:62-108 and the register-blocked fiber loops of
// src/mttkrp.c:427-463).
//
// The port's own copy of the parser, the streamed text-to-binary converter
// and the host MTTKRP of the JAX package's native runtime
// (native/splatt_native.cpp), with the same contracts:
//
//   tns_open(path)           -> handle (reads the file, counts rows and
//                               columns), null when the file cannot be read
//                               or its first data row has fewer than two
//                               fields
//   tns_rows(h) / tns_cols(h)
//   tns_fill(h, inds, vals)  -> 0, or nonzero on a malformed row (ragged,
//                               short, non-numeric); inds: int64
//                               [ncols-1][nrows], vals: double [nrows]
//   tns_close(h)
//   tns_stream_to_bin(src, dst) -> 0; 1 cannot open src, 2 bad column
//                               count, 3 malformed or negative row, 4 no
//                               data, 5 cannot open dst, 6 read failure or a
//                               file that changed between the passes, 7 a
//                               failed write
//   mttkrp_f32 / mttkrp_f64 (see below)
//
// The binary layout is the one splatt_tpu_torch/io.py reads and writes:
// magic "SPTT", u32 {version=1, nmodes, idx_width, val_width=8}, u64
// dims[nmodes], u64 nnz, each mode's indices (int32 when every index fits,
// else int64), then the values as doubles.
//
// Plain C interface for ctypes; splatt_tpu_torch/native.py builds this file
// with host_sort.cpp into one library with g++ -O3 -shared -fPIC.

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <new>
#include <vector>

namespace {

struct TnsFile {
  std::vector<char> buf;
  int64_t nrows = 0;
  int ncols = 0;
};

inline const char *skip_ws(const char *p, const char *end) {
  while (p < end && (*p == ' ' || *p == '\t' || *p == '\r')) ++p;
  return p;
}

inline const char *skip_line(const char *p, const char *end) {
  while (p < end && *p != '\n') ++p;
  return p < end ? p + 1 : end;
}

// whitespace-separated fields on one line
inline int count_fields(const char *p, const char *end) {
  int n = 0;
  while (p < end && *p != '\n') {
    p = skip_ws(p, end);
    if (p >= end || *p == '\n') break;
    ++n;
    while (p < end && *p != ' ' && *p != '\t' && *p != '\r' && *p != '\n')
      ++p;
  }
  return n;
}

inline bool is_comment_or_blank(const char *p, const char *end) {
  p = skip_ws(p, end);
  return p >= end || *p == '\n' || *p == '#';
}

TnsFile *open_tns(const char *path) {
  FILE *f = fopen(path, "rb");
  if (!f) return nullptr;
  fseek(f, 0, SEEK_END);
  long size = ftell(f);
  fseek(f, 0, SEEK_SET);
  if (size < 0) {
    fclose(f);
    return nullptr;
  }
  auto *t = new TnsFile();
  // one byte more for a NUL, so strtod on a last line without a newline
  // cannot scan past the buffer
  t->buf.resize(static_cast<size_t>(size) + 1);
  if (size > 0 && fread(t->buf.data(), 1, size, f) != (size_t)size) {
    fclose(f);
    delete t;
    return nullptr;
  }
  t->buf[size] = '\0';
  fclose(f);

  const char *p = t->buf.data();
  const char *end = p + size;
  while (p < end) {
    if (!is_comment_or_blank(p, end)) {
      if (t->ncols == 0) t->ncols = count_fields(p, end);
      ++t->nrows;
    }
    p = skip_line(p, end);
  }
  if (t->ncols < 2) {  // at least one index and a value
    delete t;
    return nullptr;
  }
  return t;
}

int fill_tns(TnsFile *t, int64_t *inds, double *vals) {
  const char *p = t->buf.data();
  const char *end = p + t->buf.size() - 1;  // the NUL is not data
  const int nmodes = t->ncols - 1;
  const int64_t nrows = t->nrows;
  int64_t r = 0;
  while (p < end) {
    if (is_comment_or_blank(p, end)) {
      p = skip_line(p, end);
      continue;
    }
    if (r >= nrows) return 4;
    for (int m = 0; m < nmodes; ++m) {
      p = skip_ws(p, end);
      bool neg = (p < end && *p == '-');
      if (neg) ++p;
      if (p >= end || *p < '0' || *p > '9') return 1;
      int64_t v = 0;
      while (p < end && *p >= '0' && *p <= '9') v = v * 10 + (*p++ - '0');
      // an index ends at whitespace: a short row such as "1 2 0.7" must
      // not lend its value's integer part to an index column
      if (p < end && *p != ' ' && *p != '\t' && *p != '\r' && *p != '\n')
        return 1;
      inds[m * nrows + r] = neg ? -v : v;
    }
    p = skip_ws(p, end);
    char *next = nullptr;
    vals[r] = strtod(p, &next);
    if (next == p) return 2;
    p = skip_ws(next, end);
    if (p < end && *p != '\n') return 3;  // ragged row (extra fields)
    p = skip_line(p, end);
    ++r;
  }
  return r == nrows ? 0 : 4;
}

// -- streamed text -> binary, two passes with bounded memory ----------------
// (≙ the reference's streamed chunk ingest, mpi_simple_distribute,
// src/mpi/mpi_io.c:587-648: here the "ranks" are the per-mode regions of
// the binary file, written through buffered seeks)

constexpr size_t kChunk = 8u << 20;

struct LineScanner {
  FILE *f;
  std::vector<char> buf;
  size_t len = 0, pos = 0;
  bool eof = false;
  bool error = false;  // a line longer than the buffer, or a read failure

  explicit LineScanner(FILE *file) : f(file), buf(kChunk + 1) {}

  // the next line, NUL-terminated without its '\n'; null at the end of
  // the file or on an error (see `error`); valid until the next call
  char *next_line() {
    for (;;) {
      char *nl = static_cast<char *>(
          memchr(buf.data() + pos, '\n', len - pos));
      if (nl) {
        *nl = '\0';
        char *line = buf.data() + pos;
        pos = static_cast<size_t>(nl - buf.data()) + 1;
        return line;
      }
      if (eof) {
        if (pos < len) {  // a last line without '\n'
          buf[len] = '\0';
          char *line = buf.data() + pos;
          pos = len;
          return line;
        }
        return nullptr;
      }
      size_t tail = len - pos;
      if (tail >= kChunk) {
        // one line fills the buffer: refuse rather than truncate
        error = true;
        return nullptr;
      }
      memmove(buf.data(), buf.data() + pos, tail);
      pos = 0;
      len = tail;
      size_t got = fread(buf.data() + len, 1, kChunk - len, f);
      len += got;
      if (got == 0) {
        if (ferror(f)) error = true;
        eof = true;
      }
    }
  }
};

inline bool parse_row(char *line, int ncols, int64_t *idx, double *val) {
  char *p = line;
  for (int c = 0; c < ncols - 1; ++c) {
    while (*p == ' ' || *p == '\t' || *p == '\r') ++p;
    bool neg = (*p == '-');
    if (neg) ++p;
    if (*p < '0' || *p > '9') return false;
    int64_t v = 0;
    while (*p >= '0' && *p <= '9') v = v * 10 + (*p++ - '0');
    if (*p != ' ' && *p != '\t' && *p != '\r' && *p != '\n' && *p != '\0')
      return false;  // the short-row guard of fill_tns
    idx[c] = neg ? -v : v;
  }
  char *next = nullptr;
  *val = strtod(p, &next);
  if (next == p) return false;
  while (*next == ' ' || *next == '\t' || *next == '\r') ++next;
  return *next == '\0';
}

inline bool line_blank_or_comment(const char *p) {
  while (*p == ' ' || *p == '\t' || *p == '\r') ++p;
  return *p == '\0' || *p == '#';
}

struct RegionWriter {
  FILE *f;
  long base;
  int width;  // 4 or 8
  std::vector<char> buf;
  size_t used = 0;
  int64_t written = 0;
  bool ok = true;  // sticky: a short write (disk full, I/O error) trips it

  RegionWriter(FILE *file, long base_off, int w)
      : f(file), base(base_off), width(w), buf(1u << 20) {}

  void push(int64_t v) {
    if (used + 8 > buf.size()) flush();
    if (width == 4) {
      int32_t x = static_cast<int32_t>(v);
      memcpy(buf.data() + used, &x, 4);
      used += 4;
    } else {
      memcpy(buf.data() + used, &v, 8);
      used += 8;
    }
  }

  void push_d(double v) {
    if (used + 8 > buf.size()) flush();
    memcpy(buf.data() + used, &v, 8);
    used += 8;
  }

  void flush() {
    if (used) {
      if (fseek(f, base + written, SEEK_SET) != 0 ||
          fwrite(buf.data(), 1, used, f) != used)
        ok = false;
      written += static_cast<int64_t>(used);
      used = 0;
    }
  }
};

int stream_to_bin(const char *src, const char *dst) {
  // pass 1: rows, columns, and each column's least and largest index
  FILE *f = fopen(src, "rb");
  if (!f) return 1;
  int ncols = 0;
  int64_t nrows = 0;
  int64_t idx[64];
  double val;
  int64_t mins[64], maxs[64];
  {
    LineScanner sc(f);
    char *line;
    while ((line = sc.next_line()) != nullptr) {
      if (line_blank_or_comment(line)) continue;
      if (ncols == 0) {
        ncols = count_fields(line, line + strlen(line));
        if (ncols < 2 || ncols > 65) {
          fclose(f);
          return 2;
        }
        for (int c = 0; c < ncols - 1; ++c) {
          mins[c] = INT64_MAX;
          maxs[c] = INT64_MIN;
        }
      }
      if (!parse_row(line, ncols, idx, &val)) {
        fclose(f);
        return 3;
      }
      for (int c = 0; c < ncols - 1; ++c) {
        if (idx[c] < 0) {  // a negative coordinate
          fclose(f);
          return 3;
        }
        if (idx[c] < mins[c]) mins[c] = idx[c];
        if (idx[c] > maxs[c]) maxs[c] = idx[c];
      }
      ++nrows;
    }
    if (sc.error) {
      fclose(f);
      return 3;
    }
  }
  fclose(f);
  if (ncols == 0 || nrows == 0) return 4;
  const int nmodes = ncols - 1;
  // a 0 anywhere makes the file 0-indexed (io.load_coord's rule)
  int64_t global_min = INT64_MAX;
  for (int c = 0; c < nmodes; ++c)
    if (mins[c] < global_min) global_min = mins[c];
  const int64_t shift = global_min > 0 ? 1 : 0;
  int64_t max_idx = 0;
  for (int c = 0; c < nmodes; ++c)
    if (maxs[c] - shift > max_idx) max_idx = maxs[c] - shift;
  const int idx_width = max_idx < (int64_t(1) << 31) ? 4 : 8;

  FILE *out = fopen(dst, "wb");
  if (!out) return 5;
  bool ok = fwrite("SPTT", 1, 4, out) == 4;
  uint32_t hdr[4] = {1u, static_cast<uint32_t>(nmodes),
                     static_cast<uint32_t>(idx_width), 8u};
  ok = ok && fwrite(hdr, 4, 4, out) == 4;
  for (int c = 0; c < nmodes; ++c) {
    uint64_t d = static_cast<uint64_t>(maxs[c] - shift + 1);
    ok = ok && fwrite(&d, 8, 1, out) == 1;
  }
  uint64_t nnz_u = static_cast<uint64_t>(nrows);
  ok = ok && fwrite(&nnz_u, 8, 1, out) == 1;
  long data_base = ftell(out);
  if (!ok || data_base < 0) {
    fclose(out);
    return 7;
  }

  std::vector<RegionWriter> writers;
  writers.reserve(nmodes + 1);
  for (int c = 0; c < nmodes; ++c)
    writers.emplace_back(out, data_base + (long)c * idx_width * nrows,
                         idx_width);
  writers.emplace_back(out, data_base + (long)nmodes * idx_width * nrows, 8);

  // pass 2: parse again and scatter into the regions
  f = fopen(src, "rb");
  if (!f) {
    fclose(out);
    return 1;
  }
  {
    LineScanner sc(f);
    char *line;
    int64_t r = 0;
    while ((line = sc.next_line()) != nullptr) {
      if (line_blank_or_comment(line)) continue;
      if (!parse_row(line, ncols, idx, &val)) {
        fclose(f);
        fclose(out);
        return 3;
      }
      if (r >= nrows) {  // the file grew between the passes
        fclose(f);
        fclose(out);
        return 6;
      }
      for (int c = 0; c < nmodes; ++c) writers[c].push(idx[c] - shift);
      writers[nmodes].push_d(val);
      ++r;
    }
    if (sc.error || r != nrows) {
      fclose(f);
      fclose(out);
      return 6;
    }
  }
  fclose(f);
  for (auto &w : writers) {
    w.flush();
    ok = ok && w.ok;
  }
  if (fclose(out) != 0) ok = false;
  return ok ? 0 : 7;
}

// -- the host MTTKRP ---------------------------------------------------------
// A flat pass over a blocked layout's nonzeros with a rank-length
// accumulator flushed when the output row changes (sorted by the output
// mode), or a direct scatter (any other mode); one core, f32 or f64.
//
//   inds:    (nmodes, nnz_pad) int32 row-major (the layout's indices)
//   vals:    (nnz_pad,) T
//   factors: nmodes pointers, factors[k] = (dims[k], rank) T row-major
//            (factors[mode] is never read)
//   out:     (dims[mode], rank) T, zeroed by the caller
//   nnz:     the real nonzeros, a prefix of the layout: the padded tail's
//            sentinel rows lie outside the factors and are never read
//   sorted:  the nonzeros are sorted by `mode`

template <typename T>
void mttkrp_impl(const int32_t *inds, const T *vals, int64_t nnz,
                 int64_t nnz_pad, int nmodes, int mode,
                 const T *const *factors, const int64_t *dims, int rank,
                 T *out, int sorted) {
  const int32_t *orow = inds + static_cast<int64_t>(mode) * nnz_pad;
  const int64_t odim = dims[mode];
  std::vector<T> accbuf(rank, T(0));
  std::vector<T> prodbuf(rank);
  T *acc = accbuf.data();
  T *prod = prodbuf.data();
  int64_t cur = -1;

  const int32_t *oinds[8];
  const T *ofac[8];
  int nother = 0;
  for (int k = 0; k < nmodes; ++k) {
    if (k == mode) continue;
    oinds[nother] = inds + static_cast<int64_t>(k) * nnz_pad;
    ofac[nother] = factors[k];
    ++nother;
  }

  for (int64_t n = 0; n < nnz; ++n) {
    const int64_t row = orow[n];
    const T v = vals[n];
    if (nother == 2) {
      const T *a = ofac[0] + static_cast<int64_t>(oinds[0][n]) * rank;
      const T *b = ofac[1] + static_cast<int64_t>(oinds[1][n]) * rank;
      if (sorted) {
        if (row != cur) {
          if (cur >= 0 && cur < odim) {
            T *o = out + cur * rank;
            for (int r = 0; r < rank; ++r) o[r] += acc[r];
          }
          for (int r = 0; r < rank; ++r) acc[r] = T(0);
          cur = row;
        }
        for (int r = 0; r < rank; ++r) acc[r] += v * a[r] * b[r];
      } else if (row >= 0 && row < odim) {
        T *o = out + row * rank;
        for (int r = 0; r < rank; ++r) o[r] += v * a[r] * b[r];
      }
    } else {
      for (int r = 0; r < rank; ++r) prod[r] = v;
      for (int j = 0; j < nother; ++j) {
        const T *u = ofac[j] + static_cast<int64_t>(oinds[j][n]) * rank;
        for (int r = 0; r < rank; ++r) prod[r] *= u[r];
      }
      if (sorted) {
        if (row != cur) {
          if (cur >= 0 && cur < odim) {
            T *o = out + cur * rank;
            for (int r = 0; r < rank; ++r) o[r] += acc[r];
          }
          for (int r = 0; r < rank; ++r) acc[r] = T(0);
          cur = row;
        }
        for (int r = 0; r < rank; ++r) acc[r] += prod[r];
      } else if (row >= 0 && row < odim) {
        T *o = out + row * rank;
        for (int r = 0; r < rank; ++r) o[r] += prod[r];
      }
    }
  }
  if (sorted && cur >= 0 && cur < odim) {
    T *o = out + cur * rank;
    for (int r = 0; r < rank; ++r) o[r] += acc[r];
  }
}

}  // namespace

extern "C" {

void *tns_open(const char *path) {
  // no exception may cross the C interface
  try {
    return open_tns(path);
  } catch (const std::bad_alloc &) {
    return nullptr;
  }
}

int64_t tns_rows(void *h) { return static_cast<TnsFile *>(h)->nrows; }
int tns_cols(void *h) { return static_cast<TnsFile *>(h)->ncols; }

int tns_fill(void *h, int64_t *inds, double *vals) {
  return fill_tns(static_cast<TnsFile *>(h), inds, vals);
}

void tns_close(void *h) { delete static_cast<TnsFile *>(h); }

int tns_stream_to_bin(const char *src, const char *dst) {
  try {
    return stream_to_bin(src, dst);
  } catch (const std::bad_alloc &) {
    return 7;
  }
}

void mttkrp_f32(const int32_t *inds, const float *vals, int64_t nnz,
                int64_t nnz_pad, int nmodes, int mode,
                const float *const *factors, const int64_t *dims, int rank,
                float *out, int sorted) {
  mttkrp_impl<float>(inds, vals, nnz, nnz_pad, nmodes, mode, factors, dims,
                     rank, out, sorted);
}

void mttkrp_f64(const int32_t *inds, const double *vals, int64_t nnz,
                int64_t nnz_pad, int nmodes, int mode,
                const double *const *factors, const int64_t *dims, int rank,
                double *out, int sorted) {
  mttkrp_impl<double>(inds, vals, nnz, nnz_pad, nmodes, mode, factors, dims,
                      rank, out, sorted);
}

}  // extern "C"

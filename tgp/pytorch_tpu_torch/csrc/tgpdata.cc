// tgpdata.cc — host data runtime of tgp.pytorch_tpu_torch: a copy of the
// JAX package's native/tgpdata.cc.
//
// Memory-mapped, multithreaded CSV/TSV parsing for the large corpora
// (airline, YearMSD), permutation generation, and shuffle-gather of rows
// into a contiguous batch buffer.  Built with g++ at first use into
// build/native/ and bound with ctypes by tgp/pytorch_tpu_torch/data/native.py.

#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <cstdio>
#include <cmath>
#include <fcntl.h>
#include <locale.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>
#include <atomic>
#include <thread>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// CSV shape scan: count rows and columns (first data row defines columns).
// Returns 0 on success.
// ---------------------------------------------------------------------------
int tgp_csv_shape(const char* path, char sep, int ws_mode, int64_t* rows,
                  int64_t* cols) {
  int fd = open(path, O_RDONLY);
  if (fd < 0) return -1;
  struct stat st;
  if (fstat(fd, &st) != 0) { close(fd); return -2; }
  size_t n = (size_t)st.st_size;
  const char* buf = (const char*)mmap(nullptr, n, PROT_READ, MAP_PRIVATE, fd, 0);
  close(fd);
  if (buf == MAP_FAILED) return -3;

  int64_t r = 0, c = 1;
  bool first = true;
  size_t i = 0;
  while (i < n) {
    size_t line_start = i;
    int64_t cc;
    if (ws_mode) {
      // count non-separator token runs (handles leading/trailing runs)
      cc = 0;
      bool in_tok = false;
      while (i < n && buf[i] != '\n') {
        bool is_sep = (buf[i] == ' ' || buf[i] == '\t' || buf[i] == '\r');
        if (!is_sep && !in_tok) { ++cc; in_tok = true; }
        if (is_sep) in_tok = false;
        ++i;
      }
    } else {
      cc = 1;
      while (i < n && buf[i] != '\n') {
        if (buf[i] == sep) ++cc;
        ++i;
      }
    }
    if (i > line_start && cc > 0) {  // non-empty line
      if (first) { c = cc; first = false; }
      ++r;
    }
    ++i;  // skip newline
  }
  munmap((void*)buf, n);
  *rows = r;
  *cols = c;
  return 0;
}

// ---------------------------------------------------------------------------
// Parse CSV into a dense row-major double array (rows x cols), multithreaded.
// Whitespace separators: pass sep=' ' and set ws_mode=1 to treat runs of
// spaces/tabs as one separator (the naval .tsv uses three-space separators).
// ---------------------------------------------------------------------------
static void parse_chunk(const char* buf, size_t begin, size_t end, size_t n,
                        char sep, int ws_mode, int64_t cols, double* out,
                        const int64_t* row_offsets, int64_t row_begin,
                        int64_t row_end, int64_t total_rows, locale_t c_loc,
                        std::atomic<int>* err) {
  (void)begin; (void)end;
  for (int64_t r = row_begin; r < row_end; ++r) {
    const char* p = buf + row_offsets[r];
    // hard end of THIS row: strtod skips leading whitespace INCLUDING
    // newlines, so without this bound a short/ragged row would silently
    // pull its missing fields from the next line
    const char* row_lim = (r + 1 < total_rows) ? buf + row_offsets[r + 1]
                                               : buf + n;
    for (int64_t c = 0; c < cols; ++c) {
      while (p < row_lim && (*p == ' ' || *p == '\t')) ++p;
      if (p >= row_lim || *p == '\n' || *p == '\r') {
        err->store(1, std::memory_order_relaxed);  // row ended early
        return;
      }
      char* q;
      // strtod_l with an explicit C locale: plain strtod is
      // LC_NUMERIC-dependent (a comma-decimal locale would silently
      // misparse md5-pinned dot-decimal corpora)
      out[r * cols + c] = strtod_l(p, &q, c_loc);
      if (q == p || q > row_lim) {  // malformed/empty field: error out,
        err->store(1, std::memory_order_relaxed);  // never silently 0.0
        return;
      }
      p = q;
      if (ws_mode) {
        while (p < row_lim && (*p == ' ' || *p == '\t')) ++p;
      } else if (p < row_lim && *p == sep) {
        ++p;
      }
    }
    // a LONGER row (extra fields) must error too, not be silently truncated
    while (p < row_lim && (*p == ' ' || *p == '\t' || *p == '\r'
                           || *p == '\n')) ++p;
    if (p < row_lim) {
      err->store(1, std::memory_order_relaxed);
      return;
    }
  }
}

int tgp_csv_parse(const char* path, char sep, int ws_mode, double* out,
                  int64_t rows, int64_t cols, int n_threads) {
  int fd = open(path, O_RDONLY);
  if (fd < 0) return -1;
  struct stat st;
  if (fstat(fd, &st) != 0) { close(fd); return -2; }
  size_t n = (size_t)st.st_size;
  const char* buf = (const char*)mmap(nullptr, n, PROT_READ, MAP_PRIVATE, fd, 0);
  close(fd);
  if (buf == MAP_FAILED) return -3;

  // index line starts
  std::vector<int64_t> offsets;
  offsets.reserve(rows);
  size_t i = 0;
  while (i < n && (int64_t)offsets.size() < rows) {
    size_t start = i;
    while (i < n && buf[i] != '\n') ++i;
    if (i > start) offsets.push_back((int64_t)start);
    ++i;
  }
  if ((int64_t)offsets.size() != rows) { munmap((void*)buf, n); return -4; }

  if (n_threads <= 0) n_threads = (int)std::thread::hardware_concurrency();
  if (n_threads < 1) n_threads = 1;
  locale_t c_loc = newlocale(LC_NUMERIC_MASK, "C", (locale_t)0);
  if (c_loc == (locale_t)0) { munmap((void*)buf, n); return -5; }
  std::atomic<int> err(0);
  std::vector<std::thread> workers;
  int64_t per = (rows + n_threads - 1) / n_threads;
  for (int t = 0; t < n_threads; ++t) {
    int64_t rb = t * per, re = std::min<int64_t>(rows, rb + per);
    if (rb >= re) break;
    workers.emplace_back(parse_chunk, buf, 0, 0, n, sep, ws_mode, cols, out,
                         offsets.data(), rb, re, rows, c_loc, &err);
  }
  for (auto& w : workers) w.join();
  freelocale(c_loc);
  munmap((void*)buf, n);
  return err.load() ? -6 : 0;  // nonzero -> the python side raises
}

// ---------------------------------------------------------------------------
// PCG64-ish permutation (splitmix-seeded Fisher-Yates).  NOTE: not numpy
// bit-compatible — parity-sensitive paths keep numpy's generator; this is
// for the large-corpus loaders.
// ---------------------------------------------------------------------------
static inline uint64_t splitmix64(uint64_t* s) {
  uint64_t z = (*s += 0x9E3779B97F4A7C15ull);
  z = (z ^ (z >> 30)) * 0xBF58476D1CE4E5B9ull;
  z = (z ^ (z >> 27)) * 0x94D049BB133111EBull;
  return z ^ (z >> 31);
}

void tgp_permutation(int64_t nrows, uint64_t seed, int64_t* out) {
  for (int64_t i = 0; i < nrows; ++i) out[i] = i;
  uint64_t s = seed;
  for (int64_t i = nrows - 1; i > 0; --i) {
    uint64_t j = splitmix64(&s) % (uint64_t)(i + 1);
    int64_t tmp = out[i];
    out[i] = out[j];
    out[j] = tmp;
  }
}

// ---------------------------------------------------------------------------
// Fused shuffle-gather: batch = data[perm[start:start+bs], :] into a
// contiguous staging buffer (one memcpy per row, threads over rows).
// ---------------------------------------------------------------------------
void tgp_gather_rows(const double* data, int64_t cols, const int64_t* perm,
                     int64_t start, int64_t batch, double* out) {
  for (int64_t i = 0; i < batch; ++i) {
    std::memcpy(out + i * cols, data + perm[start + i] * cols,
                sizeof(double) * (size_t)cols);
  }
}

// float32 variant, for batches staged in single precision
void tgp_gather_rows_f32(const double* data, int64_t cols, const int64_t* perm,
                         int64_t start, int64_t batch, float* out) {
  for (int64_t i = 0; i < batch; ++i) {
    const double* src = data + perm[start + i] * cols;
    float* dst = out + i * cols;
    for (int64_t c = 0; c < cols; ++c) dst[c] = (float)src[c];
  }
}

}  // extern "C"

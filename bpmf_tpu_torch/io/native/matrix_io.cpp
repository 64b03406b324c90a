// Native matrix I/O of bpmf_tpu_torch (copy of bpmf_tpu/io/native/
// matrix_io.cpp): the reference's C++ I/O layer (c++/io.cpp) for the binary
// formats and MatrixMarket, and the degree-bucket fill of
// bpmf_tpu_torch/sparse.py.  Formats (layout documented in
// bpmf_tpu_torch/io/matrix_io.py, the arbiter of byte compatibility):
//   .sdm  u64 nrow/ncol/nnz + u32 rows[nnz] (1-based) + u32 cols + f64 vals
//   .sbm  same without vals
//   .ddm  u64 nrow/ncol + f64 column-major data
//   .mtx  MatrixMarket coordinate (real|integer|pattern) or array, general
// All readers go through zlib's gzFile, which transparently reads BOTH
// gzip-compressed and plain files — replacing the vendored gzstream
// (c++/gzstream.{h,cpp}).
//
// Exposed as a C ABI consumed via ctypes (bpmf_tpu_torch/io/native).
// Errors: functions return 0 on success, negative on failure;
// bpmf_last_error() returns a thread-local message.

#include <zlib.h>

#include <algorithm>
#include <cerrno>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>

namespace {

thread_local std::string g_error;

int fail(const std::string& msg) {
  g_error = msg;
  return -1;
}

struct GzFile {
  gzFile f = nullptr;
  explicit GzFile(const char* path, const char* mode) { f = gzopen(path, mode); }
  ~GzFile() {
    if (f) gzclose(f);
  }
  bool ok() const { return f != nullptr; }
};

bool read_exact(gzFile f, void* dst, size_t n) {
  size_t done = 0;
  char* p = static_cast<char*>(dst);
  while (done < n) {
    unsigned chunk = static_cast<unsigned>(
        std::min<size_t>(n - done, 1u << 30));
    int r = gzread(f, p + done, chunk);
    if (r <= 0) return false;
    done += static_cast<size_t>(r);
  }
  return true;
}

bool write_all(gzFile f, const void* src, size_t n) {
  size_t done = 0;
  const char* p = static_cast<const char*>(src);
  while (done < n) {
    unsigned chunk = static_cast<unsigned>(
        std::min<size_t>(n - done, 1u << 30));
    int r = gzwrite(f, p + done, chunk);
    if (r <= 0) return false;
    done += static_cast<size_t>(r);
  }
  return true;
}

// Read the whole (possibly gzipped) file into a string.
bool slurp(const char* path, std::string* out) {
  GzFile gf(path, "rb");
  if (!gf.ok()) return false;
  char buf[1 << 20];
  int r;
  while ((r = gzread(gf.f, buf, sizeof buf)) > 0) out->append(buf, r);
  return r == 0;
}

}  // namespace

extern "C" {

const char* bpmf_last_error() { return g_error.c_str(); }

void bpmf_free(void* p) { std::free(p); }

// ---------------------------------------------------------------------------
// Binary sparse (.sdm / .sbm)
// ---------------------------------------------------------------------------

int bpmf_read_sparse_bin(const char* path, int pattern, uint64_t* nrow,
                         uint64_t* ncol, uint64_t* nnz, uint32_t** rows,
                         uint32_t** cols, double** vals) {
  GzFile gf(path, "rb");
  if (!gf.ok()) return fail(std::string("cannot open ") + path);
  uint64_t hdr[3];
  if (!read_exact(gf.f, hdr, sizeof hdr)) return fail("truncated header");
  *nrow = hdr[0];
  *ncol = hdr[1];
  *nnz = hdr[2];
  size_t n = hdr[2];
  *rows = static_cast<uint32_t*>(std::malloc(n * 4));
  *cols = static_cast<uint32_t*>(std::malloc(n * 4));
  *vals = pattern ? nullptr : static_cast<double*>(std::malloc(n * 8));
  if (!*rows || !*cols || (!pattern && !*vals)) return fail("oom");
  if (!read_exact(gf.f, *rows, n * 4) || !read_exact(gf.f, *cols, n * 4))
    return fail("truncated indices");
  if (!pattern && !read_exact(gf.f, *vals, n * 8))
    return fail("truncated values");
  for (size_t i = 0; i < n; ++i) {  // 1-based on disk -> 0-based
    (*rows)[i] -= 1;
    (*cols)[i] -= 1;
  }
  return 0;
}

int bpmf_write_sparse_bin(const char* path, int pattern, int gz,
                          uint64_t nrow, uint64_t ncol, uint64_t nnz,
                          const uint32_t* rows0, const uint32_t* cols0,
                          const double* vals) {
  GzFile gf(path, gz ? "wb" : "wbT");  // T = no compression (plain)
  if (!gf.ok()) return fail(std::string("cannot open ") + path);
  uint64_t hdr[3] = {nrow, ncol, nnz};
  std::vector<uint32_t> tmp(nnz);
  if (!write_all(gf.f, hdr, sizeof hdr)) return fail("write header");
  for (uint64_t i = 0; i < nnz; ++i) tmp[i] = rows0[i] + 1;
  if (!write_all(gf.f, tmp.data(), nnz * 4)) return fail("write rows");
  for (uint64_t i = 0; i < nnz; ++i) tmp[i] = cols0[i] + 1;
  if (!write_all(gf.f, tmp.data(), nnz * 4)) return fail("write cols");
  if (!pattern && !write_all(gf.f, vals, nnz * 8)) return fail("write vals");
  return 0;
}

// ---------------------------------------------------------------------------
// Binary dense (.ddm)
// ---------------------------------------------------------------------------

int bpmf_read_dense_bin(const char* path, uint64_t* nrow, uint64_t* ncol,
                        double** data) {
  GzFile gf(path, "rb");
  if (!gf.ok()) return fail(std::string("cannot open ") + path);
  uint64_t hdr[2];
  if (!read_exact(gf.f, hdr, sizeof hdr)) return fail("truncated header");
  *nrow = hdr[0];
  *ncol = hdr[1];
  size_t n = hdr[0] * hdr[1];
  *data = static_cast<double*>(std::malloc(n * 8));
  if (!*data) return fail("oom");
  if (!read_exact(gf.f, *data, n * 8)) return fail("truncated data");
  return 0;
}

int bpmf_write_dense_bin(const char* path, int gz, uint64_t nrow,
                         uint64_t ncol, const double* data) {
  GzFile gf(path, gz ? "wb" : "wbT");
  if (!gf.ok()) return fail(std::string("cannot open ") + path);
  uint64_t hdr[2] = {nrow, ncol};
  if (!write_all(gf.f, hdr, sizeof hdr)) return fail("write header");
  if (!write_all(gf.f, data, nrow * ncol * 8)) return fail("write data");
  return 0;
}

// ---------------------------------------------------------------------------
// MatrixMarket (.mtx) — fast tokenizer
// ---------------------------------------------------------------------------

// kind out: 0 = sparse (rows/cols/vals filled), 1 = dense (data col-major)
int bpmf_read_mtx(const char* path, int* kind, uint64_t* nrow, uint64_t* ncol,
                  uint64_t* nnz, uint32_t** rows, uint32_t** cols,
                  double** vals, double** dense) {
  std::string buf;
  if (!slurp(path, &buf)) return fail(std::string("cannot read ") + path);
  const char* p = buf.c_str();
  const char* end = p + buf.size();

  // header line
  if (std::strncmp(p, "%%MatrixMarket", 14) != 0)
    return fail("not a MatrixMarket file");
  const char* eol = static_cast<const char*>(memchr(p, '\n', end - p));
  if (!eol) return fail("bad header");
  std::string header(p, eol);
  bool coordinate = header.find("coordinate") != std::string::npos;
  bool array = header.find("array") != std::string::npos;
  bool pattern = header.find("pattern") != std::string::npos;
  if (header.find("general") == std::string::npos)
    return fail("unsupported MatrixMarket symmetry");
  if (!coordinate && !array) return fail("unsupported MatrixMarket format");
  p = eol + 1;

  // skip comments / blank lines
  while (p < end && (*p == '%' || *p == '\n' || *p == '\r')) {
    eol = static_cast<const char*>(memchr(p, '\n', end - p));
    if (!eol) return fail("missing size line");
    p = eol + 1;
  }

  char* q;
  uint64_t r64 = std::strtoull(p, &q, 10);
  uint64_t c64 = std::strtoull(q, &q, 10);
  *nrow = r64;
  *ncol = c64;
  p = q;

  if (coordinate) {
    uint64_t n = std::strtoull(p, &q, 10);
    p = q;
    *kind = 0;
    *nnz = n;
    *rows = static_cast<uint32_t*>(std::malloc(n * 4));
    *cols = static_cast<uint32_t*>(std::malloc(n * 4));
    *vals = static_cast<double*>(std::malloc(n * 8));
    if (!*rows || !*cols || !*vals) return fail("oom");
    for (uint64_t i = 0; i < n; ++i) {
      long r = std::strtol(p, &q, 10);
      if (q == p) return fail("truncated entries");
      long c = std::strtol(q, &q, 10);
      double v = 1.0;
      if (!pattern) v = std::strtod(q, &q);
      p = q;
      (*rows)[i] = static_cast<uint32_t>(r - 1);
      (*cols)[i] = static_cast<uint32_t>(c - 1);
      (*vals)[i] = v;
    }
    return 0;
  }

  // array (dense, column-major on disk)
  *kind = 1;
  size_t n = r64 * c64;
  *dense = static_cast<double*>(std::malloc(n * 8));
  if (!*dense) return fail("oom");
  for (size_t i = 0; i < n; ++i) {
    double v = std::strtod(p, &q);
    if (q == p) return fail("truncated array values");
    (*dense)[i] = v;
    p = q;
  }
  return 0;
}

// ---------------------------------------------------------------------------
// Layout builder: degree-bucket fill (the data-layout "graph builder")
// ---------------------------------------------------------------------------

// Fill one degree bucket's padded arrays from CSC ratings in a single pass.
// For each item id (a CSC column), its neighbor list is split into rows of
// at most `width` entries (row-splitting for degrees beyond the bucket
// width, bpmf_tpu/sparse.py).  Arrays must be zero-initialized by the
// caller with capacity `cap_rows` rows; row_slot prefilled with the padding
// slot.  Returns the number of rows written, or -1 on overflow.
int64_t bpmf_fill_bucket(const int64_t* indptr, const int32_t* indices,
                         const double* data, const int32_t* ids,
                         int64_t n_ids, int64_t width, int32_t* nbr,
                         double* val, float* mask, int32_t* row_slot,
                         int64_t cap_rows) {
  int64_t r = 0;
  for (int64_t s = 0; s < n_ids; ++s) {
    const int64_t a = indptr[ids[s]];
    const int64_t b = indptr[ids[s] + 1];
    int64_t off = a;
    do {
      if (r >= cap_rows) return -1;
      const int64_t n = std::min(b - off, width);
      int32_t* nrow = nbr + r * width;
      double* vrow = val + r * width;
      float* mrow = mask + r * width;
      for (int64_t w = 0; w < n; ++w) {
        nrow[w] = indices[off + w];
        vrow[w] = data ? data[off + w] : 1.0;
        mrow[w] = 1.0f;
      }
      row_slot[r] = static_cast<int32_t>(s);
      ++r;
      off += width;
    } while (off < b);
  }
  return r;
}

}  // extern "C"

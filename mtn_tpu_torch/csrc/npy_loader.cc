// Native batch loader for .npy video-feature files (mtn_tpu_torch's own
// copy of the JAX package's loader, native/npy_loader.cc: same C API,
// same results).
//
// It parses .npy headers directly, reads row-strided (frame-skip)
// float32/float64 2-D (T, D) and 3-D (T, R, D) arrays with pread
// (regions flatten into the frame axis), pads into a caller-provided
// contiguous (B, max_frames, dim) float32 buffer, and fans the per-file
// work out over a thread pool so disk latency overlaps.
//
// Exposed C API (bound from Python via ctypes, see
// mtn_tpu_torch/data/native_loader.py; built by mtn_tpu_torch/ops/_build.py
// with g++):
//   mtn_load_npy_batch(paths, n_files, skip, max_frames, dim,
//                      out, out_lens, n_threads) -> 0 on success,
//   negative error code otherwise (first failing file wins);
//   mtn_npy_shape3(path, dims, ndims) -> the header's shape.

#include <atomic>
#include <cerrno>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <thread>
#include <vector>

#include <fcntl.h>
#include <unistd.h>

namespace {

constexpr int kErrOpen = -1;
constexpr int kErrMagic = -2;
constexpr int kErrHeader = -3;
constexpr int kErrDtype = -4;
constexpr int kErrShape = -5;
constexpr int kErrRead = -6;

struct NpyInfo {
  int64_t rows = 0;      // frames (T)
  int64_t regions = 1;   // regions per frame (R) for 3-D arrays, else 1
  int64_t cols = 0;      // feature dim (D)
  int ndims = 0;         // 2 or 3
  int64_t data_offset = 0;
  int item_size = 0;     // 4 (<f4) or 8 (<f8)
  bool fortran = false;
};

// Parse the .npy v1/v2 header of an open fd.
int ParseHeader(int fd, NpyInfo* info) {
  unsigned char pre[12];
  if (pread(fd, pre, 10, 0) != 10) return kErrMagic;
  if (memcmp(pre, "\x93NUMPY", 6) != 0) return kErrMagic;
  int major = pre[6];
  uint32_t header_len;
  int64_t header_start;
  if (major == 1) {
    header_len = pre[8] | (pre[9] << 8);
    header_start = 10;
  } else {
    unsigned char len4[4];
    if (pread(fd, len4, 4, 8) != 4) return kErrHeader;
    header_len = len4[0] | (len4[1] << 8) | (len4[2] << 16) |
                 (uint32_t(len4[3]) << 24);
    header_start = 12;
  }
  std::string header(header_len, '\0');
  if (pread(fd, header.data(), header_len, header_start) !=
      (ssize_t)header_len)
    return kErrHeader;
  info->data_offset = header_start + header_len;

  auto find_val = [&](const char* key) -> std::string {
    size_t p = header.find(key);
    if (p == std::string::npos) return "";
    p = header.find(':', p);
    if (p == std::string::npos) return "";
    return header.substr(p + 1);
  };

  std::string descr = find_val("'descr'");
  if (descr.find("<f4") != std::string::npos ||
      descr.find("|f4") != std::string::npos)
    info->item_size = 4;
  else if (descr.find("<f8") != std::string::npos)
    info->item_size = 8;
  else
    return kErrDtype;

  std::string fortran = find_val("'fortran_order'");
  info->fortran = fortran.find("True") != std::string::npos;
  if (info->fortran) return kErrShape;  // row-major only

  std::string shape = find_val("'shape'");
  size_t lp = shape.find('(');
  size_t rp = shape.find(')');
  if (lp == std::string::npos || rp == std::string::npos) return kErrShape;
  std::string dims = shape.substr(lp + 1, rp - lp - 1);
  int64_t vals[4] = {0, 0, 0, 0};
  int ndims = 0;
  const char* s = dims.c_str();
  char* end = nullptr;
  while (ndims < 4) {
    while (*s == ' ' || *s == ',') ++s;
    if (*s == '\0') break;
    vals[ndims++] = strtoll(s, &end, 10);
    if (end == s) break;
    s = end;
  }
  info->ndims = ndims;
  if (ndims == 2) {  // (frames, dim)
    info->rows = vals[0];
    info->regions = 1;
    info->cols = vals[1];
  } else if (ndims == 3) {  // (frames, regions, dim)
    info->rows = vals[0];
    info->regions = vals[1];
    info->cols = vals[2];
  } else {
    return kErrShape;
  }
  return 0;
}

// Load one file into out[max_frames, dim] (zero-padded) with frame skip.
// 3-D (T, R, D) arrays follow the mtn_tpu_torch.data.features law: skip
// applies to the time axis, then regions flatten into the frame axis —
// same rows, bit-for-bit, as the numpy fallback's
// `a[::skip].reshape(-1, D)[:n]` (including a partial frame when
// max_frames cuts mid-frame).
int LoadOne(const char* path, int skip, int64_t max_frames, int64_t dim,
            float* out, int32_t* out_len) {
  int fd = open(path, O_RDONLY);
  if (fd < 0) return kErrOpen;
  NpyInfo info;
  int rc = ParseHeader(fd, &info);
  if (rc != 0) {
    close(fd);
    return rc;
  }
  if (skip < 1) skip = 1;
  int64_t kept_frames = (info.rows + skip - 1) / skip;
  int64_t total_rows = kept_frames * info.regions;
  if (total_rows > max_frames) total_rows = max_frames;
  int64_t cols = info.cols < dim ? info.cols : dim;
  memset(out, 0, sizeof(float) * max_frames * dim);

  std::vector<unsigned char> framebuf(
      (size_t)info.item_size * info.regions * info.cols);
  int64_t written = 0;
  for (int64_t f = 0; written < total_rows; ++f) {
    int64_t src_frame = f * skip;
    int64_t rows_now = info.regions;
    if (written + rows_now > total_rows) rows_now = total_rows - written;
    int64_t off = info.data_offset +
                  src_frame * info.regions * info.cols *
                      (int64_t)info.item_size;
    ssize_t want = (ssize_t)(info.item_size * rows_now * info.cols);
    if (pread(fd, framebuf.data(), want, off) != want) {
      close(fd);
      return kErrRead;
    }
    for (int64_t r = 0; r < rows_now; ++r) {
      float* dst = out + (written + r) * dim;
      const unsigned char* src =
          framebuf.data() + (size_t)r * info.cols * info.item_size;
      if (info.item_size == 4) {
        memcpy(dst, src, sizeof(float) * cols);
      } else {
        const double* sd = reinterpret_cast<const double*>(src);
        for (int64_t c = 0; c < cols; ++c) dst[c] = (float)sd[c];
      }
    }
    written += rows_now;
  }
  *out_len = (int32_t)written;
  close(fd);
  return 0;
}

}  // namespace

extern "C" {

int mtn_load_npy_batch(const char** paths, int n_files, int skip,
                       int64_t max_frames, int64_t dim, float* out,
                       int32_t* out_lens, int n_threads) {
  if (n_threads < 1) n_threads = 1;
  if (n_threads > n_files) n_threads = n_files;
  std::atomic<int> next(0);
  std::atomic<int> err(0);
  auto worker = [&]() {
    while (true) {
      int i = next.fetch_add(1);
      if (i >= n_files || err.load() != 0) return;
      int rc = LoadOne(paths[i], skip, max_frames, dim,
                       out + (int64_t)i * max_frames * dim, &out_lens[i]);
      if (rc != 0) {
        int expected = 0;
        err.compare_exchange_strong(expected, rc);
      }
    }
  };
  if (n_threads == 1) {
    worker();
  } else {
    std::vector<std::thread> threads;
    threads.reserve(n_threads);
    for (int t = 0; t < n_threads; ++t) threads.emplace_back(worker);
    for (auto& th : threads) th.join();
  }
  return err.load();
}

// General header probe: fills dims[0..ndims) and *ndims (2 or 3).
int mtn_npy_shape3(const char* path, int64_t* dims, int32_t* ndims) {
  int fd = open(path, O_RDONLY);
  if (fd < 0) return kErrOpen;
  NpyInfo info;
  int rc = ParseHeader(fd, &info);
  close(fd);
  if (rc != 0) return rc;
  *ndims = info.ndims;
  if (info.ndims == 2) {
    dims[0] = info.rows;
    dims[1] = info.cols;
  } else {
    dims[0] = info.rows;
    dims[1] = info.regions;
    dims[2] = info.cols;
  }
  return 0;
}

}  // extern "C"

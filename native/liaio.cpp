// liaio — native feature-file I/O for lia_ral.
//
// The reference's runtime layer is C++ (ALIZE FeatureServer and the file
// readers behind it, SURVEY.md §1.1); this library provides the
// equivalent native hot path for the new framework: SPRO3/SPRO4/RAW
// parsing with byte swapping, column masking, and multi-file
// concatenated loading, exposed through a minimal C ABI consumed via
// ctypes (lia_ral/io/native.py).  Python remains the fallback.
//
// Build: make -C native   (g++ -O3 -shared -fPIC)

#include <atomic>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <thread>
#include <vector>

namespace {

constexpr int FMT_SPRO3 = 0;
constexpr int FMT_SPRO4 = 1;
constexpr int FMT_RAW_F32 = 2;
constexpr int FMT_RAW_F64 = 3;

// SPro qualifier bits (features.py spro_total_dim)
constexpr uint32_t WITHE = 0x01;
constexpr uint32_t WITHN = 0x04;
constexpr uint32_t WITHD = 0x08;
constexpr uint32_t WITHA = 0x10;

inline uint32_t bswap32(uint32_t v) { return __builtin_bswap32(v); }
inline uint16_t bswap16(uint16_t v) { return __builtin_bswap16(v); }

inline float swap_float(float f) {
  uint32_t v;
  std::memcpy(&v, &f, 4);
  v = bswap32(v);
  std::memcpy(&f, &v, 4);
  return f;
}

int spro_total_dim(uint32_t dim, uint32_t flag) {
  int stat = dim + ((flag & WITHE) && !(flag & WITHN) ? 1 : 0);
  int block = dim + ((flag & WITHE) ? 1 : 0);
  int total = stat;
  if (flag & WITHD) total += block;
  if (flag & WITHA) total += block;
  return total;
}

std::vector<uint8_t> read_all(const char* path) {
  std::vector<uint8_t> buf;
  FILE* f = std::fopen(path, "rb");
  if (!f) return buf;
  std::fseek(f, 0, SEEK_END);
  long n = std::ftell(f);
  std::fseek(f, 0, SEEK_SET);
  if (n > 0) {
    buf.resize(static_cast<size_t>(n));
    if (std::fread(buf.data(), 1, buf.size(), f) != buf.size()) buf.clear();
  }
  std::fclose(f);
  return buf;
}

// Parse into out (caller-sized) or report dims. Returns 0 on success.
int parse(const std::vector<uint8_t>& raw, int fmt, int big_endian,
          int vect_size, float* out, int64_t* out_frames, int* out_dim) {
  const uint8_t* p = raw.data();
  size_t n = raw.size();
  auto rd_u32 = [&](size_t off) {
    uint32_t v;
    std::memcpy(&v, p + off, 4);
    return big_endian ? bswap32(v) : v;
  };
  if (fmt == FMT_SPRO3) {
    if (n < 16) return 1;
    uint32_t dim = rd_u32(4), flag = rd_u32(12);
    int total = spro_total_dim(dim, flag);
    if (total <= 0) return 1;
    size_t payload = (n - 16) / 4;
    if (payload % total != 0) return 1;
    int64_t frames = static_cast<int64_t>(payload) / total;
    *out_frames = frames;
    *out_dim = total;
    if (out) {
      std::memcpy(out, p + 16, payload * 4);
      if (big_endian)
        for (size_t i = 0; i < payload; i++) out[i] = swap_float(out[i]);
    }
    return 0;
  }
  if (fmt == FMT_SPRO4) {
    size_t off = 0;
    if (n >= 8 && std::memcmp(p, "<header>", 8) == 0) {
      const char* end = static_cast<const char*>(
          memmem(p, n, "</header>", 9));
      if (!end) return 1;
      off = (end - reinterpret_cast<const char*>(p)) + 9;
      if (off < n && p[off] == '\n') off++;
    }
    if (n < off + 10) return 1;
    uint16_t dim;
    std::memcpy(&dim, p + off, 2);
    if (big_endian) dim = bswap16(dim);
    if (dim == 0) return 1;
    size_t payload = (n - off - 10) / 4;
    if (payload % dim != 0) return 1;
    *out_frames = static_cast<int64_t>(payload) / dim;
    *out_dim = dim;
    if (out) {
      std::memcpy(out, p + off + 10, payload * 4);
      if (big_endian)
        for (size_t i = 0; i < payload; i++) out[i] = swap_float(out[i]);
    }
    return 0;
  }
  if (fmt == FMT_RAW_F32 || fmt == FMT_RAW_F64) {
    int esize = fmt == FMT_RAW_F32 ? 4 : 8;
    if (vect_size <= 0) return 1;
    size_t count = n / esize;
    if (count % vect_size != 0) return 1;
    *out_frames = static_cast<int64_t>(count) / vect_size;
    *out_dim = vect_size;
    if (out) {
      if (fmt == FMT_RAW_F32) {
        std::memcpy(out, p, count * 4);
        if (big_endian)
          for (size_t i = 0; i < count; i++) out[i] = swap_float(out[i]);
      } else {
        for (size_t i = 0; i < count; i++) {
          uint64_t v;
          std::memcpy(&v, p + i * 8, 8);
          if (big_endian) v = __builtin_bswap64(v);
          double d;
          std::memcpy(&d, &v, 8);
          out[i] = static_cast<float>(d);
        }
      }
    }
    return 0;
  }
  return 1;
}

}  // namespace

extern "C" {

// Probe a feature file: fills frames/dim. Returns 0 on success.
int liaio_probe(const char* path, int fmt, int big_endian, int vect_size,
                int64_t* frames, int* dim) {
  auto raw = read_all(path);
  if (raw.empty()) return 1;
  return parse(raw, fmt, big_endian, vect_size, nullptr, frames, dim);
}

// Read a feature file into a caller-allocated (frames*dim) float32 buffer.
int liaio_read(const char* path, int fmt, int big_endian, int vect_size,
               float* out, int64_t frames, int dim) {
  auto raw = read_all(path);
  if (raw.empty()) return 1;
  int64_t f2;
  int d2;
  int rc = parse(raw, fmt, big_endian, vect_size, out, &f2, &d2);
  if (rc) return rc;
  return (f2 == frames && d2 == dim) ? 0 : 2;
}

// Parallel batched read: n files into a caller-allocated padded
// (n, t_pad, dim) float32 arena (zero-filled by the caller — short files
// leave zero rows, the framework's zero-weight padding contract).  A
// worker-pool over an atomic file index replaces the reference's
// per-thread static file-list split (AccumulateTVStat.cpp:478-551);
// lengths[i] gets the file's frame count, or -1 (read/parse error) /
// -2 (dim mismatch) / -3 (longer than t_pad).  n_threads <= 0 uses the
// hardware concurrency.
int liaio_read_batch(const char* const* paths, int n, int fmt,
                          int big_endian, int vect_size, float* arena,
                          int64_t t_pad, int dim, int64_t* lengths,
                          int n_threads) {
  if (n_threads <= 0) {
    unsigned hc = std::thread::hardware_concurrency();
    n_threads = hc ? static_cast<int>(hc) : 4;
  }
  if (n_threads > n) n_threads = n;
  std::atomic<int> next(0);
  std::atomic<int> failures(0);
  auto worker = [&]() {
    for (;;) {
      int i = next.fetch_add(1);
      if (i >= n) return;
      auto raw = read_all(paths[i]);
      if (raw.empty()) { lengths[i] = -1; failures++; continue; }
      int64_t frames;
      int d2;
      if (parse(raw, fmt, big_endian, vect_size, nullptr, &frames, &d2)) {
        lengths[i] = -1; failures++; continue;
      }
      if (d2 != dim) { lengths[i] = -2; failures++; continue; }
      if (frames > t_pad) { lengths[i] = -3; failures++; continue; }
      float* slot = arena + static_cast<int64_t>(i) * t_pad * dim;
      if (parse(raw, fmt, big_endian, vect_size, slot, &frames, &d2)) {
        lengths[i] = -1; failures++; continue;
      }
      lengths[i] = frames;
    }
  };
  std::vector<std::thread> pool;
  pool.reserve(n_threads);
  for (int t = 0; t < n_threads; t++) pool.emplace_back(worker);
  for (auto& th : pool) th.join();
  return failures.load();
}

// Column-mask copy: src (frames, src_dim) → dst (frames, n_idx) using the
// given column indices (the featureServerMask hot loop).
void liaio_mask(const float* src, int64_t frames, int src_dim,
                const int* idx, int n_idx, float* dst) {
  for (int64_t t = 0; t < frames; t++) {
    const float* row = src + t * src_dim;
    float* orow = dst + t * n_idx;
    for (int j = 0; j < n_idx; j++) orow[j] = row[idx[j]];
  }
}

}  // extern "C"

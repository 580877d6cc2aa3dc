// posteriflow_torch native runtime: noise-bank crop server.
//
// Role: host-side feeder for real-noise banks too large to live in device
// memory (posteriflow_torch/data/noise_bank.py holds small banks on the
// card). Segments are memory-mapped .npy float16 files (the bank format:
// {det}_{gps}_strain.npy); sampling a training batch = N random (segment,
// offset, flip) crops converted to float32 into a caller-provided staging
// buffer (pinned host memory in data/host_feed.py), multithreaded across
// events. The Python side copies the buffer to the card on its own stream.
//
// The same source and C ABI as the JAX package's runtime/bankd.cpp, so the
// two servers give bit-equal crops from one seed. Bound with ctypes in
// posteriflow_torch/data/native_bank.py, which builds it at first use
// (g++ -O3 -std=c++17 -fPIC -shared -pthread) into the git-ignored
// posteriflow_torch/_build/.

#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <dirent.h>
#include <fcntl.h>
#include <string>
#include <sys/mman.h>
#include <sys/stat.h>
#include <thread>
#include <unistd.h>
#include <vector>

namespace {

// ── minimal .npy reader (v1.x, little-endian float16, 1-D) ──────────────────
struct MappedNpy {
  const uint16_t* data = nullptr;   // raw f16 payload
  size_t n = 0;
  void* map_base = nullptr;
  size_t map_len = 0;
  int fd = -1;

  bool open(const char* path) {
    fd = ::open(path, O_RDONLY);
    if (fd < 0) return false;
    struct stat st;
    if (fstat(fd, &st) != 0 || st.st_size < 10) return false;
    map_len = static_cast<size_t>(st.st_size);
    map_base = mmap(nullptr, map_len, PROT_READ, MAP_PRIVATE, fd, 0);
    if (map_base == MAP_FAILED) { map_base = nullptr; return false; }
    const auto* p = static_cast<const unsigned char*>(map_base);
    if (memcmp(p, "\x93NUMPY", 6) != 0) return false;
    const unsigned major = p[6];
    size_t header_len, header_off;
    if (major == 1) {
      header_len = p[8] | (p[9] << 8);
      header_off = 10;
    } else {
      header_len = p[8] | (p[9] << 8) | (p[10] << 16)
                 | (static_cast<size_t>(p[11]) << 24);
      header_off = 12;
    }
    std::string header(reinterpret_cast<const char*>(p + header_off),
                       header_len);
    if (header.find("'<f2'") == std::string::npos &&
        header.find("'float16'") == std::string::npos)
      return false;                       // bank strain files are f16
    if (header.find("'fortran_order': True") != std::string::npos)
      return false;
    const size_t payload = header_off + header_len;
    n = (map_len - payload) / 2;
    data = reinterpret_cast<const uint16_t*>(p + payload);
    return n > 0;
  }

  void close_map() {
    if (map_base) munmap(map_base, map_len);
    if (fd >= 0) ::close(fd);
    map_base = nullptr; data = nullptr; fd = -1;
  }
};

inline float f16_to_f32(uint16_t h) {
  const uint32_t sign = (h & 0x8000u) << 16;
  uint32_t exp = (h >> 10) & 0x1f;
  uint32_t man = h & 0x3ffu;
  uint32_t bits;
  if (exp == 0) {
    if (man == 0) { bits = sign; }
    else {                                   // subnormal: renormalize
      exp = 127 - 15 + 1;
      while (!(man & 0x400u)) { man <<= 1; --exp; }
      man &= 0x3ffu;
      bits = sign | (exp << 23) | (man << 13);
    }
  } else if (exp == 0x1f) {
    bits = sign | 0x7f800000u | (man << 13);
  } else {
    bits = sign | ((exp - 15 + 127) << 23) | (man << 13);
  }
  float out;
  memcpy(&out, &bits, 4);
  return out;
}

// xorshift128+ per-thread RNG (deterministic from (seed, event index))
struct Rng {
  uint64_t s0, s1;
  explicit Rng(uint64_t seed) {
    s0 = seed * 0x9E3779B97F4A7C15ull + 1;
    s1 = (seed ^ 0xD1B54A32D192ED03ull) * 0x94D049BB133111EBull + 3;
    next(); next();
  }
  uint64_t next() {
    uint64_t x = s0, y = s1;
    s0 = y;
    x ^= x << 23;
    s1 = x ^ y ^ (x >> 17) ^ (y >> 26);
    return s1 + y;
  }
  uint64_t below(uint64_t n) { return next() % n; }
  bool coin() { return next() & 1; }
};

struct Bank {
  // segments[det][k]
  std::vector<std::vector<MappedNpy>> segments;
  int n_det = 0;
};

constexpr const char* kDets[3] = {"H1", "L1", "V1"};

}  // namespace

extern "C" {

// Open a bank directory; returns an opaque handle (nullptr on failure).
void* pf_bank_open(const char* dir) {
  auto* bank = new Bank();
  bank->n_det = 3;
  bank->segments.resize(3);
  for (int d = 0; d < 3; ++d) {
    DIR* dp = opendir(dir);
    if (!dp) { delete bank; return nullptr; }
    std::vector<std::string> files;
    const std::string prefix = std::string(kDets[d]) + "_";
    while (dirent* e = readdir(dp)) {
      std::string name(e->d_name);
      if (name.rfind(prefix, 0) == 0 &&
          name.find("_strain.npy") != std::string::npos)
        files.push_back(std::string(dir) + "/" + name);
    }
    closedir(dp);
    // deterministic order
    for (size_t i = 0; i < files.size(); ++i)
      for (size_t j = i + 1; j < files.size(); ++j)
        if (files[j] < files[i]) std::swap(files[i], files[j]);
    for (const auto& f : files) {
      MappedNpy m;
      if (m.open(f.c_str())) bank->segments[d].push_back(m);
      else m.close_map();
    }
    if (bank->segments[d].empty()) { delete bank; return nullptr; }
  }
  return bank;
}

int pf_bank_n_segments(void* handle, int det) {
  auto* bank = static_cast<Bank*>(handle);
  if (!bank || det < 0 || det >= bank->n_det) return -1;
  return static_cast<int>(bank->segments[det].size());
}

// Sample n_events crops of crop_len samples for all 3 detectors into
// out [n_events, 3, crop_len] float32. seg_idx_out (optional, may be null)
// receives [n_events, 3] int32 segment choices (for re-color filter
// lookup on the Python side). Deterministic in (seed, event index).
// Returns 0 on success.
int pf_bank_sample(void* handle, uint64_t seed, int n_events, int crop_len,
                   float* out, int32_t* seg_idx_out, int n_threads) {
  auto* bank = static_cast<Bank*>(handle);
  if (!bank || n_events <= 0 || crop_len <= 0) return 1;
  for (int d = 0; d < 3; ++d)
    for (const auto& seg : bank->segments[d])
      if (seg.n < static_cast<size_t>(crop_len)) return 2;

  auto work = [&](int lo, int hi) {
    for (int i = lo; i < hi; ++i) {
      Rng rng(seed * 0x100000001b3ull + static_cast<uint64_t>(i));
      for (int d = 0; d < 3; ++d) {
        const auto& segs = bank->segments[d];
        const int k = static_cast<int>(rng.below(segs.size()));
        const MappedNpy& seg = segs[k];
        const size_t off = rng.below(seg.n - crop_len + 1);
        const bool flip = rng.coin();
        float* dst = out + (static_cast<size_t>(i) * 3 + d) * crop_len;
        if (!flip) {
          for (int t = 0; t < crop_len; ++t)
            dst[t] = f16_to_f32(seg.data[off + t]);
        } else {            // time-flip + sign (decorrelates reuse)
          for (int t = 0; t < crop_len; ++t)
            dst[t] = -f16_to_f32(seg.data[off + crop_len - 1 - t]);
        }
        if (seg_idx_out) seg_idx_out[i * 3 + d] = k;
      }
    }
  };

  const int nt = n_threads > 0 ? n_threads : 4;
  if (nt <= 1 || n_events < 4) {
    work(0, n_events);
  } else {
    std::vector<std::thread> pool;
    const int per = (n_events + nt - 1) / nt;
    for (int t = 0; t < nt; ++t) {
      const int lo = t * per, hi = std::min(n_events, (t + 1) * per);
      if (lo < hi) pool.emplace_back(work, lo, hi);
    }
    for (auto& th : pool) th.join();
  }
  return 0;
}

void pf_bank_close(void* handle) {
  auto* bank = static_cast<Bank*>(handle);
  if (!bank) return;
  for (auto& dets : bank->segments)
    for (auto& seg : dets) seg.close_map();
  delete bank;
}

}  // extern "C"

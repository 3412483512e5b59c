// Native volume loader: single-pass read + endian swap + normalisation.
//
// Native equivalent of the reference's C++ IO path
// (LoadVolume::load_data_impl, src/load_volume.cpp:112-172): reads the raw
// file in large chunks, converts to machine endianness, and linearly
// normalises into uint8 with the exact same formula
//     u8 = (uint8_t)(255 * clamp((v - lo) / (hi - lo), 0, 1))
// (truncating cast). Unlike the reference (3 sequential passes over 100 MB
// chunks + a full staging copy), this runs one fused pass, parallelised
// across hardware threads — the loader feeds jnp.asarray's host buffer
// directly.
//
// Exposed via ctypes (vkvolume/io/native.py); build: make -C native

#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <thread>
#include <vector>

namespace {

enum DType : int { U8 = 0, I8 = 1, U16 = 2, I16 = 3 };

inline uint16_t bswap16(uint16_t v) {
#if defined(__GNUC__) || defined(__clang__)
  return __builtin_bswap16(v);
#else
  return static_cast<uint16_t>((v << 8) | (v >> 8));
#endif
}

inline bool host_is_little() {
  const uint16_t x = 1;
  return *reinterpret_cast<const uint8_t*>(&x) == 1;
}

template <typename T>
void normalise_range(const uint8_t* raw, uint8_t* out, long long begin,
                     long long end, bool swap, float lo, float range) {
  const T* src = reinterpret_cast<const T*>(raw);
  for (long long i = begin; i < end; ++i) {
    T v = src[i];
    if (sizeof(T) == 2 && swap) {
      uint16_t u;
      std::memcpy(&u, &v, 2);
      u = bswap16(u);
      std::memcpy(&v, &u, 2);
    }
    // Divide (not reciprocal-multiply) to match the numpy/reference
    // formula bit-exactly at truncation boundaries.
    float t = (static_cast<float>(v) - lo) / range;
    t = std::min(1.0f, std::max(0.0f, t));
    out[i] = static_cast<uint8_t>(255.0f * t);  // truncating cast (reference
                                                // src/load_volume.cpp:169)
  }
}

template <typename T>
int load_impl(const char* path, long long n, bool file_big_endian, float lo,
              float hi, uint8_t* out) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return 1;
  std::vector<uint8_t> raw(static_cast<size_t>(n) * sizeof(T));
  size_t got = std::fread(raw.data(), 1, raw.size(), f);
  std::fclose(f);
  if (got != raw.size()) return 2;

  const bool swap = (sizeof(T) == 2) && (file_big_endian == host_is_little());
  const float range = hi - lo;

  unsigned hw = std::thread::hardware_concurrency();
  unsigned n_threads = std::max(1u, std::min(hw ? hw : 1u, 32u));
  if (n < (1 << 20)) n_threads = 1;
  std::vector<std::thread> threads;
  long long chunk = (n + n_threads - 1) / n_threads;
  for (unsigned t = 0; t < n_threads; ++t) {
    long long b = t * chunk;
    long long e = std::min<long long>(n, b + chunk);
    if (b >= e) break;
    threads.emplace_back(normalise_range<T>, raw.data(), out, b, e, swap, lo,
                         range);
  }
  for (auto& th : threads) th.join();
  return 0;
}

}  // namespace

extern "C" int vkvol_load_normalised(const char* path, long long n_voxels,
                                     int dtype_code, int big_endian, float lo,
                                     float hi, uint8_t* out) {
  switch (dtype_code) {
    case U8:
      return load_impl<uint8_t>(path, n_voxels, big_endian, lo, hi, out);
    case I8:
      return load_impl<int8_t>(path, n_voxels, big_endian, lo, hi, out);
    case U16:
      return load_impl<uint16_t>(path, n_voxels, big_endian, lo, hi, out);
    case I16:
      return load_impl<int16_t>(path, n_voxels, big_endian, lo, hi, out);
    default:
      return 3;
  }
}

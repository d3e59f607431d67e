// Native host baselines for the benchmark harness.
//
// The reference times two host references per run — std::sort and a scalar
// LSD radix sort (src/CRadixSortTask.cpp:172-222, src/CRadixSortCPU.h:29-123)
// — and reports them in the avgTotalSTLCPU / avgTotalRDXCPU CSV columns.
// These are the compiled C++ equivalents, exposed with a C ABI and loaded
// from Python via ctypes (radix_sort/utils/native_baseline.py).
//
// Keys arrive pre-biased to unsigned (the engine's order-preserving
// transform, the reference's OFFSET trick), so only unsigned sorts live
// here.  The radix sort is a textbook byte-wise LSD counting sort — an
// independent implementation, not a copy of the reference's base-8 variant.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

template <typename T>
void radix_sort_impl(T* data, std::size_t n) {
  if (n < 2) return;
  constexpr int kBytes = static_cast<int>(sizeof(T));
  std::vector<T> tmp(n);
  T* src = data;
  T* dst = tmp.data();
  for (int pass = 0; pass < kBytes; ++pass) {
    const int shift = pass * 8;
    std::size_t count[256] = {0};
    for (std::size_t i = 0; i < n; ++i)
      ++count[(src[i] >> shift) & 0xFF];
    if (count[(src[0] >> shift) & 0xFF] == n) continue;  // constant digit
    std::size_t sum = 0;
    for (int b = 0; b < 256; ++b) {
      std::size_t c = count[b];
      count[b] = sum;
      sum += c;
    }
    for (std::size_t i = 0; i < n; ++i)
      dst[count[(src[i] >> shift) & 0xFF]++] = src[i];
    std::swap(src, dst);
  }
  if (src != data) std::memcpy(data, src, n * sizeof(T));
}

template <typename T>
void radix_sort_kv_impl(T* keys, uint32_t* vals, std::size_t n) {
  if (n < 2) return;
  constexpr int kBytes = static_cast<int>(sizeof(T));
  std::vector<T> ktmp(n);
  std::vector<uint32_t> vtmp(n);
  T* ks = keys;
  T* kd = ktmp.data();
  uint32_t* vs = vals;
  uint32_t* vd = vtmp.data();
  for (int pass = 0; pass < kBytes; ++pass) {
    const int shift = pass * 8;
    std::size_t count[256] = {0};
    for (std::size_t i = 0; i < n; ++i)
      ++count[(ks[i] >> shift) & 0xFF];
    if (count[(ks[0] >> shift) & 0xFF] == n) continue;
    std::size_t sum = 0;
    for (int b = 0; b < 256; ++b) {
      std::size_t c = count[b];
      count[b] = sum;
      sum += c;
    }
    for (std::size_t i = 0; i < n; ++i) {
      std::size_t p = count[(ks[i] >> shift) & 0xFF]++;
      kd[p] = ks[i];
      vd[p] = vs[i];
    }
    std::swap(ks, kd);
    std::swap(vs, vd);
  }
  if (ks != keys) {
    std::memcpy(keys, ks, n * sizeof(T));
    std::memcpy(vals, vs, n * sizeof(uint32_t));
  }
}

}  // namespace

extern "C" {

void std_sort_u32(uint32_t* data, std::size_t n) { std::sort(data, data + n); }
void std_sort_u64(uint64_t* data, std::size_t n) { std::sort(data, data + n); }
void radix_sort_u32(uint32_t* data, std::size_t n) { radix_sort_impl(data, n); }
void radix_sort_u64(uint64_t* data, std::size_t n) { radix_sort_impl(data, n); }
void radix_sort_kv_u32(uint32_t* keys, uint32_t* vals, std::size_t n) {
  radix_sort_kv_impl(keys, vals, n);
}

}  // extern "C"

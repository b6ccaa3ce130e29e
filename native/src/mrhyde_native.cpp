// Native runtime kernels for the mrhyde_tpu setup/IO path.
//
// The compute path is JAX/XLA; this library covers the
// host-side runtime work the reference implements natively (its
// Panzer DOFManager graph build, data importer, and Exodus decode):
//
//  - unique_u64:       sort-based unique/inverse over packed entity
//                      keys — the edge/face global-numbering core of
//                      the DOF manager (reference: Panzer DOFManager
//                      via discretizationInterface.cpp:2324)
//  - nearest_point:    blocked closest-point assignment for mesh/sensor
//                      data import (reference: data.cpp
//                      findClosestPoint / assemblyManager.cpp:8235)
//  - bswap{32,64}:     big-endian bulk decode for Exodus/NetCDF3 IO
//
// Exposed as a plain C ABI for ctypes (no pybind11 in this image).
// Built by mrhyde_tpu/native.py on first use: g++ -O3 -shared.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <numeric>
#include <vector>

extern "C" {

// Sort-based unique over packed 64-bit keys.
//   keys:  n packed entity keys (caller packs node ids into bits)
//   inv:   out, n entries — inv[i] = compact id of keys[i]
//   uniq:  out, capacity n — first-occurrence ORDER IS SORTED KEY
//          ORDER (matches numpy.unique semantics)
// Returns the number of unique keys.
int64_t unique_u64(const uint64_t* keys, int64_t n, int64_t* inv,
                   uint64_t* uniq) {
  std::vector<int64_t> order(n);
  std::iota(order.begin(), order.end(), 0);
  std::sort(order.begin(), order.end(),
            [keys](int64_t a, int64_t b) { return keys[a] < keys[b]; });
  int64_t nu = 0;
  uint64_t prev = 0;
  for (int64_t r = 0; r < n; ++r) {
    const int64_t i = order[r];
    if (r == 0 || keys[i] != prev) {
      uniq[nu] = keys[i];
      prev = keys[i];
      ++nu;
    }
    inv[i] = nu - 1;
  }
  return nu;
}

// Two-column variant: rows (n, 2) of int64 node ids; equivalent to
// numpy.unique(rows, axis=0, return_inverse=True) for ids < 2^32.
int64_t unique_pairs(const int64_t* rows, int64_t n, int64_t* inv,
                     int64_t* uniq_rows) {
  std::vector<uint64_t> keys(n);
  for (int64_t i = 0; i < n; ++i) {
    keys[i] = (static_cast<uint64_t>(rows[2 * i]) << 32) |
              static_cast<uint64_t>(rows[2 * i + 1] & 0xffffffffLL);
  }
  std::vector<uint64_t> uniq(n);
  const int64_t nu = unique_u64(keys.data(), n, inv, uniq.data());
  for (int64_t u = 0; u < nu; ++u) {
    uniq_rows[2 * u] = static_cast<int64_t>(uniq[u] >> 32);
    uniq_rows[2 * u + 1] = static_cast<int64_t>(uniq[u] & 0xffffffffu);
  }
  return nu;
}

// Four-column variant for 3D face numbering (sorted node quadruples,
// ids < 2^16 per 16-bit lane would overflow real meshes, so compare
// lexicographically instead of packing).
int64_t unique_rows4(const int64_t* rows, int64_t n, int64_t* inv,
                     int64_t* uniq_rows) {
  std::vector<int64_t> order(n);
  std::iota(order.begin(), order.end(), 0);
  auto less = [rows](int64_t a, int64_t b) {
    return std::lexicographical_compare(rows + 4 * a, rows + 4 * a + 4,
                                        rows + 4 * b, rows + 4 * b + 4);
  };
  auto eq = [rows](int64_t a, int64_t b) {
    return std::equal(rows + 4 * a, rows + 4 * a + 4, rows + 4 * b);
  };
  std::sort(order.begin(), order.end(), less);
  int64_t nu = 0;
  for (int64_t r = 0; r < n; ++r) {
    const int64_t i = order[r];
    if (r == 0 || !eq(i, order[r - 1])) {
      std::memcpy(uniq_rows + 4 * nu, rows + 4 * i,
                  4 * sizeof(int64_t));
      ++nu;
    }
    inv[i] = nu - 1;
  }
  return nu;
}

// Blocked nearest-point assignment: for each query q (dim-vector),
// the index of the closest of the n points. O(n*q) with a cache
// blocking on points; the reference's findClosestPoint.
void nearest_point(const double* pts, int64_t n, const double* qry,
                   int64_t nq, int64_t dim, int64_t* out) {
  constexpr int64_t BLK = 512;
  std::vector<double> best(nq, 1e300);
  for (int64_t p0 = 0; p0 < n; p0 += BLK) {
    const int64_t p1 = std::min(p0 + BLK, n);
    for (int64_t q = 0; q < nq; ++q) {
      const double* xq = qry + q * dim;
      double b = best[q];
      int64_t bi = out[q];
      for (int64_t p = p0; p < p1; ++p) {
        const double* xp = pts + p * dim;
        double d = 0.0;
        for (int64_t k = 0; k < dim; ++k) {
          const double t = xq[k] - xp[k];
          d += t * t;
        }
        if (d < b) {
          b = d;
          bi = p;
        }
      }
      best[q] = b;
      out[q] = bi;
    }
  }
}

// Big-endian bulk decode (Exodus/NetCDF3 stores big-endian).
void bswap64(const uint8_t* src, double* dst, int64_t n) {
  for (int64_t i = 0; i < n; ++i) {
    uint64_t v;
    std::memcpy(&v, src + 8 * i, 8);
    v = __builtin_bswap64(v);
    std::memcpy(dst + i, &v, 8);
  }
}

void bswap32f(const uint8_t* src, float* dst, int64_t n) {
  for (int64_t i = 0; i < n; ++i) {
    uint32_t v;
    std::memcpy(&v, src + 4 * i, 4);
    v = __builtin_bswap32(v);
    std::memcpy(dst + i, &v, 4);
  }
}

void bswap32i(const uint8_t* src, int32_t* dst, int64_t n) {
  for (int64_t i = 0; i < n; ++i) {
    uint32_t v;
    std::memcpy(&v, src + 4 * i, 4);
    v = __builtin_bswap32(v);
    std::memcpy(dst + i, &v, 4);
  }
}

}  // extern "C"

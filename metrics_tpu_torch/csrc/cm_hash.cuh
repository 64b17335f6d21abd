// The count-min column hash of the sketch plane, on the device.
//
// The same bits as metrics_tpu_torch/sketch/kernels.py::_cm_columns (and the
// JAX package's metrics_tpu/sketch/kernels.py::_cm_columns): row j of the
// table takes column mix32(uint32(id) ^ seed_j) % width, where mix32 is the
// murmur3 finalizer and seed_j = mix32((j + 1) * 0x9E3779B9) (_row_seeds).
// Included by scatter.cu (the count-min table update from ids) and
// cms_walk.cu (the heavy-hitter ledger walk).

#pragma once

#include <stdint.h>

namespace cm_hash {

constexpr uint32_t kGold = 0x9E3779B9u;

__host__ __device__ __forceinline__ uint32_t mix32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x85EBCA6Bu;
  x ^= x >> 13;
  x *= 0xC2B2AE35u;
  return x ^ (x >> 16);
}

__host__ __device__ __forceinline__ uint32_t row_seed(int row) { return mix32((uint32_t)(row + 1) * kGold); }

// The column of `id` in the row whose seed is `seed`. kPow2: width is a power
// of two, so the modulo is a mask (decided once per launch).
template <bool kPow2>
__device__ __forceinline__ int column(int32_t id, uint32_t seed, uint32_t width) {
  const uint32_t h = mix32((uint32_t)id ^ seed);
  return (int)(kPow2 ? (h & (width - 1)) : (h % width));
}

}  // namespace cm_hash

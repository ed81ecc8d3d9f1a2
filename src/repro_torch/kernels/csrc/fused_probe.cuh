// Device code shared by the probe kernels B1 (fused_probe.cu) and B3
// (fused_probe_stream.cu): the seeded hashes of core/hashing.py, the
// seeds of the Bloom filter, the lsh rows and the variant keys, and a
// block-wide inclusive scan.
#pragma once
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int SEG = 256;  // positions per segment == threads per block
constexpr int MAX_BR = 32;
constexpr int MAX_L = 32;
constexpr int MODE_NONE = 0, MODE_LSH = 1, MODE_VAR = 2;
constexpr uint32_t BLOOM_SEED_BASE = 9100, LSH_SEED_BASE = 7000;
constexpr uint32_t VARIANT_SEED1 = 101, VARIANT_SEED2 = 202;
constexpr int SMEM_BLOOM_MAX_BYTES = 64 * 1024;

constexpr uint32_t C1 = 0x85EBCA6Bu, C2 = 0xC2B2AE35u, GOLDEN = 0x9E3779B9u;

__host__ __device__ __forceinline__ uint32_t seed_off(uint32_t seed) {
  return GOLDEN * (seed + 1u);
}
__device__ __forceinline__ uint32_t mix(uint32_t x) {
  x ^= x >> 16;
  x *= C1;
  x ^= x >> 13;
  x *= C2;
  x ^= x >> 16;
  return x;
}
__device__ __forceinline__ uint32_t hash_seeded(uint32_t x, uint32_t seed) {
  return mix(x + seed_off(seed));
}
__device__ __forceinline__ uint32_t combine(uint32_t h, uint32_t g) {
  return mix(h ^ (g + GOLDEN + (h << 6) + (h >> 2)));
}

// Inclusive scan over the block; returns the thread's inclusive prefix
// and writes the block total to *total. warp_tot holds NWARPS ints.
template <int NWARPS>
__device__ __forceinline__ int block_inclusive_scan(int v, int* warp_tot, int* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) warp_tot[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int w = lane < NWARPS ? warp_tot[lane] : 0;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, w, o);
      if (lane >= o) w += y;
    }
    if (lane < NWARPS) warp_tot[lane] = w;
  }
  __syncthreads();
  const int res = x + (warp > 0 ? warp_tot[warp - 1] : 0);
  *total = warp_tot[NWARPS - 1];
  __syncthreads();  // warp_tot may be reused right after
  return res;
}

}  // namespace


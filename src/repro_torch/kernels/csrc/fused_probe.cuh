// Device code shared by the probe kernels B1 (fused_probe.cu) and B3
// (fused_probe_stream.cu): the seeded hashes of core/hashing.py, the
// seeds of the Bloom filter, the lsh rows and the variant keys, a
// block-wide inclusive scan, the decoupled look-back that ranks a
// segment within its tile, and a 16-byte span fill.
#pragma once
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int SEG = 256;  // B3's positions per segment == threads per block
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

// look-back word of a segment: a flag in the high 32 bits, a count in
// the low 32 bits
constexpr unsigned long long LB_TOTAL = 1ull << 32, LB_PREFIX = 2ull << 32;

// Run by one thread: publishes the total of segment s, j-th of its tile
// (the tile's first segment publishes its prefix).
__device__ __forceinline__ void publish_total(unsigned long long* words, long long s, long long j,
                                              int total) {
  atomicExch(words + s, (j > 0 ? LB_TOTAL : LB_PREFIX) | (unsigned)total);
}

// Decoupled look-back, run by all NT threads of a block once segment s
// has published its total (publish_total): sums the totals of the
// segments before it in its tile, NT words a round, back to the nearest
// inclusive prefix, and returns its exclusive prefix to every thread;
// thread 0 publishes the inclusive one. Segments are handed out in ticket
// order, so every segment it waits on is held by a running block. red
// holds NT / 32 ints.
template <int NT>
__device__ int look_back(unsigned long long* words, long long s, long long j, int total,
                         int* red) {
  constexpr int NW = NT / 32;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  int excl = 0;
  if (j > 0) {  // uniform over the block
    const long long first = s - j;  // the tile's first segment publishes a prefix at once
    for (long long hi = s - 1;; hi -= NT) {
      const long long q = hi - tid;
      unsigned long long v = 0;
      if (q >= first) {
        do {
          v = *(volatile unsigned long long*)(words + q);
        } while ((v >> 32) == 0);
      }
      const unsigned stops = __ballot_sync(0xffffffffu, q < first || (v & LB_PREFIX));
      if (lane == 0) red[warp] = stops ? warp * 32 + __ffs(stops) - 1 : NT;
      __syncthreads();
      int stop = NT;  // the nearest prefix
#pragma unroll
      for (int w = 0; w < NW; ++w) stop = min(stop, red[w]);
      int x = tid <= stop ? (int)(unsigned)v : 0;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
      __syncthreads();  // red is read
      if (lane == 0) red[warp] = x;
      __syncthreads();
#pragma unroll
      for (int w = 0; w < NW; ++w) excl += red[w];
      __syncthreads();  // red is free for the next round
      if (stop < NT) break;
    }
  }
  if (tid == 0 && j > 0) atomicExch(words + s, LB_PREFIX | (unsigned)(excl + total));
  return excl;
}

// v into row[from, to) by thread t of n: 16-byte streaming stores over
// the aligned interior, scalar stores at both ends.
__device__ __forceinline__ void fill_span(int* row, long long from, long long to, int v,
                                          long long t, long long n) {
  if (from >= to) return;
  int* p = row + from;
  const long long len = to - from;
  long long head = (long long)((16u - ((unsigned)(uintptr_t)p & 15u)) & 15u) >> 2;
  if (head > len) head = len;
  const long long nvec = (len - head) >> 2;
  const long long tail0 = head + (nvec << 2);
  if (t < head) p[t] = v;
  if (t < len - tail0) p[tail0 + t] = v;
  int4* q = reinterpret_cast<int4*>(p + head);
  const int4 v4 = make_int4(v, v, v, v);
  for (long long k = t; k < nvec; k += n) __stcs(q + k, v4);
}

}  // namespace


// Banded MinHash signatures of token windows.
//
// Replaces the TPU kernel src/repro/kernels/minhash.py: minhash_pallas
// (pallas_call at :66; body _kernel :36). The plain PyTorch form of the
// same function is repro_torch/kernels/minhash.py:minhash_plain; outputs
// are equal bit for bit.
//
//   rmin[n, j]  = MIN over valid l of hash(tok[n, l], LSH_SEED_BASE + j)
//                 (0xFFFFFFFF when row n has no valid token), j < B*R
//   sig[n, b]   = combine(combine(..combine(rmin[bR], rmin[bR+1])..),
//                         b + 1)
//
// What bounds it on an H100: integer operations. Per row it reads L
// tokens and L validity bytes and writes B uint32 signatures, but it
// evaluates L*B*R hashes (a murmur3 finaliser each, ~10 int32
// operations) and B*R combines; at L = 8 and B*R = 8 that is ~660
// operations against 48 bytes, far past the card's int32 ops-per-byte
// balance point.
//
// Design: one thread per row. The thread reads its row's tokens once
// (through the read-only cache; neighbouring threads' rows are
// neighbouring in memory) and keeps the B*R running minima in
// registers, so each token is loaded once for all B*R hashes. Hash
// values are 32-bit; the output is int64 slots holding the uint32
// values, the port's convention for hashes.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MAX_BR = 32;
constexpr int THREADS = 256;
constexpr uint32_t LSH_SEED_BASE = 7000;
constexpr uint32_t C1 = 0x85EBCA6Bu, C2 = 0xC2B2AE35u, GOLDEN = 0x9E3779B9u;

__device__ __forceinline__ uint32_t mix(uint32_t x) {
  x ^= x >> 16;
  x *= C1;
  x ^= x >> 13;
  x *= C2;
  x ^= x >> 16;
  return x;
}
__device__ __forceinline__ uint32_t hash_seeded(uint32_t x, uint32_t seed) {
  return mix(x + GOLDEN * (seed + 1u));
}
__device__ __forceinline__ uint32_t combine(uint32_t h, uint32_t g) {
  return mix(h ^ (g + GOLDEN + (h << 6) + (h >> 2)));
}

__global__ void __launch_bounds__(THREADS)
    minhash_kernel(const int* __restrict__ tokens, const uint8_t* __restrict__ valid, long long N,
                   int L, int bands, int rows, long long* __restrict__ out) {
  const int BR = bands * rows;
  for (long long n = blockIdx.x * (long long)THREADS + threadIdx.x; n < N;
       n += (long long)gridDim.x * THREADS) {
    uint32_t rmin[MAX_BR];
#pragma unroll
    for (int j = 0; j < MAX_BR; ++j) rmin[j] = 0xFFFFFFFFu;
    const int* tok = tokens + n * L;
    const uint8_t* ok = valid + n * L;
    for (int l = 0; l < L; ++l) {
      if (!__ldg(ok + l)) continue;
      const uint32_t x = (uint32_t)__ldg(tok + l);
#pragma unroll
      for (int j = 0; j < MAX_BR; ++j)
        if (j < BR) rmin[j] = min(rmin[j], hash_seeded(x, LSH_SEED_BASE + j));
    }
    long long* o = out + n * bands;
    uint32_t band = 0u;
#pragma unroll
    for (int j = 0; j < MAX_BR; ++j) {
      if (j < BR) {
        const int r = j % rows;
        band = r == 0 ? rmin[j] : combine(band, rmin[j]);
        if (r == rows - 1) o[j / rows] = combine(band, (uint32_t)(j / rows + 1));
      }
    }
  }
}

}  // namespace

// tokens [N, L] int32, valid [N, L] bytes (a torch.bool tensor), out
// [N, bands] int64 holding uint32. Returns 0 or the first CUDA error.
extern "C" int minhash_launch(const int* tokens, const uint8_t* valid, long long N, int L,
                              int bands, int rows, long long* out, void* stream) {
  if (N < 1 || L < 1 || bands < 1 || rows < 1 || bands * rows > MAX_BR)
    return (int)cudaErrorInvalidValue;
  int dev = 0, sms = 132;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const long long blocks = (N + THREADS - 1) / THREADS;
  const int grid = (int)(blocks < (long long)sms * 16 ? blocks : (long long)sms * 16);
  minhash_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(tokens, valid, N, L, bands, rows,
                                                             out);
  return (int)cudaGetLastError();
}

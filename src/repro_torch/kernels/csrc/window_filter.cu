// Window filter: the ISH Bloom probe over every (position, length)
// window of a document batch, for windows of any length.
//
// Replaces the TPU kernel src/repro/kernels/window_filter.py:
// window_filter_pallas (pallas_call at :85; body _kernel :44). The plain
// PyTorch form of the same function is
// repro_torch/kernels/window_filter.py:window_filter_plain; outputs are
// equal bit for bit.
//
//   hit[d, t]        = t < T and all K Bloom probes of tok[d, t] set
//   out[d, t, l]     = OR(hit[d, t .. t+l])            (l < L)
//
// PAD tokens are probed like any other; the caller ANDs window validity.
// The engine runs this kernel where the packed survival bitmap of the
// fused probe cannot hold the lengths (L > 32).
//
// What bounds it on an H100: memory. The docs are read once (D*T*4
// bytes) and the [D, T, L] mask is written once (D*T*L bytes, one byte
// per bool); the integer work is K hashes per token and an L-step scan
// per position, far under the int32 rate.
//
// Design: a block of SEG threads owns SEG consecutive positions of one
// row (blocks loop over such segments). It stages the segment's Bloom
// hits plus an L-1 halo in shared memory, each token probed once; each
// thread then finds its position's first hit offset f (L if none), so
// out[d, t, l] = (f <= l). The block writes its contiguous
// SEG*L-byte stretch of the output with consecutive threads on
// consecutive bytes. The Bloom words sit in shared memory when they fit
// (2^18 bits = 32 KiB), else they are read through the read-only cache.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int SEG = 256;
constexpr uint32_t BLOOM_SEED_BASE = 9100;
constexpr int SMEM_BLOOM_MAX_BYTES = 64 * 1024;
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

template <bool SMEM_BLOOM>
__global__ void __launch_bounds__(SEG)
    window_filter_kernel(const int* __restrict__ docs, int D, int T,
                         const uint32_t* __restrict__ bits, uint32_t num_bits, int num_words,
                         int num_hashes, int L, int nseg, uint8_t* __restrict__ out) {
  extern __shared__ uint32_t smem[];
  const int W = SEG + L - 1;
  uint8_t* s_hit = reinterpret_cast<uint8_t*>(smem + (SMEM_BLOOM ? num_words : 0));
  __shared__ int s_first[SEG];
  if (SMEM_BLOOM) {
    for (int i = threadIdx.x; i < num_words; i += SEG) smem[i] = bits[i];
  }
  const long long nseg_total = (long long)D * nseg;
  const int tid = threadIdx.x;
  for (long long s = blockIdx.x; s < nseg_total; s += gridDim.x) {
    const int row = (int)(s / nseg);
    const int t0 = (int)(s % nseg) * SEG;
    const int* drow = docs + (long long)row * T;
    __syncthreads();  // the previous segment's staging and writes are done
    for (int i = tid; i < W; i += SEG) {
      const int t = t0 + i;
      bool hit = t < T;  // past the row end nothing hits (the reference's zero fill)
      if (hit) {
        const uint32_t x = (uint32_t)drow[t];
        for (int k = 0; k < num_hashes; ++k) {
          const uint32_t p = hash_seeded(x, BLOOM_SEED_BASE + k) % num_bits;
          const uint32_t w = SMEM_BLOOM ? smem[p >> 5] : __ldg(bits + (p >> 5));
          hit = hit && ((w >> (p & 31u)) & 1u);
        }
      }
      s_hit[i] = hit;
    }
    __syncthreads();
    int f = L;
    for (int l = 0; l < L; ++l) {
      if (s_hit[tid + l]) {
        f = l;
        break;
      }
    }
    s_first[tid] = f;
    __syncthreads();
    const int n = min(SEG, T - t0);
    uint8_t* o = out + ((long long)row * T + t0) * L;
    for (int i = tid; i < n * L; i += SEG) o[i] = s_first[i / L] <= i % L;
  }
}

template <bool SMEM_BLOOM>
cudaError_t launch(const int* docs, int D, int T, const uint32_t* bits, uint32_t num_bits,
                   int num_words, int num_hashes, int L, int nseg, uint8_t* out, int grid,
                   size_t smem, cudaStream_t st) {
  auto kern = window_filter_kernel<SMEM_BLOOM>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kern<<<grid, SEG, smem, st>>>(docs, D, T, bits, num_bits, num_words, num_hashes, L, nseg, out);
  return cudaGetLastError();
}

}  // namespace

// docs [D, T] int32, bits [num_words] uint32, out [D, T, L] bytes (a
// torch.bool tensor). Returns 0 or the first CUDA error.
extern "C" int window_filter_launch(const int* docs, int D, int T, const uint32_t* bits,
                                    long long num_bits, int num_words, int num_hashes, int L,
                                    uint8_t* out, void* stream) {
  if (D < 1 || T < 1 || L < 1 || L > 4096 || num_bits < 1 || num_hashes < 1)
    return (int)cudaErrorInvalidValue;
  int dev = 0, sms = 132;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int nseg = (T + SEG - 1) / SEG;
  const long long nseg_total = (long long)D * nseg;
  const int grid = (int)(nseg_total < (long long)sms * 8 ? nseg_total : (long long)sms * 8);
  const bool smem_bloom = (long long)num_words * 4 <= SMEM_BLOOM_MAX_BYTES;
  const size_t W = SEG + L - 1;
  const size_t smem = (smem_bloom ? (size_t)num_words * 4 : 0) + W;
  cudaStream_t st = (cudaStream_t)stream;
  return (int)(smem_bloom ? launch<true>(docs, D, T, bits, (uint32_t)num_bits, num_words,
                                         num_hashes, L, nseg, out, grid, smem, st)
                          : launch<false>(docs, D, T, bits, (uint32_t)num_bits, num_words,
                                          num_hashes, L, nseg, out, grid, smem, st));
}

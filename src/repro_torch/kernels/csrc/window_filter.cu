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
// per bool); the integer work is K hashes per token and a short scan per
// position, far under the int32 rate. At the engine's batch of 32
// documents the bytes take 0.2 us, so there the launch and the latency
// of one pass (load, probe, scan, store) are what is left to cut.
//
// What the first design lost: every block copied the whole Bloom filter
// into shared memory (8,192 words for ~900 probes at 32 documents), each
// thread scanned its L hits a byte at a time, and the output loop wrote
// one byte per step with a runtime i / L and i % L per byte.
//
// Design: each warp owns runs of RUN consecutive positions of one row and
// works through them on its own, with no block barrier after the Bloom
// copy, so one warp's stores overlap another's loads and probes. Small
// batches (at most one 4-warp block an SM) take runs of 32, one a warp;
// larger ones one persistent block of 32 warps an SM and runs of 128.
//  * Bloom words: copied into shared memory once per block, with 16-byte
//    loads, wherever the filter fits (96 KiB); larger filters are read
//    through the read-only cache. The copy ran faster than the cache at 32
//    and at 1,024 documents (development runs; PERF.md, Findings): a probe is
//    a random 4-byte gather, up to 32 cache lines a warp through L1, a few
//    bank conflicts in shared memory. A run's first tokens load during the
//    copy.
//  * Hits as bits: each token of the run and its L-1 halo is probed once,
//    all K probes of eight tokens a lane in flight at once, and the warp
//    packs each 32 hits into a word with __ballot_sync. A position's
//    first-hit offset f (L if none) is __ffs of the 32 hits from it on (a
//    funnel shift of two words), walking further words only while f is
//    not found within L, so out[d, t, l] = (f <= l).
//  * Output as 16-byte stores: the run's [RUN, L] byte tile is contiguous.
//    Each 16-byte chunk is built from the f of the positions it covers (at
//    most two when L >= 16) as byte-range masks of two 64-bit words; a
//    lane steps from chunk to chunk 512 bytes on without dividing by L.
//    The unaligned head and tail of the tile go a byte at a time. Stores
//    are streaming (evict-first); the next run's tokens load meanwhile.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr uint32_t BLOOM_SEED_BASE = 9100;
constexpr int SMEM_BLOOM_MAX_BYTES = 96 * 1024;
constexpr int BATCH = 8;  // hit words whose tokens a warp loads at once
// small batches (one wave of at most one block an SM): runs of 32
// positions, 4 warps a block, one run a warp
constexpr int SMALL_RUN = 32, SMALL_WARPS = 4;
// large batches: runs of 128, one persistent block of 32 warps an SM
// (one copy of the filter an SM)
constexpr int LARGE_RUN = 128, LARGE_WARPS = 32;
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

struct Args {
  const int* docs;
  int D, T;
  const uint32_t* bits;
  uint32_t num_bits;
  int num_words, num_hashes;
  int L;
  int nrun;    // runs a row
  int hw;      // hit words a run: RUN / 32 + ceil(L / 32)
  int dq, dr;  // 512 / L, 512 % L: a lane's step from one 16-byte chunk to its next
  uint8_t* out;
};

// bytes [0, k) of a 64-bit word set to 1, k clamped to [0, 8]
__device__ __forceinline__ uint64_t bytes_below(int k) {
  constexpr uint64_t ONES = 0x0101010101010101ull;
  return k <= 0 ? 0ull : k >= 8 ? ONES : ONES >> (64 - 8 * k);
}

// One warp a run at a time; a run's hit words and f values live in the
// warp's own slice of shared memory.
template <int RUN, int WARPS, bool SMEM_BLOOM>
__global__ void __launch_bounds__(32 * WARPS) window_filter_kernel(Args a) {
  extern __shared__ __align__(16) uint32_t smem[];
  const uint32_t* s_bloom = smem;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  uint32_t* s_hw = smem + (SMEM_BLOOM ? a.num_words : 0) + warp * a.hw;
  uint16_t* s_f = reinterpret_cast<uint16_t*>(smem + (SMEM_BLOOM ? a.num_words : 0) +
                                              WARPS * a.hw) + warp * RUN;
  const bool pow2 = (a.num_bits & (a.num_bits - 1)) == 0;
  const long long nruns = (long long)a.D * a.nrun;
  const long long stride = (long long)gridDim.x * WARPS;
  // the tokens of hit words [k0, k0 + BATCH) of the run at (row, t0)
  auto load = [&](uint32_t (&x)[BATCH], int row, int t0, int k0) {
#pragma unroll
    for (int j = 0; j < BATCH; ++j) {
      const int i = 32 * (k0 + j) + lane, t = t0 + i;
      x[j] = k0 + j < a.hw && i < RUN + a.L - 1 && t < a.T
                 ? (uint32_t)__ldg(a.docs + (long long)row * a.T + t)
                 : 0u;
    }
  };
  long long s = (long long)blockIdx.x * WARPS + warp;
  int row = (int)(s / a.nrun);
  int t0 = (int)(s - (long long)row * a.nrun) * RUN;
  uint32_t x[BATCH];
  if (s < nruns) load(x, row, t0, 0);  // in flight during the Bloom copy
  if (SMEM_BLOOM) {
    const int nv = a.num_words >> 2;
#pragma unroll 8
    for (int i = threadIdx.x; i < nv; i += 32 * WARPS)
      reinterpret_cast<uint4*>(smem)[i] = __ldg(reinterpret_cast<const uint4*>(a.bits) + i);
    for (int i = 4 * nv + threadIdx.x; i < a.num_words; i += 32 * WARPS)
      smem[i] = __ldg(a.bits + i);
    __syncthreads();
  }
  for (; s < nruns; s += stride) {
    // hit bits of positions t0 + [0, 32*hw): the run and its L-1 halo;
    // nothing hits past the row end (the reference's zero fill). All K
    // probes of a batch are in flight at once.
    for (int k0 = 0; k0 < a.hw; k0 += BATCH) {
      if (k0 > 0) load(x, row, t0, k0);
      uint32_t hit[BATCH];
#pragma unroll
      for (int j = 0; j < BATCH; ++j) {
        const int i = 32 * (k0 + j) + lane;
        hit[j] = k0 + j < a.hw && i < RUN + a.L - 1 && t0 + i < a.T;
      }
      for (int kb = 0; kb < a.num_hashes; kb += 4) {
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          if (kb + kk < a.num_hashes) {
#pragma unroll
            for (int j = 0; j < BATCH; ++j) {
              // through the cache, a token's later probes only while it still hits
              if (k0 + j < a.hw && (SMEM_BLOOM || hit[j])) {
                const uint32_t h = hash_seeded(x[j], BLOOM_SEED_BASE + kb + kk);
                const uint32_t p = pow2 ? h & (a.num_bits - 1u) : h % a.num_bits;
                const uint32_t w = SMEM_BLOOM ? s_bloom[p >> 5] : __ldg(a.bits + (p >> 5));
                hit[j] &= (w >> (p & 31u)) & 1u;
              }
            }
          }
        }
      }
#pragma unroll
      for (int j = 0; j < BATCH; ++j) {
        const uint32_t word = __ballot_sync(0xFFFFFFFFu, hit[j]);
        if (lane == 0 && k0 + j < a.hw) s_hw[k0 + j] = word;
      }
    }
    const int cur_row = row, cur_t0 = t0;
    if (s + stride < nruns) {  // the next run's first tokens load during this run's stores
      row = (int)((s + stride) / a.nrun);
      t0 = (int)((s + stride) - (long long)row * a.nrun) * RUN;
      load(x, row, t0, 0);
    }
    __syncwarp();
    // first-hit offset f of each position (L if none): out[.., l] = f <= l
    const int npos = min(RUN, a.T - cur_t0);
    for (int i = lane; i < npos; i += 32) {
      int f = a.L, k = i >> 5;
      for (int off = 0; off < a.L; off += 32, ++k) {
        const uint32_t w = __funnelshift_r(s_hw[k], s_hw[k + 1], lane);
        if (w) {
          f = min(a.L, off + __ffs(w) - 1);
          break;
        }
      }
      s_f[i] = (uint16_t)f;
    }
    __syncwarp();
    // the run's [npos, L] byte tile: 16-byte chunks between a bytewise head
    // and tail; lane c takes chunks c, c + 32, .. (512 bytes apart)
    uint8_t* o = a.out + ((long long)cur_row * a.T + cur_t0) * a.L;
    const int n = npos * a.L;
    const int head = min(n, (int)((16u - ((uint32_t)(uintptr_t)o & 15u)) & 15u));
    const int nchunks = (n - head) >> 4;
    int ci = (head + 16 * lane) / a.L, cl = head + 16 * lane - ci * a.L;
    for (int c = lane; c < nchunks; c += 32) {
      int i = ci, l = cl;
      uint64_t lo = 0ull, hi = 0ull;
      for (int b = 0; b < 16; ++i, l = 0) {  // the positions the chunk covers
        const int e = min(16, b + a.L - l);
        const int first = min(e, b + max(0, (int)s_f[i] - l));
        lo |= bytes_below(e) & ~bytes_below(first);
        hi |= bytes_below(e - 8) & ~bytes_below(first - 8);
        b = e;
      }
      __stcs(reinterpret_cast<uint4*>(o + head + 16 * c),
             make_uint4((uint32_t)lo, (uint32_t)(lo >> 32), (uint32_t)hi, (uint32_t)(hi >> 32)));
      ci += a.dq;
      cl += a.dr;
      if (cl >= a.L) {
        cl -= a.L;
        ++ci;
      }
    }
    const int tail0 = head + 16 * nchunks;
    for (int j = lane; j < head + n - tail0; j += 32) {
      const int ob = j < head ? j : tail0 + (j - head);
      const int i = ob / a.L;
      o[ob] = s_f[i] <= ob - i * a.L;
    }
    __syncwarp();  // s_hw and s_f are free for the next run
  }
}

template <int RUN, int WARPS, bool SMEM_BLOOM>
cudaError_t launch(Args a, int max_grid, cudaStream_t st) {
  a.nrun = (a.T + RUN - 1) / RUN;
  a.hw = RUN / 32 + (a.L + 31) / 32;
  const long long blocks = ((long long)a.D * a.nrun + WARPS - 1) / WARPS;
  const int grid = (int)(blocks < max_grid ? blocks : max_grid);
  const size_t smem = (SMEM_BLOOM ? (size_t)a.num_words * 4 : 0) +
                      (size_t)WARPS * (a.hw * 4 + RUN * 2);
  auto kern = window_filter_kernel<RUN, WARPS, SMEM_BLOOM>;
  if (smem > 48 * 1024) {
    cudaError_t err =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  kern<<<grid, 32 * WARPS, smem, st>>>(a);
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
  static int cached_dev = -1, sms = 0;  // the SM count of the device last launched on
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess && dev != cached_dev)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  cached_dev = dev;
  const Args a{docs, D, T, bits, (uint32_t)num_bits, num_words, num_hashes, L, 0, 0,
               512 / L, 512 % L, out};
  cudaStream_t st = (cudaStream_t)stream;
  // the filter goes to shared memory wherever it fits (measured faster than
  // the read-only cache at 32 and at 1,024 documents of 512 tokens)
  const bool smem_bloom = (long long)num_words * 4 <= SMEM_BLOOM_MAX_BYTES &&
                          (uintptr_t)bits % 16 == 0;
  const long long small_runs = (long long)D * ((T + SMALL_RUN - 1) / SMALL_RUN);
  if (small_runs <= (long long)sms * SMALL_WARPS)
    return (int)(smem_bloom ? launch<SMALL_RUN, SMALL_WARPS, true>(a, sms, st)
                            : launch<SMALL_RUN, SMALL_WARPS, false>(a, sms, st));
  return (int)(smem_bloom ? launch<LARGE_RUN, LARGE_WARPS, true>(a, sms, st)
                          : launch<LARGE_RUN, SMALL_WARPS, false>(a, 1 << 30, st));
}

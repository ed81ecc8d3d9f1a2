// Device code shared by the probe kernels B1 (fused_probe.cu) and B3
// (fused_probe_stream.cu): the per-token Bloom probe and L-step
// recurrence, the per-tile segment-count scan, lane padding and the
// survivor emit pass. See fused_probe.cu for the design.
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

struct Args {
  const int* docs;
  int D, T;
  const uint32_t* bits;
  uint32_t num_bits;
  int num_words, num_hashes, use_filter;
  int L, bands, rows, bd, C, dense, nseg;
  long long* packed;
  long long* sigs;
  int* counts;
  int* cands;
  long long* vkeys;
  int* seg_counts;
  int* seg_offs;
  // streamed form: absolute doc-row offset of each [bd, T] chunk (null
  // in the per-tile form, where tile g starts at row g * bd)
  const int* row_offs;
};

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

template <int MODE, bool SMEM_BLOOM>
__global__ void __launch_bounds__(SEG) probe_kernel(Args a) {
  extern __shared__ uint32_t smem[];
  __shared__ int warp_tot[SEG / 32];
  const int W = SEG + a.L - 1;  // staged tokens: segment + halo
  const int BR = a.bands * a.rows;
  uint32_t* s_tok = smem + (SMEM_BLOOM ? a.num_words : 0);
  uint32_t* s_flag = s_tok + W;  // bit 0 real, bit 1 Bloom hit
  uint32_t* s_h = s_flag + W;    // lsh: BR*W row hashes; variant: 2*W
  if (SMEM_BLOOM) {
    for (int i = threadIdx.x; i < a.num_words; i += SEG) smem[i] = a.bits[i];
  }
  const long long nseg_total = (long long)a.D * a.nseg;
  const int tid = threadIdx.x;
  for (long long s = blockIdx.x; s < nseg_total; s += gridDim.x) {
    const int row = (int)(s / a.nseg);
    const int t0 = (int)(s % a.nseg) * SEG;
    const int* drow = a.docs + (long long)row * a.T;
    __syncthreads();  // shared staging of the previous segment is done
    for (int i = tid; i < W; i += SEG) {
      const int t = t0 + i;
      const bool in = t < a.T;
      const uint32_t x = in ? (uint32_t)drow[t] : 0u;
      const bool real = x != 0u;
      bool hit = real;
      if (a.use_filter) {
        hit = in;  // past the row end nothing hits (the reference's zero fill)
        for (int k = 0; k < a.num_hashes; ++k) {
          const uint32_t p = hash_seeded(x, BLOOM_SEED_BASE + k) % a.num_bits;
          const uint32_t w = SMEM_BLOOM ? smem[p >> 5] : __ldg(a.bits + (p >> 5));
          hit = hit && ((w >> (p & 31u)) & 1u);
        }
      }
      s_tok[i] = x;
      s_flag[i] = (real ? 1u : 0u) | (hit ? 2u : 0u);
      if (MODE == MODE_LSH) {
        for (int j = 0; j < BR; ++j)
          s_h[j * W + i] = real ? hash_seeded(x, LSH_SEED_BASE + j) : 0xFFFFFFFFu;
      }
      if (MODE == MODE_VAR) {
        s_h[i] = hash_seeded(x, VARIANT_SEED1);
        s_h[W + i] = hash_seeded(x, VARIANT_SEED2);
      }
    }
    __syncthreads();
    const int t = t0 + tid;
    int cnt = 0;
    if (t < a.T) {
      const long long base = (long long)row * a.T + t;
      bool vand = true, vor = false;
      uint32_t pack = 0u;
      uint32_t rmin[MAX_BR];
#pragma unroll
      for (int j = 0; j < MAX_BR; ++j) rmin[j] = 0xFFFFFFFFu;
      uint32_t vs1 = 0u, vx1 = 0u, vs2 = 0u, vx2 = 0u, vcnt = 0u;
      for (int l = 0; l < a.L; ++l) {
        const int i = tid + l;
        const uint32_t f = s_flag[i];
        vand = vand && (f & 1u);
        vor = vor || (f & 2u);
        const bool surv = vand && vor;
        pack |= (uint32_t)surv << l;
        cnt += surv;
        if (MODE == MODE_LSH) {
          long long* out = a.sigs + (base * a.L + l) * a.bands;
          uint32_t band = 0u;
#pragma unroll
          for (int j = 0; j < MAX_BR; ++j) {
            if (j < BR) {
              rmin[j] = min(rmin[j], s_h[j * W + i]);
              const int r = j % a.rows;
              band = r == 0 ? rmin[j] : combine(band, rmin[j]);
              if (r == a.rows - 1) out[j / a.rows] = combine(band, (uint32_t)(j / a.rows + 1));
            }
          }
        }
        if (MODE == MODE_VAR) {
          const uint32_t x = s_tok[i];
          bool dup = false;
          for (int j = 0; j < l; ++j) dup = dup || (s_tok[tid + j] == x);
          if ((f & 1u) && !dup) {
            vs1 += s_h[i];
            vx1 ^= s_h[i];
            vs2 += s_h[W + i];
            vx2 ^= s_h[W + i];
            ++vcnt;
          }
          if (a.dense) {
            const uint32_t fin = vcnt * GOLDEN;
            long long* out = a.sigs + (base * a.L + l) * 2;
            out[0] = mix(vs1 ^ (vx1 * C1) ^ fin);
            out[1] = mix(vs2 ^ (vx2 * C1) ^ fin);
          }
        }
      }
      a.packed[base] = pack;
    }
    if (a.seg_counts != nullptr) {
      int total;
      block_inclusive_scan<SEG / 32>(cnt, warp_tot, &total);
      if (tid == 0) a.seg_counts[s] = total;
    }
  }
}

// One block per tile: segment counts -> per-segment exclusive offsets
// within the tile, and the tile's survivor count.
__global__ void __launch_bounds__(1024) scan_kernel(Args a) {
  __shared__ int warp_tot[32];
  const int g = blockIdx.x;
  const int row0 = g * a.bd;
  const int row1 = min(a.D, row0 + a.bd);
  const long long s0 = (long long)row0 * a.nseg, s1 = (long long)row1 * a.nseg;
  int carry = 0;
  for (long long b = s0; b < s1; b += blockDim.x) {
    const long long s = b + threadIdx.x;
    const int v = s < s1 ? a.seg_counts[s] : 0;
    int total;
    const int incl = block_inclusive_scan<32>(v, warp_tot, &total);
    if (s < s1 && a.seg_offs != nullptr) a.seg_offs[s] = carry + incl - v;
    carry += total;
  }
  if (threadIdx.x == 0) a.counts[g] = carry;
}

__global__ void pad_kernel(Args a, long long n) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    const int g = (int)(i / a.C);
    const int r = (int)(i % a.C);
    if (r >= a.counts[g]) {
      a.cands[i] = -1;
      if (a.vkeys != nullptr) {
        a.vkeys[2 * i] = 0;
        a.vkeys[2 * i + 1] = 0;
      }
    }
  }
}

template <bool VAR>
__global__ void __launch_bounds__(SEG) emit_kernel(Args a) {
  __shared__ int warp_tot[SEG / 32];
  const long long nseg_total = (long long)a.D * a.nseg;
  const int tid = threadIdx.x;
  for (long long s = blockIdx.x; s < nseg_total; s += gridDim.x) {
    const int off = a.seg_offs[s];
    if (off >= a.C) continue;  // uniform over the block
    const int row = (int)(s / a.nseg);
    const int t = (int)(s % a.nseg) * SEG + tid;
    const long long base = (long long)row * a.T + t;
    const uint32_t pack = t < a.T ? (uint32_t)a.packed[base] : 0u;
    const int c = __popc(pack);
    int total;
    int r = off + block_inclusive_scan<SEG / 32>(c, warp_tot, &total) - c;
    if (pack == 0u || r >= a.C) continue;
    const int g = row / a.bd;
    const long long lane0 = (long long)g * a.C;
    // global flat index of (row, t, l = 0), in 64 bits before the cast;
    // the caller bounds the index space below 2^31
    const long long flat0 =
        a.row_offs == nullptr
            ? base * a.L
            : ((long long)a.row_offs[g] * a.T + (long long)(row - g * a.bd) * a.T + t) * a.L;
    if (!VAR) {
      for (uint32_t p = pack; p != 0u && r < a.C; p &= p - 1u, ++r)
        a.cands[lane0 + r] = (int)(flat0 + __ffs(p) - 1);
      continue;
    }
    // variant: rerun the key recurrence up to the last survivor
    const int* drow = a.docs + (long long)row * a.T;
    uint32_t tok[MAX_L];
    uint32_t vs1 = 0u, vx1 = 0u, vs2 = 0u, vx2 = 0u, vcnt = 0u;
    const int last = 31 - __clz(pack);
    for (int l = 0; l <= last && r < a.C; ++l) {
      const uint32_t x = t + l < a.T ? (uint32_t)drow[t + l] : 0u;
      bool dup = false;
      for (int j = 0; j < l; ++j) dup = dup || (tok[j] == x);
      tok[l] = x;
      if (x != 0u && !dup) {
        const uint32_t h1 = hash_seeded(x, VARIANT_SEED1), h2 = hash_seeded(x, VARIANT_SEED2);
        vs1 += h1;
        vx1 ^= h1;
        vs2 += h2;
        vx2 ^= h2;
        ++vcnt;
      }
      if ((pack >> l) & 1u) {
        const uint32_t fin = vcnt * GOLDEN;
        a.cands[lane0 + r] = (int)(flat0 + l);
        a.vkeys[2 * (lane0 + r)] = mix(vs1 ^ (vx1 * C1) ^ fin);
        a.vkeys[2 * (lane0 + r) + 1] = mix(vs2 ^ (vx2 * C1) ^ fin);
        ++r;
      }
    }
  }
}

template <int MODE, bool SMEM_BLOOM>
cudaError_t launch_probe(const Args& a, int grid, size_t smem, cudaStream_t st) {
  auto kern = probe_kernel<MODE, SMEM_BLOOM>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kern<<<grid, SEG, smem, st>>>(a);
  return cudaGetLastError();
}

template <int MODE>
cudaError_t launch_probe_mode(const Args& a, bool smem_bloom, int grid, size_t smem,
                              cudaStream_t st) {
  return smem_bloom ? launch_probe<MODE, true>(a, grid, smem, st)
                    : launch_probe<MODE, false>(a, grid, smem, st);
}

// The four passes over a filled Args: probe (in probe_mode), then, with
// count_tiles, scan; with a.C > 0, pad and emit (variant keys when
// emit_var). Returns the first CUDA error of the launches, or success.
inline cudaError_t launch_passes(const Args& a, int probe_mode, bool emit_var, bool count_tiles,
                                 cudaStream_t st) {
  int dev = 0, sms = 132;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const long long nseg_total = (long long)a.D * a.nseg;
  const int grid = (int)(nseg_total < (long long)sms * 8 ? nseg_total : (long long)sms * 8);
  const bool smem_bloom = a.use_filter && (long long)a.num_words * 4 <= SMEM_BLOOM_MAX_BYTES;
  const int W = SEG + a.L - 1;
  const int per_tok =
      2 + (probe_mode == MODE_LSH ? a.bands * a.rows : probe_mode == MODE_VAR ? 2 : 0);
  const size_t smem = ((smem_bloom ? (size_t)a.num_words : 0) + (size_t)W * per_tok) * 4;

  cudaError_t err;
  if (probe_mode == MODE_LSH)
    err = launch_probe_mode<MODE_LSH>(a, smem_bloom, grid, smem, st);
  else if (probe_mode == MODE_VAR)
    err = launch_probe_mode<MODE_VAR>(a, smem_bloom, grid, smem, st);
  else
    err = launch_probe_mode<MODE_NONE>(a, smem_bloom, grid, smem, st);
  if (err != cudaSuccess) return err;
  if (!count_tiles) return cudaSuccess;
  const int G = (a.D + a.bd - 1) / a.bd;
  scan_kernel<<<G, 1024, 0, st>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  if (a.C <= 0) return cudaSuccess;
  const long long n = (long long)G * a.C;
  const long long pad_blocks = (n + 255) / 256;
  pad_kernel<<<(int)(pad_blocks < (long long)sms * 32 ? pad_blocks : (long long)sms * 32), 256, 0,
               st>>>(a, n);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  if (emit_var)
    emit_kernel<true><<<grid, SEG, 0, st>>>(a);
  else
    emit_kernel<false><<<grid, SEG, 0, st>>>(a);
  return cudaGetLastError();
}

}  // namespace


// Fused ISH-filter probe, window signatures and compaction epilogue.
//
// Replaces the TPU kernel src/repro/kernels/fused_probe.py:
// fused_probe_pallas (pallas_call at :561; body _kernel :395,
// _probe_recurrence :218, _emit_lane :350, _gather_lane_keys :382).
// The plain PyTorch form of the same function is
// repro_torch/kernels/fused_probe.py:fused_probe_plain; outputs are equal
// bit for bit.
//
// What bounds it on an H100: memory. The work per token is K Bloom
// probes, plus B*R (lsh) or 2 (variant) hashes and an L-step recurrence
// of integer operations; the bytes are the docs read once (D*T*4) and
// the function's uint32/int32 outputs written once: the packed bitmap
// (D*T*4), the dense signatures when asked for (D*T*L*S*4) and the lanes
// (G*C*4, plus G*C*8 variant keys). At 3.35 TB/s that is the floor
// chip_smoke.py reports as bound_ms. This kernel stores the uint32
// outputs in int64 slots, as the rest of the port carries hashes, so it
// writes twice those bytes: a gap to the bound of its own.
//
// Design:
//  * probe_kernel: one thread per window start (d, t). A block owns a
//    segment of SEG consecutive positions of one row; it stages the
//    segment's tokens plus an L-1 halo in shared memory with each token's
//    Bloom hit and its lsh or variant hashes computed once, then every
//    thread runs the L-step recurrence over shared memory in registers.
//    The Bloom words sit in shared memory when they fit
//    (SMEM_BLOOM_MAX_BYTES; 2^18 bits = 32 KiB) and are read through the
//    read-only cache (__ldg) otherwise. Blocks loop over segments so the
//    shared copy of the Bloom words is loaded once per block. Each block
//    writes one survivor count per segment.
//  * scan_kernel: one block per [bd, T] tile turns segment counts into
//    the tile's survivor count and each segment's exclusive offset. A
//    tile may span thousands of segments (bd = D when NC ~ D*T*L), so
//    the epilogue spans many CTAs per tile: count, scan, emit.
//  * pad_kernel: lane slots past the tile's count get -1 (keys 0).
//  * emit_kernel: per segment, a block scan of per-thread popcounts
//    gives each thread its first survivor's rank in the tile; survivors
//    are written in ascending flat order to ranks < C, reproducing the
//    reference's "first C survivors" lanes. Variant keys are recomputed
//    for the emitting threads only, so no dense key tensor is stored.
// The hashes and the block scan live in fused_probe.cuh, shared with the
// streamed form (fused_probe_stream.cu).
#include "fused_probe.cuh"

namespace {

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
};

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
    const long long flat0 = base * a.L;
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

extern "C" int fused_probe_segment() { return SEG; }

// Returns 0 or the first CUDA error of the launches. Pointers that a
// mode does not use may be null: sigs unless dense, counts and
// seg_counts unless count_tiles, cands and seg_offs unless C > 0, vkeys
// unless variant lanes are emitted.
extern "C" int fused_probe_launch(const int* docs, int D, int T, const uint32_t* bits,
                                  long long num_bits, int num_words, int num_hashes,
                                  int use_filter, int L, int sig_mode, int bands, int rows,
                                  int bd, int C, int count_tiles, int dense, long long* packed,
                                  long long* sigs, int* counts, int* cands, long long* vkeys,
                                  int* seg_counts, int* seg_offs, void* stream) {
  if (L < 1 || L > MAX_L || bands * rows > MAX_BR || bd < 1 || D < 1 || T < 1)
    return (int)cudaErrorInvalidValue;
  Args a;
  a.docs = docs;
  a.D = D;
  a.T = T;
  a.bits = bits;
  a.num_bits = (uint32_t)num_bits;
  a.num_words = num_words;
  a.num_hashes = num_hashes;
  a.use_filter = use_filter;
  a.L = L;
  a.bands = bands;
  a.rows = rows;
  a.bd = bd;
  a.C = C;
  a.dense = dense;
  a.nseg = (T + SEG - 1) / SEG;
  a.packed = packed;
  a.sigs = sigs;
  a.counts = counts;
  a.cands = cands;
  a.vkeys = vkeys;
  a.seg_counts = count_tiles ? seg_counts : nullptr;
  a.seg_offs = C > 0 ? seg_offs : nullptr;
  return (int)launch_passes(a, sig_mode, sig_mode == MODE_VAR, count_tiles != 0,
                            (cudaStream_t)stream);
}

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
// of integer operations, far under the int32 rate; the bytes are the docs
// read once (D*T*4) and the outputs written once: the packed bitmap, the
// dense signatures when asked for (D*T*L*S values), the tile counts and
// the lanes (G*C*4, plus G*C*2 variant keys). The function's own widths
// are 4 bytes a value; the port's contract keeps packed, sigs and keys in
// int64 slots, as the rest of the port carries hashes, so the kernel
// writes those twice: at phase A (D=1024, T=512, L=8, C=D*T*L, variant
// lanes) 54.6 MB at the function's widths, 90.2 MB at the contract's.
//
// Design: one launch per call, each output byte written once, by
// neighbouring threads on neighbouring addresses.
//  * Probe blocks take segments of SEG consecutive positions of one row
//    (SEG = 256 for L <= 8, 64 above, so that a segment has at most
//    2,048 survivors) in row-major order from an atomic ticket. A block
//    stages the segment's tokens plus an L-1 halo in shared memory with
//    each token's Bloom hit and its lsh or variant hashes computed once.
//    The Bloom words sit in shared memory when they fit
//    (SMEM_BLOOM_MAX_BYTES), loaded once per persistent block, and are
//    read through the read-only cache (__ldg) otherwise. Each thread runs
//    the L-step recurrence of one position in registers and writes its
//    packed word (one coalesced store per thread).
//  * Dense signatures (lsh, or variant without lanes): a segment's output
//    is one span of SEG*L*S values; each thread stages its values in
//    shared memory (rows padded to an odd stride of 8-byte words, so the
//    stores do not collide in banks), then the block writes the span with
//    16-byte stores. Where SEG*L*S values exceed the 32 KiB stage, the
//    lengths go in rounds of LG, each position's run of LG*S values
//    contiguous.
//  * Count and rank in the same launch: a block scan of the per-thread
//    popcounts gives each survivor its rank in the segment. A segment
//    publishes its total at once, stages its lanes, then ranks itself in
//    its [bd, T] tile by a decoupled look-back over the tile's earlier
//    segments, run by the whole block, SEG words a round
//    (fused_probe.cuh): a tile may hold thousands of segments (G = 1 at
//    phase A). A tile has rows*nseg segments, fewer in a last tile of
//    D % bd rows; its last segment writes the tile's count. count_only
//    needs no rank: each segment adds its total, and a done count, to
//    one word per tile, and the last to add writes the count.
//  * Emit from shared memory: each thread stages its survivors' flat
//    indices (and, in variant mode, their key pairs, computed from the
//    staged tokens and hashes) at their rank in the segment, then the
//    block writes the run [off, min(off + n, C)) of cands and vkeys as one
//    contiguous span (vkeys as 16-byte pairs).
//  * Padding: a tile has at most cap = rows*T*L survivors, so its lanes
//    [count, cap) are padding, and they split into one run per segment
//    without waiting for the count: segment j, with M_j slots missing
//    before it (its capacity prefix less its rank offset) and m_j of its
//    own, writes [cap - M_j - m_j, cap - M_j). Lanes from min(cap, C) to
//    C are padding whatever the counts: the grid's last blocks (fill
//    blocks) write them with 16-byte streaming stores while the probe
//    blocks run. No per-element division.
//  * Scratch: the ticket, then one look-back word per segment when lanes
//    are emitted, or one word per tile in count_only; the launch zeroes
//    only the words its mode uses (cudaMemsetAsync).
#include "fused_probe.cuh"

namespace {

constexpr int DENSE_STAGE = 4096;  // 8-byte values per dense round (32 KiB)
constexpr int FILL_THREADS_PER_SM = 512;

struct Args {
  const int* docs;
  int D, T, L, bd, nseg, C;
  const uint32_t* bits;
  uint32_t num_bits;
  int num_words, num_hashes, use_filter;
  int bands, rows;
  int count_tiles, dense, vec;
  int S, LG;  // dense values per (position, length); lengths per dense round
  int probe_blocks;  // the grid's first blocks probe; the rest fill
  // shared memory, in 4-byte words past the dense stage
  int off_bloom, off_lane, off_tok, lane_slots;
  long long* packed;
  long long* sigs;
  int* counts;
  int* cands;
  long long* vkeys;
  // [0]: ticket counter; [1 + s]: look-back word of segment s (count_only:
  // [1 + g]: tile g's done count and sum)
  unsigned long long* state;
};

// Positions per segment for windows of up to L tokens: at most 2,048
// survivors, the lane stage's size.
__host__ __device__ constexpr int segment_for(int L) { return L <= 8 ? 256 : 64; }

// Stage slot of local rank q: one word of padding every 32, so the
// threads of a warp, whose ranks step by about L, spread over the banks.
__device__ __forceinline__ int lane_slot(int q) { return q + (q >> 5); }

// Lanes -1 and keys 0 in [from, to) of tile g, by thread t of n.
__device__ __forceinline__ void fill_lanes(const Args& a, int g, long long from, long long to,
                                           long long t, long long n) {
  fill_span(a.cands + (long long)g * a.C, from, to, -1, t, n);
  if (a.vkeys != nullptr)
    fill_span(reinterpret_cast<int*>(a.vkeys) + 4LL * g * a.C, 4 * from, 4 * to, 0, t, n);
}

// Writes a dense round: positions [0, npos) of the segment, lengths
// [l0, l0 + RW / S), RW values each, staged with row stride SR.
__device__ __forceinline__ void write_dense(const Args& a, const long long* stage, int SR,
                                            long long* out, int npos, int RW, int nthreads) {
  const int LS = a.L * a.S;
  if (a.vec) {  // every run starts on a 16-byte boundary
    const int half = RW >> 1;
    const int n2 = npos * half;
    for (int j = threadIdx.x; j < n2; j += nthreads) {
      const int p = j / half;
      const int e = (j - p * half) * 2;
      const long long* src = stage + p * SR + e;
      *reinterpret_cast<longlong2*>(out + (long long)p * LS + e) = make_longlong2(src[0], src[1]);
    }
  } else {
    const int n = npos * RW;
    for (int i = threadIdx.x; i < n; i += nthreads) {
      const int p = i / RW;
      const int e = i - p * RW;
      out[(long long)p * LS + e] = stage[p * SR + e];
    }
  }
}

// BRMAX bounds the lsh row minima kept in registers (bands*rows <= BRMAX;
// 1 in the other modes): a loop unrolled to 32 with most rows unused
// costs the common 8 a quarter of the lsh head's time.
template <int SEGP, int MODE, int BRMAX, bool SMEM_BLOOM>
__global__ void __launch_bounds__(SEGP) fused_probe_kernel(Args a) {
  extern __shared__ __align__(16) uint32_t smem[];
  __shared__ int warp_tot[SEGP / 32];
  __shared__ long long s_seg;
  const int tid = threadIdx.x;
  if ((int)blockIdx.x >= a.probe_blocks) {  // a fill block
    const long long t = (long long)(blockIdx.x - a.probe_blocks) * SEGP + tid;
    const long long n = (long long)(gridDim.x - a.probe_blocks) * SEGP;
    for (int g = 0; g * a.bd < a.D; ++g) {
      const long long cap = (long long)min(a.bd, a.D - g * a.bd) * a.T * a.L;
      if (cap < a.C) fill_lanes(a, g, cap, a.C, t, n);
    }
    return;
  }
  const int L = a.L, S = a.S;
  const int W = SEGP + L - 1;  // staged tokens: segment + halo
  const int BR = a.bands * a.rows;
  const int SR = a.LG * S + 1;  // dense stage row stride, odd
  long long* s_dense = reinterpret_cast<long long*>(smem);
  const uint32_t* s_bloom = smem + a.off_bloom;
  int* s_cand = reinterpret_cast<int*>(smem + a.off_lane);
  uint32_t* s_k1 = smem + a.off_lane + a.lane_slots;
  uint32_t* s_k2 = s_k1 + a.lane_slots;
  uint32_t* s_tok = smem + a.off_tok;
  uint32_t* s_flag = s_tok + W;  // bit 0 real, bit 1 Bloom hit
  uint32_t* s_h = s_flag + W;    // lsh: BR*W row hashes; variant: 2*W
  if (SMEM_BLOOM) {  // 16-byte copies where the words are aligned (off_bloom is)
    uint32_t* dst = smem + a.off_bloom;
    int done = 0;
    if (((uintptr_t)a.bits & 15u) == 0) {
      done = a.num_words & ~3;
      for (int i = tid; i < done / 4; i += SEGP)
        reinterpret_cast<int4*>(dst)[i] = __ldg(reinterpret_cast<const int4*>(a.bits) + i);
    }
    for (int i = done + tid; i < a.num_words; i += SEGP) dst[i] = a.bits[i];
  }
  const long long nseg_total = (long long)a.D * a.nseg;
  const bool emit = a.C > 0;
  for (;;) {
    if (tid == 0) s_seg = (long long)atomicAdd(a.state, 1ull);
    __syncthreads();  // also: the Bloom words and the previous segment's stages are done
    const long long s = s_seg;
    if (s >= nseg_total) return;  // uniform over the block
    const int row = (int)(s / a.nseg);
    const int t0 = (int)(s - (long long)row * a.nseg) * SEGP;
    const int npos = min(SEGP, a.T - t0);
    const int* drow = a.docs + (long long)row * a.T;
    for (int i = tid; i < W; i += SEGP) {
      const int t = t0 + i;
      const bool in = t < a.T;
      const uint32_t x = in ? (uint32_t)drow[t] : 0u;
      const bool real = x != 0u;
      bool hit = real;
      if (a.use_filter) {
        hit = in;  // past the row end nothing hits (the reference's zero fill)
        for (int k = 0; k < a.num_hashes; ++k) {
          const uint32_t p = hash_seeded(x, BLOOM_SEED_BASE + k) % a.num_bits;
          const uint32_t w = SMEM_BLOOM ? s_bloom[p >> 5] : __ldg(a.bits + (p >> 5));
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
    const long long pos = (long long)row * a.T + t0 + tid;  // flat position of the thread

    // the L-step recurrence; dense signatures staged and written per round
    bool vand = true, vor = false;
    uint32_t pack = 0u;
    uint32_t rmin[BRMAX];
#pragma unroll
    for (int j = 0; j < BRMAX; ++j) rmin[j] = 0xFFFFFFFFu;
    uint32_t vs1 = 0u, vx1 = 0u, vs2 = 0u, vx2 = 0u, vcnt = 0u;
    for (int l0 = 0; l0 < L; l0 += a.LG) {
      const int l1 = min(L, l0 + a.LG);
      long long* st = s_dense + tid * SR - (long long)l0 * S;
      for (int l = l0; l < l1; ++l) {
        const int i = tid + l;
        const uint32_t f = s_flag[i];
        vand = vand && (f & 1u);
        vor = vor || (f & 2u);
        pack |= (uint32_t)(vand && vor) << l;
        if (MODE == MODE_LSH) {
          uint32_t band = 0u;
          int r = 0, b = 0;
#pragma unroll
          for (int j = 0; j < BRMAX; ++j) {
            if (j < BR) {
              rmin[j] = min(rmin[j], s_h[j * W + i]);
              band = r == 0 ? rmin[j] : combine(band, rmin[j]);
              if (++r == a.rows) {
                st[l * S + b] = combine(band, (uint32_t)(b + 1));
                ++b;
                r = 0;
              }
            }
          }
        }
        if (MODE == MODE_VAR && a.dense) {
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
          const uint32_t fin = vcnt * GOLDEN;
          st[l * 2] = mix(vs1 ^ (vx1 * C1) ^ fin);
          st[l * 2 + 1] = mix(vs2 ^ (vx2 * C1) ^ fin);
        }
      }
      if (a.dense) {  // uniform over the block
        __syncthreads();
        long long* out = a.sigs + (pos - tid) * L * S + (long long)l0 * S;
        write_dense(a, s_dense, SR, out, npos, (l1 - l0) * S, SEGP);
        __syncthreads();
      }
    }
    if (tid < npos) a.packed[pos] = pack;
    if (!a.count_tiles) continue;  // uniform; the next ticket's barrier orders the stages

    const int c = __popc(pack);
    int total;
    const int incl = block_inclusive_scan<SEGP / 32>(c, warp_tot, &total);
    const int g = row / a.bd;
    const int rows_g = min(a.bd, a.D - g * a.bd);
    if (!emit) {  // count_only: the tile's count is the sum of its segments' totals
      if (tid == 0) {
        // one word per tile: segments done in the high 32 bits, their sum
        // in the low 32 bits; the last segment to add writes the count
        const unsigned long long old =
            atomicAdd(a.state + 1 + g, (1ull << 32) | (unsigned)total);
        if ((long long)(old >> 32) == (long long)rows_g * a.nseg - 1)
          a.counts[g] = (int)(unsigned)old + total;
      }
      continue;  // the scan's last barrier and the next ticket's order the stages
    }
    const long long j = s - (long long)g * a.bd * a.nseg;  // the segment's index in its tile
    // publish the total at once (the tile's first segment: its prefix),
    // stage the lanes, then rank the segment in its tile
    if (tid == 0) publish_total(a.state + 1, s, j, total);
    if (pack != 0u) {
      int q = incl - c;  // the thread's first survivor's rank in the segment
      // global flat index of (row, t, l = 0), in 64 bits before the cast;
      // the caller bounds the index space below 2^31
      const long long flat0 = pos * L;
      if (MODE != MODE_VAR) {
        for (uint32_t p = pack; p != 0u; p &= p - 1u, ++q)
          s_cand[lane_slot(q)] = (int)(flat0 + __ffs(p) - 1);
      } else {
        // the key recurrence up to the last survivor, over the staged tokens
        uint32_t ks1 = 0u, kx1 = 0u, ks2 = 0u, kx2 = 0u, kcnt = 0u;
        const int last = 31 - __clz(pack);
        for (int l = 0; l <= last; ++l) {
          const uint32_t x = s_tok[tid + l];
          bool dup = false;
          for (int k = 0; k < l; ++k) dup = dup || (s_tok[tid + k] == x);
          if (x != 0u && !dup) {
            const uint32_t h1 = s_h[tid + l], h2 = s_h[W + tid + l];
            ks1 += h1;
            kx1 ^= h1;
            ks2 += h2;
            kx2 ^= h2;
            ++kcnt;
          }
          if ((pack >> l) & 1u) {
            const uint32_t fin = kcnt * GOLDEN;
            const int slot = lane_slot(q++);
            s_cand[slot] = (int)(flat0 + l);
            s_k1[slot] = mix(ks1 ^ (kx1 * C1) ^ fin);
            s_k2[slot] = mix(ks2 ^ (kx2 * C1) ^ fin);
          }
        }
      }
    }
    const int off = look_back<SEGP>(a.state + 1, s, j, total, warp_tot);
    if (tid == 0 && j == (long long)rows_g * a.nseg - 1) a.counts[g] = off + total;
    __syncthreads();  // the stage is complete
    const long long lane0 = (long long)g * a.C;
    const int m = max(0, min(total, a.C - off));
    for (int q = tid; q < m; q += SEGP) {
      const int slot = lane_slot(q);
      a.cands[lane0 + off + q] = s_cand[slot];
      if (MODE == MODE_VAR)
        *reinterpret_cast<longlong2*>(a.vkeys + 2 * (lane0 + off + q)) =
            make_longlong2(s_k1[slot], s_k2[slot]);
    }
    // this segment's share of the padding [count, cap), from the end
    const long long cap = (long long)rows_g * a.T * L;
    const long long missing_before = ((long long)(row - g * a.bd) * a.T + t0) * L - off;
    const long long hi = cap - missing_before;
    const long long lo = hi - ((long long)npos * L - total);
    const long long end = min(hi, (long long)a.C);
    for (long long q = lo + tid; q < end; q += SEGP) {
      a.cands[lane0 + q] = -1;
      if (MODE == MODE_VAR)
        *reinterpret_cast<longlong2*>(a.vkeys + 2 * (lane0 + q)) = make_longlong2(0, 0);
    }
  }
}

template <int SEGP, int MODE, int BRMAX, bool SMEM_BLOOM>
cudaError_t launch(Args& a, bool fill, size_t smem, cudaStream_t st) {
  auto kern = fused_probe_kernel<SEGP, MODE, BRMAX, SMEM_BLOOM>;
  // the device's SM count and the resident blocks per SM at this shared
  // memory size, kept from the last launch of this instance
  static int cached_dev = -1, sms = 0, per_sm = 0;
  static size_t cached_smem = 0;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev != cached_dev || smem != cached_smem) {
    err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, SEGP, smem);
    if (err != cudaSuccess) return err;
    cached_dev = dev;
    cached_smem = smem;
  }
  const long long nseg_total = (long long)a.D * a.nseg;
  const long long resident = (long long)sms * (per_sm > 0 ? per_sm : 1);
  a.probe_blocks = (int)(nseg_total < resident ? nseg_total : resident);
  const int fill_blocks = fill ? sms * FILL_THREADS_PER_SM / SEGP : 0;
  kern<<<a.probe_blocks + fill_blocks, SEGP, smem, st>>>(a);
  return cudaGetLastError();
}

template <int SEGP, int MODE, int BRMAX>
cudaError_t launch_bloom(Args& a, bool smem_bloom, bool fill, size_t smem, cudaStream_t st) {
  return smem_bloom ? launch<SEGP, MODE, BRMAX, true>(a, fill, smem, st)
                    : launch<SEGP, MODE, BRMAX, false>(a, fill, smem, st);
}

template <int SEGP>
cudaError_t launch_mode(Args& a, int mode, bool smem_bloom, bool fill, size_t smem,
                        cudaStream_t st) {
  if (mode == MODE_LSH && a.bands * a.rows <= 8)
    return launch_bloom<SEGP, MODE_LSH, 8>(a, smem_bloom, fill, smem, st);
  if (mode == MODE_LSH) return launch_bloom<SEGP, MODE_LSH, MAX_BR>(a, smem_bloom, fill, smem, st);
  if (mode == MODE_VAR) return launch_bloom<SEGP, MODE_VAR, 1>(a, smem_bloom, fill, smem, st);
  return launch_bloom<SEGP, MODE_NONE, 1>(a, smem_bloom, fill, smem, st);
}

}  // namespace

// Positions per segment for windows of up to L tokens: the wrapper sizes
// the scratch by it.
extern "C" int fused_probe_segment(int L) { return segment_for(L); }

// Returns 0 or the first CUDA error of the launch. Pointers that a mode
// does not use may be null: sigs unless dense, counts unless count_tiles,
// cands unless C > 0, vkeys unless variant lanes are emitted. state holds
// the scratch, zeroed here: 1 + D * ceil(T / segment) words when C > 0,
// 1 + ceil(D / bd) in count_only, 1 otherwise.
extern "C" int fused_probe_launch(const int* docs, int D, int T, const uint32_t* bits,
                                  long long num_bits, int num_words, int num_hashes,
                                  int use_filter, int L, int sig_mode, int bands, int rows,
                                  int bd, int C, int count_tiles, int dense, long long* packed,
                                  long long* sigs, int* counts, int* cands, long long* vkeys,
                                  unsigned long long* state, void* stream) {
  if (L < 1 || L > MAX_L || bands < 1 || rows < 1 || bands * rows > MAX_BR || bd < 1 || D < 1 ||
      T < 1 || C < 0 || (C > 0 && !count_tiles) || (sig_mode == MODE_LSH && !dense) ||
      (dense && sig_mode != MODE_LSH && sig_mode != MODE_VAR))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int seg = segment_for(L);
  Args a;
  a.docs = docs;
  a.D = D;
  a.T = T;
  a.L = L;
  a.bd = bd;
  a.nseg = (T + seg - 1) / seg;
  a.C = C;
  a.bits = bits;
  a.num_bits = (uint32_t)num_bits;
  a.num_words = num_words;
  a.num_hashes = num_hashes;
  a.use_filter = use_filter;
  a.bands = bands;
  a.rows = rows;
  a.count_tiles = count_tiles;
  a.dense = dense;
  a.S = sig_mode == MODE_LSH ? bands : 2;
  a.LG = L;
  if (dense) {
    const int lg = DENSE_STAGE / (seg * a.S);
    a.LG = lg < 1 ? 1 : lg < L ? lg : L;
  }
  a.vec = (L * a.S) % 2 == 0 && (a.LG * a.S) % 2 == 0 && ((L % a.LG) * a.S) % 2 == 0;
  a.packed = packed;
  a.sigs = sigs;
  a.counts = counts;
  a.cands = cands;
  a.vkeys = sig_mode == MODE_VAR && C > 0 ? vkeys : nullptr;
  a.state = state;

  // shared memory: the dense stage (8-byte values), then 4-byte words:
  // the Bloom words, the lane stage (cands, and both keys in variant
  // mode), the staged tokens, their flags and hashes
  const bool smem_bloom = use_filter && (long long)num_words * 4 <= SMEM_BLOOM_MAX_BYTES;
  const int W = seg + L - 1;
  const int dense_words = dense ? 2 * seg * (a.LG * a.S + 1) : 0;
  a.lane_slots = C > 0 ? seg * L + seg * L / 32 : 0;
  a.off_bloom = dense_words;
  a.off_lane = a.off_bloom + (smem_bloom ? num_words : 0);
  a.off_tok = a.off_lane + a.lane_slots * (a.vkeys != nullptr ? 3 : 1);
  const int per_tok =
      2 + (sig_mode == MODE_LSH ? bands * rows : sig_mode == MODE_VAR ? 2 : 0);
  const size_t smem = ((size_t)a.off_tok + (size_t)W * per_tok) * 4;

  const long long scratch =
      1 + (C > 0 ? (long long)D * a.nseg : count_tiles ? (long long)(D + bd - 1) / bd : 0);
  cudaError_t err = cudaMemsetAsync(state, 0, (size_t)scratch * sizeof(*state), st);
  if (err != cudaSuccess) return (int)err;
  // a last tile of D % bd rows has the smallest capacity
  const int last_rows = D - (D - 1) / bd * bd;
  const bool fill = C > 0 && (long long)last_rows * T * L < C;
  err = seg == 256 ? launch_mode<256>(a, sig_mode, smem_bloom, fill, smem, st)
                   : launch_mode<64>(a, sig_mode, smem_bloom, fill, smem, st);
  return (int)err;
}

// Streamed fused probe: the per-tile probe and compaction epilogue over
// a whole shard of G [bd, T] chunks in one call.
//
// Replaces the TPU kernel src/repro/kernels/fused_probe.py:
// fused_probe_stream_pallas (pallas_call at :777; body _stream_kernel
// :598). The plain PyTorch form of the same function is
// repro_torch/kernels/fused_probe.py:fused_probe_stream_plain; outputs
// are equal bit for bit.
//
// What it computes: for chunk g (rows [g*bd, (g+1)*bd) of the pre-padded
// docs), the true survivor count and the first C survivors as global
// flat indices row_offs[g]*T*L + ((r - g*bd)*T + t)*L + l, ascending,
// -1 padded, plus their variant key pairs (sig_mode variant; uint32
// pairs, 0 padded). With C == 0 (count_only) only the counts. No packed
// bitmap and no dense signatures leave the function.
//
// What bounds it on an H100: memory. The function reads the docs once
// (G*bd*T*4 bytes) and writes counts (G*4), lanes (G*C*4) and variant
// keys (G*C*8). Where C is the merge capacity NC (~D*T*L), the lanes are
// almost all padding: at one shard of 256 x 512 tokens, L = 8, G = 4 and
// C = 4,194,304 that is 201 MB written for at most 1 M survivors. The
// integer work per token (K Bloom probes and an L-step recurrence) is far
// under the int32 rate.
//
// Design: two launches, each output byte written once.
//  * stream_probe_kernel, probe blocks: one block per segment of SEG
//    positions of one row, handed out in row-major order by an atomic
//    ticket. The block
//    stages the segment's tokens plus an L-1 halo in shared memory with
//    each token's Bloom hit (and variant hashes) computed once, runs the
//    L-step recurrence per position in registers, and sums its survivors
//    with a block scan. A decoupled look-back over the earlier segments
//    of the same chunk (each publishes its total, then its inclusive
//    prefix, in one 64-bit word; the block reads SEG of them a round,
//    fused_probe.cuh) gives the segment's first rank in its chunk; the
//    ticket order makes every segment it waits on already running. The
//    survivors with rank < C are written straight away, with their
//    variant keys recomputed from shared memory: the survival bitmap
//    never leaves the block. The chunk's last segment writes the chunk's
//    count.
//  * stream_probe_kernel, fill blocks (the grid's last blocks): a chunk
//    has at most cap = bd*T*L survivors, so its lanes and keys from
//    min(cap, C) to C are padding whatever the counts: they get -1 and 0
//    with 16-byte streaming stores while the probe blocks run. At phase
//    C's shapes that is 94% of the bytes.
//  * lane_fill_kernel: the rest of the padding, from min(count, C) to
//    min(cap, C), the chunk read from the y grid index (no per-element
//    division).
#include "fused_probe.cuh"

namespace {

constexpr int FILL_THREADS = 256;

struct StreamArgs {
  const int* docs;
  int R, T, L, bd, nseg, C;
  int probe_blocks;  // the grid's first blocks probe; the rest fill
  const int* row_offs;
  const uint32_t* bits;
  uint32_t num_bits;
  int num_hashes, use_filter;
  int* counts;
  int* cands;
  uint2* keys;
  // [0]: ticket counter; [1 + s]: look-back word of segment s (zeroed
  // before the launch)
  unsigned long long* state;
};

// Lanes -1 and keys 0 in [from, to) of chunk g's rows.
__device__ __forceinline__ void fill_lanes(const StreamArgs& a, int g, long long from,
                                           long long to, long long t, long long n) {
  fill_span(a.cands + (long long)g * a.C, from, to, -1, t, n);
  if (a.keys != nullptr)
    fill_span(reinterpret_cast<int*>(a.keys) + 2LL * g * a.C, 2 * from, 2 * to, 0, t, n);
}

template <bool EMIT, bool VAR>
__global__ void __launch_bounds__(SEG) stream_probe_kernel(StreamArgs a) {
  extern __shared__ uint32_t smem[];
  __shared__ int warp_tot[SEG / 32];
  __shared__ long long s_seg;
  if ((int)blockIdx.x >= a.probe_blocks) {  // a fill block
    const long long cap = (long long)a.bd * a.T * a.L;
    const long long t = (long long)(blockIdx.x - a.probe_blocks) * SEG + threadIdx.x;
    const long long n = (long long)(gridDim.x - a.probe_blocks) * SEG;
    for (int g = 0; g < a.R / a.bd; ++g) fill_lanes(a, g, cap < a.C ? cap : a.C, a.C, t, n);
    return;
  }
  const int W = SEG + a.L - 1;  // staged tokens: segment + halo
  uint32_t* s_tok = smem;
  uint32_t* s_flag = s_tok + W;  // bit 0 real, bit 1 Bloom hit
  uint32_t* s_h = s_flag + W;    // variant: both key hashes of each token
  const int tid = threadIdx.x;
  const long long nseg_total = (long long)a.R * a.nseg;
  const long long chunk_segs = (long long)a.bd * a.nseg;
  for (;;) {
    if (tid == 0) s_seg = (long long)atomicAdd(a.state, 1ull);
    __syncthreads();
    const long long s = s_seg;
    if (s >= nseg_total) return;  // uniform over the block
    const int row = (int)(s / a.nseg);
    const int t0 = (int)(s - (long long)row * a.nseg) * SEG;
    const int g = row / a.bd;
    const int* drow = a.docs + (long long)row * a.T;
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
          hit = hit && ((__ldg(a.bits + (p >> 5)) >> (p & 31u)) & 1u);
        }
      }
      s_tok[i] = x;
      s_flag[i] = (real ? 1u : 0u) | (hit ? 2u : 0u);
      if (VAR) {
        s_h[i] = hash_seeded(x, VARIANT_SEED1);
        s_h[W + i] = hash_seeded(x, VARIANT_SEED2);
      }
    }
    __syncthreads();
    const int t = t0 + tid;
    uint32_t pack = 0u;
    if (t < a.T) {
      bool vand = true, vor = false;
      for (int l = 0; l < a.L; ++l) {
        const uint32_t f = s_flag[tid + l];
        vand = vand && (f & 1u);
        vor = vor || (f & 2u);
        pack |= (uint32_t)(vand && vor) << l;
      }
    }
    const int c = __popc(pack);
    int total;
    const int incl = block_inclusive_scan<SEG / 32>(c, warp_tot, &total);
    const long long j = s - (long long)g * chunk_segs;
    if (tid == 0) publish_total(a.state + 1, s, j, total);
    const int off = look_back<SEG>(a.state + 1, s, j, total, warp_tot);
    if (tid == 0 && j == chunk_segs - 1) a.counts[g] = off + total;
    int r = off + incl - c;  // rank of the thread's first survivor in its chunk
    if (EMIT && pack != 0u && r < a.C) {
      const long long lane0 = (long long)g * a.C;
      // global flat index of (row, t, l = 0), in 64 bits before the
      // cast; the caller bounds the index space below 2^31
      const long long flat0 =
          ((long long)a.row_offs[g] * a.T + (long long)(row - g * a.bd) * a.T + t) * a.L;
      if (!VAR) {
        for (uint32_t p = pack; p != 0u && r < a.C; p &= p - 1u, ++r)
          a.cands[lane0 + r] = (int)(flat0 + __ffs(p) - 1);
      } else {
        // the key recurrence up to the last survivor, over the staged tokens
        uint32_t vs1 = 0u, vx1 = 0u, vs2 = 0u, vx2 = 0u, vcnt = 0u;
        const int last = 31 - __clz(pack);
        for (int l = 0; l <= last && r < a.C; ++l) {
          const uint32_t x = s_tok[tid + l];
          bool dup = false;
          for (int q = 0; q < l; ++q) dup = dup || (s_tok[tid + q] == x);
          if (x != 0u && !dup) {
            const uint32_t h1 = s_h[tid + l], h2 = s_h[W + tid + l];
            vs1 += h1;
            vx1 ^= h1;
            vs2 += h2;
            vx2 ^= h2;
            ++vcnt;
          }
          if ((pack >> l) & 1u) {
            const uint32_t fin = vcnt * GOLDEN;
            a.cands[lane0 + r] = (int)(flat0 + l);
            a.keys[lane0 + r] =
                make_uint2(mix(vs1 ^ (vx1 * C1) ^ fin), mix(vs2 ^ (vx2 * C1) ^ fin));
            ++r;
          }
        }
      }
    }
    __syncthreads();  // shared memory and s_seg are reused for the next ticket
  }
}

__global__ void __launch_bounds__(FILL_THREADS)
    lane_fill_kernel(StreamArgs a, const int* counts) {
  const long long cap = (long long)a.bd * a.T * a.L;
  const long long t = (long long)blockIdx.x * FILL_THREADS + threadIdx.x;
  const long long n = (long long)gridDim.x * FILL_THREADS;
  for (int g = blockIdx.y; g < a.R / a.bd; g += gridDim.y) {
    const long long end = cap < a.C ? cap : a.C;
    fill_lanes(a, g, counts[g] < end ? counts[g] : end, end, t, n);
  }
}

}  // namespace

extern "C" int fused_probe_stream_segment() { return SEG; }

// Returns 0 or the first CUDA error of the launches. docs is [R, T] with
// R = G * bd; row_offs [G]; counts [G]; C == 0 means count_only (cands
// and keys may then be null); keys ([G, C] uint32 pairs) is null unless
// sig_mode is variant; state holds 1 + R * ceil(T / SEG) words of
// scratch, zeroed here.
extern "C" int fused_probe_stream_launch(const int* docs, int R, int T, const int* row_offs,
                                         const uint32_t* bits, long long num_bits,
                                         int num_hashes, int use_filter, int L, int sig_mode,
                                         int bd, int C, int* counts, int* cands, uint32_t* keys,
                                         unsigned long long* state, void* stream) {
  if (L < 1 || L > MAX_L || bd < 1 || R < 1 || T < 1 || R % bd != 0 || C < 0 ||
      (sig_mode != MODE_NONE && sig_mode != MODE_VAR))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  StreamArgs a;
  a.docs = docs;
  a.R = R;
  a.T = T;
  a.L = L;
  a.bd = bd;
  a.nseg = (T + SEG - 1) / SEG;
  a.C = C;
  a.row_offs = row_offs;
  a.bits = bits;
  a.num_bits = (uint32_t)num_bits;
  a.num_hashes = num_hashes;
  a.use_filter = use_filter;
  a.counts = counts;
  a.cands = cands;
  a.keys = reinterpret_cast<uint2*>(keys);
  a.state = state;
  const long long nseg_total = (long long)R * a.nseg;
  cudaError_t err = cudaMemsetAsync(state, 0, (size_t)(1 + nseg_total) * sizeof(*state), st);
  if (err != cudaSuccess) return (int)err;

  int dev = 0, sms = 132;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  a.probe_blocks = (int)(nseg_total < (long long)sms * 8 ? nseg_total : (long long)sms * 8);
  const long long cap = (long long)bd * T * L;  // survivors a chunk can have
  const int fill_blocks = C > cap ? sms * 4 : 0;
  const bool var = C > 0 && sig_mode == MODE_VAR;
  if (!var) a.keys = nullptr;
  const size_t smem = (size_t)(SEG + L - 1) * (var ? 4 : 2) * sizeof(uint32_t);
  const int grid = a.probe_blocks + fill_blocks;
  if (C == 0)
    stream_probe_kernel<false, false><<<a.probe_blocks, SEG, smem, st>>>(a);
  else if (var)
    stream_probe_kernel<true, true><<<grid, SEG, smem, st>>>(a);
  else
    stream_probe_kernel<true, false><<<grid, SEG, smem, st>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess || C == 0) return (int)err;

  const int G = R / bd;
  const long long span = (C < cap ? C : cap) * (var ? 2 : 1);  // widest row of the fill
  const long long want_x = (span / 4 + FILL_THREADS - 1) / FILL_THREADS + 1;
  dim3 fgrid;
  fgrid.y = G < 65535 ? G : 65535;
  const long long x = (long long)sms * 8 / fgrid.y;
  fgrid.x = (unsigned)(x < 1 ? 1 : x < want_x ? x : want_x);
  lane_fill_kernel<<<fgrid, FILL_THREADS, 0, st>>>(a, counts);
  return (int)cudaGetLastError();
}

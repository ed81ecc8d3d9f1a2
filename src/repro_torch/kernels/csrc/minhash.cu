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
// What bounds it on an H100: integer dispatch and memory traffic about
// equally at rows of 8 tokens, integer dispatch at rows of 40. Per row it
// reads L tokens and L validity bytes and writes B int64 slots, and it
// evaluates L*B*R hashes (a murmur3 finaliser, ~10 int32 instructions
// each) and B*R combines. An SM dispatches four 32-lane instructions a clock,
// its multiplies on the FMA pipe and the rest on the ALU pipe, so at the
// 1.98 GHz boost clock 33.4e12 instructions a second: at 1 M rows of
// L = 8 and 4 x 2 bands, 67 M hashes take 0.020 ms of dispatch against
// 75.5 MB (0.0225 ms at 3.35 TB/s); at 655,360 rows of L = 40 and 2 x 8,
// 419 M hashes take 0.125 ms against 142 MB (0.042 ms).
// scripts/minhash_hash_rate.py reads the hash loop's SASS and times it
// alone on the card.
//
// What the first design lost: it read tokens 4 bytes at a time, branched
// on each validity byte (a load -> branch -> load chain per token,
// divergent between rows with different PAD patterns), ran 32 unrolled
// seed steps guarded by a runtime j < B*R whatever B*R was, refused more
// than 32 row minima, and wrote scattered 8-byte outputs.
//
// Design: one thread per row, the row's B*R running minima in registers
// (each token loaded once for all of them):
//  * compile-time shape: instances keep CH = 8, 16 or 32 minima; rows of
//    8 tokens have an instance of their own, a generic one takes any L.
//    The hash loop has no guard; seed offsets are constants. Above 32
//    minima the seeds go in chunks of 32, each chunk re-reading the row;
//    a band may straddle two chunks (its running combine lives in a
//    register).
//  * no branch on validity: each token's mask m is 0 (valid) or
//    0xFFFFFFFF, or-ed into the finaliser's last xor (one LOP3), so
//    min(rmin, h | m) skips invalid tokens with no extra instruction and a
//    row without a valid token keeps the 0xFFFFFFFF start value. Every
//    lane of a warp runs the same instructions. The hash loop is ~10
//    instructions a hash (scripts/minhash_hash_rate.py reads the SASS).
//  * 16-byte loads: a row's tokens come as int4 groups and its validity
//    bytes as one word per group. Rows of 8 tokens (minhash_rows_kernel)
//    load whole and hash fully unrolled. Longer rows (minhash_walk_kernel)
//    walk the steps (row, seed chunk, group) with the next step's loads in
//    flight while the current group hashes, across rows too (rows of 40
//    tokens unrolled whole ran slower: registers and code size). Rows
//    whose length is not a multiple of 4, or misaligned tensors, load
//    token by token into the same registers.
//  * outputs: with B even, two bands a 16-byte store, where one 8-byte
//    store a band was slower.
// Tried on the card and not kept (development runs; PERF.md, Findings):
// staging tiles in shared memory with cp.async (two to four buffers, rows
// compacted to their valid tokens and dealt to warps by count), whose
// staging alone was slower than this kernel's loads and did not overlap
// the hashing; the finaliser's shifts as umulhi on the FMA pipe (slower);
// an instance for rows of 40 tokens (no faster than the generic one).
// Hash values are 32-bit; the output is int64 slots holding the uint32
// values, the port's convention for hashes.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BLOCK = 128;
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
__device__ __forceinline__ uint32_t combine(uint32_t h, uint32_t g) {
  return mix(h ^ (g + GOLDEN + (h << 6) + (h >> 2)));
}
// mix(a) | m: 0xFFFFFFFF where m is; one LOP3 for the last xor and the or
__device__ __forceinline__ uint32_t masked_mix(uint32_t a, uint32_t m) {
  a ^= a >> 16;
  a *= C1;
  a ^= a >> 13;
  a *= C2;
  return (a ^ (a >> 16)) | m;
}

struct Args {
  const int* tokens;
  const uint8_t* valid;
  long long* out;
  long long N;
  int L, bands, rows;
  int nsc;        // seed chunks of CH
  int vec;        // 16-byte loads (L % 4 == 0, aligned tensors)
  int pairs;      // bands stored two at a time (16 bytes; B even, out aligned)
};

// Tokens 4q .. 4q+3 of a row and their masks (past L: masked); VEC: one
// 16-byte and one 4-byte load.
template <bool VEC>
__device__ __forceinline__ void load4(const Args& a, const int* tr, const uint8_t* vr, int q,
                                      uint32_t (&x)[4], uint32_t (&m)[4]) {
  if constexpr (VEC) {
    const int4 v = __ldg(reinterpret_cast<const int4*>(tr) + q);
    const uint32_t w = __ldg(reinterpret_cast<const uint32_t*>(vr) + q);
    x[0] = v.x, x[1] = v.y, x[2] = v.z, x[3] = v.w;
#pragma unroll
    for (int k = 0; k < 4; ++k) m[k] = (w >> (8 * k)) & 0xFFu ? 0u : ~0u;
  } else {
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int l = 4 * q + k;
      const bool in = l < a.L;
      x[k] = in ? (uint32_t)__ldg(tr + l) : 0u;
      m[k] = in && __ldg(vr + l) ? 0u : ~0u;
    }
  }
}
// Instances with a known row length load 16 bytes at a time.
template <int NQ>
__device__ __forceinline__ void load_group(const Args& a, const int* tr, const uint8_t* vr,
                                           int q, uint32_t (&x)[4], uint32_t (&m)[4]) {
  if (NQ > 0 || a.vec)
    load4<true>(a, tr, vr, q, x, m);
  else
    load4<false>(a, tr, vr, q, x, m);
}

// Folds seeds sc*CH .. sc*CH + CH - 1 of a row into its bands, in order,
// and stores each finished band (with B even, two a 16-byte store).
template <int CH>
__device__ __forceinline__ void fold(const Args& a, const uint32_t (&rmin)[CH], int sc,
                                     long long row, uint32_t& band, uint32_t& held, int& r_in,
                                     int& b) {
  const int BR = a.bands * a.rows;
#pragma unroll
  for (int jj = 0; jj < CH; ++jj) {
    if (sc * CH + jj < BR) {
      band = r_in == 0 ? rmin[jj] : combine(band, rmin[jj]);
      if (++r_in == a.rows) {
        const uint32_t sig = combine(band, (uint32_t)(b + 1));
        if (row < a.N) {
          if (!a.pairs)
            a.out[row * a.bands + b] = (long long)sig;
          else if (b & 1)  // bands b - 1 and b
            *reinterpret_cast<longlong2*>(a.out + row * a.bands + b - 1) =
                make_longlong2((long long)held, (long long)sig);
        }
        held = sig;
        ++b;
        r_in = 0;
      }
    }
  }
}

// Hashes one token group into the CH running minima.
template <int CH>
__device__ __forceinline__ void hash_group(uint32_t (&rmin)[CH], const uint32_t (&x)[4],
                                           const uint32_t (&m)[4], uint32_t base) {
#pragma unroll
  for (int jj = 0; jj < CH; ++jj) {
    const uint32_t c = GOLDEN * (uint32_t)jj;
#pragma unroll
    for (int k = 0; k < 4; ++k) rmin[jj] = min(rmin[jj], masked_mix(x[k] + base + c, m[k]));
  }
}

// Short rows (NQ groups, 16-byte aligned): a thread loads its whole row at
// once and hashes it, fully unrolled; rows a grid stride apart.
template <int CH, int NQ>
__global__ void __launch_bounds__(BLOCK) minhash_rows_kernel(Args a) {
  for (long long n = (long long)blockIdx.x * BLOCK + threadIdx.x; n < a.N;
       n += (long long)gridDim.x * BLOCK) {
    uint32_t x[NQ][4], m[NQ][4];
#pragma unroll
    for (int q = 0; q < NQ; ++q)
      load_group<NQ>(a, a.tokens + n * a.L, a.valid + n * a.L, q, x[q], m[q]);
    uint32_t band = 0u, held = 0u;  // held: an even band's signature, until its pair
    int r_in = 0, b = 0;
    for (int sc = 0; sc < a.nsc; ++sc) {
      const uint32_t base = GOLDEN * (LSH_SEED_BASE + 1u + (uint32_t)(sc * CH));
      uint32_t rmin[CH];
#pragma unroll
      for (int jj = 0; jj < CH; ++jj) rmin[jj] = 0xFFFFFFFFu;
#pragma unroll
      for (int q = 0; q < NQ; ++q) hash_group<CH>(rmin, x[q], m[q], base);
      fold<CH>(a, rmin, sc, n, band, held, r_in, b);
    }
  }
}

// Longer rows: each thread walks the steps (row, seed chunk, token group)
// of its rows in order, the next step's group loading while the current
// one hashes, across rows too: a thread's next row is a grid stride on,
// and a warp's lanes take neighbouring rows.
template <int CH, int NQ>
__global__ void __launch_bounds__(BLOCK) minhash_walk_kernel(Args a) {
  const int lane = threadIdx.x & 31;
  const int nq = NQ > 0 ? NQ : (a.L + 3) >> 2;
  const long long stride = (long long)gridDim.x * BLOCK;
  long long n0 = (long long)blockIdx.x * BLOCK + (threadIdx.x & ~31);  // the warp's first row
  auto row_ptrs = [&](long long w0, const int*& tr, const uint8_t*& vr) {
    const long long n = min(w0 + lane, a.N - 1);  // lanes past N read row N - 1, write nothing
    tr = a.tokens + n * a.L;
    vr = a.valid + n * a.L;
  };
  const int* tr;
  const uint8_t* vr;
  row_ptrs(n0, tr, vr);
  uint32_t x[4], m[4];
  if (n0 < a.N) load_group<NQ>(a, tr, vr, 0, x, m);
  uint32_t rmin[CH];
  uint32_t band = 0u, held = 0u;
  int sc = 0, q = 0, r_in = 0, b = 0;
  while (n0 < a.N) {
    uint32_t xc[4], mc[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) xc[k] = x[k], mc[k] = m[k];
    // the next step, and its group's loads
    const int* tr_next = tr;
    const uint8_t* vr_next = vr;
    int q_next = q + 1, sc_next = sc;
    long long n0_next = n0;
    if (q_next == nq) {
      q_next = 0;
      if (++sc_next == a.nsc) {
        sc_next = 0;
        n0_next += stride;
        row_ptrs(n0_next, tr_next, vr_next);
      }
    }
    if (n0_next < a.N) load_group<NQ>(a, tr_next, vr_next, q_next, x, m);
    if (q == 0) {
#pragma unroll
      for (int jj = 0; jj < CH; ++jj) rmin[jj] = 0xFFFFFFFFu;
    }
    hash_group<CH>(rmin, xc, mc, GOLDEN * (LSH_SEED_BASE + 1u + (uint32_t)(sc * CH)));
    if (q == nq - 1) {
      fold<CH>(a, rmin, sc, n0 + lane, band, held, r_in, b);
      if (sc == a.nsc - 1) b = 0;
    }
    n0 = n0_next, q = q_next, sc = sc_next, tr = tr_next, vr = vr_next;
  }
}

// Per kernel instance: the device last launched on, its SM count and the
// instance's resident blocks per SM there.
struct Fit {
  int dev = -1, sms = 0, per_sm = 0;
};

template <typename Kernel>
cudaError_t launch(Kernel kern, const Args& a, Fit& fit, cudaStream_t st) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev != fit.dev) {
    err = cudaDeviceGetAttribute(&fit.sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&fit.per_sm, kern, BLOCK, 0);
    if (err != cudaSuccess) return err;
    fit.dev = dev;
  }
  const long long blocks = (a.N + BLOCK - 1) / BLOCK;
  const long long cap = (long long)fit.sms * (fit.per_sm > 0 ? fit.per_sm : 1);
  kern<<<(int)(blocks < cap ? blocks : cap), BLOCK, 0, st>>>(a);
  return cudaGetLastError();
}

template <int CH>
cudaError_t launch_ch(const Args& a, cudaStream_t st) {
  static Fit rows_fit, walk_fit;
  if (a.vec && a.L == 8) return launch(minhash_rows_kernel<CH, 2>, a, rows_fit, st);
  return launch(minhash_walk_kernel<CH, 0>, a, walk_fit, st);
}

}  // namespace

// tokens [N, L] int32, valid [N, L] bytes (a torch.bool tensor), out
// [N, bands] int64 holding uint32; any bands and rows. Returns 0 or the
// first CUDA error.
extern "C" int minhash_launch(const int* tokens, const uint8_t* valid, long long N, int L,
                              int bands, int rows, long long* out, void* stream) {
  if (N < 1 || L < 1 || bands < 1 || rows < 1) return (int)cudaErrorInvalidValue;
  Args a;
  a.tokens = tokens;
  a.valid = valid;
  a.out = out;
  a.N = N;
  a.L = L;
  a.bands = bands;
  a.rows = rows;
  a.vec = L % 4 == 0 && (uintptr_t)tokens % 16 == 0 && (uintptr_t)valid % 4 == 0;
  a.pairs = bands % 2 == 0 && (uintptr_t)out % 16 == 0;
  const int BR = bands * rows;
  const int CH = BR <= 8 ? 8 : BR <= 16 ? 16 : 32;
  a.nsc = (BR + CH - 1) / CH;
  cudaStream_t st = (cudaStream_t)stream;
  return (int)(CH == 8 ? launch_ch<8>(a, st) : CH == 16 ? launch_ch<16>(a, st)
                                                        : launch_ch<32>(a, st));
}

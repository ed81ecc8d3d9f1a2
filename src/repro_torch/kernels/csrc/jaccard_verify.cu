// Batched weighted Jaccard-containment verification.
//
// Replaces the TPU kernel src/repro/kernels/jaccard_verify.py:
// jaccard_verify_pallas (pallas_call at :83, body _kernel :37). The plain
// PyTorch form is repro_torch/kernels/jaccard_verify.py:
// jaccard_verify_plain; both sum in index order i = 0 .. L-1 and divide
// in IEEE single precision, so the kernel equals it bit for bit.
//
// What bounds it on an H100: memory. Per (n, k) pair it does an L x L
// token compare and 2L additions, against 8L bytes of entity
// row read and 4 bytes of score written; the window rows add N*L*8
// bytes. Reading N*K*L*8 + N*L*8 bytes and writing N*K*4 at 3.35 TB/s
// is the floor chip_smoke.py reports as bound_ms. At L = 40 the L x L
// int32 compares alone (N*K*1,600) take nearly as long at the int32 rate
// as the bytes at the memory rate, so the compares must run from
// registers.
//
// Design, rows of up to 32 tokens: one thread per (n, k) pair, L a
// template parameter so the window row lives in registers and both
// loops unroll. Neighbouring threads read neighbouring entity rows
// (coalesced); the window row of a pair is read by its K neighbours
// through the cache.
//
// Rows longer than 32 tokens (entities of up to L tokens, the
// window_filter path) take jaccard_long_kernel, L a runtime value. A
// thread's own entity row, 8L bytes at a stride of 8L from its
// neighbour's, is not read from device memory by the thread: the block
// copies the rows of its run of 128 pairs, a contiguous stretch, into
// shared memory with cp.async (16-byte copies when L % 4 == 0), double
// buffered, in steps of up to 24 columns, into rows padded to a stride
// that keeps a warp's row reads in distinct banks. The window row sits
// in registers (up to 64 tokens), loaded once per pair, and each entity
// token is compared only with the window's tokens up to its last real
// one (a PAD entity token never hits, so the PAD tail of a window need
// not be searched), one compare-and-or instruction per token pair. Both
// sums keep the index order.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;

template <int L, bool EXTRA>
__global__ void __launch_bounds__(THREADS)
    jaccard_kernel(const int* __restrict__ win_t, const float* __restrict__ win_w,
                   const int* __restrict__ ent_t, const float* __restrict__ ent_w,
                   float* __restrict__ out, long long N, int K) {
  const long long idx = blockIdx.x * (long long)THREADS + threadIdx.x;
  if (idx >= N * K) return;
  const long long n = idx / K;
  int wt[L];
  float ws = 0.0f;
#pragma unroll
  for (int j = 0; j < L; ++j) {
    wt[j] = __ldg(win_t + n * L + j);
    ws += __ldg(win_w + n * L + j);
  }
  float inter = 0.0f, we = 0.0f;
#pragma unroll
  for (int i = 0; i < L; ++i) {
    const int e = ent_t[idx * L + i];
    const float w = ent_w[idx * L + i];
    bool hit = false;
#pragma unroll
    for (int j = 0; j < L; ++j) hit = hit || (wt[j] == e);
    hit = hit && e != 0;
    inter += w * (hit ? 1.0f : 0.0f);
    we += w;
  }
  const float denom = EXTRA ? we : ws;
  const float score = inter / fmaxf(denom, 1e-30f);
  out[idx] = ws > 0.0f ? score : 0.0f;
}

// ---------------------------------------------------------------------------
// Rows longer than 32 tokens: jaccard_long_kernel.

constexpr int RUN = 128;  // pairs per run == threads per block
constexpr int RUN_WARPS = RUN / 32;
constexpr int CI = 24;  // entity columns staged per step
constexpr int WR = 64;  // window tokens held in registers
constexpr int NSTAGES = 2;  // shared-memory buffers the steps stream through
constexpr int ROW_LANES = 8;  // lanes per row of a 16-byte copy
static_assert(CI <= 4 * ROW_LANES, "one step of a row is copied by at most ROW_LANES lanes");

struct LongArgs {
  const int* win_t;
  const float* win_w;
  const int* ent_t;
  const float* ent_w;
  float* out;
  long long NK;
  int K, L;
  int S;  // shared-memory row stride in words
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// waits until at most the N most recent groups of this thread are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Starts the copy of entity columns [i0, i0 + ci) of pairs [p0, p0 + RUN)
// into rows of stride a.S: 16-byte copies, ROW_LANES lanes per row (VEC),
// or 4-byte copies, a warp per row.
template <bool VEC>
__device__ __forceinline__ void stage_entities(const LongArgs& a, int* s_t, float* s_w,
                                               long long p0, int i0, int ci) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (VEC) {
    constexpr int rows_per_warp = 32 / ROW_LANES;
    const int c = 4 * (lane % ROW_LANES);
    if (c >= ci) return;
    for (int row = rows_per_warp * warp + lane / ROW_LANES; row < RUN;
         row += rows_per_warp * RUN_WARPS) {
      const long long p = p0 + row;
      if (p >= a.NK) break;
      const long long src = p * a.L + i0 + c;
      cp_async16(s_t + row * a.S + c, a.ent_t + src);
      cp_async16(s_w + row * a.S + c, a.ent_w + src);
    }
  } else {
    for (int row = warp; row < RUN; row += RUN_WARPS) {
      const long long p = p0 + row;
      if (p >= a.NK) break;
      for (int c = lane; c < ci; c += 32) {
        const long long src = p * a.L + i0 + c;
        cp_async4(s_t + row * a.S + c, a.ent_t + src);
        cp_async4(s_w + row * a.S + c, a.ent_w + src);
      }
    }
  }
}

// One step of the membership test: or-s into h0..h3 whether each of the
// tokens e0..e3 equals one of w0..w7, as four independent chains of
// compare-and-or predicates (setp.eq.or: one instruction per compare).
#define JV_CMP4(w)                                   \
  "setp.eq.or.s32 p0, " w ", %12, p0;\n\t"           \
  "setp.eq.or.s32 p1, " w ", %13, p1;\n\t"           \
  "setp.eq.or.s32 p2, " w ", %14, p2;\n\t"           \
  "setp.eq.or.s32 p3, " w ", %15, p3;\n\t"
__device__ __forceinline__ void match8x4(const int* w, const int (&e)[4], unsigned (&h)[4]) {
  asm("{\n\t.reg .pred p0, p1, p2, p3;\n\t"
      "setp.ne.u32 p0, %0, 0;\n\t"
      "setp.ne.u32 p1, %1, 0;\n\t"
      "setp.ne.u32 p2, %2, 0;\n\t"
      "setp.ne.u32 p3, %3, 0;\n\t"
      JV_CMP4("%4") JV_CMP4("%5") JV_CMP4("%6") JV_CMP4("%7")
      JV_CMP4("%8") JV_CMP4("%9") JV_CMP4("%10") JV_CMP4("%11")
      "selp.u32 %0, 1, 0, p0;\n\t"
      "selp.u32 %1, 1, 0, p1;\n\t"
      "selp.u32 %2, 1, 0, p2;\n\t"
      "selp.u32 %3, 1, 0, p3;\n\t"
      "}"
      : "+r"(h[0]), "+r"(h[1]), "+r"(h[2]), "+r"(h[3])
      : "r"(w[0]), "r"(w[1]), "r"(w[2]), "r"(w[3]), "r"(w[4]), "r"(w[5]), "r"(w[6]),
        "r"(w[7]), "r"(e[0]), "r"(e[1]), "r"(e[2]), "r"(e[3]));
}
#undef JV_CMP4

// A block walks runs of RUN consecutive pairs (idx = n*K + k, so the K
// pairs of a window are neighbours), one thread per pair, each run in
// steps of CI entity columns. The steps stream through two shared-memory
// buffers: while the block verifies one step, cp.async fills the other.
// At the first step of a run each thread loads its window row into
// registers (up to WR tokens; longer windows read the rest through the
// cache) and sums its weights; the entity tokens of each step are then
// compared with the window tokens up to the window's last real one, in
// groups of 8. Both sums run in index order over the steps.
template <bool EXTRA, bool VEC>
__global__ void __launch_bounds__(RUN) jaccard_long_kernel(LongArgs a) {
  extern __shared__ __align__(16) int smem_long[];
  const int stage_words = RUN * a.S;
  const int tid = threadIdx.x;
  const long long nruns = (a.NK + RUN - 1) / RUN;
  const int nsteps = (a.L + CI - 1) / CI;
  const long long nunits = (nruns - blockIdx.x + gridDim.x - 1) / gridDim.x * nsteps;
  auto tok_buf = [&](int b) { return smem_long + b * 2 * stage_words; };
  auto w_buf = [&](int b) {
    return reinterpret_cast<float*>(smem_long + b * 2 * stage_words + stage_words);
  };

  long long next_run = blockIdx.x, staged = 0;  // the next unit to stage
  int next_step = 0, next_buf = 0;
  auto stage_next = [&]() {  // one cp.async group per call, empty past the last unit
    if (staged < nunits) {
      const int i0 = next_step * CI;
      stage_entities<VEC>(a, tok_buf(next_buf), w_buf(next_buf), next_run * RUN, i0,
                          min(CI, a.L - i0));
      if (++next_step == nsteps) {
        next_step = 0;
        next_run += gridDim.x;
      }
    }
    cp_async_commit();
    ++staged;
    next_buf = next_buf + 1 == NSTAGES ? 0 : next_buf + 1;
  };
  for (int k = 0; k < NSTAGES - 1; ++k) stage_next();

  int wr[WR];
  int nq = 0, tail_end = WR;
  float ws = 0.0f, inter = 0.0f, we = 0.0f;
  const int* wrow = nullptr;
  long long run = blockIdx.x;
  int step = 0, buf = 0;
  for (long long u = 0; u < nunits; ++u) {
    stage_next();  // unit u + NSTAGES - 1
    cp_async_wait<NSTAGES - 1>();
    __syncthreads();  // step u is in shared memory for every thread
    const long long idx = run * RUN + tid;
    if (idx < a.NK) {
      if (step == 0) {
        const long long n = a.NK < (1LL << 31) ? (long long)((unsigned)idx / (unsigned)a.K)
                                               : idx / a.K;
        wrow = a.win_t + n * a.L;
        const float* wwrow = a.win_w + n * a.L;
        const int lim = min(a.L, WR);
        if (VEC) {
#pragma unroll
          for (int q = 0; q < WR / 4; ++q) {
            const int4 v = 4 * q < lim ? __ldg(reinterpret_cast<const int4*>(wrow) + q)
                                       : make_int4(0, 0, 0, 0);
            wr[4 * q] = v.x;
            wr[4 * q + 1] = v.y;
            wr[4 * q + 2] = v.z;
            wr[4 * q + 3] = v.w;
          }
        } else {
#pragma unroll
          for (int j = 0; j < WR; ++j) wr[j] = j < lim ? __ldg(wrow + j) : 0;
        }
        nq = 0;  // groups of 8 up to the group of the window's last real token
#pragma unroll
        for (int q = 0; q < WR / 8; ++q) {
          int any = 0;
#pragma unroll
          for (int r = 0; r < 8; ++r) any |= wr[8 * q + r];
          nq = any != 0 ? q + 1 : nq;
        }
        tail_end = WR;  // one past the last real token beyond the registers
        for (int j = WR; j < a.L; ++j) tail_end = __ldg(wrow + j) != 0 ? j + 1 : tail_end;
        ws = 0.0f;
        if (VEC) {
          for (int j = 0; j < a.L; j += 4) {
            const float4 v = __ldg(reinterpret_cast<const float4*>(wwrow + j));
            ws += v.x;
            ws += v.y;
            ws += v.z;
            ws += v.w;
          }
        } else {
          for (int j = 0; j < a.L; ++j) ws += __ldg(wwrow + j);
        }
        inter = 0.0f;
        we = 0.0f;
      }
      const int ci = min(CI, a.L - step * CI);
      const int* st = tok_buf(buf) + tid * a.S;
      const float* sw = w_buf(buf) + tid * a.S;
      for (int i = 0; i < ci; i += 4) {
        int e[4];
        float w[4];
        if (VEC) {  // ci is a multiple of 4
          const int4 e4 = *reinterpret_cast<const int4*>(st + i);
          const float4 w4 = *reinterpret_cast<const float4*>(sw + i);
          e[0] = e4.x, e[1] = e4.y, e[2] = e4.z, e[3] = e4.w;
          w[0] = w4.x, w[1] = w4.y, w[2] = w4.z, w[3] = w4.w;
        } else {
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            e[k] = i + k < ci ? st[i + k] : 0;
            w[k] = i + k < ci ? sw[i + k] : 0.0f;
          }
        }
        // membership of the 4 tokens among the window's first 8*nq
        // tokens, then the window's tokens past WR (rows longer than WR)
        unsigned h[4] = {0u, 0u, 0u, 0u};
#pragma unroll
        for (int q = 0; q < WR / 8; ++q) {
          if (q >= nq) break;
          match8x4(wr + 8 * q, e, h);
        }
        for (int j = WR; j < tail_end; ++j) {
          const int x = __ldg(wrow + j);
#pragma unroll
          for (int k = 0; k < 4; ++k) h[k] |= x == e[k];
        }
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          if (!VEC && i + k >= ci) break;
          const bool hit = h[k] != 0u && e[k] != 0;
          inter += w[k] * (hit ? 1.0f : 0.0f);
          we += w[k];
        }
      }
      if (step == nsteps - 1) {
        float denom = EXTRA ? we : ws;
        denom = denom < 1e-30f ? 1e-30f : denom;  // clamp_min: NaN passes
        a.out[idx] = ws > 0.0f ? inter / denom : 0.0f;
      }
    }
    __syncthreads();  // buffer buf is free for step u + NSTAGES
    buf = buf + 1 == NSTAGES ? 0 : buf + 1;
    if (++step == nsteps) {
      step = 0;
      run += gridDim.x;
    }
  }
}

template <bool EXTRA, bool VEC>
cudaError_t launch_long(const LongArgs& a, cudaStream_t st) {
  auto kern = jaccard_long_kernel<EXTRA, VEC>;
  const int smem = NSTAGES * 2 * RUN * a.S * (int)sizeof(int);  // (tokens, weights) per stage
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 132, per_sm = 1;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, RUN, smem);
  if (err != cudaSuccess) return err;
  const long long nruns = (a.NK + RUN - 1) / RUN;
  const long long slots = (long long)sms * (per_sm > 0 ? per_sm : 1);
  kern<<<(unsigned)(nruns < slots ? nruns : slots), RUN, smem, st>>>(a);
  return cudaGetLastError();
}

// Shared-memory row stride for a step of up to min(L, CI) columns: an
// odd number of 16-byte groups for 16-byte reads (VEC), else an odd
// number of words, so the rows of a warp's threads fall in different
// banks.
int long_stride(int L, bool vec) {
  const int m = L < CI ? L : CI;
  if (!vec) return m | 1;
  const int q = (m + 3) / 4;
  return 4 * (q % 2 ? q : q + 1);
}

cudaError_t launch_any(const int* wt, const float* ww, const int* et, const float* ew,
                       float* out, long long N, int K, int L, bool extra, cudaStream_t st) {
  const bool vec = L % 4 == 0 && ((uintptr_t)wt | (uintptr_t)ww | (uintptr_t)et |
                                  (uintptr_t)ew) % 16 == 0;
  const LongArgs a{wt, ww, et, ew, out, N * K, K, L, long_stride(L, vec)};
  if (extra) return vec ? launch_long<true, true>(a, st) : launch_long<true, false>(a, st);
  return vec ? launch_long<false, true>(a, st) : launch_long<false, false>(a, st);
}

template <int L>
void launch(const int* wt, const float* ww, const int* et, const float* ew, float* out,
            long long N, int K, bool extra, cudaStream_t st) {
  const long long blocks = (N * K + THREADS - 1) / THREADS;
  if (extra)
    jaccard_kernel<L, true><<<(unsigned)blocks, THREADS, 0, st>>>(wt, ww, et, ew, out, N, K);
  else
    jaccard_kernel<L, false><<<(unsigned)blocks, THREADS, 0, st>>>(wt, ww, et, ew, out, N, K);
}

template <int... Ls>
struct Dispatch;

template <int L0, int... Ls>
struct Dispatch<L0, Ls...> {
  static bool run(int L, const int* wt, const float* ww, const int* et, const float* ew,
                  float* out, long long N, int K, bool extra, cudaStream_t st) {
    if (L == L0) {
      launch<L0>(wt, ww, et, ew, out, N, K, extra, st);
      return true;
    }
    return Dispatch<Ls...>::run(L, wt, ww, et, ew, out, N, K, extra, st);
  }
};

template <>
struct Dispatch<> {
  static bool run(int, const int*, const float*, const int*, const float*, float*, long long,
                  int, bool, cudaStream_t) {
    return false;
  }
};

}  // namespace

// mode 0 = extra (w(e ∩ s) / w(e)), 1 = missing (w(e ∩ s) / w(s)).
// Returns 0 or the CUDA error of the launch.
extern "C" int jaccard_verify_launch(const int* win_t, const float* win_w, const int* ent_t,
                                     const float* ent_w, float* out, long long N, int K, int L,
                                     int mode, void* stream) {
  if (N * K <= 0) return 0;
  const bool ok = Dispatch<1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17, 18, 19, 20,
                           21, 22, 23, 24, 25, 26, 27, 28, 29, 30, 31, 32>::run(
      L, win_t, win_w, ent_t, ent_w, out, N, K, mode == 0, (cudaStream_t)stream);
  if (!ok) {
    if (L < 1) return (int)cudaErrorInvalidValue;
    const cudaError_t err = launch_any(win_t, win_w, ent_t, ent_w, out, N, K, L, mode == 0,
                                       (cudaStream_t)stream);
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaGetLastError();
}

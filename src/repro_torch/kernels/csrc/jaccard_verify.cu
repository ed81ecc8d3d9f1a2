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
// is the floor chip_smoke.py reports as bound_ms.
//
// Design: one thread per (n, k) pair, L a template parameter so the
// window row lives in registers and both loops unroll. Neighbouring
// threads read neighbouring entity rows (coalesced); the window row of a
// pair is read by its K neighbours through the cache. Rows longer than
// 32 tokens (entities of up to L tokens, the window_filter path) take a
// kernel with L a runtime value, which reads the window row through the
// read-only cache in the inner loop instead of keeping it in registers;
// it sums in the same order.
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

// jaccard_kernel for a runtime L (rows longer than the unrolled sizes)
template <bool EXTRA>
__global__ void __launch_bounds__(THREADS)
    jaccard_kernel_any(const int* __restrict__ win_t, const float* __restrict__ win_w,
                       const int* __restrict__ ent_t, const float* __restrict__ ent_w,
                       float* __restrict__ out, long long N, int K, int L) {
  const long long idx = blockIdx.x * (long long)THREADS + threadIdx.x;
  if (idx >= N * K) return;
  const long long n = idx / K;
  const int* wt = win_t + n * L;
  float ws = 0.0f;
  for (int j = 0; j < L; ++j) ws += __ldg(win_w + n * L + j);
  float inter = 0.0f, we = 0.0f;
  for (int i = 0; i < L; ++i) {
    const int e = ent_t[idx * L + i];
    const float w = ent_w[idx * L + i];
    bool hit = false;
    for (int j = 0; j < L && !hit; ++j) hit = __ldg(wt + j) == e;
    hit = hit && e != 0;
    inter += w * (hit ? 1.0f : 0.0f);
    we += w;
  }
  const float denom = EXTRA ? we : ws;
  const float score = inter / fmaxf(denom, 1e-30f);
  out[idx] = ws > 0.0f ? score : 0.0f;
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
    const long long blocks = (N * K + THREADS - 1) / THREADS;
    cudaStream_t st = (cudaStream_t)stream;
    if (mode == 0)
      jaccard_kernel_any<true><<<(unsigned)blocks, THREADS, 0, st>>>(win_t, win_w, ent_t, ent_w,
                                                                     out, N, K, L);
    else
      jaccard_kernel_any<false><<<(unsigned)blocks, THREADS, 0, st>>>(win_t, win_w, ent_t,
                                                                      ent_w, out, N, K, L);
  }
  return (int)cudaGetLastError();
}

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
// -1 padded, plus their variant key pairs (sig_mode variant). With
// C == 0 (count_only) only the counts. No packed bitmap and no dense
// signatures leave the function.
//
// What bounds it on an H100: memory. The function reads the docs once
// (G*bd*T*4 bytes) and writes counts (G*4), lanes (G*C*4) and variant
// keys (G*C*8, as uint32 pairs); the integer work per token is K Bloom
// probes and an L-step recurrence, far under the int32 rate.
//
// Design: the TPU kernel's in-kernel loop over chunks with a
// double-buffered DMA exists to overlap the copy-in with the VPU work on
// a core that runs its grid in order. On the GPU every chunk's segments
// run as independent blocks, so the loop over chunks is the grid itself:
// this entry reuses B1's passes (fused_probe.cuh) over the whole padded
// buffer with tile height bd, with row_offs[g] in place of g*bd as the
// row base of chunk g's flat indices. The probe pass runs without
// signatures (the emit pass recomputes variant keys for the survivors it
// writes). The packed survival bitmap lives in scratch that the wrapper
// allocates (int64 slots, R*T*8 bytes written once and read once): a
// gap to the bound that a later version closes by fusing probe and emit.
#include "fused_probe.cuh"

extern "C" int fused_probe_stream_segment() { return SEG; }

// Returns 0 or the first CUDA error of the launches. docs is [R, T] with
// R = G * bd; row_offs [G]; C == 0 means count_only (cands, vkeys and
// seg_offs may then be null); vkeys is null unless sig_mode is variant.
extern "C" int fused_probe_stream_launch(const int* docs, int R, int T, const int* row_offs,
                                         const uint32_t* bits, long long num_bits, int num_words,
                                         int num_hashes, int use_filter, int L, int sig_mode,
                                         int bd, int C, long long* packed, int* counts, int* cands,
                                         long long* vkeys, int* seg_counts, int* seg_offs,
                                         void* stream) {
  if (L < 1 || L > MAX_L || bd < 1 || R < 1 || T < 1 || R % bd != 0 ||
      (sig_mode != MODE_NONE && sig_mode != MODE_VAR))
    return (int)cudaErrorInvalidValue;
  Args a;
  a.docs = docs;
  a.D = R;
  a.T = T;
  a.bits = bits;
  a.num_bits = (uint32_t)num_bits;
  a.num_words = num_words;
  a.num_hashes = num_hashes;
  a.use_filter = use_filter;
  a.L = L;
  a.bands = 1;
  a.rows = 1;
  a.bd = bd;
  a.C = C;
  a.dense = 0;
  a.nseg = (T + SEG - 1) / SEG;
  a.packed = packed;
  a.sigs = nullptr;
  a.counts = counts;
  a.cands = cands;
  a.vkeys = vkeys;
  a.seg_counts = seg_counts;
  a.seg_offs = C > 0 ? seg_offs : nullptr;
  a.row_offs = row_offs;
  return (int)launch_passes(a, MODE_NONE, C > 0 && sig_mode == MODE_VAR, true,
                            (cudaStream_t)stream);
}

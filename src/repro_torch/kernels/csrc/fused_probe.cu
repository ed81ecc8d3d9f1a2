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
// The device code lives in fused_probe.cuh, shared with the streamed
// form (fused_probe_stream.cu).
#include "fused_probe.cuh"

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
  a.row_offs = nullptr;
  return (int)launch_passes(a, sig_mode, sig_mode == MODE_VAR, count_tiles != 0,
                            (cudaStream_t)stream);
}

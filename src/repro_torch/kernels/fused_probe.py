"""Fused ISH-filter probe + window signatures + compaction epilogue.

The map-side candidate front end in one kernel, replacing the TPU
kernel ``repro.kernels.fused_probe.fused_probe_pallas``. Every
per-window quantity is a running recurrence over the token stream that
starts at each window position ``t``, for lengths ``l < L <= 32``:

    real[t]          = tok[t] != PAD
    hit[t]           = all K Bloom probes of tok[t] set
    valid[t, l]      = AND(real[t .. t+l])
    survive[t, l]    = valid[t, l] & OR(hit[t .. t+l])
    rmin_i[t, l]     = MIN(h_i(tok[t .. t+l]))            (lsh, i < B*R)
    sig[t, l, b]     = combine(rmin_{bR} .. rmin_{bR+R-1}, b+1)
    dup[t, l]        = OR(tok[t+l] == tok[t .. t+l-1])    (variant)
    key_i[t, l]      = mix(sum ^ xor*C1 ^ cnt*GOLDEN) of the first-
                       occurrence token hashes             (variant)

Survival comes out packed (bit ``l`` of ``packed[d, t]``). With
``candidates > 0`` the epilogue emits, per ``[bd, T]`` document tile,
the true survivor count and the tile's first ``candidates`` survivors
as ascending global flat indices ``(d*T + t)*L + l`` (-1 padded), plus
the variant key pairs of those survivors.

Two forms of the same function:

* ``fused_probe_plain``: PyTorch, a mirror of the reference's
  ``_probe_recurrence``, ``_emit_lane`` and ``_gather_lane_keys`` over
  the whole batch; the CPU path and the oracle of the kernel;
* ``fused_probe_cuda``: the CUDA kernel in ``csrc/fused_probe.cu``.

The streamed form of the reference (``fused_probe_stream_pallas``) runs
the same probe and epilogue over a whole shard of ``G`` pre-padded
``[bd, T]`` chunks and returns only the per-chunk counts, lanes and
keys, with chunk ``g``'s flat indices based at ``row_offs[g]`` rows:
``fused_probe_stream_plain`` and ``fused_probe_stream_cuda``
(``csrc/fused_probe_stream.cu``).

``kernels.ops`` picks between the forms by the device of the tensors.
Hash-valued outputs (``packed``, ``sigs``, ``vkeys``) are int64 tensors
holding uint32 values (see ``core.hashing``), except the streamed form's
``vkeys``: an int32 tensor of the uint32 bit patterns, the function's own
width (``widen_keys`` turns the lanes a caller selects into int64).
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch.core import hashing
from repro_torch.core.filter import _BLOOM_SEED_BASE
from repro_torch.core.hashing import _C1, _GOLDEN, MASK, mul32
from repro_torch.core.signatures import _LSH_SEED_BASE
from repro_torch.core.variants import VARIANT_SEEDS
from repro_torch.kernels import _build
from repro_torch.kernels._hashing import combine as _combine
from repro_torch.kernels._hashing import hash_seeded as _hash
from repro_torch.kernels._hashing import mix as _mix

DEFAULT_BD = 8

#: smallest adaptive emit-pass lane width (widths are rounded up to
#: powers of two so repeated densities reuse one lane shape).
MIN_LANE_WIDTH = 8

SIG_MODE_NONE = "none"
SIG_MODE_LSH = "lsh"
SIG_MODE_VARIANT = "variant"
_SIG_MODE_CODE = {SIG_MODE_NONE: 0, SIG_MODE_LSH: 1, SIG_MODE_VARIANT: 2}

#: launches of the CUDA kernel since the last reset (one per wrapper call)
launches = 0
#: launches of the streamed CUDA kernel since the last reset
stream_launches = 0


def compact_tile_height(D: int, T: int, candidates: int) -> int:
    """Doc-tile height for the compaction epilogue.

    Each tile emits a full-width ``[1 + candidates]`` lane, so lanes
    stay small against the bitmap only when ``bd >= 4 * NC / T``. The
    count pass and the emit pass of the adaptive scheme share this
    height so their per-tile counts line up.
    """
    return min(max(DEFAULT_BD, -(-4 * candidates // max(T, 1))), max(D, 1))


def round_lane_width(max_count: int, cap: int, floor: int = MIN_LANE_WIDTH) -> int:
    """Adaptive emit-pass lane width for a measured per-tile maximum.

    Rounds up to a power of two (>= ``floor``), capped at ``cap`` (= NC).
    Any width >= ``max_count`` keeps the lane merge exact.
    """
    w = max(int(max_count), int(floor), 1)
    w = 1 << (w - 1).bit_length()
    return max(min(w, int(cap)), 1)


def streaming_first_occurrence(tokens):
    """First-occurrence mask via the kernel's shifted-compare recurrence.

    Position ``j`` of each padded row is marked iff it is real (non-PAD)
    and equals none of positions ``0 .. j-1``: the <= L-1 compares the
    kernel makes against the tokens it has already read. Equal to
    ``core.semantics.first_occurrence_mask``. Takes numpy or torch.
    """
    L = tokens.shape[-1]
    cols = []
    for j in range(L):
        hit = tokens[..., j] != tokens[..., j]  # all False, same type
        for i in range(j):
            hit = hit | (tokens[..., i] == tokens[..., j])
        cols.append(hit)
    stack = torch.stack if isinstance(tokens, torch.Tensor) else np.stack
    return (tokens != 0) & ~stack(cols, -1)  # PAD == 0


def empty_band_sigs(bands: int, rows: int) -> np.ndarray:
    """[bands] uint32: the band signatures of an all-invalid window."""
    row = np.full((1,), MASK, dtype=np.uint32)
    out = []
    for b in range(bands):
        band = row
        for _ in range(1, rows):
            band = hashing.combine(band, row)
        band = hashing.combine(band, np.full((1,), b + 1, dtype=np.uint32))
        out.append(band[0])
    return np.array(out, dtype=np.uint32)


def check_args(doc_tokens, max_len: int, sig_mode: str, candidates: int, count_only: bool):
    """The argument rules both forms enforce (the reference's asserts)."""
    if doc_tokens.dim() != 2:
        raise ValueError(f"doc_tokens must be [D, T], got {tuple(doc_tokens.shape)}")
    if not 1 <= max_len <= 32:
        raise ValueError(f"max_len={max_len}: the packed survival bitmap holds 1..32 lengths")
    if sig_mode not in _SIG_MODE_CODE:
        raise ValueError(f"unknown sig_mode {sig_mode!r}")
    if count_only and candidates <= 0:
        raise ValueError("count_only needs candidates > 0")
    if count_only and sig_mode != SIG_MODE_NONE:
        raise ValueError("count_only is the sizing pass: signatures belong to the emit pass")


def _shift(x: torch.Tensor, fill) -> torch.Tensor:
    """Shift every row left by one token, filling the tail with ``fill``."""
    return torch.cat([x[:, 1:], torch.full_like(x[:, :1], fill)], dim=1)


def _probe_recurrence(docs, bits, *, num_bits, num_hashes, max_len, bands, rows,
                      use_filter, sig_mode, dense_sigs):
    """The recurrence over a zero-padded ``[Dp, T]`` batch.

    Returns (pack [Dp, T] int64, row_count [Dp] int64, sigs or None,
    (k1, k2) [Dp, T, L] variant keys or None).
    """
    Dp, T = docs.shape
    L = max_len
    real = docs != 0
    if use_filter:
        hit = torch.ones_like(real)
        for k in range(num_hashes):
            pos = _hash(docs, _BLOOM_SEED_BASE + k) % num_bits
            word = hashing.u32(bits[pos // 32])
            hit = hit & (((word >> (pos % 32)) & 1) == 1)
    else:
        hit = real
    lsh = sig_mode == SIG_MODE_LSH
    var = sig_mode == SIG_MODE_VARIANT
    S = bands if lsh else 2
    sigs = (torch.empty((Dp, T, L, S), dtype=torch.int64, device=docs.device)
            if dense_sigs else None)
    if lsh:
        hv = [torch.where(real, _hash(docs, _LSH_SEED_BASE + i), MASK)
              for i in range(bands * rows)]
        rmin = [torch.full_like(docs, MASK) for _ in hv]
    if var:
        zero = torch.zeros_like(docs)
        vs1, vx1, vs2, vx2, vcnt = zero, zero, zero, zero, zero
        prev_toks: list = []
        vkeys1, vkeys2 = [], []

    vand = torch.ones_like(real)
    vor = torch.zeros_like(real)
    pack = torch.zeros_like(docs)
    row_count = torch.zeros((Dp,), dtype=torch.int64, device=docs.device)
    sh_real, sh_hit, sh_tok = real, hit, docs
    sh_hv = list(hv) if lsh else []
    for l in range(L):
        vand = vand & sh_real
        vor = vor | sh_hit
        surv = vand & vor
        pack = pack | (surv.to(torch.int64) << l)
        row_count = row_count + surv.sum(dim=1)
        if lsh:
            for i in range(bands * rows):
                rmin[i] = torch.minimum(rmin[i], sh_hv[i])
            for b in range(bands):
                band = rmin[b * rows]
                for r in range(1, rows):
                    band = _combine(band, rmin[b * rows + r])
                sigs[:, :, l, b] = _combine(band, torch.full_like(band, b + 1))
        if var:
            dup = torch.zeros_like(real)
            for pv in prev_toks:
                dup = dup | (pv == sh_tok)
            contrib = sh_real & ~dup
            h1 = torch.where(contrib, _hash(sh_tok, VARIANT_SEEDS[0]), 0)
            h2 = torch.where(contrib, _hash(sh_tok, VARIANT_SEEDS[1]), 0)
            vs1, vx1 = (vs1 + h1) & MASK, vx1 ^ h1
            vs2, vx2 = (vs2 + h2) & MASK, vx2 ^ h2
            vcnt = vcnt + contrib.to(torch.int64)
            fin = mul32(vcnt, _GOLDEN)
            k1 = _mix(vs1 ^ mul32(vx1, _C1) ^ fin)
            k2 = _mix(vs2 ^ mul32(vx2, _C1) ^ fin)
            vkeys1.append(k1)
            vkeys2.append(k2)
            if dense_sigs:
                sigs[:, :, l, 0] = k1
                sigs[:, :, l, 1] = k2
            prev_toks.append(sh_tok)
        sh_real = _shift(sh_real, False)
        sh_hit = _shift(sh_hit, False)
        sh_tok = _shift(sh_tok, 0)
        sh_hv = [_shift(v, MASK) for v in sh_hv]
    keys = (torch.stack(vkeys1, -1), torch.stack(vkeys2, -1)) if var else None
    return pack, row_count, sigs, keys


def _emit_lanes(pack, counts, cand_cap: int, max_len: int):
    """Per tile, the first ``cand_cap`` survivors (``_emit_lane`` batched).

    ``pack`` [G, bd*T]: the tiles' packed words. Two-stage selection:
    the first cand_cap nonzero words, then the first cand_cap set bits
    among them. Returns tile-local flat indices and their validity.
    """
    G, span = pack.shape
    L = max_len
    dev = pack.device
    lane = torch.arange(cand_cap, dtype=torch.int64, device=dev)
    want = (lane + 1).expand(G, cand_cap).contiguous()
    cw = torch.cumsum(pack != 0, dim=1, dtype=torch.int64)
    wk = torch.searchsorted(cw, want, side="left")
    wok = lane[None] < cw[:, -1:].clamp_max(cand_cap)
    words = pack.gather(1, wk.clamp_max(span - 1)) * wok
    sub = ((words[..., None] >> torch.arange(L, device=dev)) & 1) != 0
    cb = torch.cumsum(sub.reshape(G, cand_cap * L), dim=1, dtype=torch.int64)
    k = torch.searchsorted(cb, want, side="left")
    ok = lane[None] < counts[:, None].clamp_max(cand_cap)
    flat = wk.gather(1, (k // L).clamp_max(cand_cap - 1)).clamp_max(span - 1) * L + k % L
    return flat, ok


def fused_probe_plain(doc_tokens, bits, num_bits: int, num_hashes: int, max_len: int,
                      sig_mode: str = SIG_MODE_NONE, bands: int = 4, rows: int = 2,
                      use_filter: bool = True, bd: int = DEFAULT_BD, candidates: int = 0,
                      count_only: bool = False):
    """Plain PyTorch form; returns ``(packed, sigs, counts, cands, vkeys)``.

    Same contract as ``repro.kernels.fused_probe.fused_probe_pallas``:
    ``packed`` [D, T]; ``sigs`` [D, T, L, B] (lsh) or [D, T, L, 2]
    (variant without the epilogue), else None; with ``candidates > 0``
    ``counts`` [G] int32 and, unless ``count_only``, ``cands`` [G, C]
    int32 and (variant) ``vkeys`` [G, C, 2].
    """
    check_args(doc_tokens, max_len, sig_mode, candidates, count_only)
    D, T = doc_tokens.shape
    bd = min(bd, D)
    Dp = -(-D // bd) * bd
    G = Dp // bd
    docs = torch.zeros((Dp, T), dtype=torch.int64, device=doc_tokens.device)
    docs[:D] = doc_tokens
    count_tiles = candidates > 0
    cand_cap = 0 if count_only else candidates
    var = sig_mode == SIG_MODE_VARIANT
    dense_sigs = sig_mode == SIG_MODE_LSH or (var and not cand_cap)
    pack, row_count, sigs, keys = _probe_recurrence(
        docs, bits, num_bits=num_bits, num_hashes=num_hashes, max_len=max_len,
        bands=bands, rows=rows, use_filter=use_filter, sig_mode=sig_mode,
        dense_sigs=dense_sigs,
    )
    counts = cands = vkeys = None
    if count_tiles:
        counts = row_count.reshape(G, bd).sum(dim=1)
    if cand_cap:
        L = max_len
        span = bd * T
        flat, ok = _emit_lanes(pack.reshape(G, span), counts, cand_cap, L)
        tile_base = torch.arange(G, device=docs.device)[:, None] * (span * L)
        cands = torch.where(ok, tile_base + flat, -1).to(torch.int32)
        if var:
            sel = flat.clamp(0, span * L - 1)
            vkeys = torch.stack(
                [torch.where(ok, k.reshape(G, span * L).gather(1, sel), 0) for k in keys], -1
            )
    return (
        pack[:D],
        sigs[:D] if sigs is not None else None,
        counts.to(torch.int32) if counts is not None else None,
        cands,
        vkeys,
    )


def narrow_keys(keys):
    """uint32 values held in int64 -> an int32 tensor of the same bits."""
    return torch.where(keys >= 2**31, keys - 2**32, keys).to(torch.int32)


def widen_keys(keys):
    """int32 bit patterns -> int64 holding the uint32 values."""
    return keys.to(torch.int64) & MASK


def check_stream_args(doc_tokens, row_offs, max_len: int, sig_mode: str, bd: int,
                      candidates: int) -> int:
    """The streamed form's argument rules (the reference's); returns G."""
    if sig_mode not in (SIG_MODE_NONE, SIG_MODE_VARIANT):
        raise ValueError(
            "streamed kernel emits no dense signature tensor: sig_mode "
            f"{sig_mode!r} unsupported (lsh band sigs are recomputed "
            "post-compaction on streaming paths)"
        )
    if candidates <= 0:
        raise ValueError("streamed kernel has no bitmap output: candidates > 0 required")
    check_args(doc_tokens, max_len, sig_mode, candidates, False)
    R = doc_tokens.shape[0]
    if bd < 1 or R % bd != 0:
        raise ValueError(
            f"streamed input rows ({R}) must be a multiple of bd ({bd}): "
            "callers pre-pad each upstream tile to full chunk height"
        )
    G = R // bd
    if tuple(row_offs.shape) != (G,):
        raise ValueError(f"row_offs must be [G={G}], got {tuple(row_offs.shape)}")
    return G


def fused_probe_stream_plain(doc_tokens, bits, row_offs, num_bits: int, num_hashes: int,
                             max_len: int, sig_mode: str = SIG_MODE_NONE,
                             use_filter: bool = True, bd: int = DEFAULT_BD,
                             candidates: int = 0, count_only: bool = False):
    """Plain PyTorch form of the streamed probe; returns ``(counts, cands, vkeys)``.

    Same contract as ``repro.kernels.fused_probe.fused_probe_stream_pallas``:
    ``doc_tokens`` [G*bd, T] pre-padded, ``row_offs`` [G] absolute doc-row
    offsets; ``counts`` [G] int32, ``cands`` [G, C] int32 ascending global
    flat indices ``row_offs[g]*T*L + ((r - g*bd)*T + t)*L + l`` (-1 pad),
    ``vkeys`` [G, C, 2] int32 bit patterns of the uint32 key pairs (0 pad;
    variant); ``count_only`` gives ``counts`` alone. Rows are independent
    in the recurrence, so the chunks run as one batch.
    """
    G = check_stream_args(doc_tokens, row_offs, max_len, sig_mode, bd, candidates)
    R, T = doc_tokens.shape
    L = max_len
    cand_cap = 0 if count_only else candidates
    var = sig_mode == SIG_MODE_VARIANT and cand_cap > 0
    pack, row_count, _, keys = _probe_recurrence(
        doc_tokens.to(torch.int64), bits, num_bits=num_bits, num_hashes=num_hashes,
        max_len=L, bands=1, rows=1, use_filter=use_filter,
        sig_mode=SIG_MODE_VARIANT if var else SIG_MODE_NONE, dense_sigs=False,
    )
    counts = row_count.reshape(G, bd).sum(dim=1)
    cands = vkeys = None
    if cand_cap:
        span = bd * T
        flat, ok = _emit_lanes(pack.reshape(G, span), counts, cand_cap, L)
        base = row_offs.to(torch.int64)[:, None] * (T * L)
        cands = torch.where(ok, base + flat, -1).to(torch.int32)
        if var:
            sel = flat.clamp(0, span * L - 1)
            vkeys = narrow_keys(torch.stack(
                [torch.where(ok, k.reshape(G, span * L).gather(1, sel), 0) for k in keys], -1
            ))
    return counts.to(torch.int32), cands, vkeys


# --------------------------------------------------------------------------
# CUDA binding
# --------------------------------------------------------------------------

_P = ctypes.c_void_p


def _lib():
    lib = _build.load("fused_probe")
    if not getattr(lib, "_typed", False):
        lib.fused_probe_launch.argtypes = [
            _P, ctypes.c_int, ctypes.c_int,  # docs, D, T
            _P, ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,  # L, mode, bands, rows
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,  # bd, C, count, dense
            _P, _P, _P, _P, _P, _P, _P,  # packed, sigs, counts, cands, vkeys, state, stream
        ]
        lib.fused_probe_launch.restype = ctypes.c_int
        lib.fused_probe_segment.argtypes = [ctypes.c_int]
        lib.fused_probe_segment.restype = ctypes.c_int
        lib._typed = True
    return lib


def _stream_lib():
    lib = _build.load("fused_probe_stream")
    if not getattr(lib, "_typed", False):
        lib.fused_probe_stream_launch.argtypes = [
            _P, ctypes.c_int, ctypes.c_int, _P,  # docs, R, T, row_offs
            _P, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,  # bits, num_bits, K, use
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,  # L, mode, bd, C
            _P, _P, _P, _P, _P,  # counts, cands, keys, state, stream
        ]
        lib.fused_probe_stream_launch.restype = ctypes.c_int
        lib.fused_probe_stream_segment.argtypes = []
        lib.fused_probe_stream_segment.restype = ctypes.c_int
        lib._typed = True
    return lib


def _ptr(t: torch.Tensor | None):
    return None if t is None else t.data_ptr()


def check_cuda_inputs(fn: str, doc_tokens, bits, use_filter: bool, num_bits: int,
                       **more) -> None:
    """Device, type, shape and contiguity of a Bloom-probing kernel's inputs."""
    for name, t in (("doc_tokens", doc_tokens), ("bits", bits), *more.items()):
        if not t.is_cuda or t.dtype != torch.int32 or not t.is_contiguous():
            raise ValueError(
                f"{fn}: {name} must be a contiguous torch.int32 CUDA tensor, "
                f"got {t.dtype} on {t.device}"
            )
        if t.device != doc_tokens.device:
            raise ValueError(f"{fn}: {name} must be on the docs' device {doc_tokens.device}")
    if bits.dim() != 1:
        raise ValueError(f"{fn}: bits must be a 1-D tensor")
    if use_filter and (num_bits % 32 or bits.numel() * 32 != num_bits or num_bits >= 2**32):
        raise ValueError(f"{fn}: {bits.numel()} words do not hold {num_bits} bits")


def fused_probe_cuda(doc_tokens, bits, num_bits: int, num_hashes: int, max_len: int,
                     sig_mode: str = SIG_MODE_NONE, bands: int = 4, rows: int = 2,
                     use_filter: bool = True, bd: int = DEFAULT_BD, candidates: int = 0,
                     count_only: bool = False):
    """CUDA form of ``fused_probe_plain``: same arguments, same outputs.

    One kernel launch per call. Its scratch, which this wrapper allocates,
    is a ticket plus one look-back word per segment of positions when lanes
    are emitted, or one count word per tile in ``count_only``.
    """
    global launches
    check_args(doc_tokens, max_len, sig_mode, candidates, count_only)
    check_cuda_inputs("fused_probe_cuda", doc_tokens, bits, use_filter, num_bits)
    if bands * rows > 32:
        raise ValueError(f"fused_probe_cuda: bands*rows={bands * rows} > 32 row minima")
    D, T = doc_tokens.shape
    L = max_len
    if D * T * L >= 2**31:
        raise ValueError(f"flat window index space {D}x{T}x{L} overflows int32")
    if D * T == 0:
        raise ValueError("fused_probe_cuda: empty document batch")
    bd = min(bd, D)
    G = -(-D // bd)
    count_tiles = candidates > 0
    cand_cap = 0 if count_only else candidates
    var = sig_mode == SIG_MODE_VARIANT
    lsh = sig_mode == SIG_MODE_LSH
    dense = lsh or (var and not cand_cap)
    dev = doc_tokens.device
    lib = _lib()
    nseg = -(-T // lib.fused_probe_segment(L))
    i64, i32 = torch.int64, torch.int32
    scratch = 1 + (D * nseg if cand_cap else G if count_tiles else 0)
    state = torch.empty((scratch,), dtype=i64, device=dev)
    packed = torch.empty((D, T), dtype=i64, device=dev)
    sigs = torch.empty((D, T, L, bands if lsh else 2), dtype=i64, device=dev) if dense else None
    counts = torch.empty((G,), dtype=i32, device=dev) if count_tiles else None
    cands = torch.empty((G, cand_cap), dtype=i32, device=dev) if cand_cap else None
    vkeys = torch.empty((G, cand_cap, 2), dtype=i64, device=dev) if cand_cap and var else None
    stream = _build.current_stream(dev)
    rc = lib.fused_probe_launch(
        doc_tokens.data_ptr(), D, T,
        bits.data_ptr(), num_bits, bits.numel(), num_hashes, int(use_filter),
        L, _SIG_MODE_CODE[sig_mode], bands, rows,
        bd, cand_cap, int(count_tiles), int(dense),
        packed.data_ptr(), _ptr(sigs), _ptr(counts), _ptr(cands), _ptr(vkeys),
        state.data_ptr(), stream,
    )
    launches += 1
    if rc != 0:
        raise RuntimeError(f"fused_probe kernel launch failed with CUDA error {rc}")
    return packed, sigs, counts, cands, vkeys


def fused_probe_stream_cuda(doc_tokens, bits, row_offs, num_bits: int, num_hashes: int,
                            max_len: int, sig_mode: str = SIG_MODE_NONE,
                            use_filter: bool = True, bd: int = DEFAULT_BD,
                            candidates: int = 0, count_only: bool = False):
    """CUDA form of ``fused_probe_stream_plain``: same arguments, same outputs.

    The kernel's look-back words (one per segment of SEG positions) are
    scratch that this wrapper allocates; only counts, lanes and keys are
    returned.
    """
    global stream_launches
    G = check_stream_args(doc_tokens, row_offs, max_len, sig_mode, bd, candidates)
    check_cuda_inputs("fused_probe_stream_cuda", doc_tokens, bits, use_filter, num_bits,
                       row_offs=row_offs)
    R, T = doc_tokens.shape
    L = max_len
    if R * T * L >= 2**31:
        raise ValueError(f"flat window index space {R}x{T}x{L} overflows int32")
    cand_cap = 0 if count_only else candidates
    var = sig_mode == SIG_MODE_VARIANT and cand_cap > 0
    dev = doc_tokens.device
    lib = _stream_lib()
    nseg = -(-T // lib.fused_probe_stream_segment())
    i32 = torch.int32
    state = torch.empty((1 + R * nseg,), dtype=torch.int64, device=dev)  # scratch
    counts = torch.empty((G,), dtype=i32, device=dev)
    cands = torch.empty((G, cand_cap), dtype=i32, device=dev) if cand_cap else None
    vkeys = torch.empty((G, cand_cap, 2), dtype=i32, device=dev) if var else None
    stream = _build.current_stream(dev)
    rc = lib.fused_probe_stream_launch(
        doc_tokens.data_ptr(), R, T, row_offs.data_ptr(),
        bits.data_ptr(), num_bits, num_hashes, int(use_filter),
        L, _SIG_MODE_CODE[SIG_MODE_VARIANT if var else SIG_MODE_NONE], bd, cand_cap,
        counts.data_ptr(), _ptr(cands), _ptr(vkeys), state.data_ptr(), stream,
    )
    stream_launches += 1
    if rc != 0:
        raise RuntimeError(f"fused_probe_stream kernel launch failed with CUDA error {rc}")
    return counts, cands, vkeys

"""Engine-facing wrappers around the kernels.

These are the dispatch points the extraction engine calls when
``use_kernel=True``. They adapt engine arguments (entity-id lists,
weight tables, filter tuples) to the layouts the kernels take, and pick
the form by the device of the tensors alone: a CUDA tensor launches the
CUDA kernel (or raises), a CPU tensor runs the plain PyTorch version.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import fused_probe as _fp
from repro_torch.kernels import jaccard_verify as _jv
from repro_torch.kernels import minhash as _mh
from repro_torch.kernels import window_filter as _wf


def _form(t: torch.Tensor, plain, cuda):
    if t.is_cuda:
        return cuda
    if t.device.type == "cpu":
        return plain
    raise ValueError(f"no kernel for tensors on {t.device}")


def jaccard_verify_inputs(win_tokens, ent_ids, dict_tokens, token_weight):
    """The kernel's dense inputs: (win [N, L] i32, win_w [N, L] f32,
    ent [N, K, L] i32, ent_w [N, K, L] f32) with first-occurrence window
    weights and the candidate entities' rows gathered."""
    from repro_torch.core.semantics import first_occurrence_mask

    ent_toks = dict_tokens[ent_ids.clamp_min(0).long()].to(torch.int32).contiguous()
    ent_w = token_weight[ent_toks.long()] * (ent_toks != 0)
    win_w = token_weight[win_tokens.long()] * first_occurrence_mask(win_tokens)
    return (win_tokens.to(torch.int32).contiguous(), win_w.to(torch.float32).contiguous(),
            ent_toks, ent_w.to(torch.float32).contiguous())


def jaccard_verify(win_tokens, ent_ids, dict_tokens, token_weight, sim_name: str):
    """Engine-facing verify: gathers entity rows and weights, runs the kernel.

    win_tokens [N, L]; ent_ids [N, K] (-1 invalid); dict_tokens [E, L];
    token_weight [V]. Returns scores [N, K] f32 (0 for invalid ids).
    Similarities other than extra/missing are computed by
    ``core.semantics.similarity``, as in the reference.
    """
    if sim_name not in _jv.MODES:
        from repro_torch.core.semantics import similarity

        ents = dict_tokens[ent_ids.clamp_min(0).long()]
        return similarity(sim_name, ents, win_tokens[:, None, :], token_weight)
    verify = _form(win_tokens, _jv.jaccard_verify_plain, _jv.jaccard_verify_cuda)
    scores = verify(*jaccard_verify_inputs(win_tokens, ent_ids, dict_tokens, token_weight),
                    mode=sim_name)
    return torch.where(ent_ids >= 0, scores, torch.zeros_like(scores))


def minhash(tokens, valid, bands: int, rows: int):
    """[N, L] tokens -> [N, bands] banded MinHash signatures (int64
    holding uint32)."""
    return _form(tokens, _mh.minhash_plain, _mh.minhash_cuda)(tokens, valid, bands, rows)


def window_filter(doc_tokens, bits, num_bits: int, num_hashes: int, max_len: int):
    """[D, T] docs -> [D, T, L] bool window-survival mask (Bloom probe)."""
    wf = _form(doc_tokens, _wf.window_filter_plain, _wf.window_filter_cuda)
    return wf(doc_tokens, bits, num_bits, num_hashes, max_len)


def _filter_args(flt, device):
    """(bits, num_bits, num_hashes, use_filter) of a filter triple or None."""
    if flt is None:
        return torch.zeros((8,), dtype=torch.int32, device=device), 256, 1, False
    bits, num_bits, num_hashes = flt
    return bits, num_bits, num_hashes, True


def _probe(doc_tokens, flt, max_len, sig_mode, bands, rows, candidates,
           bd: int = _fp.DEFAULT_BD, count_only: bool = False):
    bits, num_bits, num_hashes, use_filter = _filter_args(flt, doc_tokens.device)
    probe = _form(doc_tokens, _fp.fused_probe_plain, _fp.fused_probe_cuda)
    return probe(
        doc_tokens, bits, num_bits=num_bits, num_hashes=num_hashes, max_len=max_len,
        sig_mode=sig_mode, bands=bands, rows=rows, use_filter=use_filter, bd=bd,
        candidates=candidates, count_only=count_only,
    )


def fused_probe(doc_tokens, flt: tuple | None, max_len: int,
                sig_mode: str = _fp.SIG_MODE_NONE, bands: int = 4, rows: int = 2):
    """One-pass filter+signature probe without the epilogue.

    ``flt`` is (bits, num_bits, num_hashes) or None (validity only).
    Returns (packed [D, T], sigs or None): [.., bands] band sigs
    (``lsh``) or [.., 2] variant key pairs (``variant``, dense).
    """
    packed, sigs, _, _, _ = _probe(doc_tokens, flt, max_len, sig_mode, bands, rows, 0)
    return packed, sigs


def fused_probe_compact(doc_tokens, flt: tuple | None, max_len: int, candidates: int,
                        sig_mode: str = _fp.SIG_MODE_NONE, bands: int = 4, rows: int = 2,
                        lane_width: int | None = None):
    """``fused_probe`` plus the in-kernel compaction epilogue.

    Returns (packed, sigs, counts [G] int32, cands [G, W] int32, vkeys):
    per tile, the true survivor count and the first ``W = lane_width or
    candidates`` survivors as ascending global flat window indices (-1
    pad); with ``sig_mode="variant"`` their key pairs as ``vkeys``
    [G, W, 2] and no dense ``sigs``. The tile height is derived from
    ``candidates`` (``compact_tile_height``) whatever the lane width.
    """
    if candidates <= 0:
        raise ValueError(
            f"fused_probe_compact(candidates={candidates}): the compaction "
            "epilogue needs a positive [G, NC] lane width (NC = "
            "ExtractParams.max_candidates); use fused_probe() if you only "
            "want the packed survival bitmap"
        )
    if max_len > 32:
        raise ValueError(
            f"fused_probe_compact(max_len={max_len}): the packed survival "
            "bitmap holds one window length per uint32 bit, so the epilogue "
            "supports max_len <= 32"
        )
    if lane_width is not None and not 0 < lane_width <= candidates:
        raise ValueError(
            f"fused_probe_compact(lane_width={lane_width}): the emit-pass "
            f"lane width must be in (0, candidates={candidates}] — wider "
            "lanes than the merge capacity are never read, and the merge "
            "is only exact when every tile's survivors fit the lane "
            "(choose the width with fused_probe.round_lane_width over "
            "fused_probe_count's per-tile counts)"
        )
    D, T = doc_tokens.shape
    bd = _fp.compact_tile_height(D, T, candidates)
    return _probe(doc_tokens, flt, max_len, sig_mode, bands, rows,
                  lane_width or candidates, bd=bd)


def fused_probe_count(doc_tokens, flt: tuple | None, max_len: int, candidates: int):
    """Count-only pass: per-tile survivor counts [G] int32, no lanes.

    Tiles as ``fused_probe_compact(..., candidates)`` does, so the
    counts line up tile for tile with the emit pass.
    """
    if candidates <= 0:
        raise ValueError(
            f"fused_probe_count(candidates={candidates}): the count pass "
            "sizes lanes for a positive merge capacity (NC = "
            "ExtractParams.max_candidates)"
        )
    D, T = doc_tokens.shape
    bd = _fp.compact_tile_height(D, T, candidates)
    _, _, counts, _, _ = _probe(doc_tokens, flt, max_len, _fp.SIG_MODE_NONE, 4, 2,
                                candidates, bd=bd, count_only=True)
    return counts


def fused_probe_stream(doc_tokens, flt: tuple | None, max_len: int, candidates: int, row_offs,
                       sig_mode: str = _fp.SIG_MODE_NONE, bd: int | None = None,
                       lane_width: int | None = None, count_only: bool = False):
    """Streamed probe over a whole shard: one call, ``G`` chunks.

    ``doc_tokens`` [G*bd, T] must be pre-padded so each [bd, T] chunk is
    full height; ``row_offs`` [G] int32 (on the docs' device) carries each
    chunk's absolute doc-row offset, which keeps flat indices
    bit-identical to the per-tile loop. Returns ``(counts [G], cands
    [G, W], vkeys)``: ``fused_probe_compact``'s lanes without the packed
    bitmap or dense signatures (``sig_mode="lsh"`` raises), the variant
    keys as int32 bit patterns (``fused_probe.widen_keys``).
    ``count_only=True`` is the adaptive sizing pass: ``counts`` alone.
    """
    if candidates <= 0:
        raise ValueError(
            f"fused_probe_stream(candidates={candidates}): the streamed "
            "kernel has no bitmap output, so it always runs the compaction "
            "epilogue — a positive merge capacity (NC = "
            "ExtractParams.max_candidates) is required"
        )
    if max_len > 32:
        raise ValueError(
            f"fused_probe_stream(max_len={max_len}): the packed survival "
            "bitmap holds one window length per uint32 bit, so the "
            "streamed epilogue supports max_len <= 32"
        )
    if lane_width is not None and not 0 < lane_width <= candidates:
        raise ValueError(
            f"fused_probe_stream(lane_width={lane_width}): the emit-pass "
            f"lane width must be in (0, candidates={candidates}]"
        )
    bits, num_bits, num_hashes, use_filter = _filter_args(flt, doc_tokens.device)
    if bd is None:
        bd = _fp.compact_tile_height(doc_tokens.shape[0], doc_tokens.shape[1], candidates)
    stream = _form(doc_tokens, _fp.fused_probe_stream_plain, _fp.fused_probe_stream_cuda)
    return stream(
        doc_tokens, bits, row_offs, num_bits=num_bits, num_hashes=num_hashes, max_len=max_len,
        sig_mode=sig_mode, use_filter=use_filter, bd=bd, candidates=lane_width or candidates,
        count_only=count_only,
    )

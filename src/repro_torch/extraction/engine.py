"""Single-device extraction: the candidate front end, probe and verify.

Both EE-Join algorithms share the candidate machinery: enumerate ->
(filter) -> compact -> probe -> verify -> emit. Every buffer has a fixed
capacity and surfaced overflow counters, as in
``repro.extraction.engine``; results are identical to it.

With ``use_kernel`` the front end is ``fused_filter_compact``: the
``fused_probe`` kernel and its compaction epilogue, a merge of the
per-tile lanes, and a window gather straight from the ``[D, T]`` docs
(windows longer than 32 tokens: the ``window_filter`` kernel and
``compact_candidates``). Without it, ``survival_mask`` +
``compact_candidates`` do the same in plain PyTorch. The streaming
paths over shards of a corpus are in ``extraction.sharded``.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import hashing
from repro_torch.core.dictionary import PAD, Dictionary
from repro_torch.core.filter import token_in_filter
from repro_torch.core.index import (
    INDEX_VARIANT,
    build_inverted_index,
    build_variant_index,
    query_inverted,
    query_variant,
)
from repro_torch.core.signatures import (
    SIG_LSH,
    SIG_NAMES,
    SIG_PREFIX,
    SIG_VARIANT,
    SIG_WORD,
    EntitySignatures,
    LshParams,
    window_signatures,
)
from repro_torch.core.variants import window_variant_key
from repro_torch.extraction.results import (
    Matches,
    compact_matches,
    gather_from_tiles,
    select_from_tiles,
    select_nonzero,
)
from repro_torch.extraction.substrings import window_base
from repro_torch.extraction.verify import dedup_hits, verify_pairs

_SIGKEY_SEED = 33
# Bucket choice uses an independent hash of the signature so that bucket
# bits do not correlate with owner-routing bits in a distributed shuffle.
_BUCKET_SEED = 47


def _bucket_of(sig, n_buckets: int):
    return hashing.hash_u32(sig, seed=_BUCKET_SEED) % n_buckets


@dataclasses.dataclass(frozen=True)
class ExtractParams:
    """Static knobs of one extraction sub-job (one side of a plan).

    Construction validates every cross-field constraint up front, with
    the failing knob and the fix in the message, as the reference does.
    """

    gamma: float
    scheme: str  # index kind or signature scheme: word|prefix|lsh|variant
    sim_name: str = "extra"
    use_filter: bool = True
    max_candidates: int = 4096
    result_capacity: int = 4096
    lsh: LshParams = LshParams()
    use_kernel: bool = False
    # use_kernel only: compact candidates in the fused_probe epilogue.
    # None resolves to ``use_kernel``; False keeps the two-stage
    # compaction over the packed bitmap.
    kernel_compact: bool | None = None
    # kernel_compact only: a count-only pass sizes the emit pass's lane
    # width to the measured per-tile survivor maximum (host sync).
    adaptive_lanes: bool = False
    # adaptive_lanes only: floor of the adaptive lane width
    # (None -> fused_probe.MIN_LANE_WIDTH).
    lane_width: int | None = None
    # use_kernel only: emit window signatures inside the kernel; None =
    # ``resolve_sig_mode`` decides, False = post-compaction signatures.
    kernel_sigs: bool | None = None
    # kernel_compact only: launch mode of each shard on the streaming
    # paths (extraction.sharded): True = one streamed fused_probe_stream
    # call per shard, False = the per-tile fused_probe loop, None = stream
    # whenever a shard spans >= 2 tiles.
    streamed: bool | None = None

    def __post_init__(self):
        if self.kernel_compact is None:
            object.__setattr__(self, "kernel_compact", self.use_kernel)
        if self.scheme not in SIG_NAMES:
            raise ValueError(
                f"ExtractParams.scheme={self.scheme!r} is not a known "
                f"index kind / signature scheme; pick one of {SIG_NAMES}"
            )
        if not 0.0 < self.gamma <= 1.0:
            raise ValueError(
                f"ExtractParams.gamma={self.gamma} must be in (0, 1]: it is "
                "the similarity threshold of Def. 1 (1.0 = exact match)"
            )
        if self.max_candidates <= 0:
            raise ValueError(
                f"ExtractParams.max_candidates={self.max_candidates} must be "
                "positive: it is the static candidate-buffer capacity (and "
                "the [G, NC] lane width of ops.fused_probe_compact — the "
                "select_from_tiles merge requires lane width >= capacity)"
            )
        if self.result_capacity <= 0:
            raise ValueError(
                f"ExtractParams.result_capacity={self.result_capacity} must "
                "be positive: it is the static Matches-buffer capacity"
            )
        if self.lsh.bands <= 0 or self.lsh.rows <= 0:
            raise ValueError(
                f"ExtractParams.lsh bands={self.lsh.bands} rows="
                f"{self.lsh.rows} must both be positive"
            )
        if self.kernel_compact and not self.use_kernel:
            raise ValueError(
                "ExtractParams(kernel_compact=True) requires use_kernel=True: "
                "the compaction epilogue runs inside the fused_probe kernel, "
                "so there is no epilogue to enable on the unfused path (set "
                "use_kernel=True, or leave kernel_compact unset to track "
                "use_kernel automatically)"
            )
        if self.adaptive_lanes and not self.kernel_compact:
            raise ValueError(
                "ExtractParams(adaptive_lanes=True) requires "
                "kernel_compact=True: the two-pass lane sizing narrows the "
                "compaction epilogue's [G, NC] lanes, so there are no lanes "
                "to size on the bitmap compaction path (set use_kernel=True "
                "and leave kernel_compact unset, or drop adaptive_lanes)"
            )
        if self.lane_width is not None and not self.adaptive_lanes:
            raise ValueError(
                f"ExtractParams(lane_width={self.lane_width}) requires "
                "adaptive_lanes=True: lane_width is the floor of the "
                "adaptive emit-pass width — a fixed width below "
                "max_candidates cannot guarantee exact lane merges, so "
                "the one-pass path always emits full [G, NC] lanes (enable "
                "adaptive_lanes, or drop lane_width)"
            )
        if self.lane_width is not None and not (0 < self.lane_width <= self.max_candidates):
            raise ValueError(
                f"ExtractParams(lane_width={self.lane_width}) must be in "
                f"(0, max_candidates={self.max_candidates}]: it floors the "
                "adaptive emit-pass lane width, and lanes wider than the "
                "select_from_tiles merge capacity are never read"
            )
        if self.streamed and not self.kernel_compact:
            raise ValueError(
                "ExtractParams(streamed=True) requires kernel_compact=True: "
                "the streamed kernel's only products are the compaction "
                "epilogue's per-tile lanes (set use_kernel=True and leave "
                "kernel_compact unset, or drop streamed)"
            )
        if self.kernel_sigs and not self.use_kernel:
            raise ValueError(
                "ExtractParams(kernel_sigs=True) requires use_kernel=True: "
                "in-kernel signature emission happens inside the fused_probe "
                "kernel (set use_kernel=True, or leave kernel_sigs unset "
                "to let resolve_sig_mode decide)"
            )
        if self.kernel_sigs and self.scheme in (SIG_WORD, SIG_PREFIX):
            raise ValueError(
                f"ExtractParams(kernel_sigs=True, scheme={self.scheme!r}): "
                "the word/prefix schemes have no in-kernel signature "
                "recurrence — their window-side signatures are plain token "
                "hashes computed post-compaction; use scheme='lsh' or "
                "'variant', or leave kernel_sigs unset"
            )


def check_flat_index_space(D: int, T: int, max_len: int) -> None:
    """Fail fast when flat window indices (doc*T + pos)*L + len-1 overflow int32."""
    if D * T * max_len >= 2**31:
        raise ValueError(
            f"flat window index space D*T*L = {D}x{T}x{max_len} = "
            f"{D * T * max_len} overflows int32 lane indices; split the "
            "corpus into separate calls (or shrink the batch)"
        )


@dataclasses.dataclass
class DeviceDictionary:
    """Device-resident dictionary slice (tokens + weights)."""

    tokens: torch.Tensor  # [E, L] int32
    token_weight: torch.Tensor  # [V] f32
    entity_offset: int  # global id of entity 0 in this slice

    @classmethod
    def from_host(cls, d: Dictionary, entity_offset: int = 0,
                  device: torch.device | str = "cuda") -> "DeviceDictionary":
        return cls(
            tokens=torch.as_tensor(d.tokens, dtype=torch.int32, device=device),
            token_weight=torch.as_tensor(d.token_weight, dtype=torch.float32, device=device),
            entity_offset=entity_offset,
        )


# --------------------------------------------------------------------------
# Candidate gathering
# --------------------------------------------------------------------------


def survival_mask(doc_tokens, max_len: int, flt: tuple | None, use_kernel: bool = False):
    """[D,T] docs -> (base [D,T,L], survive [D,T,L]).

    Candidate (p, l) survives iff valid (no PAD inside) and, when
    filtering, at least one of its tokens probes into the Bloom filter.
    With ``use_kernel`` the probe is the ``window_filter`` kernel.
    """
    base = window_base(doc_tokens, max_len)
    valid = torch.cumprod((base != PAD).to(torch.int32), dim=-1).bool()
    if flt is None:
        return base, valid
    bits, num_bits, num_hashes = flt
    if use_kernel:
        from repro_torch.kernels import ops as kops

        surv = kops.window_filter(doc_tokens, bits, num_bits, num_hashes, max_len)
    else:
        tok_hit = token_in_filter(bits, num_bits, num_hashes, base)
        surv = torch.cumsum(tok_hit.to(torch.int32), dim=-1) > 0
    return base, valid & surv


def _compact_bit_indices(rows, max_candidates: int):
    """rows [M, L] bool -> ascending flat set-bit indices [NC] (-1 pad).

    Two-stage: the (at most NC) rows with any set bit first, then the
    set bits among them. Exact at any density.
    """
    M, L = rows.shape
    starts, _ = select_nonzero(rows.any(dim=-1), max_candidates)
    starts = starts.long()
    sub = rows[starts.clamp_min(0)] & (starts >= 0)[:, None]  # [NC, L]
    sel, ok = select_nonzero(sub.reshape(-1), max_candidates)
    safe = sel.clamp_min(0).long()
    idx = starts[safe // L].clamp_min(0) * L + safe % L
    return torch.where(ok, idx, -1), ok


def _candidate_dict(toks, ok, d, p, l, n, max_candidates: int) -> dict:
    n = n.to(torch.int32)
    return dict(
        win_tokens=toks.to(torch.int32),
        win_valid=ok,
        doc=torch.where(ok, d, -1).to(torch.int32),
        pos=torch.where(ok, p, -1).to(torch.int32),
        length=torch.where(ok, l + 1, -1).to(torch.int32),
        n_survive=n,
        overflow=(n - max_candidates).clamp_min(0).to(torch.int32),
    )


def compact_candidates(base, survive, max_candidates: int) -> dict:
    """Flatten surviving candidates into fixed-capacity buffers.

    Returns dict with win_tokens [N, L], win_valid [N], doc/pos/length
    [N] (-1 pad), n_survive [] and overflow [] counters.
    """
    D, T, L = base.shape
    idx, ok = _compact_bit_indices(survive.reshape(-1, L), max_candidates)
    safe = idx.clamp_min(0)
    d = safe // (T * L)
    rem = safe % (T * L)
    p = rem // L
    l = rem % L  # length-1
    toks = base[d, p]  # [N, L]
    lens_mask = torch.arange(L, device=base.device)[None, :] <= l[:, None]
    toks = torch.where(lens_mask & ok[:, None], toks, PAD)
    return _candidate_dict(toks, ok, d, p, l, survive.sum(), max_candidates)


def candidates_from_flat(doc_tokens, flat_idx, ok, n_survive, max_len: int,
                         max_candidates: int) -> dict:
    """Build the ``compact_candidates`` dict from selected flat indices.

    ``flat_idx`` [N] are (doc*T + pos)*max_len + (len-1) window indices;
    windows are gathered straight from the [D, T] token rows.
    """
    D, T = doc_tokens.shape
    L = max_len
    dev = doc_tokens.device
    safe = flat_idx.clamp_min(0).long()
    d = safe // (T * L)
    rem = safe % (T * L)
    p = rem // L
    l = rem % L  # length-1
    cols = p[:, None] + torch.arange(L, device=dev)[None, :]  # [N, L]
    toks = doc_tokens[d[:, None], cols.clamp_max(T - 1)]
    lens_mask = (torch.arange(L, device=dev)[None, :] <= l[:, None]) & (cols < T)
    toks = torch.where(lens_mask & ok[:, None], toks, PAD)
    return _candidate_dict(toks, ok, d, p, l, n_survive, max_candidates)


def candidates_from_flat_host(doc_tokens, flat_idx, ok, n_survive, max_len: int,
                              max_candidates: int, device) -> dict:
    """``candidates_from_flat`` with the window gather on the host.

    ``doc_tokens`` is a host [D, T] int32 array (typically an
    ``np.memmap``): the spill path selects candidates from per-shard
    lanes without the corpus ever being on the device, so the [N, L]
    windows are gathered from the host rows, touching only the N*L
    tokens they need, and only they are moved to ``device``. Field for
    field equal to the device gather.
    """
    T = doc_tokens.shape[1]
    L = max_len
    okh = ok.cpu().numpy()
    safe = np.maximum(flat_idx.cpu().numpy(), 0).astype(np.int64)
    d = safe // (T * L)
    rem = safe % (T * L)
    p = rem // L
    l = rem % L  # length-1
    cols = p[:, None] + np.arange(L)[None, :]  # [N, L]
    toks = np.asarray(doc_tokens[d[:, None], np.minimum(cols, T - 1)])
    lens_mask = (np.arange(L)[None, :] <= l[:, None]) & (cols < T)
    toks = np.where(lens_mask & okh[:, None], toks, PAD).astype(np.int32)
    dev = torch.device(device)

    def t(a):
        return torch.as_tensor(a, device=dev)

    return _candidate_dict(t(toks), t(okh), t(d), t(p), t(l), n_survive.to(dev),
                           max_candidates)


def attach_kernel_sigs(cands: dict, kernel_sigs, params: ExtractParams) -> dict:
    """Gather in-kernel [D,T,L,B] band sigs at the compacted candidates.

    Padded slots carry the all-invalid-window band constants, so the
    result equals ``window_signatures`` on them too.
    """
    from repro_torch.kernels.fused_probe import empty_band_sigs

    ok = cands["win_valid"]
    d = cands["doc"].clamp_min(0).long()
    p = cands["pos"].clamp_min(0).long()
    l = (cands["length"] - 1).clamp_min(0).long()
    gathered = kernel_sigs[d, p, l]  # [N, B]
    empty = torch.as_tensor(
        empty_band_sigs(params.lsh.bands, params.lsh.rows).astype(np.int64), device=ok.device
    )
    cands["sigs"] = torch.where(ok[:, None], gathered, empty[None, :])
    cands["sig_mask"] = ok[:, None].expand(gathered.shape)
    return cands


def resolve_sig_mode(params: ExtractParams, D: int, T: int, L: int) -> str:
    """Pick the kernel's in-kernel signature emission mode for a shape.

    * ``lsh``: dense [D,T,L,B] band signatures only when the compacted
      stream covers the whole window grid (``max_candidates >= D*T*L``)
      or ``kernel_sigs=True``;
    * ``variant``: key pairs ride the lanes whenever the epilogue runs;
      without it, the dense tensor follows the lsh rule;
    * ``kernel_sigs=False`` forces post-compaction signatures.
    """
    from repro_torch.kernels.fused_probe import SIG_MODE_LSH, SIG_MODE_NONE, SIG_MODE_VARIANT

    if params.kernel_sigs is False:
        return SIG_MODE_NONE
    forced = params.kernel_sigs is True
    dense = params.max_candidates >= D * T * L
    if params.scheme == SIG_LSH and (dense or forced):
        return SIG_MODE_LSH
    if params.scheme == SIG_VARIANT and (params.kernel_compact or dense or forced):
        return SIG_MODE_VARIANT
    return SIG_MODE_NONE


def attach_variant_keys(cands: dict, keys) -> dict:
    """Attach fused variant key pairs [N, 2] to compacted candidates.

    ``sigs``/``sig_mask`` equal ``window_signatures("variant", ...)``
    over the gathered windows, ``variant_keys`` = (k1, k2) feeds the
    variant index probe. Padded slots carry 0, the set hash of an
    all-PAD window.
    """
    ok = cands["win_valid"]
    k1 = torch.where(ok, keys[:, 0], 0)
    k2 = torch.where(ok, keys[:, 1], 0)
    cands["sigs"] = k1[:, None]
    cands["sig_mask"] = ok[:, None]
    cands["variant_keys"] = (k1, k2)
    return cands


def _popcount_sum(packed, max_len: int):
    shifts = torch.arange(max_len, device=packed.device)
    return ((packed[..., None] >> shifts) & 1).sum()


def fused_filter_compact(doc_tokens, max_len: int, flt: tuple | None,
                         params: ExtractParams, sig_mode: str | None = None) -> dict:
    """use_kernel front end: the fused_probe kernel -> direct compaction.

    Replaces ``survival_mask`` + ``compact_candidates`` (and, for lsh and
    variant, ``window_signatures``) with one ``fused_probe`` pass.
    Candidate selection runs in the kernel's epilogue by default (per-
    tile counts + index lanes merged by ``select_from_tiles``);
    ``params.kernel_compact=False`` compacts from the packed bitmap
    instead, with the same outputs. ``params.adaptive_lanes`` runs a
    count-only pass first and sizes the emit pass's lanes to the
    measured per-tile maximum (``round_lane_width``).
    """
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels.fused_probe import (
        MIN_LANE_WIDTH,
        SIG_MODE_LSH,
        SIG_MODE_VARIANT,
        round_lane_width,
    )

    D, T = doc_tokens.shape
    L = max_len
    if L > 32:
        # the packed bitmap holds one length per uint32 bit; longer
        # windows go through the window_filter kernel + dense compaction
        base, surv = survival_mask(doc_tokens, max_len, flt, use_kernel=True)
        return compact_candidates(base, surv, params.max_candidates)
    if sig_mode is None:
        sig_mode = resolve_sig_mode(params, D, T, L)
    lsh = sig_mode == SIG_MODE_LSH
    var = sig_mode == SIG_MODE_VARIANT
    NC = params.max_candidates
    keys = None
    if params.kernel_compact:
        lane_w = None
        if params.adaptive_lanes:
            counts0 = kops.fused_probe_count(doc_tokens, flt, max_len, NC)
            lane_w = round_lane_width(
                int(counts0.max()), NC, params.lane_width or MIN_LANE_WIDTH
            )
        packed, kernel_sigs, counts, tiles, vkeys = kops.fused_probe_compact(
            doc_tokens, flt, max_len, NC, sig_mode,
            params.lsh.bands, params.lsh.rows, lane_width=lane_w,
        )
        sel, ok, n = select_from_tiles(counts, tiles, NC, complete_tiles=lane_w is not None)
        if var:
            keys = gather_from_tiles(counts, vkeys, NC)  # [NC, 2]
    else:
        packed, kernel_sigs = kops.fused_probe(
            doc_tokens, flt, max_len, sig_mode, params.lsh.bands, params.lsh.rows
        )
        # two-stage compaction off the packed bitmap: nonzero over the
        # [D*T] words, then unpack only the selected words' bits
        shifts = torch.arange(L, device=packed.device)
        flat_words = packed.reshape(-1)
        starts, _ = select_nonzero(flat_words != 0, NC)
        starts = starts.long()
        words = flat_words[starts.clamp_min(0)] * (starts >= 0)
        sub = ((words[:, None] >> shifts[None, :]) & 1).bool()
        ssel, ok = select_nonzero(sub.reshape(-1), NC)
        ssafe = ssel.clamp_min(0).long()
        sel = starts[ssafe // L].clamp_min(0) * L + ssafe % L
        n = _popcount_sum(packed, L)
        if var:
            safe = sel.clamp_min(0)
            d, rem = safe // (T * L), safe % (T * L)
            keys = kernel_sigs[d, rem // L, rem % L]  # [NC, 2]
    cands = candidates_from_flat(doc_tokens, sel, ok, n, max_len, NC)
    if lsh:
        cands = attach_kernel_sigs(cands, kernel_sigs, params)
    if var:
        cands = attach_variant_keys(cands, keys)
    return cands


def window_sigs_for(cands: dict, params: ExtractParams):
    """Window signatures for compacted candidates: the kernel's when the
    fused path provided them, else computed from the gathered windows.
    Returns (sigs [N, S], mask [N, S])."""
    if "sigs" in cands:
        return cands["sigs"], cands["sig_mask"]
    toks = cands["win_tokens"]
    return window_signatures(params.scheme, toks, toks != PAD, params.gamma, params.lsh)


def _emit(cands, hits, scores, ent_global, params: ExtractParams) -> Matches:
    """Flatten per-candidate [N,K] hits into a Matches buffer."""
    N, K = hits.shape

    def rep(a):
        return a.repeat_interleave(K)

    return compact_matches(
        hits.reshape(-1),
        rep(cands["doc"]),
        rep(cands["pos"]),
        rep(cands["length"]),
        ent_global.reshape(-1),
        scores.reshape(-1),
        params.result_capacity,
    )


# --------------------------------------------------------------------------
# Index-on-Entities (§3.2)
# --------------------------------------------------------------------------


@dataclasses.dataclass
class BuiltIndex:
    """One memory-budget partition of an entity index (device tensors).

    Variant keys are int64 tensors holding uint32 values.
    """

    kind: str
    entity_offset: int
    postings: torch.Tensor | None = None  # [V, P] int32 (inverted kinds)
    keys1: torch.Tensor | None = None  # [n_buckets, cap] (variant kind)
    keys2: torch.Tensor | None = None
    ents: torch.Tensor | None = None  # [n_buckets, cap] int32
    n_buckets: int = 0
    nbytes: int = 0


def built_variant_part(keys1, keys2, ents, n_buckets: int, entity_offset: int,
                       device, nbytes: int = 0) -> BuiltIndex:
    """A variant ``BuiltIndex`` from host arrays (uint32 keys)."""
    return BuiltIndex(
        kind=INDEX_VARIANT,
        entity_offset=entity_offset,
        keys1=torch.as_tensor(np.asarray(keys1, np.uint32).astype(np.int64), device=device),
        keys2=torch.as_tensor(np.asarray(keys2, np.uint32).astype(np.int64), device=device),
        ents=torch.as_tensor(np.array(ents, np.int32), device=device),
        n_buckets=int(n_buckets),
        nbytes=nbytes,
    )


def build_index_partitions(dictionary: Dictionary, kind: str, gamma: float,
                           memory_budget_bytes: int, entity_offset: int = 0,
                           device: torch.device | str = "cuda") -> list[BuiltIndex]:
    """Split entities into ranges whose index each fits the budget
    (Def. 3's |E| / M_e multi-pass structure)."""
    E = dictionary.num_entities
    if E == 0:
        return []
    parts: list[BuiltIndex] = []
    start = 0
    # bytes per entity from a probe build on a small slice
    probe = dictionary.slice(0, min(E, 256))
    if kind == INDEX_VARIANT:
        probe_idx = build_variant_index(probe, gamma)
    else:
        probe_idx = build_inverted_index(probe, kind, gamma)
    per_entity = max(probe_idx.nbytes / probe.num_entities, 1.0)
    chunk = max(int(memory_budget_bytes / per_entity), 1)
    while start < E:
        stop = min(start + chunk, E)
        sl = dictionary.slice(start, stop)
        if kind == INDEX_VARIANT:
            vi = build_variant_index(sl, gamma)
            parts.append(built_variant_part(vi.keys1, vi.keys2, vi.entity_id, vi.n_buckets,
                                            entity_offset + start, device, vi.nbytes))
        else:
            ii = build_inverted_index(sl, kind, gamma)
            parts.append(BuiltIndex(
                kind=kind,
                entity_offset=entity_offset + start,
                postings=torch.as_tensor(ii.postings_padded, device=device),
                nbytes=ii.nbytes,
            ))
        start = stop
    return parts


def _offset_ids(ents, part_offset: int, ddict: DeviceDictionary):
    """Part-local entity ids -> ids into ``ddict`` (-1 stays -1)."""
    return ents + (part_offset - ddict.entity_offset) * (ents >= 0).to(ents.dtype)


def candidate_pairs(cands: dict, source, ddict: DeviceDictionary, params: ExtractParams):
    """The probe step of one index part or signature table.

    ``source`` is a ``BuiltIndex`` or a ``SigTable``. Returns the window
    tokens [N, L], the source-local candidate entities [N, K] (-1
    invalid), the same ids into ``ddict`` (the verify step's ``ent_ids``)
    and the threshold to verify at.
    """
    toks, ok = cands["win_tokens"], cands["win_valid"]
    if isinstance(source, SigTable):
        sigs, mask = window_sigs_for(cands, params)
        ents = probe_sig_table(source, sigs, mask & ok[:, None])
        gamma = 0.0 if params.scheme == SIG_VARIANT else params.gamma
    elif source.kind == INDEX_VARIANT:
        if "variant_keys" in cands:
            k1, k2 = cands["variant_keys"]  # computed in the kernel
        else:
            k1, k2 = window_variant_key(toks, toks != PAD)
        ents = query_variant(source.keys1, source.keys2, source.ents, source.n_buckets, k1, k2)
        ents = torch.where(ok[:, None], ents, -1)
        gamma = 0.0  # variant lookups are exact: no threshold re-check
    else:
        ents = query_inverted(source.postings, toks, toks != PAD)  # [N, L*P]
        ents = torch.where(ok[:, None], ents, -1)
        gamma = params.gamma
    return toks, ents, _offset_ids(ents, source.entity_offset, ddict), gamma


def _probe_verify(cands: dict, source, ddict: DeviceDictionary, params: ExtractParams) -> Matches:
    toks, ents, ent_ids, gamma = candidate_pairs(cands, source, ddict, params)
    hits, scores = verify_pairs(
        toks,
        ent_ids,
        ddict.tokens,
        ddict.token_weight,
        gamma=gamma,
        sim_name=params.sim_name,
        use_kernel=params.use_kernel,
    )
    hits = dedup_hits(hits, ents)
    ent_global = torch.where(ents >= 0, ents + source.entity_offset, -1)
    return _emit(cands, hits, scores, ent_global, params)


def extract_index_part(cands: dict, part: BuiltIndex, ddict: DeviceDictionary,
                       params: ExtractParams) -> Matches:
    """One pass of index lookups + verification over compacted candidates."""
    return _probe_verify(cands, part, ddict, params)


# --------------------------------------------------------------------------
# (ISHFilter &) SSJoin (§3.1/3.3): signature probe against a sig table
# --------------------------------------------------------------------------


@dataclasses.dataclass
class SigTable:
    """Static bucketed hash table: signature -> entity ids.

    Keys are int64 tensors holding uint32 values.
    """

    keys1: torch.Tensor  # [B, cap]
    keys2: torch.Tensor
    ents: torch.Tensor  # [B, cap] int32, -1 pad
    n_buckets: int
    bucket_cap: int
    entity_offset: int
    nbytes: int = 0
    skew: float = 1.0  # max/mean bucket load


def sig_table_from_arrays(keys1, keys2, ents, entity_offset: int, device,
                          skew: float = 1.0) -> SigTable:
    """A ``SigTable`` from host arrays (uint32 keys, int32 entities)."""
    keys1 = np.asarray(keys1, np.uint32)
    keys2 = np.asarray(keys2, np.uint32)
    ents = np.array(ents, np.int32)
    return SigTable(
        keys1=torch.as_tensor(keys1.astype(np.int64), device=device),
        keys2=torch.as_tensor(keys2.astype(np.int64), device=device),
        ents=torch.as_tensor(ents, device=device),
        n_buckets=int(keys1.shape[0]),
        bucket_cap=int(keys1.shape[1]),
        entity_offset=entity_offset,
        nbytes=int(keys1.nbytes + keys2.nbytes + ents.nbytes),
        skew=skew,
    )


def build_sig_table(esigs: EntitySignatures, entity_offset: int = 0,
                    load_factor: float = 0.5, device: torch.device | str = "cuda") -> SigTable:
    sig = esigs.sig.astype(np.uint32)
    n = max(len(sig), 1)
    n_buckets = 1 << max(3, int(np.ceil(np.log2(n / load_factor + 1))))
    k2 = hashing.hash_u32(sig, seed=_SIGKEY_SEED)
    bucket = _bucket_of(sig, n_buckets).astype(np.int64)
    counts = np.bincount(bucket, minlength=n_buckets)
    cap = max(4, int(counts.max()) if counts.size else 4)
    keys1 = np.zeros((n_buckets, cap), dtype=np.uint32)
    keys2 = np.zeros((n_buckets, cap), dtype=np.uint32)
    ents = np.full((n_buckets, cap), -1, dtype=np.int32)
    if len(sig):
        # stable sort groups rows by bucket, insertion order within each
        order = np.argsort(bucket, kind="stable")
        sb = bucket[order]
        rank = np.arange(len(sig)) - np.searchsorted(sb, sb)
        keys1[sb, rank] = sig[order]
        keys2[sb, rank] = k2[order]
        ents[sb, rank] = esigs.entity_id[order]
    mean = max(counts.mean(), 1e-9)
    skew = float(counts.max() / mean) if counts.size else 1.0
    return sig_table_from_arrays(keys1, keys2, ents, entity_offset, device, skew)


def probe_sig_table(table: SigTable, sigs, sig_mask):
    """sigs [N, S] -> candidate entities [N, S*cap] (-1 invalid)."""
    k2 = hashing.hash_u32(sigs, seed=_SIGKEY_SEED)
    b = _bucket_of(sigs, table.n_buckets)
    tk1, tk2, te = table.keys1[b], table.keys2[b], table.ents[b]  # [N,S,cap]
    hit = (tk1 == sigs[..., None]) & (tk2 == k2[..., None]) & (te >= 0)
    hit = hit & sig_mask[..., None]
    ents = torch.where(hit, te, -1)
    return ents.reshape(ents.shape[0], -1)


def extract_ssjoin_local(cands: dict, table: SigTable, ddict: DeviceDictionary,
                         params: ExtractParams) -> Matches:
    """SSJoin probe + verify with the signature table fully local."""
    return _probe_verify(cands, table, ddict, params)

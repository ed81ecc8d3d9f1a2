"""Sharded streaming extraction: the candidate front end over shards.

The paper's operator exists because extraction must scale past one
device's memory: documents are split into shards and each shard streams
through the probe kernel, as in ``repro.extraction.sharded``:

    corpus [D, T]
      └─ shards of ``shard_docs`` rows          (host-side split, PAD-padded)
           └─ tiles of ``tile_docs`` rows       (one streamed probe per shard)
                └─ fused_probe epilogue         (per-tile count + index lanes)

Every combine step (tile lanes -> shard lane -> global candidate buffer)
runs ``select_from_tiles`` over the small count/index lanes, never over
the survival bitmap. Per-tile and per-shard lanes keep the first NC
survivors in ascending flat order and their true totals, so the final
selection equals ``engine.fused_filter_compact`` on the whole batch at
any shard geometry. The variant scheme's key pairs ride the lanes as a
``[G, NC, 2]`` payload; ``ExtractParams(adaptive_lanes=True)`` narrows
the tile lanes to a width measured by a count-only pass.

A shard that spans two or more tiles goes through the streamed kernel
(``ops.fused_probe_stream``, one call per shard); otherwise the per-tile
``fused_probe`` loop runs (``resolve_streamed``). Both give the same
lanes bit for bit.

``spill_filter_compact`` streams a corpus that lives in a file
(``MemmapCorpus``): shards are file regions staged through one pinned
host buffer, and per-shard lanes can be checkpointed so an interrupted
job resumes (``LaneCheckpointStore``). Checkpoints and manifests are
interchangeable with the reference package's.

Not ported yet: the reference's ``mesh=`` path (shard waves across the
devices of a mesh), ``shard_lane_steady`` (steady-state lane sizing for
serving) and ``lanes_to_wire``/``lanes_from_wire`` (lane transport).
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import os

import numpy as np
import torch

from repro_torch.core.dictionary import PAD
from repro_torch.extraction import engine
from repro_torch.extraction.results import (
    gather_from_tiles,
    load_lane_checkpoint,
    save_lane_checkpoint,
    select_from_tiles,
)

#: default rows per streaming tile
DEFAULT_TILE_DOCS = 64

#: default device-resident budget for spill streaming: how many bytes of
#: staged documents one shard may occupy on the device (see
#: ``shard_docs_for_budget`` for the headroom rule).
DEFAULT_DEVICE_BUDGET_BYTES = 256 << 20


@dataclasses.dataclass(frozen=True)
class ShardSpec:
    """Static geometry of one sharded streaming run."""

    total_docs: int  # true corpus rows (pre-padding)
    shard_docs: int  # rows per shard (last shard PAD-padded up to this)
    num_shards: int
    tile_docs: int  # rows per probe tile within a shard

    @property
    def tiles_per_shard(self) -> int:
        return -(-self.shard_docs // self.tile_docs)


def plan_shards(total_docs: int, n_workers: int = 1, shard_docs: int | None = None,
                tile_docs: int | None = None) -> ShardSpec:
    """Choose a shard geometry: default one shard per worker.

    Shard and tile heights are clamped to the corpus, so a request
    larger than ``total_docs`` does not pad every shard with PAD rows.
    """
    if total_docs <= 0:
        raise ValueError(f"plan_shards(total_docs={total_docs}): the corpus is empty")
    sd = min(shard_docs or -(-total_docs // max(n_workers, 1)), total_docs)
    td = min(tile_docs or DEFAULT_TILE_DOCS, sd)
    return ShardSpec(total_docs=total_docs, shard_docs=sd, num_shards=-(-total_docs // sd),
                     tile_docs=td)


def resolve_streamed(params: engine.ExtractParams, n_tiles: int) -> bool:
    """Per-shard launch mode: one streamed call vs the per-tile loop.

    ``params.streamed`` overrides; ``None`` streams whenever the shard
    spans >= 2 tiles.
    """
    if params.streamed is not None:
        return bool(params.streamed)
    return n_tiles >= 2


def _pad_rows(docs, rows: int):
    """``docs`` with PAD rows appended up to ``rows``."""
    if docs.shape[0] == rows:
        return docs
    out = torch.full((rows, docs.shape[1]), PAD, dtype=docs.dtype, device=docs.device)
    out[:docs.shape[0]] = docs
    return out


def _streamed_layout(docs, td: int, n_tiles: int, bd: int):
    """Chunk layout for the streamed kernel.

    The per-tile loop pads each [td, T] tile on its own to a multiple of
    the NC-derived sub-tile height ``bd``; the streamed buffer replays
    that layout (each tile padded to ``td_p = ceil(td/bd)*bd`` rows) and
    the per-chunk row offsets keep the unpadded numbering
    ``i*td + j*bd``, so flat indices match the per-tile path. Returns
    ``(docs [n_tiles*td_p, T], offs [n_tiles*(td_p//bd)] int32 numpy)``.
    """
    T = docs.shape[1]
    td_p = -(-td // bd) * bd
    if td_p != td:
        padded = torch.full((n_tiles, td_p, T), PAD, dtype=docs.dtype, device=docs.device)
        padded[:, :td] = docs.reshape(n_tiles, td, T)
        docs = padded.reshape(n_tiles * td_p, T)
    gp = td_p // bd
    offs = (np.arange(n_tiles)[:, None] * td + np.arange(gp)[None, :] * bd).reshape(-1)
    return docs, offs.astype(np.int32)


def _count_stream(stream_stats: dict | None, chunks: int) -> None:
    if stream_stats is not None:
        for k, v in (("streamed_launches", 1), ("tiles_streamed", chunks),
                     ("dma_waits", chunks)):
            stream_stats[k] = stream_stats.get(k, 0) + v


def _tiles(docs, tile_docs: int):
    """(docs padded to whole tiles, tile height, tile count)."""
    S = docs.shape[0]
    td = min(tile_docs, S)
    n_tiles = -(-S // td)
    return _pad_rows(docs, n_tiles * td), td, n_tiles


def stream_probe_tiles(docs, max_len: int, flt: tuple | None, params: engine.ExtractParams,
                       tile_docs: int = DEFAULT_TILE_DOCS, row_offset: int = 0,
                       lane_width: int | None = None, sig_mode: str | None = None,
                       stream_stats: dict | None = None):
    """Stream a [S, T] doc shard through the probe tile by tile.

    Returns ``(counts [G], cands [G, W], vkeys)`` candidate lanes over
    the whole shard (``W = lane_width or NC``; ``vkeys`` [G, W, 2] int32
    bit patterns of the uint32 key pairs when ``sig_mode == "variant"``,
    else None; ``fused_probe.widen_keys`` widens the selected ones), flat
    indices globalised by ``row_offset`` rows. The launch mode follows
    ``resolve_streamed``; both modes give the same lanes.
    ``stream_stats`` accumulates the reference's counters
    ``streamed_launches``, ``tiles_streamed`` and ``dma_waits`` (one per
    streamed chunk).
    """
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels.fused_probe import (
        SIG_MODE_NONE,
        SIG_MODE_VARIANT,
        compact_tile_height,
        narrow_keys,
    )

    sig_mode = SIG_MODE_NONE if sig_mode is None else sig_mode
    var = sig_mode == SIG_MODE_VARIANT
    T = docs.shape[1]
    L = max_len
    NC = params.max_candidates
    docs, td, n_tiles = _tiles(docs, tile_docs)

    if resolve_streamed(params, n_tiles):
        bd = compact_tile_height(td, T, NC)
        sdocs, offs = _streamed_layout(docs, td, n_tiles, bd)
        row_offs = torch.as_tensor((offs.astype(np.int64) + row_offset).astype(np.int32),
                                   device=docs.device)
        out = kops.fused_probe_stream(sdocs, flt, L, NC, row_offs, sig_mode=sig_mode, bd=bd,
                                      lane_width=lane_width)
        _count_stream(stream_stats, int(offs.shape[0]))
        return out

    out_counts, out_cands, out_keys = [], [], []
    for i in range(n_tiles):
        _, _, cnt, cd, vk = kops.fused_probe_compact(
            docs[i * td:(i + 1) * td], flt, L, NC, sig_mode,
            params.lsh.bands, params.lsh.rows, lane_width=lane_width,
        )
        off = (row_offset + i * td) * T * L
        out_counts.append(cnt)
        out_cands.append(torch.where(cd >= 0, cd + off, -1))
        if var:
            out_keys.append(narrow_keys(vk))
    return (torch.cat(out_counts), torch.cat(out_cands, dim=0),
            torch.cat(out_keys, dim=0) if var else None)


def stream_tile_counts(docs, max_len: int, flt: tuple | None, params: engine.ExtractParams,
                       tile_docs: int = DEFAULT_TILE_DOCS, stream_stats: dict | None = None):
    """Count-only pass: per-sub-tile survivor counts [G].

    Streams the tile/sub-tile grid of ``stream_probe_tiles`` (the emit
    width never changes the grid) and keeps only the counts, with the
    same launch-mode choice.
    """
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels.fused_probe import compact_tile_height

    T = docs.shape[1]
    NC = params.max_candidates
    docs, td, n_tiles = _tiles(docs, tile_docs)
    if resolve_streamed(params, n_tiles):
        bd = compact_tile_height(td, T, NC)
        sdocs, offs = _streamed_layout(docs, td, n_tiles, bd)
        counts, _, _ = kops.fused_probe_stream(
            sdocs, flt, max_len, NC, torch.as_tensor(offs, device=docs.device), bd=bd,
            count_only=True,
        )
        _count_stream(stream_stats, int(offs.shape[0]))
        return counts
    return torch.cat([kops.fused_probe_count(docs[i * td:(i + 1) * td], flt, max_len, NC)
                      for i in range(n_tiles)])


def _adaptive_width(docs, max_len, flt, params, tile_docs) -> int:
    """Measure per-tile survivor maxima and round to the emit width."""
    from repro_torch.kernels.fused_probe import MIN_LANE_WIDTH, round_lane_width

    counts = stream_tile_counts(docs, max_len, flt, params, tile_docs)
    return round_lane_width(int(counts.max()), params.max_candidates,
                            params.lane_width or MIN_LANE_WIDTH)


def _stream_sig_mode(params: engine.ExtractParams, D: int, T: int, max_len: int) -> str:
    """Signature mode for the streaming tile lanes.

    Variant key pairs ride the lanes; dense lsh band signatures have no
    lane to ride, so lsh is coerced to ``none`` (the signatures are
    recomputed post-compaction, bit-identical), and a forced
    ``kernel_sigs=True`` for lsh raises instead of being dropped.
    """
    from repro_torch.kernels.fused_probe import SIG_MODE_LSH, SIG_MODE_NONE

    mode = engine.resolve_sig_mode(params, D, T, max_len)
    if mode == SIG_MODE_LSH:
        if params.kernel_sigs:
            raise ValueError(
                "ExtractParams(kernel_sigs=True, scheme='lsh') cannot run "
                "on the sharded streaming path: dense in-kernel band sigs "
                "do not ride the candidate lanes; use the single-call "
                "engine.fused_filter_compact for forced in-kernel band "
                "sigs, or leave kernel_sigs unset (the streaming path "
                "recomputes bit-identical band sigs post-compaction)"
            )
        return SIG_MODE_NONE
    return mode


def stream_filter_compact(doc_tokens, max_len: int, flt: tuple | None,
                          params: engine.ExtractParams,
                          tile_docs: int = DEFAULT_TILE_DOCS) -> dict:
    """Single-device streaming equivalent of ``engine.fused_filter_compact``.

    Tiles the batch through the probe, then merges the per-tile lanes;
    the candidate dict equals the single-call path's (lsh signatures are
    recomputed post-compaction, so ``sigs`` is absent for lsh). Honors
    ``params.adaptive_lanes``. Falls back to the single-call path where
    the epilogue cannot run (L > 32 or ``kernel_compact=False``).
    """
    from repro_torch.kernels.fused_probe import SIG_MODE_VARIANT, widen_keys

    if max_len > 32 or not params.kernel_compact:
        return engine.fused_filter_compact(doc_tokens, max_len, flt, params)
    D, T = doc_tokens.shape
    sig_mode = _stream_sig_mode(params, D, T, max_len)
    NC = params.max_candidates
    lane_w = None
    if params.adaptive_lanes:
        lane_w = _adaptive_width(doc_tokens, max_len, flt, params, tile_docs)
    counts, cands, vkeys = stream_probe_tiles(doc_tokens, max_len, flt, params, tile_docs,
                                              lane_width=lane_w, sig_mode=sig_mode)
    sel, ok, n = select_from_tiles(counts, cands, NC, complete_tiles=lane_w is not None)
    out = engine.candidates_from_flat(doc_tokens, sel, ok, n, max_len, NC)
    if sig_mode == SIG_MODE_VARIANT:
        out = engine.attach_variant_keys(out, widen_keys(gather_from_tiles(counts, vkeys, NC)))
    return out


def shard_lane(docs, row_offset: int, max_len: int, flt: tuple | None,
               params: engine.ExtractParams, tile_docs: int = DEFAULT_TILE_DOCS,
               lane_width: int | None = None, sig_mode: str | None = None,
               stream_stats: dict | None = None):
    """Stream one doc shard and reduce it to a single candidate lane.

    The lane wire unit, as in the reference:

    * ``cand`` [1, NC] int32: the shard's first NC surviving windows as
      ascending global flat indices ``(doc*T + pos)*L + (len-1)``, ``doc``
      globalised by ``row_offset``; -1 in unused slots;
    * ``count`` [1] int32: the shard's true survivor total (may exceed NC);
    * ``keys`` [1, NC, 2] (int64 holding uint32) or None: the slots'
      variant key pairs, 0 in padded slots.

    With ``params.adaptive_lanes`` the internal tile lanes are sized by a
    count-only pass unless ``lane_width`` is given.
    """
    from repro_torch.kernels.fused_probe import SIG_MODE_VARIANT, widen_keys

    if sig_mode is None:
        D, T = docs.shape
        sig_mode = _stream_sig_mode(params, D, T, max_len)
    NC = params.max_candidates
    if params.adaptive_lanes and lane_width is None:
        lane_width = _adaptive_width(docs, max_len, flt, params, tile_docs)
    counts, cands, vkeys = stream_probe_tiles(
        docs, max_len, flt, params, tile_docs, row_offset=row_offset,
        lane_width=lane_width, sig_mode=sig_mode, stream_stats=stream_stats,
    )
    complete = lane_width is not None and lane_width < NC
    sel, ok, n = select_from_tiles(counts, cands, NC, complete_tiles=complete)
    keys = None
    if sig_mode == SIG_MODE_VARIANT:
        keys = widen_keys(gather_from_tiles(counts, vkeys, NC))[None, :, :]
    return torch.where(ok, sel, -1)[None, :], n[None].to(torch.int32), keys


def _merge_lanes(lanes, totals, keys, max_candidates: int):
    """Global selection over per-shard lanes: (sel, ok, n, merged keys)."""
    counts = torch.cat(totals)
    sel, ok, n = select_from_tiles(counts, torch.cat(lanes, dim=0), max_candidates)
    merged = (gather_from_tiles(counts, torch.cat(keys, dim=0), max_candidates)
              if keys else None)
    return sel, ok, n, merged


def sharded_filter_compact(doc_tokens, max_len: int, flt: tuple | None,
                           params: engine.ExtractParams, mesh=None,
                           shard_docs: int | None = None, tile_docs: int | None = None,
                           checkpoint_dir: str | None = None,
                           stream_stats: dict | None = None) -> dict:
    """Shard-parallel streaming candidate front end.

    Splits the batch into ``shard_docs``-row shards, streams each through
    the probe (``shard_lane``) and merges the per-shard lanes into one
    ``compact_candidates`` dict, equal to ``engine.fused_filter_compact``
    on the whole batch. Ragged tails are PAD-padded (PAD rows never
    survive). ``checkpoint_dir`` makes the run resumable: every finished
    shard's lane is persisted (``LaneCheckpointStore``) and a restarted
    call with the same job loads it instead of probing again.

    ``mesh`` must be None: shard waves across the devices of a mesh are
    not ported yet (ROADMAP queue A6).
    """
    from repro_torch.kernels.fused_probe import SIG_MODE_VARIANT

    if mesh is not None:
        raise NotImplementedError(
            "sharded_filter_compact(mesh=...): shard waves across the devices "
            "of a mesh are not ported yet (ROADMAP queue A6); pass mesh=None "
            "to stream the shards on one device"
        )
    if max_len > 32 or not params.kernel_compact:
        # no epilogue -> no lanes to shard over; single-call fallback
        return engine.fused_filter_compact(doc_tokens, max_len, flt, params)
    D, T = doc_tokens.shape
    engine.check_flat_index_space(D, T, max_len)
    sig_mode = _stream_sig_mode(params, D, T, max_len)
    var = sig_mode == SIG_MODE_VARIANT
    spec = plan_shards(D, 1, shard_docs, tile_docs)
    NC = params.max_candidates
    padded = _pad_rows(doc_tokens, spec.num_shards * spec.shard_docs)
    store = None
    if checkpoint_dir is not None:
        store = LaneCheckpointStore(checkpoint_dir,
                                    job_manifest(spec, T, max_len, params, flt, sig_mode))

    lanes, totals, keys = [], [], []
    for s in range(spec.num_shards):
        if store is not None and store.has(s):
            lane, n, vk = store.load(s, doc_tokens.device)
        else:
            lane, n, vk = shard_lane(
                padded[s * spec.shard_docs:(s + 1) * spec.shard_docs], s * spec.shard_docs,
                max_len, flt, params, spec.tile_docs, sig_mode=sig_mode,
                stream_stats=stream_stats,
            )
            if store is not None:
                store.save(s, lane, n, vk if var else None)
        lanes.append(lane)
        totals.append(n)
        if var:
            keys.append(vk)

    if store is not None and stream_stats is not None:
        store.flush_stats(stream_stats)
    sel, ok, n, merged = _merge_lanes(lanes, totals, keys, NC)
    out = engine.candidates_from_flat(doc_tokens, sel, ok, n, max_len, NC)
    if var:
        out = engine.attach_variant_keys(out, merged)
    return out


# --------------------------------------------------------------------------
# Corpus spill streaming: shards as file regions, resumable merges
# --------------------------------------------------------------------------


def filter_fingerprint(flt: tuple | None) -> str:
    """Content hash of an ISH filter triple (checkpoint-manifest guard).

    Hashes the filter's 4-byte words, whose bytes are the same as int32
    here and as uint32 in the reference, so both packages agree.
    """
    if flt is None:
        return "none"
    bits, num_bits, num_hashes = flt
    words = bits.cpu().numpy() if isinstance(bits, torch.Tensor) else np.asarray(bits)
    h = hashlib.sha256(words.tobytes())
    h.update(f":{num_bits}:{num_hashes}".encode())
    return h.hexdigest()


def job_manifest(spec: ShardSpec, seq_len: int, max_len: int, params: engine.ExtractParams,
                 flt: tuple | None, sig_mode: str) -> dict:
    """Everything that must match for two runs to share lane checkpoints:
    geometry, extraction params and the filter fingerprint (JSON-round-
    tripped, equal to the reference's manifest for the same job)."""
    m = {
        "format": 1,
        "total_docs": spec.total_docs,
        "shard_docs": spec.shard_docs,
        "num_shards": spec.num_shards,
        "tile_docs": spec.tile_docs,
        "seq_len": seq_len,
        "max_len": max_len,
        "sig_mode": sig_mode,
        "filter": filter_fingerprint(flt),
        "params": dataclasses.asdict(params),
    }
    return json.loads(json.dumps(m))


class LaneCheckpointStore:
    """Per-shard lane checkpoints + job manifest under one directory.

    Layout: ``manifest.json`` plus one ``shard_NNNNNN.npz`` per finished
    shard (atomic writes). A second run with an equal manifest resumes;
    one with a different manifest raises instead of merging foreign
    lanes (``reset=True`` wipes the stale checkpoints and starts over).
    """

    def __init__(self, root: str, manifest: dict, reset: bool = False):
        self.root = root
        self.writes = 0
        self.hits = 0
        os.makedirs(root, exist_ok=True)
        mpath = os.path.join(root, "manifest.json")
        existing = None
        if os.path.exists(mpath):
            with open(mpath) as f:
                existing = json.load(f)
        if existing is not None and not reset:
            if existing != manifest:
                diff = sorted(k for k in set(existing) | set(manifest)
                              if existing.get(k) != manifest.get(k))
                raise ValueError(
                    f"checkpoint manifest mismatch in {root!r} (differing "
                    f"keys: {diff}): these lane checkpoints belong to a "
                    "different corpus job (other geometry, params, or "
                    "filter) and merging them would corrupt the selection; "
                    "point checkpoint_dir at a fresh directory, or pass "
                    "reset=True to discard the stale checkpoints"
                )
            return  # same job: resume against the existing checkpoints
        if existing is not None:
            for name in os.listdir(root):
                if name.startswith("shard_") and name.endswith(".npz"):
                    os.remove(os.path.join(root, name))
        tmp = f"{mpath}.tmp.{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump(manifest, f, indent=1)
        os.replace(tmp, mpath)

    def _path(self, shard: int) -> str:
        return os.path.join(self.root, f"shard_{shard:06d}.npz")

    def has(self, shard: int) -> bool:
        return os.path.exists(self._path(shard))

    def load(self, shard: int, device):
        self.hits += 1
        return load_lane_checkpoint(self._path(shard), device)

    def save(self, shard: int, lane, count, keys=None) -> None:
        save_lane_checkpoint(self._path(shard), lane, count, keys)
        self.writes += 1

    def flush_stats(self, stream_stats: dict) -> None:
        """Fold this store's counters into a ``stream_stats`` dict."""
        stream_stats["checkpoint_writes"] = stream_stats.get("checkpoint_writes", 0) + self.writes
        stream_stats["checkpoint_hits"] = stream_stats.get("checkpoint_hits", 0) + self.hits


@dataclasses.dataclass
class MemmapCorpus:
    """A corpus as a file: flat int32 ``<base>.bin`` + ``<base>.json``
    header, the reference's format. ``tokens`` is usually an
    ``np.memmap`` (``open``), but any host [D, T] int32 array will do."""

    tokens: np.ndarray  # [D, T] int32

    @property
    def rows(self) -> int:
        return int(self.tokens.shape[0])

    @property
    def seq_len(self) -> int:
        return int(self.tokens.shape[1])

    @classmethod
    def write(cls, path_base: str, docs) -> "MemmapCorpus":
        """Persist ``docs`` [D, T] as ``<base>.bin`` + ``<base>.json``."""
        if isinstance(docs, torch.Tensor):
            docs = docs.cpu().numpy()
        arr = np.ascontiguousarray(np.asarray(docs, dtype=np.int32))
        with open(path_base + ".bin", "wb") as f:
            f.write(arr.tobytes())
        with open(path_base + ".json", "w") as f:
            json.dump({"format": 1, "rows": int(arr.shape[0]), "seq_len": int(arr.shape[1]),
                       "dtype": "int32"}, f)
        return cls.open(path_base)

    @classmethod
    def open(cls, path_base: str) -> "MemmapCorpus":
        with open(path_base + ".json") as f:
            hdr = json.load(f)
        if hdr.get("dtype", "int32") != "int32":
            raise ValueError(f"MemmapCorpus {path_base!r}: dtype {hdr['dtype']!r}, want int32")
        tokens = np.memmap(path_base + ".bin", dtype=np.int32, mode="r",
                           shape=(hdr["rows"], hdr["seq_len"]))
        return cls(tokens=tokens)


class HostSpillStreamer:
    """Host -> device spill feed through one reusable staging buffer.

    Stages shard-sized file regions through a single preallocated
    [shard_docs, T] host buffer, ragged tails PAD-padded in place. For a
    CUDA device the buffer is pinned and the copy to the device does not
    block the host; before the buffer is refilled, ``stage`` waits on the
    event recorded after the previous copy, so a shard still in flight is
    never overwritten. ``bytes_staged`` counts the host -> device traffic.
    """

    def __init__(self, corpus: MemmapCorpus, shard_docs: int, device):
        self.corpus = corpus
        self.shard_docs = shard_docs
        self.device = torch.device(device)
        self._pinned = self.device.type == "cuda"
        self._buf = torch.empty((shard_docs, corpus.seq_len), dtype=torch.int32,
                                pin_memory=self._pinned)
        self._host = self._buf.numpy()
        self._copied = None  # event after the last copy out of the buffer
        self.bytes_staged = 0

    def stage(self, shard: int):
        """Copy shard ``shard``'s file region in; return it on the device."""
        start = shard * self.shard_docs
        rows = min(self.shard_docs, self.corpus.rows - start)
        if rows <= 0:
            raise ValueError(f"shard {shard} starts past the corpus ({self.corpus.rows} rows)")
        if self._copied is not None:
            self._copied.synchronize()  # the previous shard has left the buffer
        self._host[:rows] = self.corpus.tokens[start:start + rows]
        if rows < self.shard_docs:
            self._host[rows:] = PAD
        self.bytes_staged += self._host.nbytes
        if not self._pinned:
            return self._buf.clone().to(self.device)
        out = self._buf.to(self.device, non_blocking=True)
        self._copied = torch.cuda.Event()
        self._copied.record(torch.cuda.current_stream(self.device))
        return out


def shard_docs_for_budget(total_docs: int, seq_len: int, budget_bytes: int,
                          tile_docs: int | None = None) -> int:
    """Largest shard height whose staged docs fit ``budget_bytes`` twice
    (the shard being probed plus the next one's staging copy), rounded
    down to whole tiles and floored at one tile."""
    td = tile_docs or DEFAULT_TILE_DOCS
    rows = int(budget_bytes) // (seq_len * 4 * 2)
    rows = max(td, (rows // td) * td)
    return max(1, min(rows, total_docs))


def spill_filter_compact(corpus, max_len: int, flt: tuple | None,
                         params: engine.ExtractParams, device_budget_bytes: int | None = None,
                         shard_docs: int | None = None, tile_docs: int | None = None,
                         checkpoint_dir: str | None = None, reset_checkpoints: bool = False,
                         stream_stats: dict | None = None,
                         fail_after_shards: int | None = None, device=None) -> dict:
    """Corpus-scale candidate front end: shards as file regions.

    Each shard of ``corpus`` (a ``MemmapCorpus`` or any host [D, T] int32
    array) is staged through one reusable host buffer
    (``HostSpillStreamer``), probed by the streamed kernel
    (``shard_lane``) and reduced to its lane; only lanes and one staged
    shard are ever on the device. Shard height comes from ``shard_docs``
    or the ``device_budget_bytes`` rule (``shard_docs_for_budget``,
    default ``DEFAULT_DEVICE_BUDGET_BYTES``). With ``checkpoint_dir``
    every finished shard's lane is persisted and an interrupted run
    resumes to identical merged results. The final window gather reads
    the host corpus (``engine.candidates_from_flat_host``).

    ``device`` defaults to the filter's device, else ``"cuda"``.
    ``fail_after_shards`` is the kill-switch test hook: raise after
    probing that many fresh shards in this run.
    """
    from repro_torch.kernels.fused_probe import SIG_MODE_VARIANT

    if not isinstance(corpus, MemmapCorpus):
        corpus = MemmapCorpus(tokens=np.asarray(corpus))
    if device is None:
        device = flt[0].device if flt is not None else torch.device("cuda")
    D, T = corpus.rows, corpus.seq_len
    engine.check_flat_index_space(D, T, max_len)
    if max_len > 32 or not params.kernel_compact:
        raise ValueError(
            "spill_filter_compact requires the in-kernel compaction "
            "epilogue (use_kernel=True with kernel_compact on, and "
            "max_len <= 32): without per-shard lanes there is nothing to "
            "spill-merge — run engine.fused_filter_compact on a resident "
            "corpus instead"
        )
    if shard_docs is None:
        budget = (DEFAULT_DEVICE_BUDGET_BYTES if device_budget_bytes is None
                  else device_budget_bytes)
        shard_docs = shard_docs_for_budget(D, T, budget, tile_docs)
    spec = plan_shards(D, 1, shard_docs, tile_docs)
    sig_mode = _stream_sig_mode(params, D, T, max_len)
    var = sig_mode == SIG_MODE_VARIANT
    NC = params.max_candidates
    store = None
    if checkpoint_dir is not None:
        store = LaneCheckpointStore(checkpoint_dir,
                                    job_manifest(spec, T, max_len, params, flt, sig_mode),
                                    reset=reset_checkpoints)
    streamer = HostSpillStreamer(corpus, spec.shard_docs, device)

    lanes, totals, keys = [], [], []
    fresh = 0
    for s in range(spec.num_shards):
        if store is not None and store.has(s):
            lane, n, vk = store.load(s, device)
        else:
            if fail_after_shards is not None and fresh >= fail_after_shards:
                raise RuntimeError(
                    f"spill_filter_compact: simulated interruption after "
                    f"{fresh} fresh shards (fail_after_shards test hook)"
                )
            lane, n, vk = shard_lane(
                streamer.stage(s), s * spec.shard_docs, max_len, flt, params, spec.tile_docs,
                sig_mode=sig_mode, stream_stats=stream_stats,
            )
            if store is not None:
                store.save(s, lane, n, vk if var else None)
            fresh += 1
        lanes.append(lane)
        totals.append(n)
        if var:
            keys.append(vk)

    if stream_stats is not None:
        stream_stats["spill_bytes_staged"] = (
            stream_stats.get("spill_bytes_staged", 0) + streamer.bytes_staged)
        if store is not None:
            store.flush_stats(stream_stats)
    sel, ok, n, merged = _merge_lanes(lanes, totals, keys, NC)
    out = engine.candidates_from_flat_host(corpus.tokens, sel, ok, n, max_len, NC, device)
    if var:
        out = engine.attach_variant_keys(out, merged)
    return out

"""Fixed-capacity extraction result buffers, candidate-lane merges and
per-shard lane checkpoints."""
from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch


@dataclasses.dataclass
class Matches:
    """A batch of extraction matches, -1-padded to static capacity.

    doc/pos/length/entity: [R] int32 (-1 where empty); score: [R] f32;
    count: [] int32 true matches (may exceed R if the buffer overflowed:
    overflow is surfaced, never silent).
    """

    doc: torch.Tensor
    pos: torch.Tensor
    length: torch.Tensor
    entity: torch.Tensor
    score: torch.Tensor
    count: torch.Tensor

    def to_set(self) -> set[tuple[int, int, int, int]]:
        """Host-side dedup'd set of (doc, pos, len, entity)."""
        keep = self.doc >= 0
        cols = [t[keep].cpu().tolist() for t in (self.doc, self.pos, self.length, self.entity)]
        return set(zip(*cols))


def select_nonzero(mask: torch.Tensor, capacity: int):
    """First ``capacity`` flat indices of set bits in ``mask`` (-1 pad).

    Prefix sum + ``searchsorted`` (the k-th set bit lives where the
    cumsum first reaches k). Returns (idx [capacity] int32, ok
    [capacity] bool).
    """
    flat = mask.reshape(-1)
    c = torch.cumsum(flat, dim=0, dtype=torch.int64)
    want = torch.arange(1, capacity + 1, dtype=torch.int64, device=mask.device)
    idx = torch.searchsorted(c, want, side="left")
    ok = want <= c[-1]
    return torch.where(ok, idx, -1).to(torch.int32), ok


def tile_ranks(counts: torch.Tensor, capacity: int):
    """Global rank -> (tile, within-tile rank) map for per-tile lanes.

    ``counts`` [G] int32 are true per-tile survivor counts. Returns
    ``(g, within, ok, total)``: the tile and within-tile rank of each of
    the global first ``capacity`` survivors (tiles in ascending index
    range), shared by ``select_from_tiles`` and ``gather_from_tiles`` so
    both gather the same survivors.
    """
    G = counts.shape[0]
    counts = counts.to(torch.int64)
    cum = torch.cumsum(counts, dim=0)
    total = cum[-1]
    j = torch.arange(capacity, dtype=torch.int64, device=counts.device)
    ok = j < torch.clamp_max(total, capacity)
    g = torch.searchsorted(cum, j, side="right")
    gs = g.clamp_max(G - 1)
    within = j - (cum[gs] - counts[gs])
    return gs, within, ok, total.to(torch.int32)


def select_from_tiles(counts, cands, capacity: int, complete_tiles: bool = False):
    """Merge per-tile candidate lanes into one global selection.

    ``cands`` [G, C] int32 hold each tile's first C survivors as
    ascending flat indices (-1 pad): the ``fused_probe`` epilogue's
    layout. Identical to ``select_nonzero`` over the full bitmap when
    ``C >= capacity``, or at any C when every tile's lane holds all of
    its survivors (``complete_tiles``, the adaptive two-pass emit).
    Returns (idx [capacity] int32, ok [capacity] bool, total [] int32).
    """
    G, C = cands.shape
    if not (complete_tiles or C >= capacity):
        raise ValueError(
            f"lane width {C} < capacity {capacity}: truncated lanes would be "
            "re-read silently (pass complete_tiles=True only when "
            "max(counts) <= lane width)"
        )
    gs, within, ok, total = tile_ranks(counts, capacity)
    idx = cands[gs, within.clamp(0, C - 1)]
    return torch.where(ok, idx, -1), ok, total


def gather_from_tiles(counts, payload, capacity: int, fill=0):
    """Gather per-lane payload rows ([G, C, ...]) for the same selection."""
    G, C = payload.shape[:2]
    gs, within, ok, _ = tile_ranks(counts, capacity)
    out = payload[gs, within.clamp(0, C - 1)]
    mask = ok.reshape(ok.shape + (1,) * (out.ndim - 1))
    return torch.where(mask, out, fill)


def save_lane_checkpoint(path: str, lane, count, keys=None) -> None:
    """Persist one shard's lane wire unit ``(lane, count[, keys])`` to disk.

    The npz holds ``lane`` and ``count`` as int32 and ``keys`` as uint32,
    the reference's file format, so checkpoints written by either package
    resume in the other. Written atomically (tmp file + ``os.replace``):
    a kill mid-write leaves the old file or none, never a torn one.
    """
    arrays = {
        "lane": lane.cpu().numpy().astype(np.int32),
        "count": count.cpu().numpy().astype(np.int32),
    }
    if keys is not None:
        arrays["keys"] = keys.cpu().numpy().astype(np.uint32)
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "wb") as f:
        np.savez(f, **arrays)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def load_lane_checkpoint(path: str, device):
    """Load a shard lane persisted by ``save_lane_checkpoint``.

    Returns ``(lane [1, NC] int32, count [1] int32, keys [1, NC, 2] int64
    holding uint32 | None)`` on ``device``, ready to concatenate into the
    ``select_from_tiles`` merge beside freshly probed lanes.
    """
    with np.load(path) as z:
        lane = torch.as_tensor(z["lane"].astype(np.int32), device=device)
        count = torch.as_tensor(z["count"].astype(np.int32), device=device)
        keys = (torch.as_tensor(z["keys"].astype(np.int64), device=device)
                if "keys" in z.files else None)
    return lane, count, keys


def compact_matches(hit_mask, doc, pos, length, entity, score, capacity: int) -> Matches:
    """Compact flat hit arrays into a fixed-capacity Matches buffer."""
    idx, ok = select_nonzero(hit_mask, capacity)
    take = idx.clamp_min(0).long()

    def pick(a, fill):
        return torch.where(ok, a[take], fill)

    return Matches(
        doc=pick(doc, -1).to(torch.int32),
        pos=pick(pos, -1).to(torch.int32),
        length=pick(length, -1).to(torch.int32),
        entity=pick(entity, -1).to(torch.int32),
        score=pick(score, 0.0).to(torch.float32),
        count=hit_mask.sum().to(torch.int32),
    )


def merge_matches(a: Matches, b: Matches, capacity: int) -> Matches:
    """Merge two buffers into one of ``capacity`` (dedup NOT performed)."""
    doc = torch.cat([a.doc, b.doc])
    return compact_matches(
        doc >= 0,
        doc,
        torch.cat([a.pos, b.pos]),
        torch.cat([a.length, b.length]),
        torch.cat([a.entity, b.entity]),
        torch.cat([a.score, b.score]),
        capacity,
    )

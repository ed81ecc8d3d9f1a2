"""Entity indexes for the Index-on-Entities algorithm (§3.2).

Built on the host (numpy), queried on the device (torch) with static
shapes; bit-identical to ``repro.core.index``.

* ``word``    inverted list per token over all entity tokens;
* ``prefix``  inverted list per token over prefix tokens only;
* ``variant`` hash table over all Jaccard variants (Def. 2): lookups
  need no verification (64-bit keys).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.dictionary import Dictionary
from repro_torch.core.signatures import prefix_token_sets
from repro_torch.core.variants import variant_keys

INDEX_WORD = "word"
INDEX_PREFIX = "prefix"
INDEX_VARIANT = "variant"
INDEX_NAMES = (INDEX_WORD, INDEX_PREFIX, INDEX_VARIANT)


@dataclasses.dataclass
class InvertedIndex:
    """CSR token -> entity-id postings, padded for static gathers."""

    offsets: np.ndarray  # [V+1] int32
    postings: np.ndarray  # [nnz] int32
    postings_padded: np.ndarray  # [V, P] int32 (-1 pad)
    max_postings: int

    @property
    def nbytes(self) -> int:
        return int(self.postings_padded.nbytes)


@dataclasses.dataclass
class VariantIndex:
    """Static open-bucket hash table: variant key -> entity id."""

    keys1: np.ndarray  # [n_buckets, cap] uint32
    keys2: np.ndarray
    entity_id: np.ndarray  # [n_buckets, cap] int32, -1 pad
    n_buckets: int
    bucket_cap: int
    dropped: int  # variants dropped to bucket overflow (0 unless capped)

    @property
    def nbytes(self) -> int:
        return int(self.keys1.nbytes + self.keys2.nbytes + self.entity_id.nbytes)


def build_inverted_index(
    dictionary: Dictionary, kind: str, gamma: float
) -> InvertedIndex:
    """Build a word- or prefix- inverted index.

    Postings are sorted by (token, entity), as the reference's sorted
    pair list is.
    """
    V = dictionary.vocab_size
    if kind == INDEX_WORD:
        valid = dictionary.valid_mask()
        toks = dictionary.tokens[valid]
        ents = np.broadcast_to(
            np.arange(dictionary.num_entities)[:, None], dictionary.tokens.shape
        )[valid]
    elif kind == INDEX_PREFIX:
        sets = prefix_token_sets(dictionary, gamma)
        toks = np.concatenate(sets) if sets else np.zeros(0, np.int32)
        ents = np.repeat(np.arange(len(sets)), [len(s) for s in sets])
    else:
        raise ValueError(f"not an inverted index kind: {kind!r}")

    order = np.lexsort((ents, toks))
    toks = toks[order].astype(np.int32)
    ents = ents[order].astype(np.int32)
    counts = np.bincount(toks, minlength=V)
    offsets = np.zeros((V + 1,), dtype=np.int32)
    np.cumsum(counts, out=offsets[1:])
    P = max(1, int(counts.max()) if counts.size else 1)
    padded = np.full((V, P), -1, dtype=np.int32)
    if len(toks):
        rank = np.arange(len(toks)) - offsets[toks.astype(np.int64)]
        padded[toks, rank] = ents
    return InvertedIndex(offsets, ents, padded, P)


def build_variant_index(
    dictionary: Dictionary,
    gamma: float,
    max_variants: int = 256,
    load_factor: float = 0.5,
    bucket_cap: int | None = None,
) -> VariantIndex:
    """Hash all Jaccard variants into a static bucketed table."""
    k1, k2, eid = variant_keys(dictionary, gamma, max_variants)
    n = max(len(k1), 1)
    n_buckets = 1 << max(3, int(np.ceil(np.log2(n / load_factor + 1))))
    bucket = (k1 % np.uint32(n_buckets)).astype(np.int64)
    counts = np.bincount(bucket, minlength=n_buckets)
    cap = bucket_cap or max(4, int(counts.max()) if counts.size else 4)
    keys1 = np.zeros((n_buckets, cap), dtype=np.uint32)
    keys2 = np.zeros((n_buckets, cap), dtype=np.uint32)
    ents = np.full((n_buckets, cap), -1, dtype=np.int32)
    dropped = 0
    if len(k1):
        # stable sort by bucket keeps insertion order; ranks >= cap drop
        order = np.argsort(bucket, kind="stable")
        sb = bucket[order]
        rank = np.arange(len(k1)) - np.searchsorted(sb, sb)
        keep = rank < cap
        dropped = int((~keep).sum())
        keys1[sb[keep], rank[keep]] = k1[order][keep]
        keys2[sb[keep], rank[keep]] = k2[order][keep]
        ents[sb[keep], rank[keep]] = eid[order][keep]
    return VariantIndex(keys1, keys2, ents, n_buckets, cap, dropped)


# --------------------------------------------------------------------------
# Device-side queries (static shapes)
# --------------------------------------------------------------------------


def query_inverted(postings_padded: torch.Tensor, win_tokens, win_valid):
    """Candidate entity ids for each window: [..., L*P] int32, -1 invalid."""
    cands = postings_padded[win_tokens.long()]  # [..., L, P]
    cands = torch.where(win_valid[..., None], cands, -1)
    return cands.reshape(*cands.shape[:-2], -1)


def query_variant(index_keys1, index_keys2, entity_id, n_buckets: int, key1, key2):
    """Probe the variant table with window set-hash pairs.

    Keys are int64-carried uint32 values. Returns matched entity ids
    [..., cap] (-1 where no match).
    """
    b = key1 % n_buckets
    k1 = index_keys1[b]  # [..., cap]
    k2 = index_keys2[b]
    ent = entity_id[b]
    hit = (k1 == key1[..., None]) & (k2 == key2[..., None]) & (ent >= 0)
    return torch.where(hit, ent, -1)

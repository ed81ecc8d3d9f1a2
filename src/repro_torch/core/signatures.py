"""Signature schemes for the SSJoin shuffle and the entity indexes (§3.3).

A scheme gives every item (dictionary entity or document window) a
fixed-width array of uint32 signatures plus a validity mask, such that
``sim(e, s) >= gamma`` implies a shared signature: exactly for word,
prefix and variant (contiguous mentions), with high probability for lsh.

Entity-side generation is host numpy, window-side runs on tensors; both
are bit-identical to ``repro.core.signatures``. Window signatures are
int64-carried uint32 values (see ``core.hashing``).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import hashing
from repro_torch.core.dictionary import Dictionary
from repro_torch.core.semantics import first_occurrence_mask
from repro_torch.core.variants import VARIANT_SEEDS, variant_keys

SIG_WORD = "word"
SIG_PREFIX = "prefix"
SIG_LSH = "lsh"
SIG_VARIANT = "variant"
SIG_NAMES = (SIG_WORD, SIG_PREFIX, SIG_LSH, SIG_VARIANT)

_LSH_SEED_BASE = 7000
_TOKEN_SIG_SEED = 11


@dataclasses.dataclass(frozen=True)
class LshParams:
    bands: int = 4
    rows: int = 2


@dataclasses.dataclass
class EntitySignatures:
    """Host-side entity signatures: ragged as (sig, entity_id) pairs."""

    sig: np.ndarray  # [M] uint32
    entity_id: np.ndarray  # [M] int32

    @property
    def count(self) -> int:
        return int(self.sig.shape[0])


def prefix_token_sets(dictionary: Dictionary, gamma: float) -> list[np.ndarray]:
    """Per-entity prefix tokens: minimal heaviest-first set with
    cumulative weight > (1-gamma) * w(e) (plus epsilon)."""
    out = []
    for i in range(dictionary.num_entities):
        n = int(dictionary.lengths[i])
        toks = dictionary.tokens[i, :n]
        ws = dictionary.token_weight[toks]
        order = np.lexsort((toks, -ws))  # heaviest (rarest) first
        total = float(ws.sum())
        need = (1.0 - gamma) * total + 1e-6
        acc, chosen = 0.0, []
        for j in order:
            chosen.append(int(toks[j]))
            acc += float(ws[j])
            if acc > need:
                break
        out.append(np.array(chosen, dtype=np.int32))
    return out


def _minhash_np(tokens: np.ndarray, valid: np.ndarray, params: LshParams) -> np.ndarray:
    """[.., B] banded minhash signatures (numpy, uint32)."""
    B, R = params.bands, params.rows
    outs = []
    for b in range(B):
        row_mins = []
        for r in range(R):
            h = hashing.hash_u32(tokens, seed=_LSH_SEED_BASE + b * R + r)
            h = np.where(valid, h, np.uint32(0xFFFFFFFF))
            row_mins.append(h.min(axis=-1))
        band = row_mins[0]
        for m in row_mins[1:]:
            band = hashing.combine(band, m)
        # Tag with band id so bands occupy distinct signature spaces.
        band = hashing.combine(band, np.full_like(band, np.uint32(b + 1)))
        outs.append(band)
    return np.stack(outs, axis=-1)


def _minhash_torch(tokens: torch.Tensor, valid: torch.Tensor, params: LshParams):
    """[.., B] banded minhash signatures (int64-carried uint32)."""
    B, R = params.bands, params.rows
    outs = []
    for b in range(B):
        row_mins = []
        for r in range(R):
            h = hashing.hash_u32(tokens, seed=_LSH_SEED_BASE + b * R + r)
            h = torch.where(valid, h, torch.full_like(h, hashing.MASK))
            row_mins.append(h.amin(dim=-1))
        band = row_mins[0]
        for m in row_mins[1:]:
            band = hashing.combine(band, m)
        band = hashing.combine(band, torch.full_like(band, b + 1))
        outs.append(band)
    return torch.stack(outs, dim=-1)


def entity_signatures(
    scheme: str,
    dictionary: Dictionary,
    gamma: float,
    lsh: LshParams = LshParams(),
    max_variants: int = 256,
) -> EntitySignatures:
    """Host-side signature generation for all dictionary entities."""
    E, L = dictionary.tokens.shape
    valid = dictionary.valid_mask()
    if scheme == SIG_WORD:
        sig = hashing.hash_u32(dictionary.tokens, seed=_TOKEN_SIG_SEED)
        eid = np.broadcast_to(np.arange(E, dtype=np.int32)[:, None], (E, L))
        keep = valid.ravel()
        return EntitySignatures(sig.ravel()[keep], eid.ravel()[keep].astype(np.int32))
    if scheme == SIG_PREFIX:
        sets = prefix_token_sets(dictionary, gamma)
        toks = np.concatenate(sets) if sets else np.zeros(0, np.int32)
        eids = np.repeat(np.arange(E, dtype=np.int32), [len(s) for s in sets])
        return EntitySignatures(hashing.hash_u32(toks, seed=_TOKEN_SIG_SEED), eids)
    if scheme == SIG_LSH:
        sig = _minhash_np(dictionary.tokens, valid, lsh)  # [E, B]
        eid = np.broadcast_to(np.arange(E, dtype=np.int32)[:, None], sig.shape)
        return EntitySignatures(
            sig.ravel().astype(np.uint32), eid.ravel().astype(np.int32).copy()
        )
    if scheme == SIG_VARIANT:
        k1, _k2, eid = variant_keys(dictionary, gamma, max_variants)
        return EntitySignatures(k1, eid)
    raise ValueError(f"unknown signature scheme {scheme!r}")


def window_signatures(
    scheme: str,
    win_tokens: torch.Tensor,
    win_valid: torch.Tensor,
    gamma: float,
    lsh: LshParams = LshParams(),
):
    """Signatures for padded windows ``[..., L]``.

    Returns (sig int64 [..., S] holding uint32 values, mask bool [..., S]).
    """
    del gamma  # window side emits all tokens for word/prefix
    first = win_valid & first_occurrence_mask(win_tokens)
    if scheme in (SIG_WORD, SIG_PREFIX):
        return hashing.hash_u32(win_tokens, seed=_TOKEN_SIG_SEED), first
    if scheme == SIG_LSH:
        sig = _minhash_torch(win_tokens, first, lsh)
        has_any = first.any(dim=-1, keepdim=True)
        return sig, has_any.expand(sig.shape)
    if scheme == SIG_VARIANT:
        k1 = hashing.set_hash(win_tokens, first, seed=VARIANT_SEEDS[0])
        return k1[..., None], first.any(dim=-1, keepdim=True)
    raise ValueError(f"unknown signature scheme {scheme!r}")


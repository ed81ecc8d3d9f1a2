"""Entity dictionary container.

Host-side (numpy) representation of the dictionary of entities:
fixed-width padded token-id matrix, token weights, and the descending
mention-frequency order required by the plan-search (Lemma 1).

Token id 0 is reserved as PAD and never appears in an entity.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np

PAD = 0


@dataclasses.dataclass
class Dictionary:
    """Padded entity dictionary, sorted by descending mention frequency.

    Attributes:
      tokens: [E, L] int32, PAD-padded entity token ids (duplicate-free
        per entity, original order preserved).
      lengths: [E] int32 number of valid tokens.
      freq: [E] float32 estimated mention frequency (descending).
      token_weight: [V] float32 per-token weight table (w[PAD] = 0).
      entity_weight: [E] float32 total weight per entity.
    """

    tokens: np.ndarray
    lengths: np.ndarray
    freq: np.ndarray
    token_weight: np.ndarray
    entity_weight: np.ndarray

    @property
    def num_entities(self) -> int:
        return int(self.tokens.shape[0])

    @property
    def max_len(self) -> int:
        return int(self.tokens.shape[1])

    @property
    def vocab_size(self) -> int:
        return int(self.token_weight.shape[0])

    def slice(self, start: int, stop: int) -> "Dictionary":
        """Entity-range slice (keeps full weight table)."""
        return Dictionary(
            tokens=self.tokens[start:stop],
            lengths=self.lengths[start:stop],
            freq=self.freq[start:stop],
            token_weight=self.token_weight,
            entity_weight=self.entity_weight[start:stop],
        )

    def valid_mask(self) -> np.ndarray:
        return self.tokens != PAD


def build_dictionary(
    entities: Sequence[Sequence[int]],
    vocab_size: int,
    token_weight: np.ndarray | None = None,
    freq: np.ndarray | None = None,
    max_len: int | None = None,
) -> Dictionary:
    """Build a Dictionary from per-entity token-id lists.

    Duplicate tokens within an entity are dropped (set semantics, first
    occurrence kept). Entities are sorted by descending ``freq``.
    """
    dedup = []
    for ent in entities:
        seen: list[int] = []
        for t in ent:
            t = int(t)
            if t == PAD:
                raise ValueError("token id 0 is reserved as PAD")
            if t >= vocab_size:
                raise ValueError(f"token id {t} out of range {vocab_size}")
            if t not in seen:
                seen.append(t)
        if not seen:
            raise ValueError("empty entity")
        dedup.append(seen)

    L = max_len or max(len(e) for e in dedup)
    if any(len(e) > L for e in dedup):
        raise ValueError("entity longer than max_len")
    E = len(dedup)
    toks = np.zeros((E, L), dtype=np.int32)
    lens = np.zeros((E,), dtype=np.int32)
    for i, ent in enumerate(dedup):
        toks[i, : len(ent)] = ent
        lens[i] = len(ent)

    if token_weight is None:
        token_weight = np.ones((vocab_size,), dtype=np.float32)
    token_weight = token_weight.astype(np.float32).copy()
    token_weight[PAD] = 0.0

    if freq is None:
        freq = np.ones((E,), dtype=np.float32)
    freq = np.asarray(freq, dtype=np.float32)

    order = np.argsort(-freq, kind="stable")
    toks, lens, freq = toks[order], lens[order], freq[order]
    ent_w = token_weight[toks].sum(axis=1).astype(np.float32)
    return Dictionary(toks, lens, freq, token_weight, ent_w)

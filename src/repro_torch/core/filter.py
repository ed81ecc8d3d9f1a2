"""ISH filter: a Bloom filter over the prefix tokens of all entities (§3.3).

A window matching any entity under ``JaccCont_extra >= gamma`` contains
at least one of that entity's prefix tokens, and Bloom filters have no
false negatives, so the filter never drops a true mention. Built on the
host with numpy, bit-identical to ``repro.core.filter``; probed on the
device by the ``fused_probe`` kernel or ``token_in_filter``.

On the device the words are a ``torch.int32`` tensor holding the
uint32 bit patterns (``device_words``), the layout the kernel reads.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import hashing
from repro_torch.core.dictionary import Dictionary
from repro_torch.core.signatures import prefix_token_sets

_BLOOM_SEED_BASE = 9100


@dataclasses.dataclass
class BloomFilter:
    """k-hash Bloom filter over token ids, bit-packed into uint32 words."""

    bits: np.ndarray  # [n_words] uint32
    num_bits: int
    num_hashes: int
    member_tokens: np.ndarray  # [n] int32, the inserted token ids

    @property
    def nbytes(self) -> int:
        return int(self.bits.nbytes)


def build_ish_filter(
    dictionary: Dictionary,
    gamma: float,
    num_bits: int = 1 << 18,
    num_hashes: int = 3,
) -> BloomFilter:
    """Bloom filter over the union of all entities' prefix tokens."""
    toks = np.unique(np.concatenate(prefix_token_sets(dictionary, gamma)))
    words = np.zeros((num_bits // 32,), dtype=np.uint32)
    for k in range(num_hashes):
        h = hashing.hash_u32(toks, seed=_BLOOM_SEED_BASE + k)
        pos = h % np.uint32(num_bits)
        np.bitwise_or.at(words, pos // 32, np.uint32(1) << (pos % 32))
    return BloomFilter(
        bits=words, num_bits=num_bits, num_hashes=num_hashes, member_tokens=toks
    )


def device_words(words: np.ndarray, device) -> torch.Tensor:
    """uint32 Bloom words -> int32 bit-pattern tensor on ``device``."""
    return torch.from_numpy(np.ascontiguousarray(words, dtype=np.uint32).view(np.int32)).to(device)


def token_in_filter(bits: torch.Tensor, num_bits: int, num_hashes: int, tokens):
    """True where ``tokens`` are (probable) filter members."""
    hit = torch.ones(tokens.shape, dtype=torch.bool, device=tokens.device)
    for k in range(num_hashes):
        h = hashing.hash_u32(tokens, seed=_BLOOM_SEED_BASE + k)
        pos = h % num_bits
        word = hashing.u32(bits[pos // 32])
        hit = hit & (((word >> (pos % 32)) & 1) == 1)
    return hit

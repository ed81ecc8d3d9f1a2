"""Synthetic corpora and dictionaries with controlled mention statistics.

The paper evaluates plans over "entity dictionaries consisting of
entities that follow various mention distributions" (§6). This module
generates:

* a Zipfian vocabulary with IDF-style token weights,
* an entity dictionary whose *mention frequencies* follow a chosen
  distribution (``zipf`` / ``uniform`` / ``bimodal``), and
* a document collection of Zipfian background tokens with planted,
  noisy entity mentions (missing words / extra words / permuted order).

All randomness flows from a single seed for reproducibility, and the
arrays equal ``repro.data.synth.make_corpus``'s for the same arguments.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.dictionary import Dictionary, build_dictionary

MENTION_DISTS = ("zipf", "uniform", "bimodal")


@dataclasses.dataclass
class SynthCorpus:
    doc_tokens: np.ndarray  # [D, T] int32, PAD=0 tails
    dictionary: Dictionary
    planted: list[tuple[int, int, int, int]]  # (doc, pos, len, entity) as planted
    mention_freq: np.ndarray  # [E] planted mention counts (dictionary order)


def _zipf_probs(n: int, s: float = 1.1) -> np.ndarray:
    p = 1.0 / np.power(np.arange(1, n + 1), s)
    return p / p.sum()


def make_corpus(
    *,
    num_docs: int = 32,
    doc_len: int = 128,
    vocab_size: int = 2048,
    num_entities: int = 64,
    max_entity_len: int = 5,
    min_entity_len: int = 2,
    mention_dist: str = "zipf",
    mentions_per_doc: float = 3.0,
    p_drop: float = 0.25,
    p_insert: float = 0.15,
    p_permute: float = 0.1,
    weighted: bool = True,
    seed: int = 0,
) -> SynthCorpus:
    """Generate a corpus + dictionary with planted noisy mentions."""
    rng = np.random.default_rng(seed)
    bg_probs = _zipf_probs(vocab_size - 1)

    # --- entities: distinct tokens, biased to mid-frequency vocabulary
    ent_tokens: list[list[int]] = []
    seen_ents: set[tuple[int, ...]] = set()
    while len(ent_tokens) < num_entities:
        n = int(rng.integers(min_entity_len, max_entity_len + 1))
        toks = rng.choice(vocab_size - 1, size=n, replace=False, p=bg_probs) + 1
        key = tuple(sorted(int(t) for t in toks))
        if key in seen_ents:
            continue
        seen_ents.add(key)
        ent_tokens.append([int(t) for t in toks])

    # --- token weights: IDF-style from background probabilities
    if weighted:
        tw = np.zeros((vocab_size,), dtype=np.float32)
        tw[1:] = np.log1p(1.0 / (bg_probs * vocab_size)).astype(np.float32) + 0.1
    else:
        tw = np.ones((vocab_size,), dtype=np.float32)

    # --- mention frequency distribution over entities
    if mention_dist == "zipf":
        mf = _zipf_probs(num_entities, s=1.3)
    elif mention_dist == "uniform":
        mf = np.full((num_entities,), 1.0 / num_entities)
    elif mention_dist == "bimodal":
        hot = max(1, num_entities // 10)
        mf = np.concatenate(
            [np.full((hot,), 0.8 / hot), np.full((num_entities - hot,), 0.2 / (num_entities - hot))]
        )
    else:
        raise ValueError(f"unknown mention_dist {mention_dist!r}")

    total_mentions = int(mentions_per_doc * num_docs)
    ent_of_mention = rng.choice(num_entities, size=total_mentions, p=mf)

    dictionary = build_dictionary(
        ent_tokens, vocab_size, token_weight=tw, freq=np.bincount(
            ent_of_mention, minlength=num_entities
        ).astype(np.float32), max_len=max_entity_len,
    )
    # entity ids below refer to the *sorted* dictionary order; rebuild the
    # mention stream in sorted ids for planting.
    order = np.argsort(
        -np.bincount(ent_of_mention, minlength=num_entities).astype(np.float32),
        kind="stable",
    )
    inv = np.empty_like(order)
    inv[order] = np.arange(num_entities)
    ent_of_mention = inv[ent_of_mention]

    # --- documents: background + planted mentions
    docs = np.zeros((num_docs, doc_len), dtype=np.int32)
    for d in range(num_docs):
        docs[d] = rng.choice(vocab_size - 1, size=doc_len, p=bg_probs) + 1

    planted: list[tuple[int, int, int, int]] = []
    mention_freq = np.zeros((num_entities,), dtype=np.int64)
    for e in ent_of_mention:
        n = int(dictionary.lengths[e])
        toks = list(dictionary.tokens[e, :n])
        # noise: drop / permute / insert
        if n > 1 and rng.random() < p_drop:
            toks.pop(int(rng.integers(len(toks))))
        if len(toks) > 1 and rng.random() < p_permute:
            i, j = rng.choice(len(toks), size=2, replace=False)
            toks[i], toks[j] = toks[j], toks[i]
        if rng.random() < p_insert:
            junk = int(rng.choice(vocab_size - 1, p=bg_probs)) + 1
            toks.insert(int(rng.integers(len(toks) + 1)), junk)
        m = len(toks)
        d = int(rng.integers(num_docs))
        p = int(rng.integers(0, doc_len - m))
        docs[d, p : p + m] = np.array(toks, dtype=np.int32)
        planted.append((d, p, m, int(e)))
        mention_freq[e] += 1

    return SynthCorpus(
        doc_tokens=docs,
        dictionary=dictionary,
        planted=planted,
        mention_freq=mention_freq,
    )

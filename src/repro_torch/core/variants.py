"""Jaccard variants (paper Definition 2).

A *Jaccard variant* of an entity ``e`` with weight ``w(e)`` is any token
subset ``v ⊆ e`` with ``w(v) >= gamma * w(e)``. A window whose token set
equals a variant of ``e`` is a mention of ``e`` under
``JaccCont_extra >= gamma``, exactly, with no verification step.

Dictionary-side enumeration runs on the host (numpy); document windows
are hashed as sets on the device (``window_variant_key``). Bit-identical
to ``repro.core.variants``.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core import hashing
from repro_torch.core.dictionary import Dictionary

# Two independent 32-bit set hashes give an effective 64-bit variant key.
VARIANT_SEEDS = (101, 202)


def enumerate_entity_variants(
    tokens: np.ndarray,
    weights: np.ndarray,
    gamma: float,
    max_variants: int = 256,
) -> list[np.ndarray]:
    """All subsets of ``tokens`` with weight >= gamma * total, heaviest first.

    Branch-and-bound over tokens sorted by descending weight; capped at
    ``max_variants`` (heaviest kept).
    """
    n = len(tokens)
    order = np.argsort(-weights, kind="stable")
    toks = tokens[order]
    ws = weights[order]
    total = float(ws.sum())
    thresh = gamma * total - 1e-6
    suffix = np.concatenate([np.cumsum(ws[::-1])[::-1], [0.0]])

    out: list[tuple[float, np.ndarray]] = []

    def rec(i: int, cur: list[int], cur_w: float) -> None:
        if len(out) >= 4 * max_variants:
            return
        if cur_w + suffix[i] < thresh:  # cannot reach threshold
            return
        if i == n:
            if cur_w >= thresh and cur:
                out.append((cur_w, np.array(cur, dtype=np.int32)))
            return
        rec(i + 1, cur + [int(toks[i])], cur_w + float(ws[i]))
        rec(i + 1, cur, cur_w)

    rec(0, [], 0.0)
    out.sort(key=lambda t: -t[0])
    return [v for _, v in out[:max_variants]]


def _variant_masks(n: int) -> np.ndarray:
    """[2**n, n] bool include-masks in the branch-and-bound's leaf order.

    The recursion takes token ``i`` before leaving it out, so leaves come
    in ascending order of the bit string ``(not b_0, ..., not b_{n-1})``.
    """
    code = np.arange(1 << n)
    shifts = np.arange(n - 1, -1, -1)
    return ((code[:, None] >> shifts[None, :]) & 1) == 0


def _variant_keys_fixed_len(tokens, token_weight, gamma, max_variants):
    """``variant_keys`` for entities that all have ``n`` tokens, vectorised.

    Reproduces ``enumerate_entity_variants`` exactly while the cap of
    ``4 * max_variants`` leaves cannot be reached (``2**n - 1 <
    4 * max_variants``): the same float64 running sums, the same prune
    test at every node on a leaf's path, and the same stable sort.
    Returns (k1, k2, row) with row the index into ``tokens``.
    """
    E, n = tokens.shape
    ws = token_weight[tokens]  # [E, n] f32
    order = np.argsort(-ws, axis=1, kind="stable")
    toks = np.take_along_axis(tokens, order, axis=1)
    wso = np.take_along_axis(ws, order, axis=1)
    total = np.array([float(wso[i].sum()) for i in range(E)])
    thresh = gamma * total - 1e-6  # [E]
    suffix = np.concatenate(
        [np.cumsum(wso[:, ::-1], axis=1)[:, ::-1].astype(np.float64),
         np.zeros((E, 1))], axis=1)  # [E, n + 1]
    masks = _variant_masks(n)  # [M, n]
    contrib = np.where(masks[None], wso.astype(np.float64)[:, None, :], 0.0)
    cur = np.concatenate(
        [np.zeros((E, masks.shape[0], 1)), np.cumsum(contrib, axis=2)], axis=2
    )  # [E, M, n + 1]: running weight before deciding token i
    alive = (cur + suffix[:, None, :] >= thresh[:, None, None]).all(axis=2)
    alive &= masks.any(axis=1)[None]
    leaf_w = cur[:, :, n]
    cnt = masks.sum(axis=1).astype(np.uint32)[None]
    keys = []
    for seed in VARIANT_SEEDS:
        h = hashing.hash_u32(toks, seed=seed).astype(np.uint64)
        per = np.where(masks[None], h[:, None, :], np.uint64(0))  # [E, M, n]
        s = (per.sum(axis=2) & np.uint64(hashing.MASK)).astype(np.uint32)
        x = np.bitwise_xor.reduce(per, axis=2).astype(np.uint32)
        with np.errstate(over="ignore"):
            keys.append(hashing.mix(s ^ (x * np.uint32(hashing._C1))
                                    ^ (cnt * np.uint32(hashing._GOLDEN))))
    sel = []
    for i in range(E):
        keep = np.flatnonzero(alive[i])
        sel.append(keep[np.argsort(-leaf_w[i, keep], kind="stable")][:max_variants])
    rows = np.concatenate([np.full(len(k), i, dtype=np.int64) for i, k in enumerate(sel)])
    cols = np.concatenate(sel)
    return keys[0][rows, cols], keys[1][rows, cols], rows


def variant_keys(
    dictionary: Dictionary, gamma: float, max_variants: int = 256
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Enumerate variant hash keys for every entity.

    Returns (keys1 uint32 [M], keys2 uint32 [M], entity_id int32 [M]),
    grouped by entity in dictionary order, each entity's variants
    heaviest first, as ``repro.core.variants.variant_keys`` lists them.
    Entities are grouped by length and enumerated with numpy; lengths
    whose subset count can reach the enumeration cap use the recursion.
    """
    E = dictionary.num_entities
    k1 = [np.zeros(0, np.uint32)] * E
    k2 = [np.zeros(0, np.uint32)] * E
    lengths = dictionary.lengths.astype(np.int64)
    chunk = 4096
    for n in np.unique(lengths):
        ids = np.flatnonzero(lengths == n)
        if (1 << int(n)) - 1 < 4 * max_variants:
            for a in range(0, len(ids), chunk):
                sub = ids[a:a + chunk]
                toks = dictionary.tokens[sub, :n]
                c1, c2, rows = _variant_keys_fixed_len(
                    toks, dictionary.token_weight, gamma, max_variants)
                bounds = np.searchsorted(rows, np.arange(len(sub) + 1))
                for j, e in enumerate(sub):
                    k1[e] = c1[bounds[j]:bounds[j + 1]]
                    k2[e] = c2[bounds[j]:bounds[j + 1]]
            continue
        for e in ids:
            toks = dictionary.tokens[e, :n]
            ws = dictionary.token_weight[toks]
            vs = enumerate_entity_variants(toks, ws, gamma, max_variants)
            k1[e] = np.array([hashing.set_hash(v, np.ones(v.shape, bool), seed=VARIANT_SEEDS[0])
                              for v in vs], dtype=np.uint32)
            k2[e] = np.array([hashing.set_hash(v, np.ones(v.shape, bool), seed=VARIANT_SEEDS[1])
                              for v in vs], dtype=np.uint32)
    eid = np.concatenate([np.full(len(k), i, np.int32) for i, k in enumerate(k1)]) \
        if E else np.zeros(0, np.int32)
    return (
        np.concatenate(k1).astype(np.uint32) if E else np.zeros(0, np.uint32),
        np.concatenate(k2).astype(np.uint32) if E else np.zeros(0, np.uint32),
        eid.astype(np.int32),
    )


def window_variant_key(win_tokens, win_valid):
    """Set-hash pair of a padded window, matching ``variant_keys``."""
    from repro_torch.core.semantics import first_occurrence_mask

    v = win_valid & first_occurrence_mask(win_tokens)
    return (
        hashing.set_hash(win_tokens, v, seed=VARIANT_SEEDS[0]),
        hashing.set_hash(win_tokens, v, seed=VARIANT_SEEDS[1]),
    )

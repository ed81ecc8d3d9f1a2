"""Verification join: batched similarity of (candidate window, entity)
pairs, the post-lookup verify of Def. 3 and the reducer verify of Def. 4.
With ``use_kernel`` it runs the ``jaccard_verify`` kernel
(``kernels.ops``); otherwise ``core.semantics.similarity``.
"""
from __future__ import annotations

import torch

from repro_torch.core.semantics import similarity


def verify_pairs(win_tokens, ent_ids, dict_tokens, token_weight, gamma: float,
                 sim_name: str, use_kernel: bool = False):
    """Verify candidate (window, entity) pairs.

    win_tokens: [N, L] padded windows; ent_ids: [N, K] int32 (-1
    invalid); dict_tokens: [E, L]. Returns (hits [N, K] bool,
    scores [N, K] f32).
    """
    if use_kernel:
        from repro_torch.kernels import ops as kops

        scores = kops.jaccard_verify(win_tokens, ent_ids, dict_tokens, token_weight, sim_name)
    else:
        ent_toks = dict_tokens[ent_ids.clamp_min(0).long()]  # [N, K, L]
        scores = similarity(sim_name, ent_toks, win_tokens[:, None, :], token_weight)
    hits = (scores >= gamma - 1e-6) & (ent_ids >= 0)
    return hits, scores


def dedup_hits(hit_mask, ent_ids):
    """Drop duplicate (window, entity) hits within each window's K list:
    the same entity can be reached through several signatures; keep the
    first hit per (row, entity)."""
    same = (ent_ids[:, :, None] == ent_ids[:, None, :]) & hit_mask[:, None, :]
    K = ent_ids.shape[1]
    earlier = torch.ones((K, K), dtype=torch.bool, device=ent_ids.device).tril(-1)
    dup = (same & earlier[None]).any(dim=-1)
    return hit_mask & ~dup

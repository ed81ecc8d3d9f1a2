"""Similarity semantics for approximate dictionary entity extraction.

The paper's Definition 1 (weighted Jaccard containment, the ``missing``
and ``extra`` variations) plus symmetric weighted Jaccard, as in
``repro.core.semantics``. With a token weight function ``w``, a window
``s`` and an entity ``e``:

  JaccCont_missing(e, s) = w(e ∩ s) / w(s)
  JaccCont_extra(e, s)   = w(e ∩ s) / w(e)
  Jaccard(e, s)          = w(e ∩ s) / w(e ∪ s)

Inputs are PAD(=0)-padded token-id tensors; duplicated window tokens are
counted once through a first-occurrence mask.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.dictionary import PAD

SIM_MISSING = "missing"
SIM_EXTRA = "extra"
SIM_JACCARD = "jaccard"
# set(s) ⊆ set(e) and w(s) >= gamma * w(e): what the Jaccard-variant
# machinery computes exactly (an under-approximation of SIM_EXTRA).
SIM_VARIANT_EXACT = "variant_exact"
SIM_NAMES = (SIM_MISSING, SIM_EXTRA, SIM_JACCARD, SIM_VARIANT_EXACT)


def first_occurrence_mask(tokens):
    """Mask of first occurrences (dedup within each row's padded set).

    Accepts a numpy array (host builds) or a tensor.
    """
    L = tokens.shape[-1]
    t = tokens[..., :, None] == tokens[..., None, :]  # [.., L, L]
    if isinstance(tokens, torch.Tensor):
        earlier = torch.ones((L, L), dtype=torch.bool, device=tokens.device).tril(-1)
        dup = (t & earlier).any(dim=-1)
    else:
        earlier = np.tril(np.ones((L, L), dtype=bool), k=-1)
        dup = (t & earlier).any(axis=-1)
    return (tokens != PAD) & ~dup


def _intersection_weight(ent_tokens, ent_valid, win_tokens, win_valid, token_weight):
    """w(e ∩ s) for batched padded rows with broadcastable leading dims."""
    eq = ent_tokens[..., :, None] == win_tokens[..., None, :]  # [..., Le, Lw]
    both = eq & ent_valid[..., :, None] & win_valid[..., None, :]
    hit = both.any(dim=-1)
    w = token_weight[ent_tokens.long()] * hit
    return w.sum(dim=-1, dtype=torch.float32)


def similarity(sim_name: str, ent_tokens, win_tokens, token_weight, *,
               ent_valid=None, win_valid=None):
    """Batched weighted similarity between entities and windows.

    Shapes: ``ent_tokens [..., Le]``, ``win_tokens [..., Lw]`` with
    broadcastable leading dims. PAD entries are ignored; duplicate window
    tokens are counted once. Empty windows get similarity 0.
    """
    if ent_valid is None:
        ent_valid = ent_tokens != PAD
    if win_valid is None:
        win_valid = first_occurrence_mask(win_tokens)
    else:
        win_valid = win_valid & first_occurrence_mask(win_tokens)

    inter = _intersection_weight(ent_tokens, ent_valid, win_tokens, win_valid, token_weight)
    w_e = (token_weight[ent_tokens.long()] * ent_valid).sum(dim=-1, dtype=torch.float32)
    w_s = (token_weight[win_tokens.long()] * win_valid).sum(dim=-1, dtype=torch.float32)

    eps = 1e-30
    zero = torch.zeros((), dtype=torch.float32, device=inter.device)
    if sim_name == SIM_MISSING:
        denom = w_s
    elif sim_name == SIM_EXTRA:
        denom = w_e
    elif sim_name == SIM_JACCARD:
        denom = w_e + w_s - inter
    elif sim_name == SIM_VARIANT_EXACT:
        eq = win_tokens[..., :, None] == ent_tokens[..., None, :]
        in_e = (eq & ent_valid[..., None, :]).any(dim=-1)
        subset = (~win_valid | in_e).all(dim=-1)
        out = inter / w_e.clamp_min(eps)
        return torch.where(subset & (w_s > 0), out, zero)
    else:
        raise ValueError(f"unknown similarity {sim_name!r}")
    out = inter / denom.clamp_min(eps)
    return torch.where(w_s > 0, out, zero)

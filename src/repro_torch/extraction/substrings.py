"""Candidate substring (window) enumeration.

A candidate is a contiguous token window ``(doc, pos, len)`` with
``1 <= len <= L``. For a document batch ``[D, T]``, ``window_base``
builds the ``[D, T, L]`` tokens starting at each position (PAD past the
document end); candidate ``(d, p, l)`` is the first ``l+1`` of them.
The kernel path never builds it: ``fused_probe`` evaluates lengths in
place and windows are gathered from ``[D, T]``.
"""
from __future__ import annotations

import torch

from repro_torch.core.dictionary import PAD


def window_base(doc_tokens: torch.Tensor, max_len: int) -> torch.Tensor:
    """[D, T] -> [D, T, L] tokens starting at each position."""
    D, T = doc_tokens.shape
    dev = doc_tokens.device
    cols = torch.arange(T, device=dev)[:, None] + torch.arange(max_len, device=dev)[None, :]
    gathered = doc_tokens[:, cols.clamp_max(T - 1)]
    return torch.where(cols[None] < T, gathered, torch.zeros_like(gathered) + PAD)

"""Hash helpers for the plain PyTorch versions of the kernels.

The kernel-body names of ``repro.kernels._hashing`` over int64-carried
uint32 tensors (see ``core.hashing``, which holds the one torch
implementation). The CUDA sources carry the same functions in native
``uint32_t``.
"""
from __future__ import annotations

from repro_torch.core.hashing import combine, mix
from repro_torch.core.hashing import hash_u32 as hash_seeded

__all__ = ["combine", "hash_seeded", "mix"]

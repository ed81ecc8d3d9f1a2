"""Vectorised uint32 hashing for host numpy builds and device tensors.

Bit-identical to ``repro.core.hashing``: host-built structures
(indexes, filters, variant tables) must agree with device probes.

numpy arrays use native uint32 arithmetic. Torch tensors carry uint32
values as int64 in ``[0, 2**32)``, masked after every step, because CPU
torch implements neither ``+``, ``>>``, ``<<``, ``%`` nor ``min`` on
``torch.uint32``. Products are split into 16-bit halves so no int64
product overflows; ``.to(torch.uint32)`` converts at the public boundary.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

MASK = 0xFFFFFFFF
# splitmix32 constants (Stafford mix / murmur3-finaliser family).
_C1 = 0x85EBCA6B
_C2 = 0xC2B2AE35
_GOLDEN = 0x9E3779B9


def u32(x: torch.Tensor) -> torch.Tensor:
    """Any integer tensor -> int64 holding its uint32 bit pattern."""
    return x.to(torch.int64) & MASK


def mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """``x * c mod 2**32`` for int64-carried uint32 ``x`` and constant ``c``."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & MASK


def _mix_t(x: torch.Tensor) -> torch.Tensor:
    x = x ^ (x >> 16)
    x = mul32(x, _C1)
    x = x ^ (x >> 13)
    x = mul32(x, _C2)
    return x ^ (x >> 16)


def _mix_np(x: np.ndarray) -> np.ndarray:
    with np.errstate(over="ignore"):
        x = x.astype(np.uint32)
        x = x ^ (x >> np.uint32(16))
        x = x * np.uint32(_C1)
        x = x ^ (x >> np.uint32(13))
        x = x * np.uint32(_C2)
        return x ^ (x >> np.uint32(16))


def mix(x):
    """murmur3 finaliser."""
    if isinstance(x, torch.Tensor):
        return _mix_t(u32(x))
    return _mix_np(np.asarray(x))


def seed_offset(seed: int) -> int:
    return (_GOLDEN * (int(seed) + 1)) & MASK


def hash_u32(x, seed: int = 0):
    """Hash an integer array -> uint32 values, parameterised by ``seed``."""
    off = seed_offset(seed)
    if isinstance(x, torch.Tensor):
        return _mix_t((u32(x) + off) & MASK)
    with np.errstate(over="ignore"):
        x = np.asarray(x).astype(np.uint32) + np.uint32(off)
    return _mix_np(x)


def hash2(x, seed: int = 0):
    """Two decorrelated uint32 hashes, returned as a tuple."""
    return hash_u32(x, seed=2 * seed), hash_u32(x, seed=2 * seed + 1)


def combine(h, g):
    """Order-dependent combine of two uint32 hash arrays."""
    if isinstance(h, torch.Tensor):
        h, g = u32(h), u32(g)
        inner = (g + _GOLDEN + ((h << 6) & MASK) + (h >> 2)) & MASK
        return _mix_t(h ^ inner)
    h = np.asarray(h).astype(np.uint32)
    g = np.asarray(g).astype(np.uint32)
    with np.errstate(over="ignore"):
        inner = g + np.uint32(_GOLDEN) + (h << np.uint32(6)) + (h >> np.uint32(2))
    return _mix_np(h ^ inner)


def set_hash(tokens, valid, seed: int = 0, axis: int = -1):
    """Order-insensitive hash of a padded token-id set.

    Commutative combine of per-token hashes: (sum, xor, count) folded
    through the finaliser.
    """
    per = hash_u32(tokens, seed=seed)
    if isinstance(per, torch.Tensor):
        per = torch.where(valid, per, torch.zeros_like(per))
        s = per.sum(dim=axis) & MASK
        x = functools.reduce(torch.bitwise_xor, per.unbind(dim=axis))
        cnt = valid.sum(dim=axis).to(torch.int64)
        return _mix_t(s ^ mul32(x, _C1) ^ mul32(cnt, _GOLDEN))
    per = np.where(valid, per, np.uint32(0))
    with np.errstate(over="ignore"):
        s = per.sum(axis=axis, dtype=np.uint32)
        x = np.bitwise_xor.reduce(per, axis=axis)
        cnt = valid.sum(axis=axis).astype(np.uint32)
        return _mix_np(s ^ (x * np.uint32(_C1)) ^ (cnt * np.uint32(_GOLDEN)))

"""Batched weighted Jaccard-containment verification.

Replaces the TPU kernel ``repro.kernels.jaccard_verify.
jaccard_verify_pallas``. For each candidate window ``n`` and each of its
K candidate entities ``k``:

    hit[n,k,i]  = ent[n,k,i] != PAD and ent[n,k,i] in win[n, :]
    inter[n,k]  = Σ_i ent_w[n,k,i] * hit[n,k,i]
    score[n,k]  = inter / w(e)    (mode "extra")
                = inter / w(s)    (mode "missing")
                = 0 where w(s) == 0

Token weights are gathered outside (``kernels.ops.jaccard_verify``).
Both forms sum in index order ``i = 0 .. L-1``, so on the card the
kernel equals its plain version bit for bit.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

MODES = ("extra", "missing")

#: launches of the CUDA kernel since the last reset (every row length)
launches = 0
#: of those, launches of the kernel for rows longer than 32 tokens
long_launches = 0

#: longest row of the unrolled kernels; longer rows take the long-row kernel
MAX_UNROLLED_L = 32


def _check(win_tokens, win_w, ent_tokens, ent_w, mode):
    if mode not in MODES:
        raise ValueError(f"jaccard_verify mode must be one of {MODES}, got {mode!r}")
    N, L = win_tokens.shape
    if win_w.shape != (N, L) or ent_tokens.dim() != 3 or ent_tokens.shape[::2] != (N, L) \
            or ent_w.shape != ent_tokens.shape:
        raise ValueError(
            "jaccard_verify wants win [N, L], win_w [N, L], ent [N, K, L], ent_w [N, K, L]; got "
            f"{tuple(win_tokens.shape)}, {tuple(win_w.shape)}, {tuple(ent_tokens.shape)}, "
            f"{tuple(ent_w.shape)}"
        )


def jaccard_verify_plain(win_tokens, win_w, ent_tokens, ent_w, mode: str = "extra"):
    """Plain PyTorch form (mirror of the reference ``_kernel``): [N, K] f32."""
    _check(win_tokens, win_w, ent_tokens, ent_w, mode)
    L = win_tokens.shape[1]
    win = win_tokens[:, None, None, :]
    eq = (ent_tokens[..., None] == win) & (ent_tokens[..., None] != 0) & (win != 0)
    hit = eq.any(dim=-1).to(torch.float32)  # [N, K, L]
    inter = torch.zeros(ent_tokens.shape[:2], dtype=torch.float32, device=win_tokens.device)
    w_e = torch.zeros_like(inter)
    for i in range(L):
        inter = inter + ent_w[..., i] * hit[..., i]
        w_e = w_e + ent_w[..., i]
    ws = torch.zeros(win_tokens.shape[:1], dtype=torch.float32, device=win_tokens.device)
    for j in range(L):
        ws = ws + win_w[:, j]
    ws = ws[:, None]
    denom = w_e if mode == "extra" else ws.expand_as(inter)
    score = inter / denom.clamp_min(1e-30)
    return torch.where(ws > 0, score, torch.zeros_like(score))


_P = ctypes.c_void_p


def _lib():
    lib = _build.load("jaccard_verify")
    if not getattr(lib, "_typed", False):
        lib.jaccard_verify_launch.argtypes = [
            _P, _P, _P, _P, _P, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, _P,
        ]
        lib.jaccard_verify_launch.restype = ctypes.c_int
        lib._typed = True
    return lib


def jaccard_verify_cuda(win_tokens, win_w, ent_tokens, ent_w, mode: str = "extra"):
    """CUDA form of ``jaccard_verify_plain``: [N, K] f32."""
    global launches, long_launches
    _check(win_tokens, win_w, ent_tokens, ent_w, mode)
    dev = win_tokens.device
    for name, t, dtype in (("win_tokens", win_tokens, torch.int32), ("win_w", win_w, torch.float32),
                           ("ent_tokens", ent_tokens, torch.int32), ("ent_w", ent_w, torch.float32)):
        if not t.is_cuda or t.device != dev or t.dtype != dtype or not t.is_contiguous():
            raise ValueError(
                f"jaccard_verify_cuda: {name} must be a contiguous {dtype} tensor on {dev}, "
                f"got {t.dtype} on {t.device}"
            )
    N, K, L = ent_tokens.shape
    if L < 1:
        raise ValueError(f"jaccard_verify_cuda: row length L={L} must be positive")
    out = torch.empty((N, K), dtype=torch.float32, device=dev)
    if N * K == 0:
        return out
    rc = _lib().jaccard_verify_launch(
        win_tokens.data_ptr(), win_w.data_ptr(), ent_tokens.data_ptr(), ent_w.data_ptr(),
        out.data_ptr(), N, K, L, MODES.index(mode), _build.current_stream(dev),
    )
    launches += 1
    if L > MAX_UNROLLED_L:
        long_launches += 1
    if rc != 0:
        raise RuntimeError(f"jaccard_verify kernel launch failed with CUDA error {rc}")
    return out

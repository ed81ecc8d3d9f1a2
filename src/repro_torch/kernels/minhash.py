"""Banded MinHash (LSH) signatures of token windows.

Replaces the TPU kernel ``repro.kernels.minhash.minhash_pallas``: for
every row, B*R seeded token hashes, their minima over the valid tokens
(0xFFFFFFFF where none is valid), folded R at a time into B band
signatures tagged with the band number. Bit-identical to the
dictionary side's ``core.signatures`` MinHash, so a signature computed
here matches the host-built tables.

Two forms of the same function:

* ``minhash_plain``: PyTorch (``core.signatures._minhash_torch``); the
  CPU path and the oracle of the kernel;
* ``minhash_cuda``: the CUDA kernel in ``csrc/minhash.cu``.

``kernels.ops`` picks between them by the device of the tensors.
Outputs are int64 tensors holding uint32 values (see ``core.hashing``).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core.signatures import LshParams, _minhash_torch
from repro_torch.kernels import _build

#: launches of the CUDA kernel since the last reset (one per wrapper call)
launches = 0


def _check(tokens, valid, bands: int, rows: int) -> None:
    if tokens.dim() != 2 or tuple(valid.shape) != tuple(tokens.shape):
        raise ValueError(
            f"minhash wants tokens [N, L] and valid [N, L]; got {tuple(tokens.shape)}, "
            f"{tuple(valid.shape)}"
        )
    if bands < 1 or rows < 1:
        raise ValueError(f"minhash bands={bands} rows={rows} must both be positive")


def minhash_plain(tokens, valid, bands: int = 4, rows: int = 2):
    """Plain PyTorch form: [N, L] tokens -> [N, bands] band signatures."""
    _check(tokens, valid, bands, rows)
    return _minhash_torch(tokens, valid, LshParams(bands, rows))


def _lib():
    lib = _build.load("minhash")
    if not getattr(lib, "_typed", False):
        P = ctypes.c_void_p
        lib.minhash_launch.argtypes = [
            P, P, ctypes.c_longlong, ctypes.c_int,  # tokens, valid, N, L
            ctypes.c_int, ctypes.c_int, P, P,  # bands, rows, out, stream
        ]
        lib.minhash_launch.restype = ctypes.c_int
        lib._typed = True
    return lib


def minhash_cuda(tokens, valid, bands: int = 4, rows: int = 2):
    """CUDA form of ``minhash_plain``: same arguments, same output."""
    global launches
    _check(tokens, valid, bands, rows)
    for name, t, dtype in (("tokens", tokens, torch.int32), ("valid", valid, torch.bool)):
        if not t.is_cuda or t.dtype != dtype or not t.is_contiguous():
            raise ValueError(
                f"minhash_cuda: {name} must be a contiguous {dtype} CUDA tensor, "
                f"got {t.dtype} on {t.device}"
            )
    if valid.device != tokens.device:
        raise ValueError("minhash_cuda: valid must be on the tokens' device")
    N, L = tokens.shape
    if N * L == 0:
        raise ValueError("minhash_cuda: empty token batch")
    out = torch.empty((N, bands), dtype=torch.int64, device=tokens.device)
    rc = _lib().minhash_launch(
        tokens.data_ptr(), valid.data_ptr(), N, L, bands, rows, out.data_ptr(),
        _build.current_stream(tokens.device),
    )
    launches += 1
    if rc != 0:
        raise RuntimeError(f"minhash kernel launch failed with CUDA error {rc}")
    return out

"""ISH-filter probe over every (position, length) window, any length.

Replaces the TPU kernel ``repro.kernels.window_filter.
window_filter_pallas``:

    hit[d, t]     = t < T and all K Bloom probes of tok[d, t] set
    out[d, t, l]  = OR(hit[d, t .. t+l])        (l < L)

PAD tokens are probed like any other; the caller ANDs window validity.
The engine runs it where the fused probe's packed bitmap cannot hold
the window lengths (``max_len > 32``).

Two forms of the same function:

* ``window_filter_plain``: PyTorch, a mirror of the reference kernel;
  the CPU path and the oracle of the kernel;
* ``window_filter_cuda``: the CUDA kernel in ``csrc/window_filter.cu``.

``kernels.ops`` picks between them by the device of the tensors.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core.filter import token_in_filter
from repro_torch.kernels import _build
from repro_torch.kernels.fused_probe import check_cuda_inputs

#: launches of the CUDA kernel since the last reset (one per wrapper call)
launches = 0


def _check(doc_tokens, max_len: int) -> None:
    if doc_tokens.dim() != 2:
        raise ValueError(f"doc_tokens must be [D, T], got {tuple(doc_tokens.shape)}")
    if max_len < 1:
        raise ValueError(f"max_len={max_len} must be positive")


def window_filter_plain(doc_tokens, bits, num_bits: int, num_hashes: int, max_len: int):
    """Plain PyTorch form: [D, T] docs -> [D, T, L] bool survival mask."""
    _check(doc_tokens, max_len)
    D, T = doc_tokens.shape
    hit = token_in_filter(bits, num_bits, num_hashes, doc_tokens)
    out = torch.empty((D, T, max_len), dtype=torch.bool, device=doc_tokens.device)
    acc = torch.zeros_like(hit)
    shifted = hit
    for l in range(max_len):
        acc = acc | shifted
        out[:, :, l] = acc
        shifted = torch.cat([shifted[:, 1:], torch.zeros_like(shifted[:, :1])], dim=1)
    return out


def _lib():
    lib = _build.load("window_filter")
    if not getattr(lib, "_typed", False):
        P = ctypes.c_void_p
        lib.window_filter_launch.argtypes = [
            P, ctypes.c_int, ctypes.c_int,  # docs, D, T
            P, ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int,  # bits .. L
            P, P,  # out, stream
        ]
        lib.window_filter_launch.restype = ctypes.c_int
        lib._typed = True
    return lib


def window_filter_cuda(doc_tokens, bits, num_bits: int, num_hashes: int, max_len: int):
    """CUDA form of ``window_filter_plain``: same arguments, same output."""
    global launches
    _check(doc_tokens, max_len)
    check_cuda_inputs("window_filter_cuda", doc_tokens, bits, True, num_bits)
    if num_hashes < 1 or max_len > 4096:
        raise ValueError(f"window_filter_cuda: num_hashes={num_hashes}, max_len={max_len}")
    D, T = doc_tokens.shape
    if D * T == 0:
        raise ValueError("window_filter_cuda: empty document batch")
    out = torch.empty((D, T, max_len), dtype=torch.bool, device=doc_tokens.device)
    rc = _lib().window_filter_launch(
        doc_tokens.data_ptr(), D, T, bits.data_ptr(), num_bits, bits.numel(), num_hashes,
        max_len, out.data_ptr(), _build.current_stream(doc_tokens.device),
    )
    launches += 1
    if rc != 0:
        raise RuntimeError(f"window_filter kernel launch failed with CUDA error {rc}")
    return out

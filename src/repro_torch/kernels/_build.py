"""Build and load the CUDA kernels in ``csrc/``.

Each ``csrc/<name>.cu`` has a plain C interface (``csrc/*.cuh`` hold
device code that several sources include). It is compiled with
``nvcc`` for Hopper (``sm_90a``) into ``build/repro_torch/`` at the root
of the checkout, keyed by a hash of its source and flags, and loaded
with ``ctypes`` at first use. ``build()`` compiles several sources in
parallel, one ``nvcc`` process each. ``current_stream`` gives the
launchers the handle of the stream PyTorch is on.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

CSRC = Path(__file__).with_name("csrc")
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
KERNELS = ("fused_probe", "fused_probe_stream", "jaccard_verify", "window_filter", "minhash")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)
_DEFAULT_NVCC = "/usr/local/cuda/bin/nvcc"  # the CUDA toolkit's default prefix

_loaded: dict[str, ctypes.CDLL] = {}

# Private PyTorch API: the current stream's raw handle without building a
# torch.cuda.Stream object (a few microseconds a call); the public form
# where a build lacks it.
_raw_stream = getattr(torch._C, "_cuda_getCurrentRawStream", None)


def _nvcc() -> str:
    found = shutil.which("nvcc") or (_DEFAULT_NVCC if os.path.exists(_DEFAULT_NVCC) else None)
    if found is None:
        raise RuntimeError(
            "nvcc not found: building the CUDA kernels needs the CUDA toolkit "
            f"(nvcc on PATH or at {_DEFAULT_NVCC})"
        )
    return found


def library_path(name: str) -> Path:
    # the shared headers are part of every source's key
    src = b"".join(p.read_bytes() for p in [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))])
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build(names=KERNELS) -> dict[str, str]:
    """Compile every named kernel that is not built yet, all at once.

    Returns the compiler's output (``-Xptxas=-v`` register and shared
    memory report) by name; raises ``RuntimeError`` if a build fails.
    """
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        jobs[name] = (proc, tmp, out)
    logs = {}
    for name, (proc, tmp, out) in jobs.items():
        logs[name] = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on csrc/{name}.cu:\n{logs[name]}")
        os.replace(tmp, out)
    return logs


def load(name: str) -> ctypes.CDLL:
    """The loaded shared library of kernel ``name``, built if needed."""
    lib = _loaded.get(name)
    if lib is None:
        build((name,))
        lib = ctypes.CDLL(str(library_path(name)))
        _loaded[name] = lib
    return lib


def current_stream(device: torch.device) -> int:
    """The raw handle of the current CUDA stream on ``device``."""
    if _raw_stream is not None:
        return _raw_stream(device.index)
    return torch.cuda.current_stream(device).cuda_stream

#!/usr/bin/env python3
"""How many MinHash hashes an NVIDIA GPU sustains, and what the kernel's hash loop compiles to.

Run from the root of a checkout on a machine with the CUDA toolkit::

    python3 scripts/minhash_hash_rate.py

1. Builds ``src/repro_torch/kernels/csrc/minhash.cu`` (as ``chip_smoke.py``
   does) and prints, for each kernel instance, the instruction mix of the
   basic block with the most hashes in ``cuobjdump -sass``: instructions
   a hash, by opcode.
2. Builds a kernel that runs the hash step alone (registers only, no
   memory traffic: a murmur3 finaliser, the validity mask and the running
   minimum, 8 seeds x 4 tokens a step) and times it with CUDA events.
   Prints hashes a second.

The card's name and power limit come first. Exits non-zero without a GPU.
"""
from __future__ import annotations

import ctypes
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

BENCH_CU = r"""
#include <cuda_runtime.h>
#include <stdint.h>
constexpr uint32_t C1 = 0x85EBCA6Bu, C2 = 0xC2B2AE35u, GOLDEN = 0x9E3779B9u;
__device__ __forceinline__ uint32_t h(uint32_t a, uint32_t m) {
  a ^= a >> 16;
  a *= C1;
  a ^= a >> 13;
  a *= C2;
  return (a ^ (a >> 16)) | m;
}
__global__ void bench(uint32_t* out, int iters) {
  uint32_t r[8];
  for (int j = 0; j < 8; ++j) r[j] = 0xFFFFFFFFu;
  uint32_t x = threadIdx.x * 7919u + blockIdx.x;
  for (int i = 0; i < iters; ++i) {
    const uint32_t xs[4] = {x, x ^ 0x1234u, x + 77u, x * 3u};
    const uint32_t m = (i & 7) == 7 ? ~0u : 0u;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int k = 0; k < 4; ++k) r[j] = min(r[j], h(xs[k] + GOLDEN * (j + 1), m));
    x += 0x9E37u;
  }
  uint32_t acc = 0;
  for (int j = 0; j < 8; ++j) acc ^= r[j];
  out[blockIdx.x * blockDim.x + threadIdx.x] = acc;
}
extern "C" int hash_bench(int grid, int block, int iters, uint32_t* out, void* st) {
  bench<<<grid, block, 0, (cudaStream_t)st>>>(out, iters);
  return (int)cudaGetLastError();
}
"""


def hot_blocks(sass: str):
    """(function, instructions, hashes, opcode counts) of each function's
    basic block with the most murmur3 C1 multiplies (one a hash)."""
    for f in re.split(r"\n\s*Function : ", sass)[1:]:
        name = f.split("\n", 1)[0].strip()
        ins = [(int(m.group(1), 16), m.group(2).strip())
               for m in re.finditer(r"/\*([0-9a-f]{4,})\*/\s+([^;]*);", f)]
        targets = {int(m.group(1), 16) for _, s in ins
                   for m in [re.search(r"BRA\s+0x([0-9a-f]+)", s)] if m}
        blocks, cur = [], []
        for addr, s in ins:
            if addr in targets and cur:
                blocks.append(cur)
                cur = []
            cur.append(s)
            if "BRA" in s or "EXIT" in s:
                blocks.append(cur)
                cur = []
        blocks.append(cur)
        best = max(blocks, key=lambda b: sum("-0x7a143595" in s for s in b))
        ops: dict[str, int] = {}
        for s in best:
            op = (s.split()[1] if s.startswith("@") else s.split()[0]).split(".")[0]
            ops[op] = ops.get(op, 0) + 1
        yield name, len(best), sum("-0x7a143595" in s for s in best), ops


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("minhash_hash_rate: no CUDA device available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import _build

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    _build.build(("minhash",))
    cuobjdump = Path(_build._nvcc()).with_name("cuobjdump")
    sass = subprocess.run([str(cuobjdump), "-sass", str(_build.library_path("minhash"))],
                          capture_output=True, text=True, check=True).stdout
    for name, n, hashes, ops in hot_blocks(sass):
        inst = re.search(r"minhash_(rows|walk)_kernelILi(\d+)ELi(\d+)E", name)
        top = ", ".join(f"{k} {v}" for k, v in sorted(ops.items(), key=lambda kv: -kv[1])[:8])
        print(f"[sass] {inst.group(1)} CH={inst.group(2)} NQ={inst.group(3)}: hot block {n} "
              f"instructions for {hashes} hashes, {n / max(hashes, 1):.2f} a hash ({top})")

    src = _build.BUILD_DIR / "hash_bench.cu"
    lib = _build.BUILD_DIR / "libhash_bench.so"
    src.write_text(BENCH_CU)
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib), str(src)], check=True,
                   capture_output=True)
    fn = ctypes.CDLL(str(lib)).hash_bench
    fn.argtypes = [ctypes.c_int] * 3 + [ctypes.c_void_p] * 2
    grid = torch.cuda.get_device_properties(0).multi_processor_count * 16  # 16 blocks an SM
    block, iters = 128, 512
    out = torch.empty(grid * block, dtype=torch.int32, device="cuda")
    run = lambda: fn(grid, block, iters, out.data_ptr(), _build.current_stream(out.device))  # noqa: E731
    if run() != 0:
        raise RuntimeError("hash_bench launch failed")
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(20):
        run()
    stop.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(stop) / 20
    hashes = grid * block * iters * 32
    print(f"[rate] hash step alone: {ms:.4f} ms for {hashes} hashes, "
          f"{hashes / ms / 1e9:.3f} e12 hashes/s")
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""CUDA kernels (``csrc/``), their plain PyTorch versions and dispatch."""

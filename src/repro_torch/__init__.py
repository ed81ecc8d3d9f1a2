"""EE-Join in PyTorch with hand-written CUDA kernels for NVIDIA Hopper.

A port of ``repro`` (JAX + Pallas) that mirrors its layout module for
module. It imports ``torch`` and numpy only. Entry point:
``core.eejoin.EEJoinOperator``.
"""

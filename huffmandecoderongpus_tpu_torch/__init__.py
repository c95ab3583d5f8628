"""PyTorch / CUDA port of the wide-lane Huffman decoder.

The JAX package ``huffmandecoderongpus_tpu`` is the reference this package is
held against; this package imports nothing of it.  It carries its own
host layer (``huffio``: the `.huff` reader, trees, the encoder), the tables
in numpy, the device program in torch, and each Pallas kernel as a
hand-written CUDA C++ kernel for Hopper (``csrc/``) with a plain torch
version beside it.

Layering (bottom-up):
  huffio    — `.huff` container reader, Huffman trees, encoder (numpy)
  csrc      — CUDA C++ kernels (K1-K4, their 1-bit versions, the fused
              one-shot kernel, the lane-DFA scans), built with nvcc at
              first use
  ops       — host staging (numpy), the torch device program, the kernel
              wrappers (CUDA tensors launch the kernel, CPU tensors run the
              plain torch version)
  models    — the decoder registry (``lane_wide``, ``lane_oneshot``,
              ``lane_dfa``, ``lane_dfa_pallas``)
  harness   — the ``decode`` command line

This package never imports jax.
"""

__version__ = "0.1.0"

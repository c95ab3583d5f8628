"""PyTorch / CUDA port of the lane-parallel Huffman codec.

The JAX package ``huffmandecoderongpus_tpu`` is the reference this package is
held against; this package imports nothing of it.  It carries its own
host layer (``huffio``: the `.huff` reader and writer, trees, the host
encoder, the `.huffidx` writer), the tables in numpy, the device programs
in torch, and each Pallas kernel as a hand-written CUDA C++ kernel for
Hopper (``csrc/``) with a plain torch version beside it.

Layering (bottom-up):
  huffio    — `.huff` container reader and writer, Huffman trees, host
              encoder, `.huffidx` sidecar writer (numpy)
  csrc      — CUDA C++ kernels (K1-K4, their 1-bit versions, the fused
              one-shot kernel, the lane-DFA scans; the encoder's E1-E3),
              built with nvcc at first use
  ops       — host staging (numpy), the torch device programs (decode and
              ``encode.encode_lanes``), the kernel wrappers (CUDA tensors
              launch the kernel, CPU tensors run the plain torch version)
  models    — the decoder registry (``lane_wide``, ``lane_oneshot``,
              ``lane_dfa``, ``lane_dfa_pallas``)
  harness   — the ``encode`` and ``decode`` command line

This package never imports jax.
"""

__version__ = "0.1.0"

"""PyTorch / CUDA port of the lane-parallel Huffman codec.

The JAX package ``huffmandecoderongpus_tpu`` is the reference this package is
held against; this package imports nothing of it.  It carries its own
host layer (``huffio``: the `.huff` reader and writer, trees, the host
encoder, the `.huffidx` writer) and its own copy of the C++ host runtime
(``native``), the tables in numpy, the device programs in torch, and each
Pallas kernel as a hand-written CUDA C++ kernel for Hopper (``csrc/``) with
a plain torch version beside it.

Layering (bottom-up):
  huffio    — `.huff` container reader and writer, Huffman trees and their
              metrics, host encoder, `.huffidx` sidecar writer (numpy)
  native    — the C++ host runtime (``huffc.cpp``: serial decoders, table
              builder, truncation scan, bit-packer), built with g++ at
              first use and driven through ctypes
  csrc      — CUDA C++ kernels (K1-K4, their 1-bit versions, the fused
              one-shot kernel, the lane-DFA scans, the speculative
              pipeline's S1-S4; the encoder's E1-E3; the hardware probes'
              kernels), built with nvcc at first use
  ops       — host staging (numpy), the torch device programs (decode and
              ``encode.encode_lanes``), the kernel wrappers (CUDA tensors
              launch the kernel, CPU tensors run the plain torch version)
  models    — the decoder registry: the host decoders (``serial``,
              ``dfa``), the speculative pipeline, the one-thread decode and
              the lane decoders (``lane_wide``, ``lane_oneshot``,
              ``lane_dfa``, ``lane_dfa_pallas``, ``lane_dfa_sync``) and
              the sharded decoders
  parallel  — the shard mesh (virtual shards of one device, or a
              ``torch.distributed`` job), the block-parallel and the
              lane-sharded decodes, the multi-process decode
  data      — the reference's corpora (``HUFF_FILES_DIR``) as TestData pairs
  probes    — the hardware probes of ``scripts/``, on the card
  harness   — timers, evaluate (verify + min-of-N), the truncation sweeps,
              the stage profiler, and the command line (the reference's
              suites; ``encode``, ``decode``, ``verify``, ``info``,
              ``bits``, ``corpora``, ``decoders``, ``prof``, ``probe``,
              ``scaling``), the scaling sweep
  utils     — env-gated debug dumps; the profiler spans and counters of
              the codec's host work (``trace``)

This package never imports jax.
"""

__version__ = "0.1.0"

from huffmandecoderongpus_tpu_torch.huffio import (  # noqa: F401
    HuffFile,
    encode_bytes,
    read_huff,
    write_huff,
)
from huffmandecoderongpus_tpu_torch.models import get_decoder  # noqa: F401

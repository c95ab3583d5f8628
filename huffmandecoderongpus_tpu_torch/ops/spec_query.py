"""S3: the speculative pipeline's query, result and size check, fused.

The port of stages 4-6 of ``huffmandecoderongpus_tpu/ops/speculative.py``
``speculative_decode_xla`` (:142-173), XLA gathers there and no Pallas
kernel: each output index walks the doubling levels top-down to its
codeword's bit position (odd levels composed from the kept level below),
takes its symbol there, and ``found_size`` is ``size`` when the last
codeword ends at ``bits`` and no taken span was -1, else -1.  CUDA source:
``csrc/spec_query.cu``: outputs that share the high bits of their index
share that part of the walk, so a block of ``2^BLOCK_LEVELS`` outputs walks
its first index's high bits once and expands its outputs as a tree (node
``n + 2^k`` one jump past node ``n``), each jump into a node below ``size``
made once.
"""

from __future__ import annotations

import ctypes

import torch

from huffmandecoderongpus_tpu_torch.ops import _build
from huffmandecoderongpus_tpu_torch.utils import trace

#: a block's outputs, 2^BLOCK_LEVELS, its threads, and the levels warp 0
#: expands by shuffles (``csrc/spec_query.cu`` B, THREADS and SHUF)
BLOCK_LEVELS = 10
THREADS = 128
SHUFFLE_LEVELS = 5
#: the most bits the kernel takes: positions stay below bits + 32
MAX_BITS = 2**31 - 33


def kept_count(levels: int) -> int:
    """How many levels the pipeline keeps: 0, 2, 4, ... below
    max(levels, 1)."""
    return (max(levels, 1) - 1) // 2 + 1


def _check_inputs(kept, sym, bits, size, levels) -> None:
    if len(kept) != kept_count(levels) or levels > 31:
        raise ValueError(f"spec_query: {levels} levels keep "
                         f"{kept_count(levels)}, got {len(kept)}")
    for lv in kept:
        if lv.dtype not in (torch.int16, torch.int32) or lv.numel() != bits:
            raise ValueError("spec_query: kept levels are (bits,) int16 or "
                             "int32")
    if sym.dtype != torch.uint8 or sym.numel() != bits or bits < 1:
        raise ValueError("spec_query: sym must be (bits,) uint8")
    if bits > MAX_BITS:
        raise ValueError(f"spec_query: at most {MAX_BITS} bits")
    if size < 0:
        raise ValueError("spec_query: size must not be negative")


def spec_query(kept, sym, *, bits: int, size: int, levels: int):
    """(result uint8 (size,), found_size int32 ()) from the kept levels
    (levels 0, 2, 4, ..., each (bits,) int16 or int32) and the symbols at
    every offset.  CPU tensors run the plain version; CUDA tensors launch
    the kernel (none for size 0, whose result is empty)."""
    _check_inputs(kept, sym, bits, size, levels)
    if sym.is_cpu or size == 0:
        return spec_query_ref(kept, sym, bits=bits, size=size, levels=levels)
    _build.require_cuda("spec_query", sym, *kept)
    result = torch.empty(size, dtype=torch.uint8, device=sym.device)
    scratch = torch.empty(4, dtype=torch.int32, device=sym.device)
    ptrs = (ctypes.c_longlong * len(kept))(*(lv.data_ptr() for lv in kept))
    wide = sum(1 << j for j, lv in enumerate(kept)
               if lv.dtype == torch.int32)
    rc = _build.get_lib().ws_spec_query(
        ctypes.addressof(ptrs), len(kept), wide, sym.data_ptr(),
        result.data_ptr(), scratch.data_ptr(), scratch[3:].data_ptr(), bits,
        size, levels, _build.stream_ptr(sym))
    trace.count("launch.spec_query")
    _build.check(rc, "spec_query")
    return result, scratch[3]


def delta_at(kept, k: int, pos, bits: int):
    """The level-``k`` span at ``pos`` (int64): kept, or for odd ``k``
    composed from kept level ``k - 1`` with the doubling's rule."""
    if k % 2 == 0:
        return kept[k // 2][pos.clamp(0, bits - 1)].to(torch.int64)
    base = kept[(k - 1) // 2]
    d1 = base[pos.clamp(0, bits - 1)].to(torch.int64)
    t = pos + d1
    d2 = base[t.clamp(0, bits - 1)].to(torch.int64)
    ok = (d1 != -1) & (t < bits) & (d2 != -1) & (t + d2 <= bits)
    return torch.where(ok, d1 + d2, -1)


def spec_query_ref(kept, sym, *, bits: int, size: int, levels: int):
    """Plain torch stages 4-6, XLA's clip on every gather."""
    dev = sym.device
    i = torch.arange(size, dtype=torch.int64, device=dev)
    pos = torch.zeros(size, dtype=torch.int64, device=dev)
    bad = torch.zeros((), dtype=torch.bool, device=dev)
    for k in range(levels - 1, -1, -1):
        delta = delta_at(kept, k, pos, bits)
        take = ((i >> k) & 1) == 1
        bad = bad | (take & (delta == -1)).any()
        pos = torch.where(take, pos + delta.clamp(min=0), pos)
    result = sym[pos.clamp(0, bits - 1)]
    if size > 0:
        # the code length at the last position: where step0 is -1 it runs
        # past bits, so the end below cannot equal bits (the JAX test on
        # the raw length)
        ln = kept[0][pos[-1].clamp(0, bits - 1)].to(torch.int64)
        last_ok = (ln != -1) & (pos[-1] + ln == bits)
    else:
        last_ok = torch.tensor(bits == 0, device=dev)
    found = torch.where(last_ok & ~bad, size, -1).to(torch.int32)
    return result, found

"""S2's high levels: the next kept level from the one below, two doubling
levels a launch.

The port of ``double`` and the kept levels in
``huffmandecoderongpus_tpu/ops/speculative.py`` ``speculative_decode_xla``
(:122-140), XLA ops there and no Pallas kernel.  CUDA source:
``csrc/spec_pair.cu``: a thread computes the odd level at b and at its
jump target from four loads of kept level 2j and writes level 2j + 2, so
no odd level reaches device memory.  ``s2_plan`` (``ops/spec_tile.py``)
says which kept levels it makes, and for each ``seg``: where three spans of
the level pass most of the L2, the blocks in a span, so that blocks a
span apart run together and a block's gathers land where others read.
"""

from __future__ import annotations

import torch

from huffmandecoderongpus_tpu_torch.ops import _build
from huffmandecoderongpus_tpu_torch.ops.spec_double import spec_double_ref
from huffmandecoderongpus_tpu_torch.utils import trace

_SIZES = {torch.int16: 2, torch.int32: 4}
#: offsets a block of the kernel takes: 256 threads, 4 offsets each
BLOCK_OFFSETS = 1024


def blocks(bits: int) -> int:
    """The kernel's blocks of offsets for a level of ``bits`` offsets."""
    return -(-bits // BLOCK_OFFSETS)


def spec_pair(s, *, bits: int, dtype: torch.dtype, seg: int = 1):
    """Kept level 2j + 2 from kept level 2j ``s`` ((bits,) int16 or int32),
    as ``dtype`` (int16 or int32, no narrower than ``s``); ``seg`` the
    blocks a span apart that run together (1: in order; 1 to the blocks
    of ``bits``).  CPU tensors run the plain version; CUDA tensors launch
    the kernel."""
    if s.dtype not in _SIZES or dtype not in _SIZES or (
            _SIZES[dtype] < _SIZES[s.dtype]) or s.numel() != bits or bits < 1:
        raise ValueError("spec_pair: s is (bits,) int16 or int32, and the "
                         "output int16 or int32 no narrower")
    if not 1 <= seg <= blocks(bits):
        raise ValueError(f"spec_pair: seg {seg} outside 1-{blocks(bits)}")
    if s.is_cpu:
        return spec_pair_ref(s, bits=bits, dtype=dtype)
    _build.require_cuda("spec_pair", s)
    out = torch.empty(bits, dtype=dtype, device=s.device)
    rc = _build.get_lib().ws_spec_pair(
        s.data_ptr(), out.data_ptr(), bits, _SIZES[s.dtype], _SIZES[dtype],
        seg, _build.stream_ptr(s))
    trace.count("launch.spec_pair")
    _build.check(rc, "spec_pair")
    return out


def spec_pair_ref(s, *, bits: int, dtype: torch.dtype):
    """Plain version: ``spec_double_ref`` twice, the odd level between
    as int32."""
    odd = spec_double_ref(s, bits=bits, dtype=torch.int32)
    return spec_double_ref(odd, bits=bits, dtype=dtype)

"""P1: the launch-cost probe, ``x + 1``, and its gridded mode with scratch.

Replaces the trivial Pallas kernels of the hardware probes:
``scripts/hw_dispatch.py:52`` and ``scripts/hw_k1fixed.py:57`` (``triv``),
``hw_k1fixed.py:69`` (``triv5``, five launches here) and
``hw_k1fixed.py:95`` (``grid``, ``grid_k`` :79-89).  CUDA source:
``csrc/probe_inc.cu``, which says what the gridded mode measures once its
scratch no longer fits one block.
"""

from __future__ import annotations

import torch

from huffmandecoderongpus_tpu_torch.ops import _build
from huffmandecoderongpus_tpu_torch.ops.quad import to_i32, u32

#: kernel launches made by ``probe_inc`` and ``probe_grid`` on CUDA tensors
launches = 0
#: the scratch of ``grid_k`` past s1, in blocks of the x block's shape:
#: s2 (14, R, C), s3 (12, R, C) and s4 (12, R, C)
WORK_BLOCKS = 14 + 12 + 12


def probe_inc(x):
    """``x + 1`` on an int32 tensor of any shape (wrapping).  CPU tensors
    run the plain version; CUDA tensors launch the kernel."""
    if x.device.type == "cpu":
        return probe_inc_ref(x)
    global launches
    _build.require_cuda("probe_inc", x)
    if x.dtype != torch.int32:
        raise ValueError("probe_inc: x must be int32")
    out = torch.empty_like(x)
    rc = _build.get_lib().ws_probe_inc(_build.ptr(x), _build.ptr(out),
                                       x.numel(), _build.stream_ptr(x))
    launches += 1
    _build.check(rc, "probe_inc")
    return out


def probe_inc_ref(x):
    """Plain torch ``x + 1``, wrapping at 32 bits."""
    return to_i32((u32(x) + 1) & 0xFFFFFFFF)


def probe_grid(x):
    """``grid_k`` over x (S, R, C) int32, one grid step a block of (R, C):
    returns (out, work), out = x + s1[0, 0] with s1 zeroed, and ``work``
    (WORK_BLOCKS, R, C) int32, the scratch s2-s4 as the blocks leave it
    (all zero).  CPU tensors run the plain version; CUDA tensors launch the
    kernel, its workspace from ``torch.empty``."""
    if x.device.type == "cpu":
        return probe_grid_ref(x)
    global launches
    _build.require_cuda("probe_grid", x)
    if x.dtype != torch.int32 or x.dim() != 3:
        raise ValueError("probe_grid: x must be (S, R, C) int32")
    S, R, C = x.shape
    out = torch.empty_like(x)
    work = torch.empty((WORK_BLOCKS, R, C), dtype=torch.int32,
                       device=x.device)
    rc = _build.get_lib().ws_probe_grid(
        _build.ptr(x), _build.ptr(out), _build.ptr(work), S, R * C,
        work.numel(), _build.stream_ptr(x))
    launches += 1
    _build.check(rc, "probe_grid")
    return out, work


def probe_grid_ref(x):
    """Plain ``grid_k``: every scratch buffer zeroed, out = x + s1[0, 0]."""
    S, R, C = x.shape
    s1 = torch.zeros((R, C), dtype=torch.int32, device=x.device)
    work = torch.zeros((WORK_BLOCKS, R, C), dtype=torch.int32,
                       device=x.device)
    return to_i32((u32(x) + u32(s1[0, 0])) & 0xFFFFFFFF), work

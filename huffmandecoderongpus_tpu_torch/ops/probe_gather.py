"""P3: the gather probes, one-shot along either axis and chained.

Replaces the gather and roll Pallas kernels of the hardware probes:
``scripts/probe_gather.py:26`` and ``:58``, ``scripts/probe_vpu.py:104``
(``probe_i16_gather``) and ``:129`` (``probe_roll``), one-shot; and
``scripts/probe_vpu2.py:88`` (``make_gather``) and ``scripts/probe_vpu.py:78``
(``probe_gather``), chained.  CUDA source: ``csrc/probe_gather.cu``.

One-shot: ``out[r, j] = tab[r, idx[r, j]]`` (axis 1) or ``tab[idx[r, j],
j]`` (axis 0), as ``take_along_axis``, for int32, int16, uint16 and uint8
tables and int32, int16 and uint16 indices (read by the kernel as given);
an index outside the table's axis reads its nearest end.  The roll is the
kernel's roll mode: it computes each source position itself, so a roll is
one launch with no index.

Chained: P chains an element, ``c_i = (init + i) & (C - 1)``, then S steps
of ``c_i = tab[row, c_i & (C - 1)]`` with ``row`` the element's own row, or
row 0 of the table for every row with ``broadcast``; out = sum of the c_i.
"""

from __future__ import annotations

import torch

from huffmandecoderongpus_tpu_torch.ops import _build
from huffmandecoderongpus_tpu_torch.ops.quad import to_i32
from huffmandecoderongpus_tpu_torch.utils import trace

ELEMENTS = (torch.int32, torch.int16, torch.uint16, torch.uint8)
#: the index types the kernel reads, and the code its launcher takes
INDEXES = {torch.int32: 0, torch.int16: 1, torch.uint16: 2}
CHAINS = (1, 4, 8)


def _check_gather(tab, idx, axis):
    if axis not in (0, 1) or tab.dim() != 2 or idx.dim() != 2:
        raise ValueError("probe_gather: 2-d tab and idx, axis 0 or 1")
    if tab.dtype not in ELEMENTS:
        raise ValueError(f"probe_gather: tab type {tab.dtype} not taken")
    if idx.dtype not in INDEXES:
        raise ValueError(f"probe_gather: idx type {idx.dtype} not taken; "
                         "int32, int16 or uint16")
    other = 1 - axis
    if tab.shape[other] != idx.shape[other] or tab.shape[axis] == 0:
        raise ValueError("probe_gather: tab and idx differ off the axis")


def probe_gather(tab, idx, *, axis):
    """``take_along_axis(tab, idx, axis)`` of 2-d tensors, of tab's type and
    idx's shape.  CPU tensors run the plain version; CUDA tensors launch
    the kernel, which reads idx in its own type."""
    _check_gather(tab, idx, axis)
    if tab.is_cpu:
        return probe_gather_ref(tab, idx, axis=axis)
    _build.require_cuda("probe_gather", tab, idx)
    out = torch.empty_like(idx, dtype=tab.dtype)
    R, W = idx.shape
    Rt, Wt = tab.shape
    rc = _build.get_lib().ws_probe_gather(
        tab.data_ptr(), idx.data_ptr(), out.data_ptr(), R, W, Rt, Wt, axis,
        tab.element_size(), INDEXES[idx.dtype], _build.stream_ptr(tab))
    trace.count("launch.probe_gather")
    _build.check(rc, "probe_gather")
    return out


def probe_gather_ref(tab, idx, *, axis):
    """Plain ``torch.gather``, indices clamped to the axis; uint16 gathered
    as int16 (the same bits)."""
    _check_gather(tab, idx, axis)
    k = idx.to(torch.int64).clamp(0, tab.shape[axis] - 1)
    if tab.dtype == torch.uint16:
        return tab.view(torch.int16).gather(axis, k).view(torch.uint16)
    return tab.gather(axis, k)


def _check_roll(x, axis):
    if axis not in (0, 1) or x.dim() != 2:
        raise ValueError("probe_roll: 2-d x, axis 0 or 1")
    if x.dtype not in ELEMENTS:
        raise ValueError(f"probe_roll: x type {x.dtype} not taken")


def probe_roll(x, shift: int, *, axis):
    """``roll(x, shift, axis)`` of a 2-d tensor: position p of the axis
    reads (p - shift) mod n.  CPU tensors run the plain version; CUDA
    tensors launch the kernel's roll mode, once."""
    _check_roll(x, axis)
    if x.is_cpu:
        return probe_roll_ref(x, shift, axis=axis)
    _build.require_cuda("probe_roll", x)
    out = torch.empty_like(x)
    R, W = x.shape
    n = x.shape[axis]
    rc = _build.get_lib().ws_probe_roll(
        x.data_ptr(), out.data_ptr(), R, W, axis, x.element_size(),
        shift % n if n else 0, _build.stream_ptr(x))
    trace.count("launch.probe_gather")
    _build.check(rc, "probe_roll")
    return out


def probe_roll_ref(x, shift: int, *, axis):
    """Plain ``torch.roll``; uint16 rolled as int16 (the same bits)."""
    _check_roll(x, axis)
    if x.dtype == torch.uint16:
        return torch.roll(x.view(torch.int16), shift, axis).view(torch.uint16)
    return torch.roll(x, shift, axis)


def _check_chain(tab, init, P, S, broadcast):
    if tab.dtype != torch.int32 or init.dtype != torch.int32:
        raise ValueError("probe_gather_chain: int32 tab and init")
    R, C = init.shape
    if tab.dim() != 2 or tab.shape[1] != C or C & (C - 1) or C > 1024:
        raise ValueError("probe_gather_chain: tab (Rt, C) and init (R, C), "
                         "C a power of two up to 1024")
    if not broadcast and tab.shape[0] != R:
        raise ValueError("probe_gather_chain: tab needs R rows unless "
                         "broadcast")
    if P not in CHAINS or S < 0:
        raise ValueError(f"probe_gather_chain: P in {CHAINS}, S >= 0")


def probe_gather_chain(tab, init, *, P, S, broadcast=False):
    """The chained probe's (R, C) int32 sums.  CPU tensors run the plain
    version; CUDA tensors launch the kernel."""
    _check_chain(tab, init, P, S, broadcast)
    if tab.device.type == "cpu":
        return probe_gather_chain_ref(tab, init, P=P, S=S,
                                      broadcast=broadcast)
    _build.require_cuda("probe_gather_chain", tab, init)
    R, C = init.shape
    out = torch.empty_like(init)
    rc = _build.get_lib().ws_probe_gather_chain(
        tab.data_ptr(), init.data_ptr(), out.data_ptr(), R, C, P, S,
        int(broadcast), _build.stream_ptr(tab))
    trace.count("launch.probe_gather")
    _build.check(rc, "probe_gather_chain")
    return out


def probe_gather_chain_ref(tab, init, *, P, S, broadcast=False):
    """Plain chained gathers: the P chains stacked, one ``torch.gather`` a
    step."""
    _check_chain(tab, init, P, S, broadcast)
    R, C = init.shape
    rows = tab[:1].expand(R, C) if broadcast else tab
    rows = rows.to(torch.int64)[None].expand(P, R, C)
    c = (init.to(torch.int64)[None] + torch.arange(
        P, device=init.device)[:, None, None]) & (C - 1)
    for _ in range(S):
        c = rows.gather(2, c & (C - 1))
    return to_i32(c.sum(0) & 0xFFFFFFFF)

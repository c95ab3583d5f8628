"""K4: per-lane compaction of cell-packed emissions into dense bytes.

Replaces ``huffmandecoderongpus_tpu/ops/pallas_widescan.py`` ``k4_compact``
/ ``_k4_kernel`` (without its timing-only ``probes`` knob).  CUDA source:
``csrc/k4_compact.cu``.

Row g of ``denseT`` (G, ORP) uint8 holds lane g's valid slot bytes in slot
order: a prefix over the valid nibbles gives each byte its rank.  Ranks at
or past ORP are dropped (the caller checks the counts), and the rest of the
row is zero.
"""

from __future__ import annotations

import torch

from huffmandecoderongpus_tpu_torch.ops import _build
from huffmandecoderongpus_tpu_torch.ops.quad import CELL, u32

#: kernel launches made by ``k4_compact`` on CUDA tensors
launches = 0


def k4_compact(sym, val, *, ORP):
    """denseT (G, ORP) uint8 from spliced ``sym`` (cells_p, G) int32 and
    ``val`` (cells_p, G) uint8.  CPU tensors run the plain version; CUDA
    tensors launch the kernel."""
    if sym.device.type == "cpu":
        return k4_compact_ref(sym, val, ORP=ORP)
    global launches
    _build.require_cuda("k4_compact", sym, val)
    cells_p, G = sym.shape
    if ORP % 128 or val.shape != sym.shape:
        raise ValueError("k4_compact: ORP must be a multiple of 128")
    out = torch.empty((G, ORP), dtype=torch.uint8, device=sym.device)
    rc = _build.get_lib().ws_k4_compact(
        _build.ptr(sym), _build.ptr(val), _build.ptr(out), G, cells_p, ORP,
        _build.stream_ptr(sym))
    launches += 1
    _build.check(rc, "k4_compact")
    return out


def k4_compact_ref(sym, val, *, ORP):
    """Plain torch K4: a cumulative sum over each lane's valid slots, then
    one scatter of every valid byte to its rank."""
    cells_p, G = sym.shape
    b = torch.arange(CELL, device=sym.device)
    bytes_ = (u32(sym)[:, :, None] >> (8 * b)) & 0xFF       # (cells, G, 4)
    valid = ((val.to(torch.int64)[:, :, None] >> b) & 1) > 0
    bytes_ = bytes_.permute(1, 0, 2).reshape(G, cells_p * CELL)
    valid = valid.permute(1, 0, 2).reshape(G, cells_p * CELL)
    rank = torch.cumsum(valid.to(torch.int64), dim=1) - 1
    dst = torch.where(valid & (rank < ORP), rank, ORP)
    out = torch.zeros((G, ORP + 1), dtype=torch.uint8, device=sym.device)
    out.scatter_(1, dst, bytes_.to(torch.uint8))
    return out[:, :ORP].contiguous()

"""K3: fix scan + splice for lanes whose true entry offset is nonzero.

Replaces ``huffmandecoderongpus_tpu/ops/pallas_widescan.py`` ``k3_fix2`` /
``_k3_kernel2``.  CUDA source: ``csrc/k3_fix2.cu``.  The batched ``c01``
variant is ``k3_fix2_c01.py``.

A lane with entry ``ent > 0`` re-decodes from bit ``ent`` (an odd entry
starts mid-chunk: that chunk is a root step on its second bit) up to its
``cut`` row, and the re-decoded slots below ``cut_slot`` replace the main
scan's.  The cell holding ``cut_slot`` is spliced under a mask.  There is no
stream-limit mask: the splice bounds what is used.  Both versions update
``sym``/``val`` IN PLACE (the TPU kernel aliases them to its outputs) and
return them.
"""

from __future__ import annotations

import torch

from huffmandecoderongpus_tpu_torch.ops import _build
from huffmandecoderongpus_tpu_torch.ops.quad import (
    CELL,
    chunk_rows,
    decode_entry,
    quad_entry,
    scatter_slots,
    to_i32,
    u32,
)
from huffmandecoderongpus_tpu_torch.utils import trace


def k3_fix2(wmat, tab, ent, cut, cut_slot, sym, val, *, steps_p, SEG, md, C0,
            C1, NS):
    """Splice the fix scan into ``sym`` (cells_p, G) int32 and ``val``
    (cells_p, G) uint8 in place; ``ent``/``cut``/``cut_slot`` are (G,)
    int32.  CPU tensors run the plain version; CUDA tensors launch the
    kernel."""
    kw = dict(steps_p=steps_p, SEG=SEG, md=md, C0=C0, C1=C1, NS=NS)
    if wmat.device.type == "cpu":
        return k3_fix2_ref(wmat, tab, ent, cut, cut_slot, sym, val, **kw)
    _build.require_cuda("k3_fix2", wmat, tab, ent, cut, cut_slot, sym, val)
    steps_w, G = wmat.shape
    if (SEG % (CELL * md) or SEG > 32 or NS > 8 or steps_p % SEG
            or steps_w * 32 < steps_p
            or sym.shape != (steps_p // md // CELL, G)):
        raise ValueError("geometry outside the K3 kernel's bounds (see _plan)")
    rc = _build.get_lib().ws_k3_fix2(
        wmat.data_ptr(), tab.data_ptr(), ent.data_ptr(), cut.data_ptr(),
        cut_slot.data_ptr(), sym.data_ptr(), val.data_ptr(),
        G, steps_w, steps_p, SEG, md, C0, C1, NS, _build.stream_ptr(wmat))
    trace.count("launch.k3_fix2")
    _build.check(rc, "k3_fix2")
    return sym, val


def k3_fix2_ref(wmat, tab, ent, cut, cut_slot, sym, val, *, steps_p, SEG, md,
                C0, C1, NS, tbase=0):
    """Plain torch K3 (in place): vectorized over lanes, a Python loop over
    chunk rows up to the last segment any lane's cut reaches.  ``C0``/``C1``
    and ``tbase`` as in ``k1_scan2_ref``."""
    G = ent.shape[0]
    dev = ent.device
    nseg = min(-(-int(cut.max().clamp(min=0)) // SEG), steps_p // SEG)
    nrows = nseg * SEG // 2
    ncell = nrows * 2 // md // CELL
    tabf = u32(tab).reshape(-1)
    b0s, b1s = chunk_rows(wmat, nrows)
    ent64 = ent.to(torch.int64)
    node = torch.zeros(G, dtype=torch.int64, device=dev)
    cells = torch.zeros((ncell, G), dtype=torch.int64, device=dev)
    nib = torch.zeros_like(cells)
    for i in range(nrows):
        jbit = 2 * i
        b0, b1 = b0s[i], b1s[i]
        rc = torch.where(b1 > 0, C1, C0)
        started = jbit >= ent64
        e = torch.where(started, quad_entry(tabf, NS, node, b0, b1, tbase),
                        0)
        emit, pos, s, nfull = decode_entry(e, NS, rc)
        node = torch.where(started, nfull, node)
        node = torch.where(ent64 == jbit + 1, rc, node)
        scatter_slots(cells, nib, jbit, pos, emit, s, md)
    return splice(cells, nib, cut_slot, sym, val)


def splice(cells, nib, cut_slot, sym, val):
    """Masked splice, in place: slots below each lane's ``cut_slot`` take
    the fix scan's ``cells``/``nib`` (ncell, G) int64, the rest keep
    ``sym``/``val``.  Returns (sym, val)."""
    ncell = cells.shape[0]
    first = CELL * torch.arange(ncell, device=cells.device)[:, None]
    k = (cut_slot.to(torch.int64)[None, :] - first).clamp(0, CELL)
    vmask = (1 << k) - 1
    smask = torch.where(k >= CELL, 0xFFFFFFFF, (1 << (8 * k)) - 1)
    old = u32(sym[:ncell])
    sym[:ncell] = to_i32((cells & smask) | (old & ~smask & 0xFFFFFFFF))
    oldv = val[:ncell].to(torch.int64)
    val[:ncell] = ((nib & vmask) | (oldv & ~vmask)).to(torch.uint8)
    return sym, val

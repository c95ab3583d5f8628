"""K1 without discovery: the chunked main scan alone, for the indexed decode.

Replaces ``huffmandecoderongpus_tpu/ops/pallas_widescan.py`` ``k1_scan2`` /
``_k1_kernel2`` with ``discover=False`` (md >= 2 trees), the scan of
``wide_decode_indexed_program``.  CUDA source: ``csrc/k1_main.cu``.

Every lane is one `.huffidx` block: it starts at the DFA root on a codeword
boundary and ends at its bit limit ``lim``, so no candidate chain and no
exit is tracked.  The lane walks its bits two per step through the quad
table; a chunk at or past its limit reads entry 0 (no emission).  Outputs,
lanes minor: ``sym`` (cells_p, G) int32, four symbol bytes per cell (slot =
bit // md), and ``val`` (cells_p, G) uint8, the valid nibble per cell,
cells_p = steps_p / md / 4.  The JAX kernel's maps are left unwritten there
and unread by its caller, so none are made here.
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

#: kernel launches made by ``k1_main`` on CUDA tensors
launches = 0


def k1_main(wmat, tab, lim, *, steps_p, md, C0, C1, NS):
    """(sym, val) from the word matrix ``wmat`` (steps_w, G) int32 (no halo
    rows), the quad table ``tab`` (2 * NS, 128) int32 and the per-lane bit
    limits ``lim`` (G,) int32.  CPU tensors run the plain version; CUDA
    tensors launch the kernel."""
    kw = dict(steps_p=steps_p, md=md, C0=C0, C1=C1, NS=NS)
    if wmat.device.type == "cpu":
        return k1_main_ref(wmat, tab, lim, **kw)
    global launches
    _build.require_cuda("k1_main", wmat, tab, lim)
    steps_w, G = wmat.shape
    if (md < 2 or steps_p % (CELL * md) or NS > 8 or steps_w * 32 < steps_p
            or lim.shape != (G,)):
        raise ValueError("geometry outside the K1 main-scan kernel's bounds")
    cells_p = steps_p // md // CELL
    sym = torch.empty((cells_p, G), dtype=torch.int32, device=wmat.device)
    val = torch.empty((cells_p, G), dtype=torch.uint8, device=wmat.device)
    rc = _build.get_lib().ws_k1_main(
        wmat.data_ptr(), tab.data_ptr(), lim.data_ptr(), sym.data_ptr(),
        val.data_ptr(), G, steps_w, steps_p, md, C0, C1, NS,
        _build.stream_ptr(wmat))
    launches += 1
    _build.check(rc, "k1_main")
    return sym, val


def k1_main_ref(wmat, tab, lim, *, steps_p, md, C0, C1, NS):
    """Plain torch main scan: vectorized over lanes, a Python loop over
    chunk rows."""
    G = lim.shape[0]
    nrows = steps_p // 2
    i64 = dict(dtype=torch.int64, device=lim.device)
    tabf = u32(tab).reshape(-1)
    b0s, b1s = chunk_rows(wmat, nrows)
    lim64 = lim.to(torch.int64)
    node = torch.zeros(G, **i64)
    cells = torch.zeros((steps_p // md // CELL, G), **i64)
    nib = torch.zeros_like(cells)
    for i in range(nrows):
        jbit = 2 * i
        b0, b1 = b0s[i], b1s[i]
        e = torch.where(lim64 > jbit, quad_entry(tabf, NS, node, b0, b1), 0)
        emit, pos, sym, node = decode_entry(e, NS,
                                            torch.where(b1 > 0, C1, C0))
        scatter_slots(cells, nib, jbit, pos, emit, sym, md)
    return to_i32(cells), nib.to(torch.uint8)

"""K1 without discovery: the chunked main scan alone, for the indexed decode.

Replaces ``huffmandecoderongpus_tpu/ops/pallas_widescan.py`` ``k1_scan2`` /
``_k1_kernel2`` with ``discover=False`` (md >= 2 trees), the scan of
``wide_decode_indexed_program``.  CUDA source: ``csrc/k1_main.cu``.

Every lane is one `.huffidx` block: it starts at the DFA root on a codeword
boundary and ends at its bit limit ``lim``, so no candidate chain and no
exit is tracked.  The lane walks its bits two per step through the quad
table; a chunk at or past its limit reads entry 0 (no emission).  On the
card a thread walks a lane on the team body's step table and segments
(``csrc/k1_main.cu``), launched by ``k1_main_plan``.  Outputs,
lanes minor: ``sym`` (cells_p, G) int32, four symbol bytes per cell (slot =
bit // md), and ``val`` (cells_p, G) uint8, the valid nibble per cell,
cells_p = steps_p / md / 4.  The JAX kernel's maps are left unwritten there
and unread by its caller, so none are made here.
"""

from __future__ import annotations

import functools

import torch

from huffmandecoderongpus_tpu_torch.ops import _build
from huffmandecoderongpus_tpu_torch.ops.k1_scan2 import seg_bits, step_bytes
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

#: a block's threads (``__launch_bounds__(128)``): on the indexed (a), (b)
#: and (i) of ``chip_smoke.py`` 128 beat or tied 64 and 32, within 8 %,
#: though those spread (a)'s 11,264 lanes over every SM (H100 SXM, 700 W;
#: PERF.md)
THREADS = 128
#: blocks an SM holds at most (Hopper)
SM_BLOCKS = 32


@functools.lru_cache(maxsize=256)
def k1_main_plan(G: int, md: int, NS: int, steps_p: int,
                 sm_count: int = _build.SM_COUNT) -> dict:
    """Launch plan of ``k1_main`` on a card of ``sm_count`` SMs: a thread a
    lane, THREADS a block, ceil(G / THREADS) blocks.  Returns threads,
    blocks, ``shared`` (the step table's dynamic bytes, which each block
    stages), ``per_sm`` (the blocks an SM holds by threads, shared memory
    and the SM's block limit) and ``waves`` (the grid's blocks over what
    the card holds at once).  Raises ValueError for a geometry outside the
    kernel's bounds, steps_p not whole segments of the team body's SEG
    among them (the indexed SEG, lcm(4 * md, 32), is a multiple of it)."""
    if (not 2 <= md <= 8 or not 1 <= NS <= 8 or G < 1
            or steps_p % seg_bits(md)):
        raise ValueError("geometry outside the K1 main-scan kernel's bounds")
    blocks = -(-G // THREADS)
    shared = step_bytes(NS)
    per_sm = min(SM_BLOCKS, _build.SM_THREADS // THREADS,
                 _build.SM_SHARED // (shared + _build.BLOCK_RESERVED))
    return dict(threads=THREADS, blocks=blocks, shared=shared,
                per_sm=per_sm, waves=-(-blocks // (sm_count * per_sm)),
                sm_count=sm_count)


def k1_main(wmat, tab, lim, *, steps_p, md, C0, C1, NS):
    """(sym, val) from the word matrix ``wmat`` (steps_w, G) int32 (no halo
    rows), the quad table ``tab`` (2 * NS, 128) int32 and the per-lane bit
    limits ``lim`` (G,) int32.  CPU tensors run the plain version; CUDA
    tensors launch the kernel."""
    kw = dict(steps_p=steps_p, md=md, C0=C0, C1=C1, NS=NS)
    if wmat.device.type == "cpu":
        return k1_main_ref(wmat, tab, lim, **kw)
    _build.require_cuda("k1_main", wmat, tab, lim)
    steps_w, G = wmat.shape
    if steps_w * 32 < steps_p or lim.shape != (G,):
        raise ValueError("geometry outside the K1 main-scan kernel's bounds")
    p = k1_main_plan(G, md, NS, steps_p, _build.sm_count(wmat.device))
    cells_p = steps_p // md // CELL
    sym = torch.empty((cells_p, G), dtype=torch.int32, device=wmat.device)
    val = torch.empty((cells_p, G), dtype=torch.uint8, device=wmat.device)
    rc = _build.get_lib().ws_k1_main(
        wmat.data_ptr(), tab.data_ptr(), lim.data_ptr(), sym.data_ptr(),
        val.data_ptr(), G, steps_w, steps_p, md, C0, C1, NS, p["threads"],
        p["shared"], _build.stream_ptr(wmat))
    trace.count("launch.k1_main")
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

"""K3': 1-bit fix scan + splice for lanes whose true entry offset is nonzero.

Replaces ``huffmandecoderongpus_tpu/ops/pallas_widescan.py`` ``k3_fix`` /
``_k3_kernel`` (md = 1 trees).  CUDA source: ``csrc/k3_fix.cu``.

A lane with entry ``ent > 0`` re-decodes through the pair table from the
root at bit ``ent`` (bits before it read a zero entry, which leaves the
walk at the root) up to its ``cut`` row, and the re-decoded slots below
``cut_slot`` replace the main scan's; the cell holding ``cut_slot`` is
spliced under a mask.  There is no stream-limit mask: the splice bounds
what is used.  Both versions update ``sym``/``val`` IN PLACE (the TPU kernel
aliases them to its outputs) and return them.  On the card a thread walks a
lane on the 1-bit step table in shared memory (``csrc/widescan.cuh``
``stage_step_table1``, K1''s table) and stores the cells below the one
holding ``cut_slot`` without reading them.
"""

from __future__ import annotations

import torch

from huffmandecoderongpus_tpu_torch.ops import _build
from huffmandecoderongpus_tpu_torch.ops.k3_fix2 import splice
from huffmandecoderongpus_tpu_torch.ops.pair import bit_rows, e1_fields, pair_entry
from huffmandecoderongpus_tpu_torch.ops.quad import CELL, u32
from huffmandecoderongpus_tpu_torch.utils import trace


def k3_fix(wmat, tab, ent, cut, cut_slot, sym, val, *, steps_p, SEG, md, NS):
    """Splice the fix scan into ``sym`` (cells_p, G) int32 and ``val``
    (cells_p, G) uint8 in place; ``ent``/``cut``/``cut_slot`` are (G,)
    int32.  CPU tensors run the plain version; CUDA tensors launch the
    kernel (md = 1 only)."""
    kw = dict(steps_p=steps_p, SEG=SEG, md=md, NS=NS)
    if wmat.device.type == "cpu":
        return k3_fix_ref(wmat, tab, ent, cut, cut_slot, sym, val, **kw)
    _build.require_cuda("k3_fix", wmat, tab, ent, cut, cut_slot, sym, val)
    steps_w, G = wmat.shape
    if (md != 1 or SEG != 32 or not 1 <= NS <= 8 or tab.shape[0] != NS
            or steps_p % SEG or steps_w * 32 < steps_p
            or sym.shape != (steps_p // CELL, G)):
        raise ValueError("geometry outside the K3' kernel's bounds (see _plan)")
    rc = _build.get_lib().ws_k3_fix(
        wmat.data_ptr(), tab.data_ptr(), ent.data_ptr(), cut.data_ptr(),
        cut_slot.data_ptr(), sym.data_ptr(), val.data_ptr(),
        G, steps_w, steps_p, NS, _build.stream_ptr(wmat))
    trace.count("launch.k3_fix")
    _build.check(rc, "k3_fix")
    return sym, val


def k3_fix_ref(wmat, tab, ent, cut, cut_slot, sym, val, *, steps_p, SEG, md,
               NS):
    """Plain torch K3' (in place): vectorized over lanes, a Python loop over
    bits up to the last segment any lane's cut reaches."""
    G = ent.shape[0]
    dev = ent.device
    nseg = min(-(-int(cut.max().clamp(min=0)) // SEG), steps_p // SEG)
    nbits = nseg * SEG
    ncell = nbits // md // CELL
    tabf = u32(tab).reshape(-1)
    bits = bit_rows(wmat, nbits)
    ent64 = ent.to(torch.int64)
    node = torch.zeros(G, dtype=torch.int64, device=dev)
    cells = torch.zeros((ncell, G), dtype=torch.int64, device=dev)
    nib = torch.zeros_like(cells)
    for j in range(nbits):
        e = torch.where(j >= ent64, pair_entry(tabf, node, bits[j]), 0)
        emit, s, node = e1_fields(e, NS)
        slot = j // md
        cells[slot // CELL] |= s << (8 * (slot % CELL))
        nib[slot // CELL] |= emit << (slot % CELL)
    return splice(cells, nib, cut_slot, sym, val)

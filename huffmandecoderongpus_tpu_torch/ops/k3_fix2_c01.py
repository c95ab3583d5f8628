"""K3 of the batched multi-stream decode: each lane on its own stream's table.

Replaces ``huffmandecoderongpus_tpu/ops/pallas_widescan.py``
``_k3_kernel2_c01`` with ``k3_fix2``'s ``tab_bounds``.  CUDA source:
``csrc/k3_fix2_c01.cu``.

The same fix scan and splice as ``k3_fix2``, IN PLACE on ``sym``/``val``,
with the stacked tables, stream map and root children of
``k1_scan2_c01``.
"""

from __future__ import annotations

from huffmandecoderongpus_tpu_torch.ops import _build
from huffmandecoderongpus_tpu_torch.ops.k1_scan2_c01 import BLOCK, lane_tables
from huffmandecoderongpus_tpu_torch.ops.k3_fix2 import k3_fix2_ref
from huffmandecoderongpus_tpu_torch.ops.quad import CELL
from huffmandecoderongpus_tpu_torch.utils import trace


def k3_fix2_c01(wmat, tabs, ent, cut, cut_slot, sym, val, c01, bstream, *,
                steps_p, SEG, md):
    """Splice the fix scan into ``sym``/``val`` in place, each lane on its
    stream's table; returns them.  CPU tensors run the plain version; CUDA
    tensors launch the kernel."""
    kw = dict(steps_p=steps_p, SEG=SEG, md=md)
    if wmat.device.type == "cpu":
        return k3_fix2_c01_ref(wmat, tabs, ent, cut, cut_slot, sym, val, c01,
                               bstream, **kw)
    _build.require_cuda("k3_fix2_c01", wmat, tabs, ent, cut, cut_slot, sym,
                        val, c01, bstream)
    steps_w, G = wmat.shape
    if (SEG % (CELL * md) or SEG > 32 or steps_p % SEG
            or steps_w * 32 < steps_p or G % BLOCK
            or sym.shape != (steps_p // md // CELL, G)
            or bstream.shape != (G // BLOCK,) or c01.shape != (G,)):
        raise ValueError("geometry outside the batched K3 kernel's bounds")
    rc = _build.get_lib().ws_k3_fix2_c01(
        wmat.data_ptr(), tabs.data_ptr(), ent.data_ptr(), cut.data_ptr(),
        cut_slot.data_ptr(), c01.data_ptr(), bstream.data_ptr(),
        sym.data_ptr(), val.data_ptr(), G, steps_w, steps_p, SEG, md,
        _build.stream_ptr(wmat))
    trace.count("launch.k3_fix2_c01")
    _build.check(rc, "k3_fix2_c01")
    return sym, val


def k3_fix2_c01_ref(wmat, tabs, ent, cut, cut_slot, sym, val, c01, bstream,
                    *, steps_p, SEG, md):
    """Plain torch: ``k3_fix2_ref`` with per-lane tables and root
    children."""
    C0, C1, tbase = lane_tables(c01, bstream)
    return k3_fix2_ref(wmat, tabs, ent, cut, cut_slot, sym, val,
                       steps_p=steps_p, SEG=SEG, md=md, C0=C0, C1=C1, NS=1,
                       tbase=tbase)

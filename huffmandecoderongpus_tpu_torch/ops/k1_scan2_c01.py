"""K1 of the batched multi-stream decode: each lane on its own stream's table.

Replaces ``huffmandecoderongpus_tpu/ops/pallas_widescan.py``
``_k1_kernel2_c01`` with ``k1_scan2``'s ``tab_bounds``.  CUDA source:
``csrc/k1_scan2_c01.cu``.

The same scan and discovery as ``k1_scan2`` (and the same outputs), with
the tables of N streams stacked as ``tabs`` (2 * N, 128) int32 (compact
quad tables, NS = 1), the stream of every 128-lane block in ``bstream``
(G / 128,) int32 and every lane's root children C0 | C1 << 16 in ``c01``
(G,) int32.  The JAX kernel selects the table per row group through its
BlockSpec index map; here each block of the kernel (``k1_plan``'s lanes, at
most 32) lies inside one 128-lane entry of the stream map.  The compact
table's entries hold their post-chunk states, so the step table the kernel
builds from it does not depend on C0/C1, which it reads per lane.
"""

from __future__ import annotations

import torch

from huffmandecoderongpus_tpu_torch.ops import _build
from huffmandecoderongpus_tpu_torch.ops.k1_scan2 import (
    _shapes,
    k1_plan,
    k1_scan2_ref,
)
from huffmandecoderongpus_tpu_torch.ops.quad import CELL
from huffmandecoderongpus_tpu_torch.utils import trace

#: lanes of one stream-map entry
BLOCK = 128


def lane_tables(c01, bstream):
    """(C0, C1, tbase) (G,) int64: each lane's root children and the offset
    of its stream's table in the flattened stack."""
    r = c01.to(torch.int64) & 0xFFFFFFFF
    tbase = bstream.to(torch.int64).repeat_interleave(BLOCK) * (2 * 128)
    return r & 0xFFFF, r >> 16, tbase


def k1_scan2_c01(wmat, tabs, lim, c01, bstream, *, B, H, steps, steps_p,
                 SEG, md):
    """(sym, val, cntmap, exmap, mrowmap) as ``k1_scan2``, each lane on its
    stream's table.  CPU tensors run the plain version; CUDA tensors launch
    the kernel."""
    kw = dict(B=B, H=H, steps=steps, steps_p=steps_p, SEG=SEG, md=md)
    if wmat.device.type == "cpu":
        return k1_scan2_c01_ref(wmat, tabs, lim, c01, bstream, **kw)
    _build.require_cuda("k1_scan2_c01", wmat, tabs, lim, c01, bstream)
    steps_w, G = wmat.shape
    _CH, HP, cells_p = _shapes(H, steps_p, md)
    if (SEG % (CELL * md) or SEG > 32 or md > 8 or HP > 128
            or steps_p % SEG or steps_w * 32 < steps_p or G % BLOCK
            or bstream.shape != (G // BLOCK,) or c01.shape != (G,)
            or tabs.shape[1:] != (128,) or tabs.shape[0] % 2):
        raise ValueError("geometry outside the batched K1 kernel's bounds")
    dev = wmat.device
    sym = torch.empty((cells_p, G), dtype=torch.int32, device=dev)
    val = torch.empty((cells_p, G), dtype=torch.uint8, device=dev)
    maps = [torch.empty((HP, G), dtype=torch.int32, device=dev)
            for _ in range(3)]
    p = k1_plan(G, H, md, SEG, steps_p, 1, _build.sm_count(dev))
    rc = _build.get_lib().ws_k1_scan2_c01(
        wmat.data_ptr(), tabs.data_ptr(), lim.data_ptr(), c01.data_ptr(),
        bstream.data_ptr(), sym.data_ptr(), val.data_ptr(),
        *(m.data_ptr() for m in maps), G, steps_w, B, H, steps, steps_p,
        SEG, md, p["T"], p["shared"], _build.stream_ptr(wmat))
    trace.count("launch.k1_scan2_c01")
    _build.check(rc, "k1_scan2_c01")
    return (sym, val, *maps)


def k1_scan2_c01_ref(wmat, tabs, lim, c01, bstream, *, B, H, steps, steps_p,
                     SEG, md):
    """Plain torch: ``k1_scan2_ref`` with per-lane tables and root
    children."""
    C0, C1, tbase = lane_tables(c01, bstream)
    return k1_scan2_ref(wmat, tabs, lim, B=B, H=H, steps=steps,
                        steps_p=steps_p, SEG=SEG, md=md, C0=C0, C1=C1, NS=1,
                        tbase=tbase)

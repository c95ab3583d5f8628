"""Lane scan of the lane-DFA chain: each lane from its true entry offset.

Replaces ``huffmandecoderongpus_tpu/ops/pallas_lanedfa.py``
``lane_scan_pallas_tiled`` / ``_main_kernel`` (and computes what the XLA
``_lane_scan`` of ``ops/lanedfa.py`` computes).  CUDA source:
``csrc/lane_scan.cu``.

Lane g walks the fused table one bit row at a time from the root at row
``start[g]``; a row is active while it is below the lane's stream limit
``N - g*B`` and the lane has not finished: its first emission at a row j
with j + 1 >= B is its last (it completes the last codeword that starts in
the lane).  Outputs (B+H, G) uint8: ``valid`` marks the active rows that
emit, and ``sym`` is the symbol field of every row's table entry (set on
every row; only rows marked valid carry a decoded symbol).  With ``rows``
the scan walks only the first ``rows`` bit rows: the fix scan of the
self-synchronizing discovery (``_fix_scan`` of ``ops/lanedfa_sync.py``,
the same rules cut at W rows).

The kernel stages the bit matrix in shared memory a tile at a time; its
launch plan (lanes a block, rows a tile, copy width, shared bytes) is
``lanedfa.tile_plan``'s, computed here and handed to the launcher.
"""

from __future__ import annotations

import torch

from huffmandecoderongpus_tpu_torch.ops import _build
from huffmandecoderongpus_tpu_torch.ops.lanedfa import (
    EMIT_BIT,
    STATE_MASK,
    lane_limits,
    tile_plan,
)
from huffmandecoderongpus_tpu_torch.utils import trace


def lane_scan(bits_t, tab, start, *, B, H, N, rows=None):
    """(sym, valid) (rows, G) uint8 from the bit matrix ``bits_t`` (rows, G)
    uint8 (``rows`` B+H unless given), the padded fused table ``tab``
    (n_chunks, 128) int32 and the entry offsets ``start`` (G,) int32.  CPU
    tensors run the plain version; CUDA tensors launch the kernel."""
    if bits_t.device.type == "cpu":
        return lane_scan_ref(bits_t, tab, start, B=B, H=H, N=N, rows=rows)
    _build.require_cuda("lane_scan", bits_t, tab, start)
    steps, G = bits_t.shape
    if (steps != (B + H if rows is None else rows)
            or bits_t.dtype != torch.uint8
            or start.dtype != torch.int32 or start.shape != (G,)
            or tab.numel() > _build.LANEDFA_TAB_WORDS):
        raise ValueError("lane_scan: bits must be (rows, G) uint8 (rows B+H "
                         "unless given), start (G,) int32 and the table at "
                         "most 16 chunks")
    sym = torch.empty((steps, G), dtype=torch.uint8, device=bits_t.device)
    valid = torch.empty((steps, G), dtype=torch.uint8, device=bits_t.device)
    bp, sp, vp = bits_t.data_ptr(), sym.data_ptr(), valid.data_ptr()
    p = tile_plan(G, 1, bp | sp | vp, out_tiles=True)
    rc = _build.get_lib().ws_lane_scan(
        bp, tab.data_ptr(), start.data_ptr(), sp, vp, G, B, steps, N,
        tab.numel(), p["lanes"], p["rows"], p["vec"], p["shared"],
        _build.stream_ptr(bits_t))
    trace.count("launch.lane_scan")
    _build.check(rc, "lane_scan")
    return sym, valid


def lane_scan_ref(bits_t, tab, start, *, B, H, N, rows=None):
    """Plain torch lane scan: all lanes as one (G,) state, a Python loop
    over bit rows."""
    steps, G = bits_t.shape
    if steps != (B + H if rows is None else rows):
        raise ValueError("lane_scan: bits must have rows (B+H unless given) "
                         "rows")
    dev = bits_t.device
    tabf = tab.reshape(-1).to(torch.int64)
    j0 = start.to(torch.int64)
    lim = lane_limits(N, B, G, dev)
    node = torch.zeros(G, dtype=torch.int64, device=dev)
    done = torch.zeros(G, dtype=torch.bool, device=dev)
    sym = torch.empty((steps, G), dtype=torch.uint8, device=dev)
    valid = torch.empty((steps, G), dtype=torch.uint8, device=dev)
    for j in range(steps):
        e = tabf[node * 2 + bits_t[j].to(torch.int64)]
        active = (j >= j0) & ~done & (j < lim)
        emit = active & ((e & EMIT_BIT) != 0)
        node = torch.where(active, e & STATE_MASK, node)
        if j + 1 >= B:
            done = done | emit
        sym[j] = (e >> 16).to(torch.uint8)
        valid[j] = emit.to(torch.uint8)
    return sym, valid

"""Short candidate scan of the self-synchronizing lane-DFA discovery.

Replaces ``huffmandecoderongpus_tpu/ops/lanedfa_sync.py``
``_short_candidate_scan`` (an XLA scan there).  CUDA source:
``csrc/short_candidate_scan.cu``.

Chain (o, g) starts at the root at bit row o of lane g's column and walks
the fused table one bit per row, for rows below W and the lane's stream
limit ``N - g*B``, until it resolves: its first emission on a row where
the 0-chain (``valid0``, the lane scanned from offset 0) also emitted
merges it, or else its first emission at a row j with j + 1 >= B exits it
into lane g+1.  Outputs (H, G): ``merged`` and ``exited`` bool, ``mrow``
(the merge row), ``cnt`` (emissions through the resolving one) and
``exit_off`` (j + 1 - B) int32, each 0 where the chain never set it.

The kernel stages the first W rows of the bit matrix and of ``valid0`` in
shared memory a tile at a time, in two rings under one launch plan
(``lanedfa.short_plan``'s: lanes a block, rows a tile, copy width, shared
bytes), computed here and handed to the launcher.
"""

from __future__ import annotations

import torch

from huffmandecoderongpus_tpu_torch.ops import _build
from huffmandecoderongpus_tpu_torch.ops.lanedfa import (
    EMIT_BIT,
    STATE_MASK,
    lane_limits,
    short_plan,
)
from huffmandecoderongpus_tpu_torch.utils import trace


def short_candidate_scan(bits_t, tab, valid0, *, B, H, N, W):
    """(merged, exited, mrow, cnt, exit_off) (H, G) from the first W rows
    of the bit matrix ``bits_t`` (>= W, G) uint8 and of the 0-chain's
    emissions ``valid0`` (>= W, G) uint8 or bool, and the padded fused
    table ``tab`` (n_chunks, 128) int32.  CPU tensors run the plain
    version; CUDA tensors launch the kernel."""
    if bits_t.device.type == "cpu":
        return short_candidate_scan_ref(bits_t, tab, valid0, B=B, H=H, N=N,
                                        W=W)
    _build.require_cuda("short_candidate_scan", bits_t, tab, valid0)
    steps, G = bits_t.shape
    if (bits_t.dtype != torch.uint8 or valid0.shape[1:] != (G,)
            or valid0.dtype not in (torch.uint8, torch.bool)
            or not 0 <= W <= min(steps, valid0.shape[0])
            or tab.numel() > _build.LANEDFA_TAB_WORDS):
        raise ValueError("short_candidate_scan: bits and valid0 must be "
                         "(>= W, G) uint8 (valid0 may be bool) and the "
                         "table at most 16 chunks")
    dev = bits_t.device
    merged = torch.empty((H, G), dtype=torch.bool, device=dev)
    exited = torch.empty((H, G), dtype=torch.bool, device=dev)
    mrow, cnt, ex = (torch.empty((H, G), dtype=torch.int32, device=dev)
                     for _ in range(3))
    bp, vp = bits_t.data_ptr(), valid0.data_ptr()
    p = short_plan(G, H, bp | vp)
    rc = _build.get_lib().ws_short_candidate_scan(
        bp, tab.data_ptr(), vp, merged.data_ptr(), exited.data_ptr(),
        mrow.data_ptr(), cnt.data_ptr(), ex.data_ptr(), G, B, H, N, W,
        tab.numel(), p["lanes"], p["rows"], p["vec"], p["shared"],
        _build.stream_ptr(bits_t))
    trace.count("launch.short_candidate_scan")
    _build.check(rc, "short_candidate_scan")
    return merged, exited, mrow, cnt, ex


def short_candidate_scan_ref(bits_t, tab, valid0, *, B, H, N, W):
    """Plain torch short candidate scan: all H chains of all lanes as one
    (H, G) state, a Python loop over the first W bit rows."""
    G = bits_t.shape[1]
    dev = bits_t.device
    tabf = tab.reshape(-1).to(torch.int64)
    offs = torch.arange(H, device=dev)[:, None]
    lim = lane_limits(N, B, G, dev)
    z = torch.zeros((H, G), dtype=torch.int64, device=dev)
    f = torch.zeros((H, G), dtype=torch.bool, device=dev)
    node, cnt, mrow, ex, merged, exited = z, z, z, z, f, f
    for j in range(W):
        e = tabf[node * 2 + bits_t[j].to(torch.int64)]
        live = (j >= offs) & ~merged & ~exited & (j < lim)
        emit = live & ((e & EMIT_BIT) != 0)
        node = torch.where(live, e & STATE_MASK, node)
        merge_now = emit & (valid0[j] != 0)
        exit_now = emit & ~merge_now & (j + 1 >= B)
        cnt = cnt + emit
        mrow = torch.where(merge_now, j, mrow)
        ex = torch.where(exit_now, j + 1 - B, ex)
        merged = merged | merge_now
        exited = exited | exit_now
    i32 = torch.int32
    return merged, exited, mrow.to(i32), cnt.to(i32), ex.to(i32)

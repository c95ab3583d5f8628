"""Candidate scan of the lane-DFA chain: every entry offset of every lane.

Replaces ``huffmandecoderongpus_tpu/ops/pallas_lanedfa.py``
``candidate_scan_pallas_tiled`` / ``_candidate_kernel`` (and computes what
the XLA ``_candidate_scan`` of ``ops/lanedfa.py`` computes).  CUDA source:
``csrc/candidate_scan.cu``.

Chain (o, g) starts at the root at bit row o of lane g's column of the bit
matrix and walks the fused table one bit per row while the row is below
the lane's stream limit ``N - g*B`` and the chain has not exited: its first
emission at row j with j + 1 >= B ends it (it has decoded every codeword
that starts in the lane).  Outputs (H, G) int32: ``cnt``, the symbols the
chain emitted, and ``ex``, the offset j + 1 - B of its exit in lane g+1 (0
if it never exits).

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


def candidate_scan(bits_t, tab, *, B, H, N):
    """(cnt, ex) (H, G) int32 from the bit matrix ``bits_t`` (B+H, G) uint8
    and the padded fused table ``tab`` (n_chunks, 128) int32; ``N`` is the
    stream's bit count.  CPU tensors run the plain version; CUDA tensors
    launch the kernel."""
    if bits_t.device.type == "cpu":
        return candidate_scan_ref(bits_t, tab, B=B, H=H, N=N)
    _build.require_cuda("candidate_scan", bits_t, tab)
    steps, G = bits_t.shape
    if (steps != B + H or bits_t.dtype != torch.uint8
            or tab.numel() > _build.LANEDFA_TAB_WORDS):
        raise ValueError("candidate_scan: bits must be (B+H, G) uint8 and "
                         "the table at most 16 chunks")
    cnt = torch.empty((H, G), dtype=torch.int32, device=bits_t.device)
    ex = torch.empty((H, G), dtype=torch.int32, device=bits_t.device)
    bp = bits_t.data_ptr()
    p = tile_plan(G, H, bp, out_tiles=False)
    rc = _build.get_lib().ws_candidate_scan(
        bp, tab.data_ptr(), cnt.data_ptr(), ex.data_ptr(), G, B, H, N,
        tab.numel(), p["lanes"], p["rows"], p["vec"], p["shared"],
        _build.stream_ptr(bits_t))
    trace.count("launch.candidate_scan")
    _build.check(rc, "candidate_scan")
    return cnt, ex


def candidate_scan_ref(bits_t, tab, *, B, H, N):
    """Plain torch candidate scan: all H chains of all lanes as one (H, G)
    state, a Python loop over bit rows."""
    steps, G = bits_t.shape
    dev = bits_t.device
    tabf = tab.reshape(-1).to(torch.int64)
    offs = torch.arange(H, device=dev)[:, None]
    lim = lane_limits(N, B, G, dev)
    z = torch.zeros((H, G), dtype=torch.int64, device=dev)
    node, cnt, ex, done = z, z, z, torch.zeros((H, G), dtype=torch.bool,
                                               device=dev)
    for j in range(steps):
        e = tabf[node * 2 + bits_t[j].to(torch.int64)]
        active = (j >= offs) & ~done & (j < lim)
        emit = active & ((e & EMIT_BIT) != 0)
        node = torch.where(active, e & STATE_MASK, node)
        cnt = cnt + emit
        if j + 1 >= B:
            ex = torch.where(emit, j + 1 - B, ex)
            done = done | emit
    return cnt.to(torch.int32), ex.to(torch.int32)

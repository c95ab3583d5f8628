"""Dense lane decode of the lane-DFA chain: each lane's symbols packed.

Replaces ``huffmandecoderongpus_tpu/ops/pallas_lanedfa.py``
``lane_decode_dense_pallas_tiled`` (``_main_kernel_cum`` and
``_compact_tiled_kernel``).  CUDA source: ``csrc/lane_decode_dense.cu``.

Lane g is scanned as ``lane_scan`` scans it (from the root at row
``start[g]``, below its stream limit ``N - g*B``, to its first emission at
a row j with j + 1 >= B), and its i-th emitted symbol goes to row i of its
column.  Outputs ``dense`` (out_rows, G) uint8, rows at or past the lane's
count zero, and ``counts`` (G,) int32, the lane's emissions (not clipped to
out_rows).  The JAX function returns the same in (T, out_rows, 8, 128)
tiles and leaves the rows past a lane's count unspecified.
"""

from __future__ import annotations

import torch

from huffmandecoderongpus_tpu_torch.ops import _build
from huffmandecoderongpus_tpu_torch.ops.lanedfa import (
    EMIT_BIT,
    STATE_MASK,
    lane_limits,
)

#: kernel launches made by ``lane_decode_dense`` on CUDA tensors
launches = 0


def lane_decode_dense(bits_t, tab, start, *, B, H, N, out_rows):
    """(dense (out_rows, G) uint8, counts (G,) int32) from the bit matrix
    ``bits_t`` (B+H, G) uint8, the padded fused table ``tab`` (n_chunks,
    128) int32 and the entry offsets ``start`` (G,) int32.  CPU tensors run
    the plain version; CUDA tensors launch the kernel."""
    if bits_t.device.type == "cpu":
        return lane_decode_dense_ref(bits_t, tab, start, B=B, H=H, N=N,
                                     out_rows=out_rows)
    global launches
    _build.require_cuda("lane_decode_dense", bits_t, tab, start)
    steps, G = bits_t.shape
    if (steps != B + H or bits_t.dtype != torch.uint8
            or start.dtype != torch.int32 or start.shape != (G,)
            or out_rows < 0 or tab.numel() > _build.LANEDFA_TAB_WORDS):
        raise ValueError("lane_decode_dense: bits must be (B+H, G) uint8, "
                         "start (G,) int32 and the table at most 16 chunks")
    dense = torch.empty((out_rows, G), dtype=torch.uint8, device=bits_t.device)
    counts = torch.empty(G, dtype=torch.int32, device=bits_t.device)
    rc = _build.get_lib().ws_lane_decode_dense(
        bits_t.data_ptr(), tab.data_ptr(), start.data_ptr(),
        dense.data_ptr(), counts.data_ptr(), G, B, H, N, out_rows,
        tab.numel(), _build.stream_ptr(bits_t))
    launches += 1
    _build.check(rc, "lane_decode_dense")
    return dense, counts


def lane_decode_dense_ref(bits_t, tab, start, *, B, H, N, out_rows):
    """Plain torch dense lane decode: ``lane_scan_ref``'s loop over bit
    rows with a running count per lane, each row's emissions scattered to
    their rank."""
    steps, G = bits_t.shape
    if steps != B + H:
        raise ValueError("lane_decode_dense: bits must be (B+H, G)")
    dev = bits_t.device
    tabf = tab.reshape(-1).to(torch.int64)
    j0 = start.to(torch.int64)
    lim = lane_limits(N, B, G, dev)
    lanes = torch.arange(G, device=dev)
    node = torch.zeros(G, dtype=torch.int64, device=dev)
    cnt = torch.zeros(G, dtype=torch.int64, device=dev)
    done = torch.zeros(G, dtype=torch.bool, device=dev)
    dense = torch.zeros((out_rows, G), dtype=torch.uint8, device=dev)
    for j in range(steps):
        e = tabf[node * 2 + bits_t[j].to(torch.int64)]
        active = (j >= j0) & ~done & (j < lim)
        emit = active & ((e & EMIT_BIT) != 0)
        node = torch.where(active, e & STATE_MASK, node)
        if j + 1 >= B:
            done = done | emit
        put = emit & (cnt < out_rows)
        dense[cnt[put], lanes[put]] = (e[put] >> 16).to(torch.uint8)
        cnt = cnt + emit
    return dense, cnt.to(torch.int32)

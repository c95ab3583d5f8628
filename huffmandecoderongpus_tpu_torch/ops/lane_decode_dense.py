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

On the card (``csrc/lane_decode_dense.cu``, plan ``dense_plan``) a warp
walks 32 lanes on ``lane_scan``'s ring of staged bit tiles, stages each
emission in a window of ``WINDOW`` ranks in shared memory, and after each
tile writes out whole the rows every lane of the block has passed (zero
past a lane's count).  A lane that a tile could carry past the window
(``WINDOW`` - ``rows`` ranks ahead of those rows) writes its oldest ranks
out itself; the kernel counts such bytes where the caller asks
(``ahead``).
"""

from __future__ import annotations

import torch

from huffmandecoderongpus_tpu_torch.ops import _build
from huffmandecoderongpus_tpu_torch.ops.lanedfa import (
    EMIT_BIT,
    STATE_MASK,
    TILE_STAGES,
    lane_limits,
    tile_plan,
)
from huffmandecoderongpus_tpu_torch.utils import trace

#: ranks of a block's lanes its window stages in shared memory (a power of
#: two), and the bytes a rank takes (a lane each, 32 whatever the lanes)
WINDOW = 512
WIN_STRIDE = 32


def dense_plan(G: int, bits_ptr: int, dense_ptr: int) -> dict:
    """Launch plan of the dense decode: ``tile_plan``'s ring for one chain
    a lane (``lanes`` a block, ``rows`` a tile, at most half the window,
    copy width ``vec``) with the window of ``window`` ranks x WIN_STRIDE
    bytes beside it, one warp a block (``threads``), and the flush width
    ``flush_vec``: 4 lanes a store where a block holds 32 lanes, G is a
    multiple of 4 and ``dense_ptr`` is 4-byte aligned, else 1."""
    p = tile_plan(G, 1, bits_ptr, out_tiles=False, extra=WINDOW * WIN_STRIDE)
    rows = min(p["rows"], WINDOW // 2)
    fv = 4 if p["lanes"] == 32 and G % 4 == 0 and dense_ptr % 4 == 0 else 1
    return dict(p, rows=rows, threads=32, window=WINDOW, flush_vec=fv,
                shared=TILE_STAGES * rows * p["lanes"] + WINDOW * WIN_STRIDE)


def lane_decode_dense(bits_t, tab, start, *, B, H, N, out_rows, ahead=None):
    """(dense (out_rows, G) uint8, counts (G,) int32) from the bit matrix
    ``bits_t`` (B+H, G) uint8, the padded fused table ``tab`` (n_chunks,
    128) int32 and the entry offsets ``start`` (G,) int32.  CPU tensors run
    the plain version; CUDA tensors launch the kernel.  ``ahead``: a (1,)
    int32 CUDA tensor to which the kernel adds the symbols lanes ahead of
    their block wrote out themselves."""
    if bits_t.device.type == "cpu":
        return lane_decode_dense_ref(bits_t, tab, start, B=B, H=H, N=N,
                                     out_rows=out_rows)
    _build.require_cuda("lane_decode_dense", bits_t, tab, start,
                        *(() if ahead is None else (ahead,)))
    steps, G = bits_t.shape
    if (steps != B + H or bits_t.dtype != torch.uint8
            or start.dtype != torch.int32 or start.shape != (G,)
            or out_rows < 0 or tab.numel() > _build.LANEDFA_TAB_WORDS
            or (ahead is not None and (ahead.dtype != torch.int32
                                       or ahead.numel() != 1))):
        raise ValueError("lane_decode_dense: bits must be (B+H, G) uint8, "
                         "start (G,) int32, the table at most 16 chunks and "
                         "ahead one int32")
    dense = torch.empty((out_rows, G), dtype=torch.uint8, device=bits_t.device)
    counts = torch.empty(G, dtype=torch.int32, device=bits_t.device)
    p = dense_plan(G, bits_t.data_ptr(), dense.data_ptr())
    rc = _build.get_lib().ws_lane_decode_dense(
        bits_t.data_ptr(), tab.data_ptr(), start.data_ptr(),
        dense.data_ptr(), counts.data_ptr(),
        None if ahead is None else ahead.data_ptr(), G, B, steps, N,
        out_rows, tab.numel(), p["lanes"], p["rows"], p["vec"], p["window"],
        p["flush_vec"], p["shared"], _build.stream_ptr(bits_t))
    trace.count("launch.lane_decode_dense")
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

"""Lane scan over index-defined lanes: the `.huffidx` sidecar decode.

Replaces ``huffmandecoderongpus_tpu/ops/pallas_lanedfa.py``
``lane_scan_indexed_pallas`` / ``_indexed_kernel`` (and computes what the
XLA ``_lane_scan_indexed`` of ``ops/lanedfa.py`` computes).  CUDA source:
``csrc/lane_scan_indexed.cu``.

Lane g is one index block: it walks the fused table one bit row at a time
from the root at row 0 and is active while the row is below its exact bit
length ``lane_len[g]``.  Outputs (B, G) uint8: ``valid`` marks the active
rows that emit, and ``sym`` is the symbol field of every row's table entry.

The kernel stages the bit matrix in shared memory a tile at a time and
walks a lane's active rows two bits a lookup on a 2-bit step table it
builds at launch; its launch plan (lanes a block, rows a tile, copy width,
shared bytes with the step table's) is ``lanedfa.indexed_plan``'s,
computed here and handed to the launcher.
"""

from __future__ import annotations

import torch

from huffmandecoderongpus_tpu_torch.ops import _build
from huffmandecoderongpus_tpu_torch.ops.lanedfa import (
    EMIT_BIT,
    STATE_MASK,
    indexed_plan,
)
from huffmandecoderongpus_tpu_torch.utils import trace


def lane_scan_indexed(bits_t, tab, lane_len):
    """(sym, valid) (B, G) uint8 from the bit matrix ``bits_t`` (B, G)
    uint8, the padded fused table ``tab`` (n_chunks, 128) int32 and the
    lane lengths ``lane_len`` (G,) int32.  CPU tensors run the plain
    version; CUDA tensors launch the kernel."""
    if bits_t.device.type == "cpu":
        return lane_scan_indexed_ref(bits_t, tab, lane_len)
    _build.require_cuda("lane_scan_indexed", bits_t, tab, lane_len)
    B, G = bits_t.shape
    if (bits_t.dtype != torch.uint8 or lane_len.dtype != torch.int32
            or lane_len.shape != (G,)
            or tab.numel() > _build.LANEDFA_TAB_WORDS):
        raise ValueError("lane_scan_indexed: bits must be (B, G) uint8, "
                         "lane_len (G,) int32 and the table at most 16 "
                         "chunks")
    sym = torch.empty((B, G), dtype=torch.uint8, device=bits_t.device)
    valid = torch.empty((B, G), dtype=torch.uint8, device=bits_t.device)
    bp, sp, vp = bits_t.data_ptr(), sym.data_ptr(), valid.data_ptr()
    p = indexed_plan(G, bp | sp | vp, tab.numel())
    rc = _build.get_lib().ws_lane_scan_indexed(
        bp, tab.data_ptr(), lane_len.data_ptr(), sp, vp, G, B, tab.numel(),
        p["lanes"], p["rows"], p["vec"], p["shared"],
        _build.stream_ptr(bits_t))
    trace.count("launch.lane_scan_indexed")
    _build.check(rc, "lane_scan_indexed")
    return sym, valid


def lane_scan_indexed_ref(bits_t, tab, lane_len):
    """Plain torch scan: all lanes as one (G,) state, a Python loop over
    bit rows."""
    B, G = bits_t.shape
    dev = bits_t.device
    tabf = tab.reshape(-1).to(torch.int64)
    length = lane_len.to(torch.int64)
    node = torch.zeros(G, dtype=torch.int64, device=dev)
    sym = torch.empty((B, G), dtype=torch.uint8, device=dev)
    valid = torch.empty((B, G), dtype=torch.uint8, device=dev)
    for j in range(B):
        e = tabf[node * 2 + bits_t[j].to(torch.int64)]
        active = j < length
        node = torch.where(active, e & STATE_MASK, node)
        sym[j] = (e >> 16).to(torch.uint8)
        valid[j] = (active & ((e & EMIT_BIT) != 0)).to(torch.uint8)
    return sym, valid

"""K4: per-lane compaction of cell-packed emissions into dense bytes.

Replaces ``huffmandecoderongpus_tpu/ops/pallas_widescan.py`` ``k4_compact``
/ ``_k4_kernel`` (without its timing-only ``probes`` knob).  CUDA source:
``csrc/k4_compact.cu``, a block-wide compaction (``widescan.cuh``
``k4_block``) whose launch plan is ``k4_plan``.

Row g of ``denseT`` (G, ORP) uint8 holds lane g's valid slot bytes in slot
order: a prefix over the valid nibbles gives each byte its rank.  Ranks at
or past ORP are dropped (the caller checks the counts), and the rest of the
row is zero.
"""

from __future__ import annotations

import torch

from huffmandecoderongpus_tpu_torch.ops import _build
from huffmandecoderongpus_tpu_torch.ops.quad import CELL, u32
from huffmandecoderongpus_tpu_torch.utils import trace

#: most lanes a block owns: a warp's 32 threads read one cell row of them
MAX_LANES = 32
#: most chunks a lane's cells are cut into (the prefix is one warp scan)
MAX_CHUNKS = 32
#: fewest cells a chunk takes, and the threads a block aims at
MIN_CHUNK_CELLS = 4
TARGET_THREADS = 256
#: shared memory a block may take without opting in
SHARED_MAX = 48 * 1024


def k4_bytes(lanes: int, chunks: int, window: int) -> int:
    """Shared bytes of the block-wide body: ``lanes`` staged rows of
    ``window`` + 16 bytes, and the (chunks, lanes) int32 counts."""
    return lanes * (window + 16) + chunks * lanes * 4


def k4_plan(G: int, cells_p: int, ORP: int, sym_ptr: int = 0,
            val_ptr: int = 0, *, lanes: int = MAX_LANES,
            threads: int = TARGET_THREADS, stage_max: int | None = None,
            min_lanes: int = 1) -> dict:
    """Launch plan of the block-wide K4 over (cells_p, G) cells into
    (G, ORP) rows.  A block owns ``lanes`` neighbouring lanes (at most 32
    and G; fewer where their rows would not fit ``SHARED_MAX``), the last
    block the rest; a thread reads ``vec`` lanes of a cell row at a time
    (4, as one 4-byte val word and one 16-byte sym vector, where the lanes
    a block, G and both addresses allow it, else 1) over one of ``chunks``
    runs of consecutive cells; rows are staged ``window`` ranks at a time
    (a multiple of 16, all of ORP where it fits: a wider row takes
    ceil(ORP / window) rounds).  ``threads`` is the block (whole warps;
    ``active`` of them hold a chunk), ``shared`` its dynamic shared bytes,
    ``blocks`` the grid.  ``stage_max`` caps the staged rows' bytes (the
    one-shot kernel's budget); lanes are not cut below ``min_lanes``."""
    if G < 1 or cells_p < 0 or ORP < 128 or ORP % 128:
        raise ValueError(f"k4_plan: G={G}, cells_p={cells_p}, ORP={ORP}")
    cap = SHARED_MAX if stage_max is None else stage_max
    L = min(lanes, MAX_LANES, G)
    while L > min_lanes and L * (ORP + 16) > cap:
        L //= 2
    vec = 4 if (L % 4 == 0 and G % 4 == 0 and val_ptr % 4 == 0
                and sym_ptr % 16 == 0) else 1
    rt = L // vec
    chunks = max(1, min(MAX_CHUNKS, threads // rt,
                        -(-cells_p // MIN_CHUNK_CELLS)))
    room = min(cap, SHARED_MAX - chunks * L * 4)
    window = min(ORP, (room // L - 16) // 16 * 16)
    if window < 16:
        raise ValueError(f"k4_plan: no room for a window of {L} rows")
    active = rt * chunks
    return dict(lanes=L, vec=vec, chunks=chunks, window=window,
                active=active, threads=-(-active // 32) * 32,
                shared=k4_bytes(L, chunks, window), blocks=-(-G // L),
                windows=-(-ORP // window))


def k4_compact(sym, val, *, ORP):
    """denseT (G, ORP) uint8 from spliced ``sym`` (cells_p, G) int32 and
    ``val`` (cells_p, G) uint8.  CPU tensors run the plain version; CUDA
    tensors launch the kernel with ``k4_plan``'s plan."""
    if sym.device.type == "cpu":
        return k4_compact_ref(sym, val, ORP=ORP)
    _build.require_cuda("k4_compact", sym, val)
    cells_p, G = sym.shape
    if ORP % 128 or val.shape != sym.shape:
        raise ValueError("k4_compact: ORP must be a multiple of 128")
    p = k4_plan(G, cells_p, ORP, sym.data_ptr(), val.data_ptr())
    out = torch.empty((G, ORP), dtype=torch.uint8, device=sym.device)
    rc = _build.get_lib().ws_k4_compact(
        sym.data_ptr(), val.data_ptr(), out.data_ptr(), G, cells_p, ORP,
        p["lanes"], p["vec"], p["chunks"], p["window"], p["threads"],
        p["shared"], _build.stream_ptr(sym))
    trace.count("launch.k4_compact")
    _build.check(rc, "k4_compact")
    return out


def k4_compact_ref(sym, val, *, ORP):
    """Plain torch K4: a cumulative sum over each lane's valid slots, then
    one scatter of every valid byte to its rank."""
    cells_p, G = sym.shape
    b = torch.arange(CELL, device=sym.device)
    bytes_ = (u32(sym)[:, :, None] >> (8 * b)) & 0xFF       # (cells, G, 4)
    valid = ((val.to(torch.int64)[:, :, None] >> b) & 1) > 0
    bytes_ = bytes_.permute(1, 0, 2).reshape(G, cells_p * CELL)
    valid = valid.permute(1, 0, 2).reshape(G, cells_p * CELL)
    rank = torch.cumsum(valid.to(torch.int64), dim=1) - 1
    dst = torch.where(valid & (rank < ORP), rank, ORP)
    out = torch.zeros((G, ORP + 1), dtype=torch.uint8, device=sym.device)
    out.scatter_(1, dst, bytes_.to(torch.uint8))
    return out[:, :ORP].contiguous()

"""E2: per-lane compaction of E1's granule rows into dense rows.

Replaces ``huffmandecoderongpus_tpu/ops/pallas_encode.py`` ``e2_compact``
/ ``_e2_kernel``.  CUDA source: ``csrc/e2_compact.cu``.

Row g of ``denseT`` (G, ORP) int32 holds lane g's valid granules in row
order.  Ranks at or past ORP are dropped (the caller checks the counts),
and the rest of the row is zero; the TPU kernel leaves the words past the
largest count unwritten, so a comparison with it stops at the counts.
Unlike the TPU kernel, E2 reads E1's (2K, G) rows as they are: no
transpose and no padding to ``rows_p``.

On the card it is a block-wide compaction in K4's design
(``csrc/e2_compact.cu``, plan ``e2_plan``): a block owns a tile of up to
32 lanes and a range of their rows, counts the valid flags of each (chunk,
lane), takes a prefix over the chunks and the lanes' counts before the
block from a decoupled look-back over the tile's earlier row blocks
(``lookback``), places the valid granules at their ranks in the lanes'
spans staged in shared memory, and writes the spans out, a warp a lane.
"""

from __future__ import annotations

import torch

from huffmandecoderongpus_tpu_torch.ops import _build, lookback
from huffmandecoderongpus_tpu_torch.utils import trace

#: the look-back's state, a device and stream each
_states = lookback.States()

#: most lanes a block owns: a warp's 32 threads read one row of them
MAX_LANES = 32
#: most chunks a block's rows are cut into (the prefix is one warp scan)
MAX_CHUNKS = 32
#: the threads a block aims at, the fewest blocks an SM the grid gives
#: (where the rows allow), and the fewest rows a block and a chunk take
TARGET_THREADS = 256
BLOCKS_PER_SM = 2
MIN_BLOCK_ROWS = 32
MIN_CHUNK_ROWS = 4
#: dynamic shared memory a block may take without opting in: 48 KB less
#: room for the kernel's own static words
SHARED_MAX = 48 * 1024 - 256


def e2_bytes(lanes: int, chunks: int, window: int) -> int:
    """Shared bytes of an E2 block: ``lanes`` staged spans of ``window``
    int32 ranks, the (chunks, lanes) int32 counts, and each lane's count,
    its count before the block and its span (four int32)."""
    return 4 * (lanes * window + chunks * lanes + 4 * lanes)


def e2_plan(G: int, rows: int, ORP: int, sm_count: int = _build.SM_COUNT,
            gran_ptr: int = 0, gval_ptr: int = 0) -> dict:
    """Launch plan of E2 over (rows, G) flags into (G, ORP) rows on a card
    of ``sm_count`` SMs.  A block owns ``lanes`` neighbouring lanes (at most
    32 and G), the last tile the rest, and ``block_rows`` consecutive rows
    of them; a tile's rows take ``row_blocks`` blocks, the fewest that
    give the grid BLOCKS_PER_SM blocks an SM (at least one, and none below
    MIN_BLOCK_ROWS rows).  A thread reads ``vec`` lanes of a row at a time
    (4, as one 4-byte gval word and one 16-byte gran vector, where the
    lanes a block, G and both addresses allow it, else 1) over one of
    ``chunks`` runs of the block's rows.  A lane's span is staged
    ``window`` ranks at a time (a multiple of 4, all of ORP where it fits
    ``SHARED_MAX``).  ``threads`` is the block (whole warps; ``active`` of
    them hold a chunk), ``shared`` its dynamic bytes, ``blocks`` the
    grid."""
    if G < 1 or rows < 1 or ORP < 1:
        raise ValueError(f"e2_plan: G={G}, rows={rows}, ORP={ORP}")
    L = min(MAX_LANES, G)
    vec = 4 if (L % 4 == 0 and G % 4 == 0 and gval_ptr % 4 == 0
                and gran_ptr % 16 == 0) else 1
    rt = L // vec
    tiles = -(-G // L)
    S = max(1, min(-(-BLOCKS_PER_SM * sm_count // tiles),
                   -(-rows // MIN_BLOCK_ROWS)))
    RB = -(-rows // S)
    S = -(-rows // RB)
    chunks = max(1, min(MAX_CHUNKS, TARGET_THREADS // rt,
                        -(-RB // MIN_CHUNK_ROWS)))
    room = SHARED_MAX - e2_bytes(L, chunks, 0)
    window = min(-(-ORP // 4) * 4, room // (4 * L) // 4 * 4)
    active = rt * chunks
    return dict(lanes=L, vec=vec, chunks=chunks, block_rows=RB,
                row_blocks=S, window=window, active=active,
                threads=-(-active // 32) * 32,
                shared=e2_bytes(L, chunks, window), blocks=tiles * S,
                sm_count=sm_count)


def e2_compact(gran, gval, *, ORP):
    """denseT (G, ORP) int32 from ``gran`` (2K, G) int32 and ``gval``
    (2K, G) uint8.  CPU tensors run the plain version; CUDA tensors launch
    the kernel with ``e2_plan``'s plan."""
    if gran.device.type == "cpu":
        return e2_compact_ref(gran, gval, ORP=ORP)
    _build.require_cuda("e2_compact", gran, gval)
    rows, G = gran.shape
    if (gval.shape != gran.shape or gran.dtype != torch.int32
            or gval.dtype != torch.uint8 or ORP < 1):
        raise ValueError("e2_compact: gran (2K, G) int32, gval (2K, G) "
                         "uint8, ORP >= 1")
    dev = gran.device
    p = e2_plan(G, rows, ORP, _build.sm_count(dev), gran.data_ptr(),
                gval.data_ptr())
    stream = _build.stream_ptr(gran)
    state, cap = _states.get(dev, stream, p["blocks"])
    out = torch.empty((G, ORP), dtype=torch.int32, device=dev)
    rc = _build.get_lib().ws_e2_compact(
        gran.data_ptr(), gval.data_ptr(), out.data_ptr(), state.data_ptr(),
        cap, rows, G, ORP, p["lanes"], p["vec"], p["chunks"],
        p["block_rows"], p["row_blocks"], p["window"], p["threads"],
        p["shared"], p["blocks"], stream)
    trace.count("launch.e2_compact")
    _build.check(rc, "e2_compact")
    return out


def e2_compact_ref(gran, gval, *, ORP):
    """Plain torch E2: a cumulative sum over each lane's valid rows gives
    every granule its rank, then one scatter."""
    G = gran.shape[1]
    valid = gval.t() > 0
    rank = torch.cumsum(valid.to(torch.int64), dim=1) - 1
    dst = torch.where(valid & (rank < ORP), rank, ORP)
    out = torch.zeros((G, ORP + 1), dtype=torch.int32, device=gran.device)
    out.scatter_(1, dst, torch.where(valid, gran.t(), 0))
    return out[:, :ORP].contiguous()

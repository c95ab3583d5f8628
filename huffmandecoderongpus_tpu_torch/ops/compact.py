"""Per-column compaction of padded lane-DFA emissions to dense rows.

Replaces ``huffmandecoderongpus_tpu/ops/pallas_lanedfa.py``
``compact_pallas`` / ``_compact_kernel``.  CUDA source: ``csrc/compact.cu``.

``cum`` (steps, G) int32 is each column's inclusive emission count
(``cumsum(valid, 0)`` of a lane scan) and ``sym`` (steps, G) uint8 its
per-row symbols.  Output (out_rows, G) uint8: row i of column g holds
``sym[r, g]`` for r the row of the column's (i+1)-th emission; rows at or
past the column's count are zero (the JAX function leaves them
unspecified).  Any number of columns.

Contract: ``cum`` rises by 0 or 1 a row, as ``cumsum`` of a 0/1 ``valid``
does, so a chunk of R rows of one column emits at most R ranks.  The kernel
relies on it; ``compact_ref``'s search would also fill ranks that a larger
step skips.

On the card (plan ``compact_plan``) a block owns a tile of ``W`` columns
(an output row of the tile is one 32-byte sector) by a chunk of ``R`` rows:
it stages the chunk's emissions in shared memory at (rank - the column's
first rank in the chunk, column), writes them out row by row over the
union of its columns' rank ranges, one store a row (whole sectors where
every column holds the rank: all but the rows at the chunk's ends), and
zeroes its share of the rows past each column's count.
"""

from __future__ import annotations

import torch

from huffmandecoderongpus_tpu_torch.ops import _build
from huffmandecoderongpus_tpu_torch.utils import trace

#: columns a tile, rows a chunk and threads a block of the kernel
W, R, THREADS = 32, 1024, 256
#: stats the kernel adds where asked: blocks whose rank union is wider than
#: 2R, the rows those unions span, those blocks' cycles, all blocks' cycles
STATS = ("wide_blocks", "wide_rows", "wide_cycles", "cycles")


def compact_bytes(W: int, R: int) -> int:
    """Shared bytes of a block: the staged R x W ranks, then each column's
    base, end and count (int32)."""
    return R * W + 3 * W * 4


def compact_plan(steps: int, G: int, out_rows: int, cum_ptr: int = 0,
                 sym_ptr: int = 0, out_ptr: int = 0) -> dict:
    """Launch plan of the compaction over (steps, G) into (out_rows, G):
    tiles of ``W`` columns by chunks of ``R`` rows, a block each
    (``blocks`` = ``tiles`` x ``chunks``, at least one chunk); ``vec``
    columns a thread (4, as one 16-byte cum load, one 4-byte sym load and
    4-byte stores, where G and the three addresses allow, else 1);
    ``threads`` a block, ``shared`` its dynamic bytes, ``zrows`` the
    output rows whose zero fill each chunk owns."""
    if steps < 0 or G < 0 or out_rows < 0:
        raise ValueError(f"compact_plan: steps={steps}, G={G}, "
                         f"out_rows={out_rows}")
    vec = 4 if (G % 4 == 0 and cum_ptr % 16 == 0 and sym_ptr % 4 == 0
                and out_ptr % 4 == 0) else 1
    tiles, chunks = -(-G // W), max(1, -(-steps // R))
    return dict(W=W, R=R, vec=vec, threads=THREADS,
                shared=compact_bytes(W, R), tiles=tiles, chunks=chunks,
                blocks=tiles * chunks, zrows=-(-out_rows // chunks))


def compact_plan_ok(p: dict, steps: int, G: int, out_rows: int,
                    cum_ptr: int, sym_ptr: int, out_ptr: int) -> bool:
    """The launcher's check (``csrc/compact.cu`` ``ws_compact``) mirrored:
    ``compact_plan``'s plan for these shapes, with 4 columns a thread only
    where G and the addresses allow them (1 always)."""
    if steps < 0 or G < 0 or out_rows < 0:
        return False
    q = compact_plan(steps, G, out_rows)
    if p["vec"] == 4 and (G % 4 or cum_ptr % 16 or sym_ptr % 4
                          or out_ptr % 4):
        return False
    return p["vec"] in (1, 4) and all(
        p[k] == q[k] for k in ("W", "R", "threads", "shared", "tiles",
                               "chunks", "zrows"))


def compact(cum, sym, *, out_rows, stats=None):
    """Dense (out_rows, G) uint8 from ``cum`` (steps, G) int32 and ``sym``
    (steps, G) uint8.  CPU tensors run the plain version; CUDA tensors
    launch the kernel with ``compact_plan``'s plan.  ``stats``: a (4,)
    int64 CUDA tensor to which the kernel adds ``STATS``."""
    if cum.device.type == "cpu":
        return compact_ref(cum, sym, out_rows=out_rows)
    _build.require_cuda("compact", cum, sym,
                        *(() if stats is None else (stats,)))
    steps, G = cum.shape
    if (cum.dtype != torch.int32 or sym.dtype != torch.uint8
            or sym.shape != cum.shape or out_rows < 0
            or (stats is not None and (stats.dtype != torch.int64
                                       or stats.numel() != len(STATS)))):
        raise ValueError("compact: cum must be (steps, G) int32, sym "
                         "(steps, G) uint8 and stats four int64")
    out = torch.empty((out_rows, G), dtype=torch.uint8, device=cum.device)
    p = compact_plan(steps, G, out_rows, cum.data_ptr(), sym.data_ptr(),
                     out.data_ptr())
    rc = _build.get_lib().ws_compact(
        cum.data_ptr(), sym.data_ptr(), out.data_ptr(),
        None if stats is None else stats.data_ptr(), steps, G, out_rows,
        p["W"], p["R"], p["vec"], p["threads"], p["shared"], p["tiles"],
        p["chunks"], p["zrows"], _build.stream_ptr(cum))
    trace.count("launch.compact")
    _build.check(rc, "compact")
    return out


def compact_ref(cum, sym, *, out_rows):
    """Plain torch compaction: the JAX kernel's binary search as
    ``torch.searchsorted`` over each column's count, then a gather, with
    the rows past the column's count zeroed."""
    steps, G = cum.shape
    cum_t = cum.t().contiguous()
    want = torch.arange(1, out_rows + 1, dtype=cum.dtype,
                        device=cum.device).expand(G, out_rows).contiguous()
    row = torch.searchsorted(cum_t, want).clamp_(max=steps - 1)
    out = sym.t().gather(1, row)
    out[want > cum_t[:, -1:]] = 0
    return out.t().contiguous()

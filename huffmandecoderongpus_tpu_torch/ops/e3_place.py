"""E3: every lane's dense granules, shifted to its phase, into the payload.

Replaces ``huffmandecoderongpus_tpu/ops/pallas_encode.py`` ``e3_place`` /
``_e3_kernel``, with the lane offsets and ``shift_lanes`` before it folded
in.  CUDA source: ``csrc/e3_place.cu``.

From E2's dense rows ``denseT`` (G, ORP) and E1's per-lane granule counts
``cnt`` and bit counts ``bits`` (G,): lane g's exclusive bit offset P
gives its phase a = P & 15 and granule offset W = P >> 4; its granules,
masked to its count and shifted to its phase (``encode.shift_lanes``),
land at payload granules W, W + 1, ... up to its occupancy (``occupancy``)
and ORP.  A granule two or more lanes share holds disjoint bit ranges, so
OR (here: ADD) is exact in any order.  The output (NROWS, 128) int32
holds the payload's u16 granules, row-major, as the TPU kernel's does.
Unlike the TPU package, which places payloads over 8 MiB on the host
(``place_lanes``), the port runs E3 at every size.

On the card one launch does it all (``csrc/e3_place.cu``, plan
``e3_plan``): a block owns a tile of lanes, sums the bits before it,
scans its lanes' offsets, and a warp a lane writes each payload granule
the lane owns once: the granules whose first bit is the lane's, each with
the lanes that start inside it added.
"""

from __future__ import annotations

import torch

from huffmandecoderongpus_tpu_torch.ops import _build
from huffmandecoderongpus_tpu_torch.utils import trace

#: threads a block, and most lanes a tile (a thread each in the scan)
THREADS = 256
MAX_LANES = 256
#: the fewest lanes a tile, and the most tiles, so that the bits a block
#: sums before its tile stay at most G int32 and all blocks at most
#: MAX_TILES * G
MIN_LANES = 16
MAX_TILES = 512
#: lanes after a tile whose offsets a block stages (followers in its last
#: granule), and the chunks of 32 granules a warp has in flight
EXTRA = 32
UNROLL = 4


def occupancy(shift, lane_bits):
    """Granules lane g's L code bits at phase a occupy:
    ``((a + L - 1) >> 4) + 1``, or 0 for an empty lane (int32)."""
    L = lane_bits.to(torch.int64)
    occ = ((shift.to(torch.int64) + L - 1) >> 4) + 1
    return torch.where(L > 0, occ, 0).to(torch.int32)


def e3_plan(G: int) -> dict:
    """Launch plan of E3 over G lanes: tiles of ``lanes`` neighbouring
    lanes (MIN_LANES, or more where G would give more than MAX_TILES
    tiles), a block of ``threads`` each, ``blocks`` in all; ``staged``
    lanes' offsets in shared memory (the tile and EXTRA after it), and
    ``shared`` its static bytes (offsets int64 with one past the last,
    counts and first granules int32, eight warps' partial sums)."""
    if G < 1:
        raise ValueError(f"e3_plan: G={G}")
    lanes = max(MIN_LANES, -(-G // MAX_TILES))
    if lanes > MAX_LANES:
        raise ValueError(f"e3_plan: G={G} needs more than {MAX_LANES} "
                         "lanes a tile")
    staged = MAX_LANES + EXTRA
    return dict(lanes=lanes, threads=THREADS, blocks=-(-G // lanes),
                staged=staged, unroll=UNROLL,
                shared=8 * (staged + 1) + 8 * staged + 8 * (THREADS // 32))


def e3_place(denseT, cnt, bits, *, NROWS):
    """(NROWS, 128) int32 payload granules from ``denseT`` (G, ORP) int32,
    ``cnt`` (G,) int32 and ``bits`` (G,) int32.  CPU tensors run the plain
    version; CUDA tensors launch the kernel."""
    if denseT.device.type == "cpu":
        return e3_place_ref(denseT, cnt, bits, NROWS=NROWS)
    G, ORP = denseT.shape
    _build.require_cuda("e3_place", denseT, cnt, bits)
    if (cnt.shape != (G,) or bits.shape != (G,) or NROWS < 1
            or {t.dtype for t in (denseT, cnt, bits)} != {torch.int32}):
        raise ValueError("e3_place: denseT (G, ORP), cnt and bits (G,), all "
                         "int32, NROWS >= 1")
    p = e3_plan(G)
    out = torch.empty((NROWS, 128), dtype=torch.int32, device=denseT.device)
    rc = _build.get_lib().ws_e3_place(
        denseT.data_ptr(), cnt.data_ptr(), bits.data_ptr(), out.data_ptr(),
        G, ORP, NROWS * 128, p["lanes"], p["threads"], p["blocks"],
        _build.stream_ptr(denseT))
    trace.count("launch.e3_place")
    _build.check(rc, "e3_place")
    return out


def e3_place_ref(denseT, cnt, bits, *, NROWS):
    """Plain torch E3: ``encode.lane_offsets``, ``encode.shift_lanes``,
    then ``place_ref``."""
    # ops.encode imports this module
    from huffmandecoderongpus_tpu_torch.ops.encode import (
        lane_offsets,
        shift_lanes,
    )

    shift, word_off, occ = lane_offsets(bits)
    return place_ref(shift_lanes(denseT, cnt, shift), word_off, occ,
                     NROWS=NROWS)


def place_ref(shifted, word_off, occ, *, NROWS):
    """The TPU kernel's placement of phase-shifted rows ``shifted`` (G, ORP)
    at ``word_off`` (G,) up to ``occ`` (G,) granules: one index_add of every
    occupied granule at its payload index (ADD equals OR on disjoint bit
    ranges)."""
    G, ORP = shifted.shape
    n = NROWS * 128
    i = torch.arange(ORP, device=shifted.device)
    idx = word_off.to(torch.int64)[:, None] + i
    keep = (i < occ[:, None]) & (idx < n)
    out = torch.zeros(n + 1, dtype=torch.int64, device=shifted.device)
    out.index_add_(0, torch.where(keep, idx, n).reshape(-1),
                   torch.where(keep, shifted, 0).to(torch.int64).reshape(-1))
    return out[:n].to(torch.int32).reshape(NROWS, 128)

"""E1: each lane packs its symbols' codes into 16-bit granules.

Replaces ``huffmandecoderongpus_tpu/ops/pallas_encode.py`` ``e1_pack`` /
``_e1_kernel``.  CUDA source: ``csrc/e1_pack.cu``.

Lane g's symbols are column g of ``data3`` (K, G) uint8; rows at or past
``nval[g]`` pack zero bits.  Each symbol appends its two half-codes (the
``lo``/``hi`` tables of ``encode.build_pack_tables``) to a granule
accumulator, and after each half, sub-step row ``2k + half`` records
``acc & 0xFFFF`` in ``gran`` and whether a granule completed in ``gval``.
The last row takes the residual granule.  ``cnt`` is each lane's granule
count, ``bits`` its code bits.

On the card a sub-step depends on the ones before it only through the
lane's bits so far, so a block owns a tile of 32 lanes and a range of
symbol rows (``e1_plan``), staged in shared memory and cut into chunks, a
warp each: a scan over the chunks' code lengths, and the lanes' bits before
the block from a decoupled look-back over the tile's earlier row blocks
(``lookback``), give each chunk's first bit; its first granule is rebuilt
from the codes before it, and its sub-steps run in registers
(``csrc/e1_pack.cu``).
"""

from __future__ import annotations

import torch

from huffmandecoderongpus_tpu_torch.ops import _build, lookback
from huffmandecoderongpus_tpu_torch.utils import trace

GRAN = 16
HALF = 13

#: the look-back's state, a device and stream each
_states = lookback.States()

#: lanes a block owns: one a thread of each warp, so that a warp's row store
#: is 128 bytes of gran and 32 of gval
LANES = 32
#: chunks of a block's rows, a warp each (the block is LANES x CHUNKS)
CHUNKS = 8
#: the grid aims at this many blocks an SM (blocks of 256 threads): a
#: tile's rows in as few blocks as fill the card
BLOCKS_PER_SM = 2
#: fewest symbol rows a chunk takes, and most a block stages (32 bytes a
#: row of shared memory)
MIN_CHUNK_ROWS = 2
MAX_ROWS = 1024


def e1_plan(G: int, K: int, sm_count: int = _build.SM_COUNT,
            data_ptr: int = 0) -> dict:
    """Launch plan of E1 over G lanes of K symbol rows on a card of
    ``sm_count`` SMs.  A block owns a tile of ``lanes`` (32) lanes and
    ``rows`` consecutive symbol rows of them (at most MAX_ROWS, staged in
    ``shared`` bytes), cut into ``chunks`` runs of ``chunk_rows`` rows, one
    warp a run; a tile's rows take ``row_blocks`` blocks, as many as keep
    the grid within BLOCKS_PER_SM blocks an SM (at least one, and none
    below MIN_CHUNK_ROWS rows a chunk).  The block reads symbol rows
    ``vec`` lanes a load (16 or 4 where G and the symbols' address are
    multiples of it, else 1).  ``blocks`` is the grid, ``threads`` the
    block.  Raises ValueError for G or K below 1."""
    if G < 1 or K < 1:
        raise ValueError(f"e1_plan: G={G}, K={K}")
    tiles = -(-G // LANES)
    S = max(1, min(BLOCKS_PER_SM * sm_count // tiles,
                   -(-K // (CHUNKS * MIN_CHUNK_ROWS))), -(-K // MAX_ROWS))
    RB = -(-(-(-K // S)) // CHUNKS) * CHUNKS
    S = -(-K // RB)
    vec = next(v for v in (16, 4, 1) if G % v == 0 and data_ptr % v == 0)
    return dict(lanes=LANES, vec=vec, chunks=CHUNKS, rows=RB,
                chunk_rows=RB // CHUNKS, row_blocks=S,
                threads=LANES * CHUNKS, shared=RB * LANES,
                blocks=tiles * S, sm_count=sm_count)


def e1_pack(data3, lo, hi, nval):
    """(gran (2K, G) int32 of u16 values, gval (2K, G) uint8, cnt (G,)
    int32, bits (G,) int32) from ``data3`` (K, G) uint8, the 256-entry
    int32 tables ``lo``/``hi`` and ``nval`` (G,) int32.  CPU tensors run
    the plain version; CUDA tensors launch the kernel with ``e1_plan``'s
    plan."""
    if data3.device.type == "cpu":
        return e1_pack_ref(data3, lo, hi, nval)
    _build.require_cuda("e1_pack", data3, lo, hi, nval)
    K, G = data3.shape
    if (data3.dtype != torch.uint8 or lo.shape != (256,) or hi.shape != (256,)
            or nval.shape != (G,)
            or {lo.dtype, hi.dtype, nval.dtype} != {torch.int32}):
        raise ValueError("e1_pack: data3 (K, G) uint8, int32 tables (256,) "
                         "and nval (G,)")
    dev = data3.device
    p = e1_plan(G, K, _build.sm_count(dev), data3.data_ptr())
    stream = _build.stream_ptr(data3)
    state, cap = _states.get(dev, stream, p["blocks"])
    gran = torch.empty((2 * K, G), dtype=torch.int32, device=dev)
    gval = torch.empty((2 * K, G), dtype=torch.uint8, device=dev)
    cnt = torch.empty(G, dtype=torch.int32, device=dev)
    bits = torch.empty(G, dtype=torch.int32, device=dev)
    rc = _build.get_lib().ws_e1_pack(
        data3.data_ptr(), lo.data_ptr(), hi.data_ptr(), nval.data_ptr(),
        gran.data_ptr(), gval.data_ptr(), cnt.data_ptr(), bits.data_ptr(),
        state.data_ptr(), cap, K, G, p["lanes"], p["vec"], p["chunks"],
        p["rows"], p["row_blocks"], p["threads"], p["shared"], p["blocks"],
        stream)
    trace.count("launch.e1_pack")
    _build.check(rc, "e1_pack")
    return gran, gval, cnt, bits


def e1_pack_ref(data3, lo, hi, nval):
    """Plain torch E1: the accumulator of every lane at once, one symbol
    row after another."""
    K, G = data3.shape
    dev = data3.device
    gran = torch.empty((2 * K, G), dtype=torch.int32, device=dev)
    gval = torch.empty((2 * K, G), dtype=torch.uint8, device=dev)
    acc = torch.zeros(G, dtype=torch.int64, device=dev)
    nb = torch.zeros_like(acc)
    cnt = torch.zeros_like(acc)
    bits = torch.zeros_like(acc)
    lo, hi, nval = lo.to(torch.int64), hi.to(torch.int64), nval.to(torch.int64)
    for k in range(K):
        sym = data3[k].to(torch.int64)
        valid = k < nval
        for half, tab in ((0, lo), (1, hi)):
            ent = torch.where(valid, tab[sym], 0)
            acc = acc | ((ent & ((1 << HALF) - 1)) << nb)
            nb = nb + (ent >> HALF)
            bits = bits + (ent >> HALF)
            emit = nb >= GRAN
            gran[2 * k + half] = (acc & 0xFFFF).to(torch.int32)
            gval[2 * k + half] = emit.to(torch.uint8)
            acc = torch.where(emit, acc >> GRAN, acc)
            nb = torch.where(emit, nb - GRAN, nb)
            cnt = cnt + emit.to(torch.int64)
    gran[2 * K - 1] = (acc & 0xFFFF).to(torch.int32)
    gval[2 * K - 1] = (nb > 0).to(torch.uint8)
    cnt = cnt + (nb > 0).to(torch.int64)
    return gran, gval, cnt.to(torch.int32), bits.to(torch.int32)

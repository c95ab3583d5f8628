"""The launch plan of the block-wide K4 (``ops.k4_compact.k4_plan``).

K4 runs a block over up to 32 neighbouring lanes: its threads count the
valid nibbles of their chunk of each lane's cells, take a prefix over the
chunks, place every valid byte at its rank in the lane's row staged in
shared memory, a window of ranks at a time, and write the rows out.  The
plan is computed in Python and handed to the kernel, whose launcher refuses
any other.  Here, on the CPU, the plan must stage every (lane, rank) of
the output exactly once and read every (lane, cell) exactly once, fit a
block's threads and its shared memory without opting in, and read 4 lanes
at a time only where G, the lanes a block and both addresses allow it.
``emulate`` replays the kernel's steps on the plan in numpy and must give
the plain version's bytes, ranks past ORP dropped and rows zero-filled.
"""

import numpy as np
import pytest
import torch

from huffmandecoderongpus_tpu_torch.ops import widescan
from huffmandecoderongpus_tpu_torch.ops.k4_compact import (
    MAX_CHUNKS,
    SHARED_MAX,
    k4_bytes,
    k4_compact,
    k4_compact_ref,
    k4_plan,
)

GS = (1, 3, 100, 1024, 8192, 16384)
#: the largest ORP the wide plan gives: a 4 Gbit stream at 2 bits a symbol
ORP_MAX = widescan._plan(1 << 32, 9, 2, avg_len=2.0)["ORP"]
ORPS = (128, 256, 640, 768, 1024, ORP_MAX)


def _cells(ORP):
    """Cells a lane: enough for ranks past ORP when every slot is valid."""
    return ORP // 4 + 9


def _layout(G, cells_p, ORP, p):
    """Per (lane, rank): how often a window stages it; per (lane, cell):
    how often a chunk reads it.  Walks blocks, chunks and windows as
    ``widescan.cuh`` ``k4_block`` does."""
    L, vec, nch, W = p["lanes"], p["vec"], p["chunks"], p["window"]
    rt = L // vec
    per = -(-cells_p // nch)
    ranks = np.zeros(ORP, dtype=np.int64)  # the same for every lane
    w0 = 0
    while w0 < ORP:
        ww = min(W, ORP - w0)
        assert ww % 16 == 0 and w0 % 16 == 0  # 16-byte stores
        ranks[w0:w0 + ww] += 1
        w0 += W
    lanes = np.zeros(G, dtype=np.int64)
    cells = np.zeros(cells_p, dtype=np.int64)
    for b in range(p["blocks"]):
        g0 = b * L
        w = min(L, G - g0)
        assert w > 0 and w % vec == 0
        for t in range(p["active"]):
            ch, l0 = t // rt, (t % rt) * vec
            if l0 < w:
                lanes[g0 + l0:g0 + l0 + vec] += 1 if ch == 0 else 0
            if b == 0 and t % rt == 0:
                c0 = min(ch * per, cells_p)
                cells[c0:min(c0 + per, cells_p)] += 1
    return lanes, ranks, cells


@pytest.mark.parametrize("ORP", ORPS)
@pytest.mark.parametrize("G", GS)
def test_plan_stages_every_rank_once(G, ORP):
    cells_p = _cells(ORP)
    p = k4_plan(G, cells_p, ORP)
    lanes, ranks, cells = _layout(G, cells_p, ORP, p)
    assert set(lanes) == {1}  # every lane in one block, once
    assert set(ranks) == {1}  # every rank of a row in one window, once
    assert set(cells) == {1}  # every cell of a lane in one chunk, once
    assert p["windows"] == -(-ORP // p["window"])
    assert p["blocks"] * p["lanes"] >= G > (p["blocks"] - 1) * p["lanes"]


@pytest.mark.parametrize("ORP", ORPS)
@pytest.mark.parametrize("G", GS)
def test_plan_fits_a_block(G, ORP):
    p = k4_plan(G, _cells(ORP), ORP)
    assert 1 <= p["lanes"] <= min(32, G)
    assert 1 <= p["chunks"] <= MAX_CHUNKS  # the prefix is one warp scan
    assert p["active"] == p["lanes"] // p["vec"] * p["chunks"]
    assert p["threads"] % 32 == 0 and p["active"] <= p["threads"] <= 1024
    assert p["shared"] == k4_bytes(p["lanes"], p["chunks"], p["window"])
    assert p["shared"] <= SHARED_MAX  # no opt-in
    assert p["window"] % 16 == 0 and 16 <= p["window"] <= ORP
    # the rows fit whole where 32 lanes of them fit the staging
    if 32 * (ORP + 16) + 32 * 32 * 4 <= SHARED_MAX and G >= 32:
        assert p["windows"] == 1 and p["lanes"] == 32


@pytest.mark.parametrize("G,sym_ptr,val_ptr,vec", [
    (1024, 0, 0, 4), (16384, 256, 64, 4), (100, 0, 0, 4), (8192, 4, 0, 1),
    (8192, 0, 1, 1), (8192, 16, 2, 1), (3, 0, 0, 1), (1, 0, 0, 1),
    (36, 0, 0, 4), (30, 0, 0, 1), (20, 0, 0, 4)])
def test_plan_vector_width(G, sym_ptr, val_ptr, vec):
    # 4 lanes a load (a 4-byte val word, a 16-byte sym vector) only where G
    # and the lanes a block are multiples of 4 and both addresses aligned
    p = k4_plan(G, 100, 256, sym_ptr, val_ptr)
    assert p["vec"] == vec
    if vec == 4:
        assert G % 4 == 0 and p["lanes"] % 4 == 0
        assert sym_ptr % 16 == 0 and val_ptr % 4 == 0


def test_plan_refuses_what_the_kernel_cannot_take():
    for args in ((0, 10, 128), (8, 10, 100), (8, 10, 64), (8, -1, 128)):
        with pytest.raises(ValueError):
            k4_plan(*args)


def emulate(sym, val, ORP, p):
    """The kernel's steps on plan ``p`` (numpy): chunk counts, the prefix
    over chunks, placement a window at a time, rows zero past the placed
    bytes."""
    cells_p, G = sym.shape
    L, nch, W = p["lanes"], p["chunks"], p["window"]
    per = -(-cells_p // nch)
    nib = (val[:, :, None].astype(np.int64) >> np.arange(4)) & 1
    byt = (sym.view(np.uint32)[:, :, None] >> (8 * np.arange(4))) & 0xFF
    out = np.full((G, ORP), 0xAA, dtype=np.uint8)  # torch.empty's garbage
    for b in range(p["blocks"]):
        g0 = b * L
        w = min(L, G - g0)
        counts = np.zeros((nch, w), dtype=np.int64)
        for ch in range(nch):
            c0 = min(ch * per, cells_p)
            counts[ch] = nib[c0:c0 + per, g0:g0 + w].sum(axis=(0, 2))
        base = np.cumsum(counts, axis=0) - counts  # exclusive prefix
        for w0 in range(0, ORP, W):
            ww = min(W, ORP - w0)
            stage = np.zeros((w, W + 16), dtype=np.uint8)
            for ch in range(nch):
                c0 = min(ch * per, cells_p)
                for lane in range(w):
                    r = base[ch, lane]
                    for c in range(c0, min(c0 + per, cells_p)):
                        for k in range(4):
                            if nib[c, g0 + lane, k]:
                                if w0 <= r < min(ORP, w0 + ww):
                                    stage[lane, r - w0] = byt[c, g0 + lane, k]
                                r += 1
            out[g0:g0 + w, w0:w0 + ww] = stage[:, :ww]
    return out


@pytest.mark.parametrize("G,cells_p,ORP,fill,stage_max", [
    (1, 40, 128, "random", None), (3, 70, 256, "full", None),
    (100, 12, 128, "random", None), (40, 50, 256, "empty", None),
    (8, 300, 1024, "full", 1000), (2, 200, 768, "random", 600)])
def test_emulated_kernel_matches_plain(G, cells_p, ORP, fill, stage_max):
    # the plan's chunks, prefix and windows give the plain K4's rows: lanes
    # of one lane and of three, a tail block, no valid slot, lanes past
    # ORP, and rows in several windows (a small staging area)
    rng = np.random.default_rng(G * 7 + cells_p)
    sym = rng.integers(-2**31, 2**31, (cells_p, G)).astype(np.int32)
    val = {"random": rng.integers(0, 16, (cells_p, G)),
           "full": np.full((cells_p, G), 15),
           "empty": np.zeros((cells_p, G))}[fill].astype(np.uint8)
    p = k4_plan(G, cells_p, ORP, stage_max=stage_max)
    if stage_max:
        assert p["windows"] > 1
    want = k4_compact_ref(torch.from_numpy(sym), torch.from_numpy(val),
                          ORP=ORP)
    np.testing.assert_array_equal(emulate(sym, val, ORP, p), want.numpy())
    # on the CPU the wrapper runs the plain version
    assert torch.equal(k4_compact(torch.from_numpy(sym),
                                  torch.from_numpy(val), ORP=ORP), want)

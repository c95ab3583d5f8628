"""The launch plan of the lane-DFA scans' bit tiles (``ops.lanedfa.tile_plan``).

``candidate_scan`` and ``lane_scan`` stage the (rows, G) bit matrix in
shared memory a tile of R rows x L lanes at a time; the plan is computed in
Python and handed to the kernels, which take it as given (their launchers
refuse a plan outside these rules).  Here, on the CPU, the plan must cover
every lane and row exactly once with copies that keep their addresses
aligned, stay within a block's threads and its shared memory without
opting in, and fall back from 16-byte copies where the address, or G and
the lanes a block, do not allow them (where one block holds every lane,
its rows are one run of bytes whatever G is).
"""

import pytest

from huffmandecoderongpus_tpu_torch.ops.lanedfa import (
    MAX_THREADS,
    SHARED_DEFAULT,
    TABLE_BYTES,
    TILE_STAGES,
    tile_plan,
)

GS = (1, 3, 64, 4096, 16384)
HS = (1, 9, 31, 64, 200)
#: bit rows B+H of a plan's matrix: B rounds up to a multiple of 512
ROWS = (1, 15, 512 + 9, 3 * 512 + 200, 6656 + 9)


def _staged(G, rows, p):
    """(lanes, rows) each staged how many times, walking the blocks and
    tiles as ``widescan.cuh`` ``stage_bit_tile`` does: row by row in
    ``vec``-byte chunks, or, where one block holds every lane, each tile's
    rows as one run of bytes (``vec``-byte chunks from an aligned start,
    the rest byte by byte)."""
    L, R, vec = p["lanes"], p["rows"], p["vec"]
    lanes, rows_seen = [0] * G, [0] * rows
    for b in range(p["blocks"]):
        g0 = b * L
        w = min(L, G - g0)
        assert w > 0 and (L == G or (w % vec == 0 and g0 % vec == 0))
        for g in range(g0, g0 + w):
            lanes[g] += 1
        if b == 0:
            for t in range(-(-rows // R)):
                nr = min(R, rows - t * R)
                assert (t * R * G) % vec == 0  # the run starts aligned
                for j in range(t * R, t * R + nr):
                    rows_seen[j] += 1
    return lanes, rows_seen


@pytest.mark.parametrize("H", HS)
@pytest.mark.parametrize("G", GS)
def test_plan_covers_every_lane_and_row(G, H):
    for chains, out_tiles in ((H, False), (1, True)):
        p = tile_plan(G, chains, 0, out_tiles=out_tiles)
        for rows in ROWS:
            lanes, rows_seen = _staged(G, rows, p)
            assert set(lanes) == {1} and set(rows_seen) == {1}
        assert p["blocks"] * p["lanes"] >= G > (p["blocks"] - 1) * p["lanes"]
        assert p["stages"] == TILE_STAGES
        # eight rows are read ahead at a time and copies stay aligned
        assert p["rows"] % 16 == 0
        assert p["lanes"] == G or p["lanes"] % p["vec"] == 0


@pytest.mark.parametrize("H", HS)
@pytest.mark.parametrize("G", GS)
def test_plan_fits_a_block(G, H):
    cand = tile_plan(G, H, 0, out_tiles=False)
    lane = tile_plan(G, 1, 0, out_tiles=True)
    assert cand["threads"] == cand["lanes"] * H <= MAX_THREADS
    assert lane["threads"] == 32 and lane["lanes"] <= 32
    for p, tiles in ((cand, TILE_STAGES), (lane, TILE_STAGES + 4)):
        assert p["shared"] == tiles * p["rows"] * p["lanes"]
        assert p["shared"] + TABLE_BYTES <= SHARED_DEFAULT
    # a warp's 32 threads are 32 neighbouring lanes of one chain where G
    # and the tree allow it
    if G >= 32 and H <= 32:
        assert cand["lanes"] == 32


@pytest.mark.parametrize("G,ptr,vec", [
    (4096, 0, 16), (16384, 256, 16), (64, 4, 4), (64, 1, 1), (100, 0, 4),
    (100, 2, 1), (48, 0, 16), (36, 0, 4), (4096, 8, 4), (4096, 2, 1),
    # one block holds every lane: its rows are one run of bytes
    (20, 0, 16), (3, 0, 16), (1, 0, 16), (1, 4, 4), (3, 1, 1), (8, 2, 1)])
def test_plan_copy_width(G, ptr, vec):
    # 16-byte cp.async copies only where the address is a multiple of 16
    # and so are G and the lanes a block, or one block holds every lane;
    # then 4 bytes; else byte by byte
    for chains, out_tiles in ((9, False), (1, True)):
        assert tile_plan(G, chains, ptr, out_tiles=out_tiles)["vec"] == vec


def test_tall_trees_shrink_the_lanes():
    # L*H would pass 1,024 threads at 32 lanes: L halves, never refused
    assert [tile_plan(4096, H, 0, out_tiles=False)["lanes"]
            for H in (32, 33, 64, 65, 200, 1023, 1024)] == [
                32, 16, 16, 8, 4, 1, 1]
    assert tile_plan(4096, 200, 0, out_tiles=False)["vec"] == 4
    with pytest.raises(ValueError):
        tile_plan(4096, 1025, 0, out_tiles=False)
    with pytest.raises(ValueError):
        tile_plan(0, 9, 0, out_tiles=False)

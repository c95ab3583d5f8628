"""The launch plan of the dense lane decode and its window-and-flush rule,
on the CPU.

``csrc/lane_decode_dense.cu`` walks a block's 32 lanes (one warp) as
``lane_scan`` does, on its ring of staged bit tiles, and puts each
emission of rank n in a window of ``WINDOW`` ranks in shared memory at
(n mod WINDOW, lane); in runs of eight rows away from a lane's ends, each
row's symbol field goes to the lane's next slot, which moves on where the
row emits.  After each tile it writes out whole the rows every
lane of the block has passed (the least count of the lanes that can still
emit): the staged symbol below a lane's count, zero from it on.  A lane
``WINDOW`` ranks ahead of the flushed rows stores that symbol and every
later one straight to ``dense``, and the flushes skip them.  Its plan is
computed in Python (``ops.lane_decode_dense.dense_plan``) and handed to the
kernel, whose launcher refuses any other.

Here, without a card: the plan at the lane counts the kernel takes (128
blocks at G = 4,096, one warp a block, shared memory under 48 KB with the
staged table, the flush width), the launcher's check mirrored, and a numpy
emulation of the kernel's window and flushes, block by block and tile by
tile, on the lane scan's emissions, against the plain
``lane_decode_dense_ref`` at ``probes.streams.DENSE_CASES`` (which the
card tests and ``chip_smoke.py`` run on the card) and on a test stream's
tiled geometry: every output byte written once, every window slot free
when it is reused, and the lanes' own write-outs counted (the count the
kernel's ``ahead`` gives on the card).  Tolerance: bit-exact (integer
outputs).
"""

import numpy as np
import pytest
import torch

from huffmandecoderongpus_tpu_torch.ops import lane_decode_dense as ldd
from huffmandecoderongpus_tpu_torch.ops import lanedfa, lanedfa_decode
from huffmandecoderongpus_tpu_torch.ops.candidate_scan import candidate_scan
from huffmandecoderongpus_tpu_torch.ops.lane_scan import lane_scan_ref
from huffmandecoderongpus_tpu_torch.ops.lanedfa import (
    BIT_SHARED_MAX,
    TABLE_BYTES,
    TILE_STAGES,
)
from huffmandecoderongpus_tpu_torch.probes import streams as ps
from torch_streams import make


def dense_plan_ok(bits_ptr, dense_ptr, G, L, R, vec, W, fv, shared):
    """``csrc/lane_decode_dense.cu``'s launcher check (with
    ``widescan.cuh`` ``bit_plan_ok`` at 32 threads), mirrored."""
    return (G >= 1 and 1 <= L <= 32 and R >= 16 and R % 16 == 0
            and vec in (1, 4, 16) and (L == G or (L % vec == 0
                                                   and G % vec == 0))
            and bits_ptr % vec == 0 and 32 >= L
            and TILE_STAGES * R * L <= shared <= BIT_SHARED_MAX
            and W >= 16 and W & (W - 1) == 0
            and 2 * R <= W
            and shared >= TILE_STAGES * R * L + W * ldd.WIN_STRIDE
            and (fv == 1 or (fv == 4 and L == 32 and G % 4 == 0
                             and dense_ptr % 4 == 0)))


@pytest.mark.parametrize("G", [1, 3, 20, 31, 32, 33, 100, 1024, 4096, 4097,
                               16384])
@pytest.mark.parametrize("ptrs", [(0, 0), (1, 0), (4, 2), (16, 4), (16, 8)])
def test_dense_plan_rules(G, ptrs):
    p = ldd.dense_plan(G, *ptrs)
    assert dense_plan_ok(*ptrs, G, p["lanes"], p["rows"], p["vec"],
                         p["window"], p["flush_vec"], p["shared"])
    assert p["threads"] == 32 and p["lanes"] == min(32, G)
    assert p["blocks"] == -(-G // p["lanes"])
    if G >= 4096:  # (d)'s lanes fill 128 blocks, where 128 threads gave 32
        assert p["blocks"] >= 128
    # dynamic bytes, the staged table and the kernel's two count arrays
    assert p["shared"] + TABLE_BYTES + 2 * 32 * 4 < 48 * 1024
    want_fv = 4 if (p["lanes"] == 32 and G % 4 == 0
                    and ptrs[1] % 4 == 0) else 1
    assert p["flush_vec"] == want_fv


def emulate_dense(sym, valid, start, B, N, out_rows, p):
    """The kernel's window, flushes and write-outs on plan ``p``, block by
    block, tile by tile and eight rows at a time, from the lane scan's
    rows (``sym``, the symbol field of each row's entry; ``valid``, its
    emissions: the walk the kernel shares with ``lane_scan``) and the entry
    rows ``start``.  Eight rows that are all active, hold no last codeword
    and stay below out_rows store each row's symbol field at the lane's
    next slot and move on where the row emits; other rows store their
    emissions below out_rows.  After each tile the block flushes the rows
    all its lanes passed and each lane writes out its ranks below its count
    + rows - WINDOW.  Returns (dense (out_rows, G) int64, counts (G,),
    written out (G,)), every byte of dense written exactly once and no
    window slot overwritten before its rank was flushed or written out."""
    steps, G = valid.shape
    L, R, W = p["lanes"], p["rows"], p["window"]
    big = np.iinfo(np.int64).max
    dense = np.full((out_rows, G), -1, dtype=np.int64)
    writes = np.zeros((out_rows, G), dtype=np.int64)
    counts = np.zeros(G, dtype=np.int64)
    written = np.zeros(G, dtype=np.int64)
    lim = np.clip(N - np.arange(G, dtype=np.int64) * B, 0, steps)
    T = -(-steps // R)
    for g0 in range(0, G, L):
        w = min(L, G - g0)
        n = np.zeros(w, dtype=np.int64)
        ev = np.zeros(w, dtype=np.int64)
        done = np.zeros(w, dtype=bool)
        win = np.zeros((W, w), dtype=np.int64)
        slot = np.full((W, w), -1, dtype=np.int64)  # the rank each holds
        base = 0

        def put(l, k, v):
            # the slot's rank is flushed or written out, or is this one (a
            # row's byte the emission of that rank overwrites)
            old = slot[k % W, l]
            assert old < max(base, ev[l]) or old == k
            win[k % W, l], slot[k % W, l] = v, k

        def flush(lo, hi):
            for r in range(lo, hi):
                for l in range(w):
                    if r >= n[l]:
                        v = 0
                    elif r < ev[l]:
                        continue  # written out by the lane
                    else:
                        assert slot[r % W, l] == r
                        v = win[r % W, l]
                    dense[r, g0 + l] = v
                    writes[r, g0 + l] += 1

        for t in range(T):
            r0 = t * R
            nr = min(R, steps - r0)
            for l in range(w):
                g = g0 + l
                if done[l] or r0 >= lim[g]:
                    continue
                for j in range(r0, r0 + nr, 8):
                    if (j >= start[g] and j + 8 <= lim[g] and j + 8 < B
                            and not done[l] and n[l] + 8 <= out_rows):
                        for row in range(j, j + 8):
                            put(l, n[l], sym[row, g])
                            n[l] += valid[row, g]
                        continue
                    for row in range(j, min(j + 8, steps)):
                        if not valid[row, g]:
                            continue
                        if n[l] < out_rows:
                            put(l, n[l], sym[row, g])
                        n[l] += 1
                        if row + 1 >= B:
                            done[l] = True
            passed = done | (lim[g0:g0 + w] <= r0 + nr)
            hi = min(int(np.where(passed, big, n).min()), out_rows)
            flush(base, hi)
            base = hi
            for l in range(w):
                to = min(n[l] + R - W, out_rows)
                for r in range(max(ev[l], base), to):
                    assert slot[r % W, l] == r
                    dense[r, g0 + l] = win[r % W, l]
                    writes[r, g0 + l] += 1
                    written[g0 + l] += 1
                ev[l] = max(ev[l], to)
        if T == 0:
            flush(0, out_rows)
        counts[g0:g0 + w] = n
    assert (writes == 1).all()
    return dense, counts, written


def _check(bits, tab, start, kw, ptrs=(0, 0)):
    B, H, N, out_rows = kw["B"], kw["H"], kw["N"], kw["out_rows"]
    G = bits.shape[1]
    p = ldd.dense_plan(G, *ptrs)
    sym, valid = lane_scan_ref(bits, tab, start, B=B, H=H, N=N)
    dense, counts, stored = emulate_dense(sym.numpy(), valid.numpy() != 0,
                                          start.numpy(), B, N, out_rows, p)
    want, want_counts = ldd.lane_decode_dense_ref(bits, tab, start, **kw)
    np.testing.assert_array_equal(dense, want.numpy())
    np.testing.assert_array_equal(counts, want_counts.numpy())
    return stored


@pytest.mark.parametrize("case", ps.DENSE_CASES)
def test_dense_emulation_matches_plain(case):
    bits, tab, start, kw = ps.dense_case(case, "cpu")
    stored = _check(bits, tab, start, kw,
                    (bits.data_ptr(), 0 if case != "g100" else 2))
    if case == "ahead":  # the 1-bit lane runs a window ahead
        assert stored[5] > 0 and not np.delete(stored, 5).any()
    else:
        assert not stored.any()
    if case == "short-rows":
        assert int(ldd.lane_decode_dense_ref(bits, tab, start, **kw)[1]
                   .min()) > kw["out_rows"]


@pytest.mark.parametrize("name", ["text", "md1"])
def test_dense_emulation_tiled_geometry(name):
    # the dense pipeline's own inputs: candidate scan, compose, the JAX
    # test's out_rows
    _raw, hf = make(name)
    st = lanedfa_decode.stage_lanedfa(hf, device="cpu")
    kw = dict(B=st["B"], H=st["H"], N=st["N"])
    entry = lanedfa_decode.compose(*candidate_scan(st["bits"], st["tab"],
                                                   **kw))[0]
    md = lanedfa.build_lane_dfa(hf.tree).min_depth
    out_rows = min(st["B"] + st["H"], st["B"] // max(md, 1) + 2)
    _check(st["bits"], st["tab"], entry, dict(kw, out_rows=out_rows))


def test_window_rule_counts_a_lane_ahead():
    # one lane of a block emits every row, the others never: the flushed
    # rows stay 0 until the last tile, so after each earlier tile the lane
    # writes out its ranks below its count + R - WINDOW
    B, G = 2000, 32
    p = ldd.dense_plan(G, 0, 0)
    R, W = p["rows"], p["window"]
    valid = np.zeros((B, G), dtype=bool)
    valid[:, 3] = True
    sym = np.zeros((B, G), dtype=np.int64)
    dense, counts, written = emulate_dense(
        sym, valid, np.zeros(G, dtype=np.int64), B, G * B, B, p)
    before_last = (B - 1) // R * R  # the count after the last full tile
    assert written[3] == before_last + R - W > 0
    assert not np.delete(written, 3).any()
    assert counts[3] == B and not dense.any()

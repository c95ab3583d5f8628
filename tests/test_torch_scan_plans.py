"""The launch plans and tiled walks of ``lane_scan_indexed`` and
``short_candidate_scan`` on the CPU.

Both kernels stage their bit rows in shared memory a tile at a time
(``csrc/widescan.cuh`` ``BitRing``; the short scan the 0-chain's emission
rows too, in a second ring under the same plan), and the indexed scan walks
a lane's active rows two bits a lookup on a 2-bit step table it builds at
launch.  Their plans are computed in Python (``ops.lanedfa.indexed_plan``,
``short_plan``) and handed to the kernels, whose launchers refuse any
other.  Here, without a card: the plans at the kernels' edge cases (shared
bytes within ``BIT_SHARED_MAX``, copy widths that keep both matrices'
addresses aligned, L*H threads within a block); the host mirror of the
2-bit step table against two 1-bit lookups over every (state, 2 bits) of
the test streams' tables; a numpy emulation of each kernel's walk, block
by block, tile by tile and eight rows at a time as the CUDA source walks
them, against the plain ``_ref`` versions at the kernels' edge cases
(``probes.streams.INDEXED_SCAN_CASES`` and ``SHORT_SCAN_CASES``, which
the card tests and ``chip_smoke.py`` run on the card); and one cheap case of the plain
indexed scan against the JAX ``lane_scan_indexed_pallas`` in interpret
mode.  Tolerance: bit-exact (integer outputs).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from huffmandecoderongpus_tpu.ops import pallas_lanedfa as jpl
from huffmandecoderongpus_tpu_torch.ops import lane_scan_indexed as lsi
from huffmandecoderongpus_tpu_torch.ops import lanedfa
from huffmandecoderongpus_tpu_torch.ops import short_candidate_scan as scs
from huffmandecoderongpus_tpu_torch.ops.lanedfa import (
    BIT_SHARED_MAX,
    CHUNK,
    EMIT_BIT,
    INDEXED_THREADS,
    MAX_THREADS,
    STATE_MASK,
    TILE_STAGES,
    indexed_plan,
    short_plan,
    step2_bytes,
    step2_table,
)
from huffmandecoderongpus_tpu_torch.probes import streams as ps
from torch_streams import MD1_SHAPES, SHAPES, comb_stream, make

#: padded table sizes (int32 words): one chunk, the text trees' two, 255
#: states' four, and the most the kernels take (16 chunks, 1,023 states)
TAB_WORDS = (CHUNK, 2 * CHUNK, 4 * CHUNK, 16 * CHUNK)
#: lane counts: one, odd, around a warp, lane_dfa's indexed (a) and the
#: tiled geometry's multiples of 1,024
GS = (1, 3, 31, 32, 33, 1000, 11264, 16384)
#: candidate chains a lane: the text trees' 9, 32 and 33 around a warp of
#: lanes, 140 (a comb tree: L shrinks), 1,023 (one lane a block)
HS = (1, 9, 32, 33, 140, 1023)


def _aligned(p, G, ptr):
    vec = p["vec"]
    return ptr % vec == 0 and (p["lanes"] == G or (
        p["lanes"] % vec == 0 and G % vec == 0))


@pytest.mark.parametrize("words", TAB_WORDS)
@pytest.mark.parametrize("G", GS)
def test_indexed_plan(G, words):
    for ptr in (0, 1, 4, 256 + 8):
        p = indexed_plan(G, ptr, words)
        L, R = p["lanes"], p["rows"]
        assert p["threads"] == INDEXED_THREADS and L == min(32, G)
        assert p["blocks"] * L >= G > (p["blocks"] - 1) * L
        # three bit tiles, two pairs of output tiles, the 2-bit table
        assert p["shared"] == (TILE_STAGES + 4) * R * L + step2_bytes(words)
        assert p["shared"] <= BIT_SHARED_MAX
        assert R >= 16 and R % 16 == 0 and _aligned(p, G, ptr)
        # a 16-chunk table costs the tiles rows, never a refused plan
        if words <= 4 * CHUNK:
            assert R == max(16, 4096 // L // 16 * 16)
    assert step2_bytes(16 * CHUNK) == 16 * 1024


@pytest.mark.parametrize("H", HS)
@pytest.mark.parametrize("G", GS)
def test_short_plan(G, H):
    for ptr in (0, 2, 4, 16 + 4):
        p = short_plan(G, H, ptr)
        L, R = p["lanes"], p["rows"]
        assert p["threads"] == L * H <= MAX_THREADS
        assert L == G or L * H * 2 > MAX_THREADS or L == 32
        # a ring of bit tiles and one of the 0-chain's emission tiles
        assert p["shared"] == 2 * TILE_STAGES * R * L <= BIT_SHARED_MAX
        assert R >= 16 and R % 16 == 0 and _aligned(p, G, ptr)
    # both matrices' addresses take part in the copy width
    assert short_plan(4096, 9, 16 | 4)["vec"] == 4
    assert short_plan(4096, 9, 16 | 1)["vec"] == 1
    with pytest.raises(ValueError):
        short_plan(4096, 1025, 0)


def _tables():
    """Padded fused tables of the test streams: every SHAPES and MD1_SHAPES
    tree, a comb tree 140 tall, and a 255-state table padded to 16
    chunks."""
    out = {}
    for name in sorted(SHAPES) + sorted(MD1_SHAPES):
        out[name] = lanedfa.pad_table(lanedfa.build_lane_dfa(
            make(name)[1].tree).entry)
    out["comb140"] = lanedfa.pad_table(lanedfa.build_lane_dfa(
        comb_stream(141, 2000)[1].tree).entry)
    wide = np.zeros((16, CHUNK), dtype=np.int32)
    ns2 = out["ns2"].reshape(-1)
    wide.reshape(-1)[:ns2.size] = ns2
    out["ns2 in 16 chunks"] = wide
    return out


TABLES = _tables()


@pytest.mark.parametrize("name", sorted(TABLES))
def test_step2_table_is_two_lookups(name):
    tab = TABLES[name].reshape(-1).astype(np.int64)
    step = step2_table(tab)
    states = (tab.size + 1) // 2
    assert step.shape == (4 * states,) and step.dtype == np.uint32
    assert step.nbytes == step2_bytes(tab.size)
    for s in range(states):
        for b0 in (0, 1):
            e0 = int(tab[2 * s + b0])
            for b1 in (0, 1):
                e1 = int(tab[2 * (e0 & STATE_MASK) + b1])
                got = int(step[4 * s + 2 * b0 + b1])
                assert got >> 4 & STATE_MASK == e1 & STATE_MASK
                assert got & 0xF == 0
                assert got >> 14 & 1 == int(e0 & EMIT_BIT != 0)
                assert got >> 15 & 1 == int(e1 & EMIT_BIT != 0)
                assert got >> 16 & 0xFF == e0 >> 16 & 0xFF
                assert got >> 24 == e1 >> 16 & 0xFF


def emulate_indexed(bits, tab, lane_len):
    """``csrc/lane_scan_indexed.cu`` in numpy: blocks of L lanes, tiles of
    R rows, eight rows at a time (four 2-bit steps while all eight are
    active, lookups from the frozen state once none is, one bit a step in
    the group that holds the lane's end), through the output tiles."""
    bits = np.asarray(bits)
    B, G = bits.shape
    t1 = np.zeros(2 * (STATE_MASK + 1), dtype=np.int64)
    t1[:tab.size] = np.asarray(tab).reshape(-1)
    step = step2_table(tab).astype(np.int64)
    p = indexed_plan(G, 0, tab.size)
    L, R = p["lanes"], p["rows"]
    sym = np.full((B, G), 0xAA, dtype=np.uint8)  # every cell is written
    valid = np.full((B, G), 0xAA, dtype=np.uint8)
    for g0 in range(0, G, L):
        w = min(L, G - g0)
        lens = np.clip(np.asarray(lane_len)[g0:g0 + w], 0, B)
        off = np.zeros(w, dtype=np.int64)  # state * 16
        for r0 in range(0, B, R):
            tile = np.zeros((R, w), dtype=np.int64)  # stale rows read 0
            nr = min(R, B - r0)
            tile[:nr] = bits[r0:r0 + nr, g0:g0 + w] & 1
            os = np.zeros((R, w), dtype=np.uint8)
            ov = np.zeros((R, w), dtype=np.uint8)
            for k0 in range(0, nr, 8):
                j0 = r0 + k0
                b = tile[k0:k0 + 8]
                full = j0 + 8 <= lens
                past = j0 >= lens
                mid = ~full & ~past
                for m in range(0, 8, 2):  # four 2-bit steps
                    e = step[(off + (b[m] << 3 | b[m + 1] << 2)) >> 2]
                    e = np.where(full, e, 0)
                    os[k0 + m][full] = (e >> 16 & 0xFF)[full]
                    os[k0 + m + 1][full] = (e >> 24 & 0xFF)[full]
                    ov[k0 + m][full] = (e >> 14 & 1)[full]
                    ov[k0 + m + 1][full] = (e >> 15 & 1)[full]
                    off = np.where(full, (e >> 4 & STATE_MASK) << 4, off)
                f = off >> 4  # the 1-bit walk's state
                for k in range(8):
                    e = t1[2 * f + b[k]]
                    act = mid & (j0 + k < lens)
                    sel = past | mid
                    os[k0 + k][sel] = (e >> 16 & 0xFF)[sel]
                    ov[k0 + k][sel] = (act & (e & EMIT_BIT != 0))[sel]
                    f = np.where(act, e & STATE_MASK, f)
                off = np.where(mid, f << 4, off)
            sym[r0:r0 + nr, g0:g0 + w] = os[:nr]
            valid[r0:r0 + nr, g0:g0 + w] = ov[:nr]
    return torch.from_numpy(sym), torch.from_numpy(valid)


@pytest.mark.parametrize("case", ps.INDEXED_SCAN_CASES)
def test_indexed_walk_matches_ref(case):
    bits, tab, lane_len = ps.indexed_scan_case(case, "cpu")
    got = emulate_indexed(bits.numpy(), tab.numpy(), lane_len.numpy())
    want = lsi.lane_scan_indexed_ref(bits, tab, lane_len)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def emulate_short(bits, tab, valid0, *, B, H, N, W):
    """``csrc/short_candidate_scan.cu`` in numpy: blocks of L lanes by H
    chains (chain-major threads, warps of 32 of them), tiles of R rows that
    a block leaves once none of its chains has rows left, eight rows at a
    time that a warp leaves the same way, the eight rows' emissions
    gathered into a mask and the first merge or exit row found from it."""
    bits, valid0 = np.asarray(bits), np.asarray(valid0)
    G = bits.shape[1]
    t1 = np.zeros(2 * (STATE_MASK + 1), dtype=np.int64)
    t1[:tab.size] = np.asarray(tab).reshape(-1)
    p = short_plan(G, H, 0)
    L, R = p["lanes"], p["rows"]
    outs = [np.zeros((H, G), dtype=d) for d in (bool, bool, np.int32,
                                               np.int32, np.int32)]
    for g0 in range(0, G, L):
        w = min(L, G - g0)
        n_thr = L * H
        o = np.arange(n_thr) // L
        lane = np.arange(n_thr) % L
        real = lane < w
        g = g0 + np.minimum(lane, w - 1)
        end = np.where(real, np.clip(N - g.astype(np.int64) * B, 0, W), 0)
        off = np.zeros(n_thr, dtype=np.int64)
        n, mr, x = (np.zeros(n_thr, dtype=np.int64) for _ in range(3))
        is_m = np.zeros(n_thr, dtype=bool)
        is_x = np.zeros(n_thr, dtype=bool)
        live = o < end
        for r0 in range(0, W, R):
            if not (live & (r0 < end)).any():
                break
            nr = min(R, W - r0)
            tb = np.zeros((R, n_thr), dtype=np.int64)
            tv = np.zeros((R, n_thr), dtype=np.int64)
            tb[:nr] = bits[r0:r0 + nr, g] & 1
            tv[:nr] = valid0[r0:r0 + nr, g]
            go = np.ones(n_thr, dtype=bool)  # the warp is still in the tile
            for k0 in range(0, nr, 8):
                j0 = r0 + k0
                for wb in range(0, n_thr, 32):
                    if not (live & (j0 < end))[wb:wb + 32].any():
                        go[wb:wb + 32] = False
                em = np.zeros(n_thr, dtype=np.int64)
                for k in range(8):
                    e = t1[(off >> 2) + tb[k0 + k]]
                    nxt = np.where(j0 + k >= o, (e & STATE_MASK) << 3, 0)
                    off = np.where(go, nxt, off)
                    em |= (e & EMIT_BIT != 0).astype(np.int64) << k
                lo = np.maximum(o - j0, 0)
                hi = np.minimum(end - j0, 8)
                rows = np.where(hi > lo, ((1 << np.clip(hi, 0, 8)) - 1)
                                & ~((1 << np.clip(lo, 0, 8)) - 1), 0)
                em &= np.where(live & go, rows, 0)
                vm = np.zeros(n_thr, dtype=np.int64)
                for k in range(8):
                    vm |= (tv[k0 + k] != 0).astype(np.int64) << k
                xs = B - 1 - j0
                xm = 0xFF if xs <= 0 else 0 if xs >= 8 else (0xFF << xs) & 0xFF
                stop = em & (vm | xm)
                f = np.array([(int(s) & -int(s)).bit_length() - 1
                              for s in stop])
                upto = np.where(stop != 0, (2 << np.maximum(f, 0)) - 1, 0xFF)
                n += np.array([bin(int(v)).count("1") for v in em & upto])
                hit = stop != 0
                merge = hit & ((vm >> np.maximum(f, 0)) & 1 == 1)
                is_m |= merge
                mr = np.where(merge, j0 + f, mr)
                is_x |= hit & ~merge
                x = np.where(hit & ~merge, j0 + f + 1 - B, x)
                live &= ~hit
        for out, v in zip(outs, (is_m, is_x, mr, n, x)):
            out[o[real], g[real]] = v[real]
    return tuple(torch.from_numpy(a) for a in outs)


@pytest.mark.parametrize("case", ps.SHORT_SCAN_CASES)
def test_short_walk_matches_ref(case):
    bits, tab, valid0, kw = ps.short_scan_case(case, "cpu")
    got = emulate_short(bits.numpy(), tab.numpy(), valid0.numpy(), **kw)
    want = scs.short_candidate_scan_ref(bits, tab, valid0, **kw)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)
    merged, exited = want[0], want[1]
    if case == "merge+exit":
        assert bool(merged.any()) and bool(exited.any())
    if case == "unresolved":
        assert not bool((merged | exited).any())
    if case == "tall":
        assert short_plan(bits.shape[1], kw["H"], 0)["lanes"] < 8


def test_indexed_ref_matches_pallas_interpret():
    # the tiled geometry's 1,024 lanes, 40 rows of seeded bits, lengths 0-40
    rng = np.random.default_rng(150)
    B, G = 40, 1024
    bits = torch.from_numpy(rng.integers(0, 2, (B, G), dtype=np.uint8))
    tab = torch.from_numpy(TABLES["text"])
    lens = torch.from_numpy(rng.integers(0, B + 1, G).astype(np.int32))
    sym, valid = lsi.lane_scan_indexed_ref(bits, tab, lens)
    jsym, jvalid = jpl.lane_scan_indexed_pallas(
        jnp.asarray(bits.numpy()), jnp.asarray(tab.numpy()),
        jnp.asarray(lens.numpy()), B=B, G=G, interpret=True)
    np.testing.assert_array_equal(valid.numpy(), np.asarray(jvalid))
    np.testing.assert_array_equal(sym.numpy(), np.asarray(jsym))

"""The launch plans of the block-wide E1 and E2 (``ops.e1_pack.e1_plan``,
``ops.e2_compact.e2_plan``), their look-back (``csrc/lookback.cuh``), and
both kernels' steps replayed in numpy.

E1 runs a block over a tile of 32 lanes and a range of their symbol rows,
staged in shared memory and cut into chunks (a warp each): each chunk's
first bit comes from a scan over code lengths and the lanes' bits before
the block, which a decoupled look-back over the tile's earlier row blocks
gives; its first granule is rebuilt from the codes before it, and its
sub-steps run as the TPU kernel's.  E2 runs a block over a tile of up to 32
lanes and a range of their rows: counts of the valid flags of each (chunk,
lane), a prefix over the chunks, the lanes' counts before the block from
the same look-back, the granules placed at their ranks in each lane's span
of its row, staged a window at a time, and the spans written out.  The
plans are computed in Python and handed to the kernels, whose launchers
refuse any other (their checks mirrored here).

Here, on the CPU: every (lane, row) is read by one chunk, the grid fills
the card at G = 512, the blocks fit their threads and shared memory, the
look-back's walk (windows of 32 predecessors, up to the nearest inclusive
sum) gives every block its exact sum over any mix of published states, and
``emulate_e1`` / ``emulate_e2`` replay the kernels on the plans and must
give the plain versions' outputs, every output written exactly once.
Tolerance: bit-exact (integer outputs).
"""

import itertools

import numpy as np
import pytest
import torch

from huffmandecoderongpus_tpu.ops import pallas_encode as pe
from huffmandecoderongpus_tpu_torch.ops import encode
from huffmandecoderongpus_tpu_torch.ops import e1_pack as e1_mod
from huffmandecoderongpus_tpu_torch.ops import e2_compact as e2_mod
from huffmandecoderongpus_tpu_torch.ops.e1_pack import (
    CHUNKS,
    LANES,
    MAX_ROWS,
    e1_pack,
    e1_pack_ref,
    e1_plan,
)
from huffmandecoderongpus_tpu_torch.ops.e2_compact import (
    SHARED_MAX,
    e2_bytes,
    e2_compact,
    e2_compact_ref,
    e2_plan,
)
from huffmandecoderongpus_tpu_torch.ops import lookback
from huffmandecoderongpus_tpu_torch.ops.lookback import state_words
from huffmandecoderongpus_tpu_torch.probes import streams as ps
from torch_streams import fib_tree_data, text_like

#: (G, K, ORP) of chip_smoke.py's streams (a), (b), (c), (g), (h), (i)
STREAMS = {"a": (8192, 688, 384), "b": (8192, 1040, 768),
           "c": (8192, 1040, 512), "g": (512, 752, 384),
           "h": (512, 528, 384), "i": (512, 784, 384)}
#: (G, K, ORP) at the lane counts a caller may ask for, K at its least
#: (16) and ORP past one staging window
ODD = [(G, K, 128) for G in (1, 37, 128, 130, 8192) for K in (16, 100)] + [
    (128, 688, 4096), (37, 300, 1408), (8192, 16, 128)]
GEOMS = list(STREAMS.values()) + ODD
SMS = (132, 114)


# ---- the launchers' checks, mirrored ---------------------------------------

def e1_plan_ok(data_ptr, state_ptr, cap, K, G, lanes, vec, chunks, rows,
               row_blocks, threads, shared, blocks):
    """``csrc/e1_pack.cu`` ``e1_plan_ok``, mirrored."""
    if (K < 1 or G < 1 or lanes != 32 or not 1 <= chunks <= 32
            or threads != 32 * chunks or rows < chunks or rows % chunks
            or rows > 1024 or row_blocks < 1 or shared != 32 * rows
            or vec not in (1, 4, 16) or G % vec or data_ptr % vec
            or state_ptr % 8):
        return False
    tiles = -(-G // 32)
    return ((row_blocks - 1) * rows < K <= row_blocks * rows
            and tiles * row_blocks == blocks and blocks <= cap)


def e2_plan_ok(gran_ptr, gval_ptr, state_ptr, cap, rows, G, ORP, lanes, vec,
               chunks, block_rows, row_blocks, window, threads, shared,
               blocks):
    """``csrc/e2_compact.cu`` ``e2_plan_ok``, mirrored."""
    if (rows < 1 or G < 1 or ORP < 1 or not 1 <= lanes <= min(32, G)
            or vec not in (1, 4) or not 1 <= chunks <= 32 or block_rows < 1
            or row_blocks < 1 or window < 4 or window % 4
            or state_ptr % 8):
        return False
    if vec == 4 and (lanes % 4 or G % 4 or gval_ptr % 4 or gran_ptr % 16):
        return False
    tiles = -(-G // lanes)
    return ((row_blocks - 1) * block_rows < rows <= row_blocks * block_rows
            and tiles * row_blocks == blocks and blocks <= cap
            and threads == -(-(lanes // vec * chunks) // 32) * 32
            and threads <= 1024 and window < ORP + 4
            and shared == e2_bytes(lanes, chunks, window)
            and shared <= SHARED_MAX == 48 * 1024 - 256)


def _e1_args(G, K, p, data_ptr=0):
    return dict(data_ptr=data_ptr, state_ptr=0, cap=p["blocks"], K=K, G=G,
                lanes=p["lanes"], vec=p["vec"], chunks=p["chunks"],
                rows=p["rows"], row_blocks=p["row_blocks"],
                threads=p["threads"], shared=p["shared"],
                blocks=p["blocks"])


def _e2_args(G, rows, ORP, p, gran_ptr=0, gval_ptr=0):
    return dict(gran_ptr=gran_ptr, gval_ptr=gval_ptr, state_ptr=0,
                cap=p["blocks"], rows=rows, G=G, ORP=ORP, lanes=p["lanes"],
                vec=p["vec"], chunks=p["chunks"],
                block_rows=p["block_rows"], row_blocks=p["row_blocks"],
                window=p["window"], threads=p["threads"],
                shared=p["shared"], blocks=p["blocks"])


# ---- the look-back ---------------------------------------------------------

AGGREGATE, INCLUSIVE = 1, 2


def look_back(flags, agg, inc, first, b):
    """``lookback.cuh`` ``look_back``, one lane's walk: the sum over blocks
    [first, b), read from b - 1 in windows of 32 (a warp's lanes), each
    window up to its nearest inclusive sum."""
    total = 0
    hi = b - 1
    while hi >= first:
        f = [INCLUSIVE if hi - q < first else flags[hi - q]
             for q in range(32)]
        assert all(f)  # the kernel waits until each has published
        ballot = sum(1 << q for q in range(32) if f[q] == INCLUSIVE)
        n = (ballot & -ballot).bit_length() if ballot else 32
        for q in range(n):
            if hi - q < first:
                break
            total += (inc if (ballot >> q) & 1 else agg)[hi - q]
        if ballot:
            break
        hi -= 32
    return total


def emulate_lookback(values, rng):
    """The sums before each of a tile's row blocks, each block's walk run
    over a random mix of its predecessors' states as the card may leave
    them (every predecessor has published its aggregate; some, at random,
    their inclusive sums too).  ``values`` (S, lanes): each block's own
    sums."""
    S = values.shape[0]
    before = np.zeros_like(values)
    incl = np.cumsum(values, 0)
    for b in range(S):
        flags = [INCLUSIVE if rng.random() < 0.3 else AGGREGATE
                 for _ in range(b)]
        for l in range(values.shape[1]):
            before[b, l] = look_back(flags, values[:, l], incl[:, l], 0, b)
    return before


@pytest.mark.parametrize("S", [1, 2, 33, 64, 70, 130])
def test_look_back_sums(S):
    rng = np.random.default_rng(S)
    values = rng.integers(0, 1000, size=(S, 3))
    want = np.cumsum(values, 0) - values
    np.testing.assert_array_equal(emulate_lookback(values, rng), want)
    # none inclusive but the first: the walk crosses every window
    flags = [INCLUSIVE] + [AGGREGATE] * (S - 1)
    incl = np.cumsum(values[:, 0])
    for b in range(S):
        assert look_back(flags, values[:, 0], incl, 0, b) == want[b, 0]
    # a tile whose first block is block 5 of the state: its walk stops there
    pad = np.concatenate([np.full(5, 10**9), values[:, 0]])
    flags = [AGGREGATE] * (S + 5)
    for b in range(S):
        assert look_back(flags, pad, pad, 5, 5 + b) == want[b, 0]
    # the state's words: the epoch and ticket word, a flag a block, two
    # sums a (block, lane)
    assert state_words(S) == 2 + S + 64 * S


@pytest.mark.parametrize("wrapper", [e1_mod, e2_mod])
def test_encoder_lookback_states(wrapper):
    # each wrapper's own state cache, in the encoder's layout: made zeroed
    # for MIN_BLOCKS blocks, kept for a stream, grown past its blocks, the
    # MAX_STREAMS streams used last
    states = type(wrapper._states)()
    cpu = torch.device("cpu")
    first, cap = states.get(cpu, 1, 1)
    assert cap == lookback.MIN_BLOCKS
    assert first.shape == (state_words(cap),) and not first.any()
    assert states.get(cpu, 1, cap)[0] is first
    grown, cap2 = states.get(cpu, 1, cap + 1)
    assert grown is not first and cap2 == 2 * (cap + 1)
    for stream in range(2, 2 * lookback.MAX_STREAMS):
        states.get(cpu, stream, 1)
    assert len(states) == lookback.MAX_STREAMS and (None, 1) not in states
    # E1 and E2 keep states apart: their look-backs differ in cap
    assert e1_mod._states is not e2_mod._states


# ---- the plans -------------------------------------------------------------

def _e1_layout(G, K, p):
    """How often a chunk owns each symbol row, walking blocks and chunks as
    ``csrc/e1_pack.cu`` does (the same for every lane of a tile)."""
    NC, RB, S = p["chunks"], p["rows"], p["row_blocks"]
    RC = RB // NC
    own = np.zeros(K, dtype=np.int64)
    for j in range(S):
        for c in range(NC):
            kc = min(j * RB + c * RC, K)
            own[kc:min(kc + RC, K)] += 1
    return own


@pytest.mark.parametrize("G,K,ORP", GEOMS)
@pytest.mark.parametrize("sms", SMS)
def test_e1_plan_rules(G, K, ORP, sms):
    p = e1_plan(G, K, sms)
    assert p["lanes"] == LANES == 32 and p["chunks"] == CHUNKS
    assert p["vec"] == (16 if G % 16 == 0 else 4 if G % 4 == 0 else 1)
    assert p["rows"] <= MAX_ROWS and p["shared"] == 32 * p["rows"]
    assert p["threads"] == 32 * p["chunks"] <= 1024
    assert p["rows"] % p["chunks"] == 0 and p["chunk_rows"] >= 2
    tiles = -(-G // 32)
    assert p["blocks"] == tiles * p["row_blocks"]
    # every row of a lane in one chunk
    assert (_e1_layout(G, K, p) == 1).all()
    # within the aim of BLOCKS_PER_SM blocks an SM, or as few row blocks
    # as MAX_ROWS allows
    assert (p["row_blocks"] == -(-K // MAX_ROWS)
            or p["blocks"] <= e1_mod.BLOCKS_PER_SM * sms)
    if G == 512:  # the grid fills the card
        assert p["blocks"] >= sms
    args = _e1_args(G, K, p)
    assert e1_plan_ok(**args)
    for bad in (dict(lanes=16), dict(chunks=0), dict(chunks=33),
                dict(threads=args["threads"] + 32),
                dict(rows=args["rows"] + 1), dict(rows=args["chunks"] - 1),
                dict(row_blocks=args["row_blocks"] + 1),
                dict(row_blocks=0), dict(blocks=args["blocks"] - 1),
                dict(vec=2), dict(shared=args["shared"] + 16),
                dict(rows=2048, row_blocks=1, shared=2048 * 32),
                dict(state_ptr=4), dict(cap=args["blocks"] - 1),
                dict(K=0), dict(G=0)):
        assert not e1_plan_ok(**{**args, **bad}), bad
    if p["vec"] > 1:
        assert not e1_plan_ok(**{**args, "data_ptr": 2})


def _e2_layout(G, rows, p):
    """How often a chunk reads each row of a tile, walking blocks and
    chunks as ``csrc/e2_compact.cu`` does (the same for every lane of a
    tile)."""
    nch, RB, S = p["chunks"], p["block_rows"], p["row_blocks"]
    own = np.zeros(rows, dtype=np.int64)
    for jb in range(S):
        r0, r1 = jb * RB, min(jb * RB + RB, rows)
        per = -(-(r1 - r0) // nch)
        for ch in range(nch):
            c0 = min(r0 + ch * per, r1)
            own[c0:min(c0 + per, r1)] += 1
    return own


@pytest.mark.parametrize("G,K,ORP", GEOMS)
@pytest.mark.parametrize("sms", SMS)
def test_e2_plan_rules(G, K, ORP, sms):
    rows = 2 * K
    p = e2_plan(G, rows, ORP, sms)
    L = p["lanes"]
    assert L == min(32, G)
    assert p["vec"] == (4 if L % 4 == 0 and G % 4 == 0 else 1)
    assert p["active"] == L // p["vec"] * p["chunks"] <= p["threads"]
    assert p["threads"] == -(-p["active"] // 32) * 32 <= 1024
    assert p["blocks"] == -(-G // L) * p["row_blocks"]
    assert (_e2_layout(G, rows, p) == 1).all()
    # no more row blocks than give the grid BLOCKS_PER_SM blocks an SM
    tiles = -(-G // L)
    assert p["row_blocks"] == 1 or (
        (p["row_blocks"] - 1) * tiles < e2_mod.BLOCKS_PER_SM * sms)
    if G == 512:
        assert p["blocks"] >= sms
    # the window: whole 16-byte stores, all of ORP where it fits
    W = p["window"]
    assert W % 4 == 0 and 4 <= W < ORP + 4
    assert p["shared"] == e2_bytes(L, p["chunks"], W) <= SHARED_MAX
    assert (W == -(-ORP // 4) * 4
            or e2_bytes(L, p["chunks"], W + 4) > SHARED_MAX)
    if ORP == 4096:
        assert W < ORP  # past one staging window
    args = _e2_args(G, rows, ORP, p)
    assert e2_plan_ok(**args)
    for bad in (dict(lanes=33), dict(vec=2), dict(chunks=33),
                dict(window=W + 2), dict(window=ORP + 8),
                dict(threads=p["threads"] + 32),
                dict(shared=p["shared"] + 16),
                dict(block_rows=(rows - 1) // p["row_blocks"]),
                dict(row_blocks=p["row_blocks"] + 1),
                dict(blocks=p["blocks"] + 1), dict(state_ptr=4),
                dict(cap=p["blocks"] - 1), dict(ORP=0)):
        assert not e2_plan_ok(**{**args, **bad}), bad
    if p["vec"] == 4:
        assert not e2_plan_ok(**{**args, "gran_ptr": 4})
        assert not e2_plan_ok(**{**args, "gval_ptr": 2})


def test_plans_refuse_and_take_the_card():
    for bad in ((0, 16), (1, 0), (-3, 100)):
        with pytest.raises(ValueError):
            e1_plan(*bad)
    for bad in ((0, 32, 128), (8, 0, 128), (8, 32, 0)):
        with pytest.raises(ValueError):
            e2_plan(*bad)
    # misaligned addresses read fewer lanes a load
    assert e2_plan(512, 1504, 384, 132, gran_ptr=4)["vec"] == 1
    assert e2_plan(512, 1504, 384, 132, gval_ptr=1)["vec"] == 1
    assert e1_plan(512, 752, 132, data_ptr=2)["vec"] == 1
    assert e1_plan(512, 752, 132, data_ptr=4)["vec"] == 4
    # a long lane on few tiles: no block stages more than MAX_ROWS rows
    p = e1_plan(1, 100_000, 132)
    assert p["rows"] <= MAX_ROWS and p["row_blocks"] * p["rows"] >= 100_000
    # CPU tensors plan for the H100's 132 SMs
    assert e1_plan(512, 752)["sm_count"] == 132
    assert e2_plan(512, 1504, 384)["sm_count"] == 132
    # more SMs, more row blocks
    assert (e1_plan(512, 752, 264)["row_blocks"]
            > e1_plan(512, 752, 132)["row_blocks"])


@pytest.mark.parametrize("G,K", list(itertools.product((128, 512), (16, 48))))
def test_plans_cover_small_geometries(G, K):
    # every block's chunks hold a row or none, and the last row block ends
    # at K (E1) and at the rows (E2), at any SM count
    for sms in (1, 7, 132, 10_000):
        p = e1_plan(G, K, sms)
        assert (_e1_layout(G, K, p) == 1).all()
        q = e2_plan(G, 2 * K, 128, sms)
        assert (_e2_layout(G, 2 * K, q) == 1).all()


# ---- E1 replayed -----------------------------------------------------------

def emulate_e1(data3, lo, hi, nval, p, rng):
    """``csrc/e1_pack.cu`` on plan ``p``, block by block and chunk by chunk
    (the lanes of a chunk at once): the code bits of each chunk; the lanes'
    bits before each block from ``emulate_lookback`` over the blocks' own
    sums (``rng`` picks the states it walks); each chunk's first bit P;
    its first granule rebuilt from the codes before it; its sub-steps; the
    flush by the chunk holding row K - 1.  Returns (gran, gval, cnt, bits,
    stats), every output written exactly once (the flush row twice, as in
    the kernel); ``stats`` counts the (block, lane) pairs whose block
    starts inside a granule and inside the lane's pad rows."""
    K, G = data3.shape
    NC, RB, S = p["chunks"], p["rows"], p["row_blocks"]
    RC = RB // NC
    sym = data3.astype(np.int64)
    lo = lo.astype(np.int64) & 0xFFFFFFFF
    hi = hi.astype(np.int64) & 0xFFFFFFFF
    lens = (lo >> 13) + (hi >> 13)
    nv = nval.astype(np.int64)
    g = np.arange(G)
    gran = np.full((2 * K, G), -1, dtype=np.int64)
    gval = np.full((2 * K, G), -1, dtype=np.int64)
    cnt = np.full(G, -1, dtype=np.int64)
    bits = np.full(G, -1, dtype=np.int64)
    written = np.zeros((2 * K, G), dtype=np.int64)
    flushed = np.zeros(G, dtype=np.int64)
    stats = dict(mid_granule=0, in_pad=0)

    def bits_of(rows):
        if not rows.size:
            return np.zeros(G, dtype=np.int64)
        return (lens[sym[rows]] * (rows[:, None] < nv[None, :])).sum(0)

    blocks = np.stack([bits_of(np.arange(j * RB, min(j * RB + RB, K)))
                       for j in range(S)])
    before = emulate_lookback(blocks, rng)
    for j in range(S):
        k0 = j * RB
        span = [(min(k0 + c * RC, K), min(min(k0 + c * RC, K) + RC, K))
                for c in range(NC)]
        own = np.stack([bits_of(np.arange(kc, ke)) for kc, ke in span])
        for c, (kc, ke) in enumerate(span):
            P = before[j] + own[:c].sum(0)
            need = P & 15
            if c == 0 and j > 0:
                stats["mid_granule"] += int((need > 0).sum())
                stats["in_pad"] += int(((nv > 0) & (nv <= k0)).sum())
            w = np.zeros(G, dtype=np.int64)
            have = np.zeros(G, dtype=np.int64)
            k = np.minimum(kc, nv) - 1
            while True:
                act = (have < need) & (k >= 0)
                if not act.any():
                    break
                s = sym[np.maximum(k, 0), g]
                la = lo[s] >> 13
                n = la + (hi[s] >> 13)
                code = (lo[s] & 8191) | ((hi[s] & 8191) << la)
                w = np.where(act, (w << n) | code, w)
                have = np.where(act, have + n, have)
                k = k - 1
            assert (have < 41).all()  # the kernel's 64-bit window
            acc = np.where(need > 0, w >> np.maximum(have - need, 0), 0)
            nb = need.copy()
            for k in range(kc, ke):
                valid = k < nv
                for half, tab in ((0, lo), (1, hi)):
                    ent = np.where(valid, tab[sym[k]], 0)
                    acc = acc | ((ent & 8191) << nb)
                    nb = nb + (ent >> 13)
                    emit = nb >= 16
                    o = 2 * k + half
                    gran[o], gval[o] = acc & 0xFFFF, emit
                    written[o] += 1
                    acc = np.where(emit, acc >> 16, acc)
                    nb = np.where(emit, nb - 16, nb)
            if ke == K and kc < ke:
                total = P + own[c]
                gran[2 * K - 1], gval[2 * K - 1] = acc & 0xFFFF, nb > 0
                cnt[:], bits[:] = (total + 15) // 16, total
                flushed += 1
    assert (written == 1).all() and (flushed == 1).all()
    return gran, gval, cnt, bits, stats


def _e1_check(st, sms):
    args = tuple(st[k] for k in ("data3", "lo", "hi", "nval"))
    K, G = args[0].shape
    p = e1_plan(G, K, sms)
    *got, stats = emulate_e1(*(a.numpy() for a in args), p,
                             np.random.default_rng(K + G))
    want = e1_pack_ref(*args)
    for x, y in zip(got, want):
        np.testing.assert_array_equal(x, y.numpy().astype(np.int64))
    return p, stats


@pytest.mark.parametrize("case", ps.E_CASES)
@pytest.mark.parametrize("sms", (132, 1000))
def test_e1_emulation_matches_plain(case, sms):
    _raw, _tree, _lanes, st = ps.e_case(case, "cpu")
    p, stats = _e1_check(st, sms)
    if case == "code26":
        assert int(st["hi"].max()) >> 13 == 13  # 26-bit codes
    if case == "one-symbol":
        assert int(st["lo"].max()) >> 13 == 1 and int(st["hi"].max()) == 0
    if case == "nval0":
        assert int((st["nval"] == 0).sum()) == 88
    if case == "pad-start":  # the last row block starts past every lane's
        assert p["row_blocks"] == 3 and stats["in_pad"] == 32
    if case in ("g512", "fib600", "alpha256"):
        assert p["row_blocks"] > 1 and stats["mid_granule"] > 0


@pytest.mark.parametrize("lanes,n", [(1, 3000), (37, 5000), (130, 9000),
                                     (8192, 8192 * 3)])
def test_e1_emulation_odd_lanes(lanes, n):
    raw = text_like(np.random.default_rng(lanes), n)
    st = encode.stage_encode_inputs(raw, lanes=lanes, device="cpu")
    _e1_check(st, 132)


def test_e1_long_walk_back():
    # 1-bit codes and a 26-bit one: a chunk's first granule takes up to 15
    # symbols before it, one of which may add 26 bits to the window; and
    # over more than 64 row blocks a tile, the look-back crosses windows
    raw, tree = fib_tree_data(np.random.default_rng(3), 30, n_sym=27,
                              body=3000)
    raw = np.concatenate([raw[:1500], np.zeros(700, np.uint8), raw[1500:]])
    st = encode.stage_encode_inputs(raw, tree=tree, lanes=2, device="cpu")
    p, stats = _e1_check(st, 5000)
    assert p["chunk_rows"] == 2 and p["row_blocks"] > 64
    assert stats["mid_granule"] > 0


# ---- E2 replayed -----------------------------------------------------------

def emulate_e2(gran, gval, ORP, p, rng):
    """``csrc/e2_compact.cu`` on plan ``p``, block by block: the valid flags
    of each (chunk, lane), the lanes' counts before each block from
    ``emulate_lookback`` over the blocks' own counts (``rng`` picks the
    states it walks), each chunk's first rank, each lane's span [lo, hi)
    of its row, then per window the granules each chunk places (a chunk's
    whole vec lanes skip a window none of their ranks falls in), and the
    spans written.  Returns (G, ORP) int64, every word written exactly
    once."""
    rows, G = gran.shape
    L, vec, nch = p["lanes"], p["vec"], p["chunks"]
    RB, S, W = p["block_rows"], p["row_blocks"], p["window"]
    valid = gval != 0
    out = np.full((G, ORP), -1, dtype=np.int64)
    written = np.zeros((G, ORP), dtype=np.int64)
    for t in range(-(-G // L)):
        g0 = t * L
        w = min(L, G - g0)
        V = valid[:, g0:g0 + w]
        X = gran[:, g0:g0 + w].astype(np.int64)
        before = emulate_lookback(np.stack([
            V[jb * RB:jb * RB + RB].sum(0) for jb in range(S)]), rng)
        for jb in range(S):
            r0, r1 = jb * RB, min(jb * RB + RB, rows)
            last = r1 == rows
            per = -(-(r1 - r0) // nch)
            own = np.zeros((nch, w), dtype=np.int64)
            ranges = []
            for ch in range(nch):
                c0 = min(r0 + ch * per, r1)
                c1 = min(c0 + per, r1)
                own[ch] = V[c0:c1].sum(0)
                ranges.append((c0, c1))
            base = before[jb]
            first = base + np.cumsum(own, 0) - own
            lo = np.minimum(base, ORP)
            hi = np.full(w, ORP) if last else np.minimum(base + own.sum(0),
                                                         ORP)
            span = int((hi - lo).max(initial=0))
            for w0 in range(0, span, W):
                stage = np.zeros((w, W), dtype=np.int64)
                for ch, (c0, c1) in enumerate(ranges):
                    r = first[ch]
                    hit = (r < np.minimum(hi, lo + w0 + W)) & (
                        r + own[ch] > lo + w0)
                    anyv = hit.reshape(-1, vec).any(1).repeat(vec)
                    v = V[c0:c1]
                    q = r[None, :] + np.cumsum(v, 0) - v  # ranks
                    s = q - lo[None, :] - w0
                    put = v & anyv[None, :] & (s >= 0) & (s < W) & (
                        q < hi[None, :])
                    ri, li = np.nonzero(put)
                    stage[li, s[ri, li]] = X[c0:c1][ri, li]
                for l in range(w):
                    n = min(W, int(hi[l] - lo[l]) - w0)
                    if n > 0:
                        a = int(lo[l]) + w0
                        out[g0 + l, a:a + n] = stage[l, :n]
                        written[g0 + l, a:a + n] += 1
    assert (written == 1).all()
    return out


def _e2_check(gran, gval, ORP, sms, ptrs=(0, 0)):
    rows, G = gran.shape
    p = e2_plan(G, rows, ORP, sms, *ptrs)
    got = emulate_e2(gran.numpy(), gval.numpy(), ORP, p,
                     np.random.default_rng(rows + G))
    want = e2_compact_ref(gran, gval, ORP=ORP).numpy()
    np.testing.assert_array_equal(got, want)
    return p


@pytest.mark.parametrize("case", ps.E_CASES)
def test_e2_emulation_matches_plain(case):
    _raw, _tree, _lanes, st = ps.e_case(case, "cpu")
    gran, gval, cnt, _bits = e1_pack_ref(st["data3"], st["lo"], st["hi"],
                                         st["nval"])
    ORP = st["plan"]["ORP"]
    for orp, sms in ((ORP, 132), (ORP, 1000), (ps.E_SMALL_ORP, 132)):
        _e2_check(gran, gval, orp, sms)
    if case == "fib600":
        assert int(cnt.max()) >= ORP  # ranks past ORP dropped


@pytest.mark.parametrize("G,rows,ORP,ptrs", [
    (1, 500, 128, (0, 0)), (37, 300, 40, (0, 0)), (128, 2000, 1408, (0, 0)),
    (130, 96, 8, (0, 0)), (512, 1504, 384, (0, 0)), (512, 1504, 384, (4, 0)),
    (64, 700, 4096, (0, 0))])
def test_e2_emulation_random_flags(G, rows, ORP, ptrs):
    # dense and sparse lanes, lanes with no flag, flags past ORP, flag
    # bytes other than 1, rows wider than a window
    rng = np.random.default_rng(G + rows)
    density = rng.choice([0.0, 0.05, 0.4, 1.0], size=G)
    gval = (rng.random((rows, G)) < density).astype(np.uint8)
    gval *= rng.integers(1, 4, size=(rows, G)).astype(np.uint8)
    gran = rng.integers(0, 1 << 16, size=(rows, G)).astype(np.int32)
    p = _e2_check(torch.from_numpy(gran), torch.from_numpy(gval), ORP, 132,
                  ptrs)
    if ORP == 4096:
        assert p["window"] < ORP


# ---- against the JAX kernels, in interpret mode ----------------------------

def test_e1_matches_jax_interpret():
    # a cheap case through the JAX e1_pack and the plain E1 (what a CPU
    # tensor runs), and the emulated kernel on its plan
    raw, tree = fib_tree_data(np.random.default_rng(4), 20, n_sym=27,
                              body=1500)
    st = encode.stage_encode_inputs(raw, tree=tree, lanes=128, device="cpu")
    p = st["plan"]
    K, G = p["K"], p["G"]
    assert (K, G) == (16, 128)
    args = tuple(st[k] for k in ("data3", "lo", "hi", "nval"))
    got = e1_pack(*args)
    want = pe.e1_pack(args[0].numpy().reshape(K, 1, 128),
                      pe._chunk256(args[1].numpy()),
                      pe._chunk256(args[2].numpy()),
                      args[3].numpy().reshape(1, 128), K=K, G=G, SEG=16,
                      interpret=True)
    for x, y in zip(got, want):
        np.testing.assert_array_equal(x.numpy(), np.asarray(y).reshape(
            x.shape))
    *emu, _stats = emulate_e1(*(a.numpy() for a in args),
                              e1_plan(G, K, 1000), np.random.default_rng(1))
    for x, y in zip(emu, got):
        np.testing.assert_array_equal(x, y.numpy())


def test_e2_matches_jax_interpret():
    rng = np.random.default_rng(8)
    G, rows, rows_p, ORP = 128, 96, 128, 128
    gval = (rng.random((rows, G)) < rng.random(G)).astype(np.uint8)
    gran = rng.integers(0, 1 << 16, size=(rows, G)).astype(np.int32)
    granT = np.zeros((G, rows_p), np.int32)
    gvalT = np.zeros((G, rows_p), np.uint8)
    granT[:, :rows], gvalT[:, :rows] = gran.T, gval.T
    want = np.asarray(pe.e2_compact(granT, gvalT, G=G, rows_p=rows_p,
                                    ORP=ORP, interpret=True))
    got = e2_compact(torch.from_numpy(gran), torch.from_numpy(gval),
                     ORP=ORP).numpy()
    n = gval.astype(bool).sum(0)
    mask = np.arange(ORP)[None, :] < n[:, None]
    # the TPU kernel leaves the words past the counts unwritten
    np.testing.assert_array_equal(got[mask], want[mask])
    assert not got[~mask].any()
    emu = emulate_e2(gran, gval, ORP, e2_plan(G, rows, ORP, 1000),
                     np.random.default_rng(2))
    np.testing.assert_array_equal(emu, got)

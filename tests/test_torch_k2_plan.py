"""The launch plans of K2 (``ops.k2_compose.k2_plan``) and of K1's main
scan (``ops.k1_main.k1_main_plan``), their kernels' steps in numpy, and
their edge cases against the JAX package, on the CPU.

On the card K2 is one launch: blocks take tiles of consecutive lanes by a
ticket, compose each tile's maps in shared memory over the HP + 1 entry
classes (a thread a sub-tile and class, then a prefix-doubling scan), chain
the tiles by a decoupled look-back over 32 predecessors a step, and walk
each sub-tile from its entry.  Here, over G 1-16,640, HP 1-128 and 132 and
114 SMs: the tiles cover every lane once, no sub-tile is empty and a block
walks all of its sub-tiles at once, the shared memory is the kernel's
layout and stays under 48 KB; and the kernel's steps, emulated in numpy at
the plan's geometry (look-back windows included), give the plain version's
entries and composite map, values past HP and a start past HP included.

``k1_main`` walks a lane a thread on the step table, by the team body's
segments: the plan's block of 128 threads (the fastest on the card) holds
the step table (NS 1-8) without opting in past 48 KB, and no lane ends in
part of a segment; the walk, emulated in
numpy (main_fast for whole segments below the limit, the limit's segment
row by row, zero cells past it), equals the plain version on
``probes.streams.K1_MAIN_CASES``, and the plain version equals the JAX
``k1_scan2(discover=False)`` (interpret mode; the eight-chunk case only
with RUN_SLOW=1).  ``probes.streams.K2_CASES`` hold the plain K2 against
the lane-by-lane definition and the JAX ``k2_compose`` (interpret mode).
Tolerance: bit-exact.
"""

import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from huffmandecoderongpus_tpu.ops import pallas_widescan as jws
from huffmandecoderongpus_tpu_torch.ops import _build, k1_main, k2_compose
from huffmandecoderongpus_tpu_torch.ops.k1_main import k1_main_plan
from huffmandecoderongpus_tpu_torch.ops.k2_compose import k2_plan
from huffmandecoderongpus_tpu_torch.probes import streams as ps

SMS = (132, 114)
K2_GS = (1, 7, 100, 255, 256, 257, 300, 1000, 4096, 8192, 8200, 16384,
         16640)
K2_HPS = (1, 2, 3, 9, 16, 24, 63, 64, 65, 127, 128)


def _walk(ex, start):
    """The definition: (entries, exit) of lane-by-lane composition."""
    HP, G = ex.shape
    out = np.empty(G, dtype=np.int64)
    e = start
    for lane in range(G):
        out[lane] = e
        e = int(ex[e, lane]) if e < HP else 0
    return out, e


@pytest.mark.parametrize("HP", K2_HPS)
def test_k2_plan_tiles(HP):
    NC = HP + 1
    for G, sms in itertools.product(K2_GS, SMS):
        p = k2_plan(G, HP, sms)
        tile, sub, threads = p["tile"], p["sub"], p["threads"]
        S = threads // NC  # sub-tiles a block walks at once
        assert S >= 1 and threads % 32 == 0 and threads <= 1024
        assert tile % 16 == 0 and sub == -(-tile // S)
        assert p["tiles"] == -(-G // tile)  # every lane in one tile
        assert (p["tiles"] - 1) * tile < G <= p["tiles"] * tile
        for TLt in {tile, G - (p["tiles"] - 1) * tile}:
            n = -(-TLt // sub)
            assert 1 <= n <= S and (n - 1) * sub < TLt  # none empty
        # the kernel's layout: rows, entries, two sub-tile and two window
        # buffers, the composite, each 16-byte aligned
        up = lambda n: -(-n // 16) * 16  # noqa: E731
        assert p["shared"] == (up(HP * tile) + 4 * tile + 2 * up(S * NC)
                               + 2 * up(32 * NC) + up(NC))
        assert p["shared"] <= 48 * 1024
        per_sm = min(_build.SM_THREADS // threads,
                     _build.SM_SHARED // (p["shared"]
                                          + _build.BLOCK_RESERVED))
        assert p["per_sm"] == per_sm
        assert p["waves"] == -(-p["tiles"] // (sms * per_sm))
    with pytest.raises(ValueError):
        k2_plan(100, 129)
    with pytest.raises(ValueError):
        k2_plan(0, 9)


def test_k2_lookback_states_bounded(monkeypatch):
    # the look-back's state is kept for the MAX_STREAMS streams used last;
    # a stream used again keeps its own, and grows only past its tiles
    monkeypatch.setattr(k2_compose, "_states", type(k2_compose._states)())
    cpu = torch.device("cpu")
    first, cap = k2_compose._lookback_state(cpu, 1, 1)
    assert cap == k2_compose.STATE_TILES
    assert first.shape == (k2_compose._state_words(cap),)
    assert not first.any()
    for stream in range(2, 3 * k2_compose.MAX_STREAMS):
        k2_compose._lookback_state(cpu, stream, 1)
        assert k2_compose._lookback_state(cpu, 1, cap)[0] is first
        assert len(k2_compose._states) <= k2_compose.MAX_STREAMS
    assert (None, 1) in k2_compose._states
    grown, cap2 = k2_compose._lookback_state(cpu, 1, cap + 1)
    assert grown is not first and cap2 == 2 * (cap + 1)
    assert k2_compose._lookback_state(cpu, 1, 1)[0] is grown


def _k2_emulated(ex, start, p, seen=None):
    """K2's kernel (``csrc/k2_compose.cu``) step by step in numpy, tiles in
    ticket order: each tile's sub-tile maps over the HP + 1 classes, their
    inclusive scan, the look-back over windows of 32 predecessors
    (aggregates up to the nearest inclusive map, composed farthest first),
    the sub-tile walks from each sub-tile's entry, and tot.  Which
    predecessors' inclusive maps a look-back sees depends on the card's
    timing: tile 0's always, another's where ``seen(j)`` (default none)."""
    HP, G = ex.shape
    NC, tile, sub = HP + 1, p["tile"], p["sub"]
    cls = lambda v: np.minimum(v, HP)  # noqa: E731

    def compose(b, a):  # b after a
        return b[cls(a)]

    def lane(e, g):
        return np.where(e < HP, ex[np.minimum(e, HP - 1), g], 0)

    agg, inc = [], []
    entry = np.empty(G, dtype=np.int64)
    tot = None
    for t in range(p["tiles"]):
        g0 = t * tile
        TLt = min(tile, G - g0)
        S = -(-TLt // sub)
        maps = []
        for s in range(S):
            v = np.arange(NC)
            for g in range(g0 + s * sub, g0 + min(s * sub + sub, TLt)):
                v = lane(v, g)
            maps.append(v)
        pref = [maps[0]]
        for m in maps[1:]:
            pref.append(compose(m, pref[-1]))
        a = pref[-1]
        agg.append(a)
        if t == 0:
            inc.append(a)
            x = start
        else:
            hi, acc = t - 1, None
            while True:
                js = list(range(hi, max(hi - 32, -1), -1))
                k = next((i for i, j in enumerate(js)
                          if j == 0 or (seen and seen(j))), None)
                n = len(js) if k is None else k + 1
                win = [inc[js[n - 1]] if k is not None else agg[js[n - 1]]]
                win += [agg[j] for j in reversed(js[:n - 1])]
                w = win[0]
                for m in win[1:]:
                    w = compose(m, w)
                acc = w if acc is None else compose(acc, w)
                hi -= n
                if k is not None:
                    break
            inc.append(compose(a, acc))
            x = int(acc[cls(start)])
        for s in range(S):
            v = x if s == 0 else int(pref[s - 1][cls(x)])
            for g in range(g0 + s * sub, g0 + min(s * sub + sub, TLt)):
                entry[g] = v
                v = int(lane(np.array(v), g))
        tot = inc[-1][cls(np.arange(128))]
    return entry, tot


@pytest.mark.parametrize("case", ps.K2_CASES)
def test_k2_kernel_emulated(case):
    G, HP, start, _values = case
    ex = ps.k2_exmap(case, "cpu")
    want_e, want_t = k2_compose.k2_compose_ref(ex, start)
    rng = np.random.default_rng(G)
    for sms, seen in itertools.product(SMS, (None, lambda j: rng.random()
                                             < 0.3)):
        entry, tot = _k2_emulated(ex.numpy(), start, k2_plan(G, HP, sms),
                                  seen)
        np.testing.assert_array_equal(entry, want_e.numpy())
        np.testing.assert_array_equal(tot, want_t.numpy())


def _jax_k2(ex, start):
    """The JAX k2_compose (interpret mode) on (HP, G) maps, in the port's
    layouts, or None where G has no NG >= 8 groups of Rg lanes."""
    HP, G = ex.shape
    NG = next((n for n in range(8, G + 1) if G % n == 0 and G // n <= 256),
              None)
    if NG is None:
        return None
    Rg = G // NG
    ex3 = jnp.pad(jnp.asarray(ex).T.reshape(NG, Rg, HP).transpose(1, 0, 2),
                  ((0, 0), (0, 0), (0, 128 - HP)))
    ent3, tot = jws.k2_compose(ex3, jnp.full((1, 1), start, jnp.int32),
                               Rg=Rg, NG=NG, interpret=True)
    return (np.asarray(ent3[:, :, 0].T.reshape(G)).astype(np.int64),
            np.asarray(tot).reshape(-1))


@pytest.mark.parametrize("case", ps.K2_CASES)
def test_k2_cases_match_jax(case):
    G, HP, start, values = case
    ex = ps.k2_exmap(case, "cpu")
    assert ex.shape == (HP, G) and ex.dtype == torch.int32
    if values == "past":
        assert int(ex.max()) >= HP and start >= HP
    entry, tot = k2_compose.k2_compose(ex, start)  # the plain version
    want_e, exit_ = _walk(ex.numpy(), start)
    np.testing.assert_array_equal(entry.numpy(), want_e)
    assert entry.dtype == torch.int32 and tot.dtype == torch.uint8
    assert int(tot[start]) == exit_
    jax_out = _jax_k2(ex.numpy(), start)
    if jax_out is not None:
        np.testing.assert_array_equal(entry.numpy(), jax_out[0])
        np.testing.assert_array_equal(tot.numpy(), jax_out[1])


# ---- k1_main ---------------------------------------------------------------

K1_GS = (1, 31, 32, 64, 100, 1024, 4096, 8448, 11264, 16384)
MDS = (2, 3, 4, 5, 6, 7, 8)


def _seg(md):
    unroll = 4 * md
    return unroll * max(1, 32 // unroll)


@pytest.mark.parametrize("md", MDS)
def test_k1_main_plan(md):
    SEG = _seg(md)
    for G, NS, sms in itertools.product(K1_GS, range(1, 9), SMS):
        steps_p = np.lcm(4 * md, 32) * 7  # the indexed SEG divides it
        p = k1_main_plan(G, md, NS, steps_p, sms)
        T = p["threads"]
        assert T == 128  # the fastest on the card (PERF.md)
        assert steps_p % SEG == 0
        assert p["blocks"] == -(-G // T) and (p["blocks"] - 1) * T < G
        assert p["shared"] == NS * 128 * 16 <= 16 * 1024  # no opt-in
        per_sm = min(32, _build.SM_THREADS // T,
                     _build.SM_SHARED // (p["shared"]
                                          + _build.BLOCK_RESERVED))
        assert p["per_sm"] == per_sm
        assert p["waves"] == -(-p["blocks"] // (sms * per_sm))
    for bad in ((1024, md, 0, 96), (1024, md, 9, 96), (0, md, 1, 96),
                (1024, md, 1, SEG + 4 * md if SEG > 4 * md else SEG + 1)):
        with pytest.raises(ValueError):
            k1_main_plan(*bad)
    with pytest.raises(ValueError):
        k1_main_plan(1024, 1, 1, 96)


def test_k1_main_plan_cases():
    # the indexed streams of chip_smoke.py: (a) at 512 symbols a block has
    # 11,264 lanes, 88 blocks of 128 on 132 SMs (176 of 64 would cover
    # them, and ran 2 % slower); (b) at 1024, 8,192 lanes of md 6; (i) at
    # 512, 1,024 lanes
    a = k1_main_plan(11264, 2, 1, 2720, 132)
    assert (a["threads"], a["blocks"], a["waves"]) == (128, 88, 1)
    b = k1_main_plan(8192, 6, 2, 7488, 132)
    assert (b["blocks"], b["shared"]) == (64, 4096)
    i = k1_main_plan(1024, 3, 1, 1920, 114)
    assert (i["blocks"], i["waves"], i["sm_count"]) == (8, 1, 114)


def _step_table(tab, NS, C0, C1):
    """The kernel's step table (``widescan.cuh`` ``stage_step_table``) in
    numpy: entry state * 4 + chunk (post state << 4 | emit << 14 | pos <<
    15 | symbol << 16)."""
    i = np.arange(NS * 128 * 4)
    s, b0, b1 = i >> 2, i & 1, (i >> 1) & 1
    w = np.asarray(tab, dtype=np.int64)[b0 * NS + (s >> 7), s & 127]
    e = ((w & 0xFFFFFFFF) >> (16 * b1)) & 0xFFFF
    rc = np.where(b1 > 0, C1, C0)
    if NS > 1:
        emit, pos = (e >> 15) & 1, e & 1
        sym = np.where(emit > 0, (e >> 1) & 0xFF, 0)
        node = np.where(emit > 0, (1 - pos) * rc, e & 0x7FFF)
    else:
        emit, node, sym = (e >> 7) & 1, e & 127, e >> 8
        pos = np.where(node == 0, emit, 0)
    return node << 4 | emit << 14 | pos << 15 | sym << 16


def _k1_main_emulated(wmat, tab, lim, *, steps_p, md, C0, C1, NS):
    """``k1_main``'s walk in numpy, all lanes at once: segments of the team
    body's SEG, each segment's bits from two words of the word matrix (0
    past it), a step-table lookup a 2-bit chunk (state as a byte offset),
    entry 0 for a chunk at or past the lane's limit, zero cells from the
    first segment at or past it; cell-packed as the kernel writes them."""
    SEG = _seg(md)
    step = _step_table(tab, NS, C0, C1)
    w = np.asarray(wmat, dtype=np.int64) & 0xFFFFFFFF
    steps_w, G = w.shape
    lim = np.asarray(lim, dtype=np.int64)
    cells_seg = SEG // (4 * md)
    sym = np.zeros((steps_p // (4 * md), G), dtype=np.int64)
    val = np.zeros_like(sym)
    node = np.zeros(G, dtype=np.int64)
    for seg in range(steps_p // SEG):
        base = seg * SEG
        wb = base & ~31
        lo = w[wb >> 5] if wb >> 5 < steps_w else 0
        hi = w[(wb >> 5) + 1] if (wb >> 5) + 1 < steps_w else 0
        bits = ((lo | (hi << 32)) >> (base - wb)) & 0xFFFFFFFF
        live = lim > base
        for cc in range(cells_seg):
            cacc = np.zeros(G, dtype=np.int64)
            nacc = np.zeros(G, dtype=np.int64)
            for k in range(2 * md):
                i = cc * 2 * md + k
                jbit = base + 2 * i
                chunk4 = ((bits >> (2 * i)) & 3) << 2
                e = np.where(lim > jbit, step[(node | chunk4) >> 2], 0)
                node = (e & 0x3FF0) * live + node * ~live
                em = ((e >> 14) & 1) * live
                sl = (2 * k + ((e >> 15) & 1)) // md
                cacc |= (em * ((e >> 16) & 0xFF)) << (8 * sl)
                nacc |= em << sl
            sym[seg * cells_seg + cc] = cacc
            val[seg * cells_seg + cc] = nacc
    return (sym.astype(np.uint32).view(np.int32), val.astype(np.uint8))


@pytest.mark.parametrize("case", ps.K1_MAIN_CASES)
def test_k1_main_walk_emulated(case):
    (wmat, tab, lim), kw, _hf = ps.k1_main_case(case, "cpu")
    assert kw["steps_p"] % _seg(kw["md"]) == 0
    sym, val = _k1_main_emulated(wmat.numpy(), tab.numpy(), lim.numpy(),
                                 **kw)
    want = k1_main.k1_main_ref(wmat, tab, lim, **kw)
    np.testing.assert_array_equal(sym, want[0].numpy())
    np.testing.assert_array_equal(val, want[1].numpy())


def test_k1_main_cases_stage():
    seen = {}
    for case in ps.K1_MAIN_CASES:
        (wmat, tab, lim), kw, hf = ps.k1_main_case(case, "cpu")
        seen[case] = (wmat.shape[1], kw, lim)
        assert tab.shape == (2 * kw["NS"], 128)
    G, kw, lim = seen["full"]
    # every block ends on the last bit of its lane, and pad lanes follow
    assert int(lim.max()) == kw["steps_p"] and int((lim <= 0).sum()) > 0
    assert seen["full-g1"][0] == 1 and int(seen["full-g1"][2][0]) == \
        kw["steps_p"]
    for case, md, SEG in (("md3", 3, 96), ("md5", 5, 160), ("md7", 7, 224)):
        kw = seen[case][1]
        assert kw["md"] == md and kw["steps_p"] % SEG == 0
    assert seen["ns2"][1]["NS"] == 2 and seen["ns8"][1]["NS"] == 8
    assert seen["text-512"][1]["md"] == 2


def test_spread_table_decodes_the_same():
    # the relabelled eight-chunk table is the same decoder
    (wmat, tab, lim), kw, _ = ps.k1_main_case("ns2", "cpu")
    (_w, tab8, _l), kw8, _ = ps.k1_main_case("ns8", "cpu")
    for g, w in zip(k1_main.k1_main_ref(wmat, tab, lim, **kw),
                    k1_main.k1_main_ref(wmat, tab8, lim, **kw8)):
        assert torch.equal(g, w)


def _jax_k1_main(wmat, tab, lim, kw):
    """The JAX k1_scan2(discover=False) (interpret mode): (sym, val)."""
    steps_w, G = wmat.shape
    R = G // 128
    steps_p, md = kw["steps_p"], kw["md"]
    sym, val, *_ = jws.k1_scan2(
        jnp.asarray(wmat.reshape(steps_w, R, 128)), jnp.asarray(tab),
        jnp.asarray(lim.reshape(R, 128)), B=steps_p, H=2, G=G,
        steps=steps_p, steps_p=steps_p, SEG=int(np.lcm(4 * md, 32)),
        UNROLL=4 * md, md=md, C0=kw["C0"], C1=kw["C1"], NS=kw["NS"],
        RB=min(R, 32), discover=False, interpret=True)
    return [np.asarray(o).reshape(-1, G) for o in (sym, val)]


#: the one case over 10 s in interpret mode (the eight-chunk table)
K1_MAIN_SLOW = "ns8"


@pytest.mark.parametrize("case", [
    pytest.param(c, marks=pytest.mark.interpret if c == K1_MAIN_SLOW else ())
    for c in ps.K1_MAIN_CASES])
def test_k1_main_cases_match_jax(case):
    (wmat, tab, lim), kw, _hf = ps.k1_main_case(case, "cpu")
    got = k1_main.k1_main_ref(wmat, tab, lim, **kw)
    # the wrapper takes its plain version for CPU tensors
    for g, w in zip(k1_main.k1_main(wmat, tab, lim, **kw), got):
        assert torch.equal(g, w)
    if case == "full-g1":  # lane 0 of the whole staging, which JAX takes
        (wmat, tab, lim), kw, _hf = ps.k1_main_case("full", "cpu")
    want = _jax_k1_main(wmat.numpy(), tab.numpy(), lim.numpy(), kw)
    G = got[0].shape[1]
    for name, g, w in zip(("sym", "val"), got, want):
        np.testing.assert_array_equal(g.numpy(),
                                      w[:, :G].astype(g.numpy().dtype),
                                      err_msg=name)

"""K3's card design (md >= 2: ``k3_fix2`` and the batch's ``k3_fix2_c01``),
emulated on the CPU.

On the card both kernels run one lane body, ``k3_fix2_lane``
(``csrc/widescan.cuh``), a thread a lane: the step table of
``stage_step_table`` in shared memory (the batch's the compact table of its
block's stream, which needs no root children), the state carried as the
next lookup's byte offset (lookup, one LOP3, lookup), a mask and the root
child of an odd entry taken from the cell and the entry alone, the lane's
words through a 64-bit window with the next word loaded a word ahead, and
every cell below the one that holds ``cut_slot`` stored whole, that one
read when the lane starts and stored spliced.  Here:

- a numpy emulation of that walk equals ``k3_fix2_ref`` and
  ``k3_fix2_c01_ref`` on every ``probes.streams.K3_CASES`` case with every
  old cell the lane stores poisoned but its cut cell, reads no old cell but
  that one, and uses no word in the cell that loads it;
- the cases stage with the edge each is there for (md 2-8, NS 1, 2 and 8,
  odd entries and entries on a word's last bit, cuts on a cell boundary,
  mid-cell and past the last segment, lanes with cut 0, G = 200 for
  ``k3_fix2``, two trees in adjacent blocks for ``k3_fix2_c01``);
- the plain versions equal the JAX ``k3_fix2`` on them (its Pallas kernel
  in interpret mode; the cheap case in the default run).

Tolerance: bit-exact.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from huffmandecoderongpus_tpu.ops import pallas_batch as jpb
from huffmandecoderongpus_tpu.ops import pallas_widescan as jws
from huffmandecoderongpus_tpu_torch.ops import k3_fix2, k3_fix2_c01
from huffmandecoderongpus_tpu_torch.probes import streams as ps
from torch_streams import as_numpy

STEP_NODE = 0x3FF0
CELL = 4
#: the streams' lanes of one stream-map entry
BLOCK = 128


def _step_table(tab, NS, C0, C1):
    """``stage_step_table`` in numpy: entry state * 4 + chunk (post state
    << 4 | emit << 14 | pos << 15 | symbol << 16)."""
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


def _lane_tables(kernel, inputs, kw):
    """(steps, which, C0, C1): the step tables the kernel's blocks stage
    (n, entries), the one each lane walks, and each lane's root
    children."""
    tab = inputs[1].numpy()
    G = inputs[0].shape[1]
    if kernel == "k3_fix2":
        steps = _step_table(tab, kw["NS"], kw["C0"], kw["C1"])[None]
        return (steps, np.zeros(G, dtype=np.int64),
                np.full(G, kw["C0"]), np.full(G, kw["C1"]))
    c01, bstream = (t.numpy().astype(np.int64) for t in inputs[7:9])
    steps = np.stack([_step_table(t, 1, 0, 0)
                      for t in tab.reshape(-1, 2, 128)])
    rc = c01 & 0xFFFFFFFF
    return steps, np.repeat(bstream, BLOCK)[:G], rc & 0xFFFF, rc >> 16


def _k3_emulated(kernel, inputs, kw):
    """``k3_fix2_lane`` in numpy, every lane at once.  Returns (sym, val,
    reads): reads[g] the old cells lane g read."""
    wmat, _tab, ent, cut, cs, sym, val = (t.numpy() for t in inputs[:7])
    steps, which, C0, C1 = _lane_tables(kernel, inputs, kw)
    md, SEG, steps_p = kw["md"], kw["SEG"], kw["steps_p"]
    BITS = CELL * md
    w = np.asarray(wmat, dtype=np.int64).astype(np.uint64) & 0xFFFFFFFF
    steps_w, G = w.shape
    sym = np.asarray(sym, dtype=np.int64).copy() & 0xFFFFFFFF
    val = np.asarray(val, dtype=np.int64).copy()
    ent, cut, cs = (np.asarray(a, dtype=np.int64) for a in (ent, cut, cs))
    nseg = np.minimum((cut + SEG - 1) // SEG, steps_p // SEG)
    nc = np.where(cut > 0, np.minimum(nseg * (SEG // BITS),
                                      (cs + CELL - 1) // CELL), 0)
    spliced = (cs % CELL != 0) & (cs // CELL < nc) & (nc > 0)
    reads = [[] for _ in range(G)]
    lanes = np.arange(G)
    for g in lanes[spliced]:
        reads[g].append(int(nc[g] - 1))
    cut_cell = np.maximum(nc - 1, 0)
    old_s, old_v = sym[cut_cell, lanes], val[cut_cell, lanes]

    loaded = {}  # word -> the cell in which its load was issued (-1: start)

    def word(j, c):
        loaded[j] = c
        return w[j] if j < steps_w else np.zeros(G, dtype=np.uint64)

    win = word(0, -1) | word(1, -1) << np.uint64(32)
    ahead, ahead_j, wi = word(2, -1), 2, 0
    bits = (win & 0xFFFFFFFF).astype(np.int64)
    off = (bits & 3) << 2
    c0, c1 = C0 << 4, C1 << 4
    for c in range(int(nc.max(initial=0))):
        nb = (c + 1) * BITS
        if nb >> 5 != wi:  # the window moves on a word: ahead is used now
            assert loaded[ahead_j] < c, "a word used in the cell loading it"
            win = (win >> np.uint64(32)) | ahead << np.uint64(32)
            wi += 1
            ahead, ahead_j = word(wi + 2, c), wi + 2
        nxt = ((win >> np.uint64(nb & 31)) & 0xFFFFFFFF).astype(np.int64)
        rel = ent - c * BITS
        cacc = np.zeros(G, dtype=np.int64)
        nacc = np.zeros(G, dtype=np.int64)
        for k in range(2 * md):
            e = steps[which, off >> 2]
            on = 2 * k >= rel
            rc = np.where((bits >> (2 * k + 1)) & 1, c1, c0)
            root = np.where(rel == 2 * k + 1, rc, 0)
            nx = bits >> (2 * k + 2) if k + 1 < 2 * md else nxt
            off = (e & np.where(on, STEP_NODE, 0)) | root | ((nx & 3) << 2)
            em = np.where(on, (e >> 14) & 1, 0)
            sl = np.where((e >> 15) & 1, (2 * k + 1) // md, (2 * k) // md)
            cacc |= (em * ((e >> 16) & 0xFF)) << (8 * sl)
            nacc |= em << sl
        mine = c < nc
        part = mine & spliced & (c == nc - 1)
        whole = mine & ~part
        sym[c, whole], val[c, whole] = cacc[whole], nacc[whole]
        kk = cs % CELL
        sm, vm = (1 << (8 * kk)) - 1, (1 << kk) - 1
        sym[c, part] = ((cacc & sm) | (old_s & ~sm & 0xFFFFFFFF))[part]
        val[c, part] = ((nacc & vm) | (old_v & ~vm))[part]
        bits = nxt
    return sym, val, reads, nc, spliced


def _plain(kernel, inputs, kw):
    mod = k3_fix2 if kernel == "k3_fix2" else k3_fix2_c01
    ins = list(inputs)
    ins[5], ins[6] = ins[5].clone(), ins[6].clone()
    return getattr(mod, kernel + "_ref")(*ins, **kw)


@pytest.mark.parametrize("case", ps.K3_CASES)
def test_k3_emulation_matches_plain(case):
    kernel, inputs, kw, _hfs = ps.k3_case(case, "cpu")
    want_s, want_v = _plain(kernel, inputs, kw)
    _s, _v, _r, nc, spliced = _k3_emulated(kernel, inputs, kw)
    # the old cells poisoned but for each lane's cut cell: what the kernel
    # stores whole must not depend on them
    sym, val = inputs[5].numpy(), inputs[6].numpy()
    rng = np.random.default_rng(7)
    cells, G = sym.shape
    fixed = np.arange(cells)[:, None] < nc[None, :]
    keep = np.zeros(sym.shape, dtype=bool)
    keep[nc[spliced] - 1, np.nonzero(spliced)[0]] = True
    poison = fixed & ~keep
    s0 = np.where(poison, rng.integers(-2**31, 2**31, sym.shape), sym)
    v0 = np.where(poison, rng.integers(0, 16, sym.shape), val)
    ins = list(inputs)
    ins[5] = torch.from_numpy(s0.astype(np.int32))
    ins[6] = torch.from_numpy(v0.astype(np.uint8))
    got_s, got_v, reads, _nc, _sp = _k3_emulated(kernel, ins, kw)
    np.testing.assert_array_equal(got_s, want_s.numpy().astype(np.int64)
                                  & 0xFFFFFFFF)
    np.testing.assert_array_equal(got_v, want_v.numpy())
    cs = inputs[4].numpy()
    for g, r in enumerate(reads):
        assert r == ([int(cs[g] // CELL)] if spliced[g] else []), g
    assert poison.sum() > 0
    if ps.K3_CUTS.get(case) == "mid":
        assert spliced.sum() > 0.8 * (nc > 0).sum()
    if ps.K3_CUTS.get(case) in ("cell", "full"):
        assert not spliced.any()


def test_k3_cases_stage():
    # every case stages at its named shape, and the edge it is there for
    # shows in its inputs
    seen = {}
    for case in ps.K3_CASES:
        kernel, inputs, kw, hfs = ps.k3_case(case, "cpu")
        wmat, tab, ent, cut, cs, sym, val = inputs[:7]
        G = wmat.shape[1]
        assert kernel == ("k3_fix2_c01" if case.startswith("batch")
                          else "k3_fix2")
        assert sym.shape == (kw["steps_p"] // kw["md"] // CELL, G)
        assert kw["SEG"] % (CELL * kw["md"]) == 0 and kw["SEG"] <= 32
        e, c, s = (t.numpy().astype(np.int64) for t in (ent, cut, cs))
        fixed = c > 0
        # cut_slot is the first md-slot at or past the cut (fix_rows)
        np.testing.assert_array_equal(s[fixed], -(-c[fixed] // kw["md"]))
        assert (s[~fixed] == 0).all() and (~fixed).any()
        assert (e[fixed] % 2 == 1).any()  # odd entries
        seen[case] = (kernel, G, kw, e[fixed], s[fixed], c[fixed], inputs)
    mds = {seen[c][2]["md"] for c in ps.K3_CASES}
    assert mds == set(range(2, 9))
    assert {seen[c][2].get("NS", 1) for c in ps.K3_CASES} == {1, 2, 8}
    assert seen["md3-g200"][1] == 200
    for case, how in ps.K3_CUTS.items():
        _k, _G, kw, e, s, c, _i = seen[case]
        assert np.isin([31, 63], e).all()  # entries on a word's last bit
        if how == "cell":
            assert (s % CELL == 0).all()
        elif how == "mid":
            assert (s % CELL != 0).all()
        else:  # past the last segment
            assert (c > kw["steps_p"]).all()
    # the batch: two trees, in adjacent 128-lane blocks
    for case in ("batch-pair", "batch-mid"):
        _k, G, _kw, _e, _s, _c, inputs = seen[case]
        tabs, c01, bstream = inputs[1], inputs[7], inputs[8]
        assert G % BLOCK == 0 and bstream.shape == (G // BLOCK,)
        b = bstream.numpy()
        edge = np.nonzero(b[1:] != b[:-1])[0]
        assert edge.size == 1
        t = tabs.numpy().reshape(-1, 2, 128)
        assert not np.array_equal(t[b[edge[0]]], t[b[edge[0] + 1]])
        rc = c01.numpy().reshape(-1, BLOCK)
        assert (rc == rc[:, :1]).all()


def _jax_k3(kernel, inputs, kw, hfs):
    """The JAX k3_fix2 (interpret mode) on a K3 case, in the port's layout;
    lanes padded to a multiple of 128 with cut 0, which JAX leaves alone."""
    wmat, tab, ent, cut, cs, sym, val = (t.numpy() for t in inputs[:7])
    G = wmat.shape[1]
    Gp = -(-G // 128) * 128

    def pad(a):
        return np.pad(a, [(0, 0)] * (a.ndim - 1) + [(0, Gp - G)])

    wmat, ent, cut, cs, sym, val = (pad(a) for a in (wmat, ent, cut, cs,
                                                     sym, val))
    R = Gp // 128
    md = kw["md"]
    args = dict(G=Gp, steps_p=kw["steps_p"], SEG=kw["SEG"], UNROLL=4 * md,
                md=md, interpret=True)
    if kernel == "k3_fix2":
        c01, extra = None, dict(C0=kw["C0"], C1=kw["C1"], NS=kw["NS"],
                                RB=min(R, 32))
    else:
        st = as_numpy(jpb.stage_batch_inputs(hfs))
        p = st["plan"]
        assert (p["G"], p["steps_p"]) == (Gp, kw["steps_p"])
        tab = st["tabw"]
        c01 = jnp.asarray(np.asarray(st["c01"]).reshape(R, 128))
        extra = dict(C0=0, C1=0, NS=1, RB=p["RB"],
                     tab_bounds=st["tab_bounds"])
    out = jws.k3_fix2(
        jnp.asarray(wmat.reshape(wmat.shape[0], R, 128)), jnp.asarray(tab),
        *(jnp.asarray(a.reshape(R, 128)) for a in (ent, cut, cs)),
        *(jnp.asarray(a.reshape(a.shape[0], R, 128)) for a in (sym, val)),
        c01, **args, **extra)
    return [np.asarray(o).reshape(-1, Gp)[:, :G] for o in out]


K3_CHEAP = "text-512"


@pytest.mark.parametrize("case", [
    pytest.param(c, marks=() if c == K3_CHEAP else pytest.mark.interpret)
    for c in ps.K3_CASES])
def test_k3_cases_match_jax(case):
    kernel, inputs, kw, hfs = ps.k3_case(case, "cpu")
    got = _plain(kernel, inputs, kw)
    # the wrapper takes its plain version for CPU tensors
    mod = k3_fix2 if kernel == "k3_fix2" else k3_fix2_c01
    ins = list(inputs)
    ins[5], ins[6] = ins[5].clone(), ins[6].clone()
    for g, w in zip(getattr(mod, kernel)(*ins, **kw), got):
        assert torch.equal(g, w)
    want = _jax_k3(kernel, inputs, kw, hfs)
    for name, g, w in zip(("sym", "val"), got, want):
        np.testing.assert_array_equal(g.numpy(), w.astype(g.numpy().dtype),
                                      err_msg=name)

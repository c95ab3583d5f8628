"""K1''s and K3''s card design (md = 1), emulated on the CPU.

On the card ``k1_scan`` gives each lane a team of T threads walking a 1-bit
step table in shared memory (``csrc/k1_scan.cu``), under a plan computed in
Python (``ops.k1_scan.k1_scan_plan``) that its launcher refuses to change,
and ``k3_fix`` walks the same table a thread a lane, storing every cell
below the one that holds ``cut_slot`` without reading it
(``csrc/k3_fix.cu``).  Here:

- the step table (``widescan.cuh`` ``stage_step_table1``, mirrored in
  numpy) equals ``pair_entry``/``e1_fields`` for every state and bit, at NS
  1 (the compact layout, up to 128 states) and NS 2-8 (the wide one; a
  255-state table relabelled over more chunks), and entry 0 is the root
  with no emission; the main chain's 2-bit table (``stage_step_table2``)
  is two such steps a chunk;
- the plan keeps its rules over G 1-16,384, H 2-128, NS 1-8 and lanes of
  64-8,192 bits on 132 and 114 SMs (T, whole blocks, shared bytes, the
  device's SM count), and every plan passes the launcher's check, mirrored
  here, which refuses the plans it is given with any one field changed;
- a numpy emulation of K3''s walk and splice equals ``k3_fix_ref`` on every
  K3' case and reads no old cell but the one holding each lane's cut slot;
- ``probes.streams.K1P_CASES`` (the card tests' and ``chip_smoke.py``'s
  edge cases) stage with the edge each is there for, and the port's plain
  K1' equals the JAX ``k1_scan`` on each (its Pallas kernel in interpret
  mode; the cheap case in the default run).

Tolerance: bit-exact.
"""

import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from huffmandecoderongpus_tpu.ops import pallas_widescan as jws
from huffmandecoderongpus_tpu_torch.ops import _build, k1_scan, k3_fix
from huffmandecoderongpus_tpu_torch.ops.k1_scan import k1_scan_plan
from huffmandecoderongpus_tpu_torch.ops.k1_scan2 import team_words
from huffmandecoderongpus_tpu_torch.ops.pair import e1_fields, pair_entry
from huffmandecoderongpus_tpu_torch.probes import streams as ps

STEP1_NODE, STEP1_EMIT = 0x1FF8, 1 << 15


def _step_table1(tab, NS):
    """``stage_step_table1`` in numpy: entry i is state i // 2 on bit
    i % 2, node << 3 | emit << 15 | sym << 16 (sym zero unless emit)."""
    w = np.asarray(tab, dtype=np.int64).reshape(-1) & 0xFFFFFFFF
    i = np.arange(NS * 256)
    e = (w[i >> 1] >> (16 * (i & 1))) & 0xFFFF
    if NS > 1:
        emit = (e >> 15) & 1
        sym, node = emit * ((e >> 1) & 0xFF), (1 - emit) * (e & 0x7FFF)
    else:
        emit, sym, node = (e >> 7) & 1, e >> 8, e & 127
    return node << 3 | emit << 15 | (emit * sym) << 16


def _step_table2(tab, NS):
    """``csrc/k1_scan.cu`` ``stage_step_table2`` in numpy: entry i is
    state i // 4 on the chunk b0 = i & 1, b1 = (i >> 1) & 1: the post-chunk
    state << 4, emit on b0 << 14, emit on b1 << 15, and the two bits' slot
    symbols at bits 16-23 and 24-31."""
    st1 = _step_table1(tab, NS)
    i = np.arange(NS * 512)
    f = st1[(i >> 2) * 2 + (i & 1)]
    t = st1[((f & STEP1_NODE) >> 3) * 2 + ((i >> 1) & 1)]
    return (((t & STEP1_NODE) >> 3) << 4 | ((f >> 15) & 1) << 14
            | ((t >> 15) & 1) << 15 | (f >> 16) << 16 | (t >> 16) << 24)


def _spread_pair(tab, NS_to, seed=0):
    """The wide pair table ``tab`` (NS, 128) relabelled onto NS_to chunks:
    every state but the root to a distinct state below 128 * NS_to."""
    t = np.asarray(tab, dtype=np.int64).reshape(-1) & 0xFFFFFFFF
    n = t.size
    top = min(128 * NS_to, 1024)
    perm = np.zeros(n, dtype=np.int64)
    perm[1:] = np.random.default_rng(seed).choice(np.arange(1, top),
                                                  size=n - 1, replace=False)
    out = np.zeros(128 * NS_to, dtype=np.int64)
    for s in range(n):
        for b in (0, 1):
            e = (int(t[s]) >> (16 * b)) & 0xFFFF
            if not e & 0x8000:
                e = int(perm[e])
            out[perm[s]] |= e << (16 * b)
    return out.astype(np.uint32).view(np.int32).reshape(NS_to, 128)


def _pair_tables():
    """(NS, table): the 128-state compact table and the 255-state wide one
    spread over 2-8 chunks."""
    (_w, t128, _l), kw128, _c, _hf = ps.k1p_case("ns1-128", "cpu")
    assert kw128["NS"] == 1 and t128.numpy()[0, 127] != 0  # 128 states
    (_w, t255, _l), kw255, _c, _hf = ps.k1p_case("ns2-255", "cpu")
    assert kw255["NS"] == 2
    out = [(1, t128.numpy()), (2, t255.numpy())]
    out += [(ns, _spread_pair(t255.numpy(), ns, ns)) for ns in range(3, 9)]
    return out


@pytest.mark.parametrize("NS,tab", _pair_tables(),
                         ids=[f"ns{k}" for k in range(1, 9)])
def test_step_table1_matches_pair_entries(NS, tab):
    st = _step_table1(tab, NS)
    assert st.size * 4 == k1_scan.step1_bytes(NS) <= 8192
    tabf = torch.from_numpy(np.asarray(tab, dtype=np.int64).reshape(-1)
                            & 0xFFFFFFFF)
    node = torch.arange(NS * 128).repeat_interleave(2)
    bit = torch.arange(2).repeat(NS * 128)
    emit, sym, nxt = e1_fields(pair_entry(tabf, node, bit), NS)
    np.testing.assert_array_equal((st & STEP1_NODE) >> 3, nxt.numpy())
    np.testing.assert_array_equal((st >> 15) & 1, emit.numpy())
    np.testing.assert_array_equal(st >> 16, sym.numpy())
    # the state's byte offset is its index: a step is lookup, LOP3, lookup
    assert ((st & STEP1_NODE) >> 3).max() < NS * 128
    assert not (st & ~(STEP1_NODE | STEP1_EMIT | 0xFF << 16)).any()
    # entry 0 of an invalid row: the root, nothing emitted
    assert (0 & STEP1_NODE, 0 & STEP1_EMIT, 0 >> 16) == (0, 0, 0)


@pytest.mark.parametrize("NS,tab", _pair_tables(),
                         ids=[f"ns{k}" for k in range(1, 9)])
def test_step_table2_is_two_steps(NS, tab):
    # the main chain's 2-bit table: a chunk is two 1-bit steps (pair_entry,
    # e1_fields), both bits' slot symbols in one entry; a second emission
    # in a chunk ends a 1-bit code
    st = _step_table2(tab, NS)
    assert st.size * 4 == k1_scan.step2_bytes(NS) <= 16384
    tabf = torch.from_numpy(np.asarray(tab, dtype=np.int64).reshape(-1)
                            & 0xFFFFFFFF)
    s = torch.arange(NS * 128).repeat_interleave(4)
    b0 = torch.arange(4).repeat(NS * 128) & 1
    b1 = torch.arange(4).repeat(NS * 128) >> 1
    e0, s0, n1 = e1_fields(pair_entry(tabf, s, b0), NS)
    e1, s1, n2 = e1_fields(pair_entry(tabf, n1, b1), NS)
    np.testing.assert_array_equal((st >> 4) & 0x3FF, n2.numpy())
    np.testing.assert_array_equal((st >> 14) & 1, e0.numpy())
    np.testing.assert_array_equal((st >> 15) & 1, e1.numpy())
    np.testing.assert_array_equal((st >> 16) & 0xFF, s0.numpy())
    np.testing.assert_array_equal((st >> 24) & 0xFF, s1.numpy())
    both = (e0 * e1).numpy() > 0
    root = e1_fields(pair_entry(tabf, torch.zeros_like(b1), b1), NS)[0]
    assert (root.numpy()[both] == 1).all()


def _plan_ok(G, H, NS, T, shared):
    """``csrc/k1_scan.cu`` ``k1_scan_plan_ok``, mirrored."""
    if H - 1 > 127 or not 1 <= NS <= 8 or not 4 <= T <= 32 or T & (T - 1):
        return False
    CH = max(H - 1, 1)
    return (G >= 1 and shared % 16 == 0
            and shared >= NS * 3072 + 4 * (128 // T) * team_words(CH, 1, 32)
            and shared <= 227 * 1024)


GS = (1, 37, 512, 4096, 4352, 16384)
HS = (2, 3, 9, 17, 31, 64, 128)
NSS = (1, 2, 8)
#: lane bits: 2 to 256 segments of 32
STEPS = (64, 1024, 2432, 8192)
SMS = (132, 114)


@pytest.mark.parametrize("G,sms", list(itertools.product(GS, SMS)))
def test_k1_scan_plan_rules(G, sms):
    for H, NS, steps_p in itertools.product(HS, NSS, STEPS):
        p = k1_scan_plan(G, H, steps_p, NS, sms)
        CH = max(H - 1, 1)
        T = 4
        while T < 32 and T < CH + 1:
            T *= 2
        if steps_p // 32 >= 32 and G * T / 32 / sms > 16:
            T = 4  # long lanes on a busy grid: the smallest team
        assert p["T"] == T and 32 % T == 0 and p["sm_count"] == sms
        assert p["lanes"] == 128 // T and p["threads"] == 128
        # whole blocks, every lane a team, and no block without one
        assert (p["blocks"] - 1) * 128 < G * T <= p["blocks"] * 128
        assert p["shared"] == (k1_scan.step1_bytes(NS)
                               + k1_scan.step2_bytes(NS) + p["lanes"]
                               * team_words(CH, 1, 32) * 4)
        assert p["shared"] % 16 == 0 and p["shared"] <= 227 * 1024
        per_sm = min(4, 16, (228 * 1024) // (p["shared"] + 1024))
        assert p["per_sm"] == per_sm
        assert p["waves"] == -(-p["blocks"] // (sms * per_sm))
        assert _plan_ok(G, H, NS, p["T"], p["shared"])
        for bad in (dict(T=2), dict(T=12), dict(T=64),
                    dict(shared=p["shared"] - 16),
                    dict(shared=p["shared"] + 8), dict(shared=228 * 1024),
                    dict(G=0), dict(NS=0), dict(NS=9), dict(H=129)):
            args = {**dict(G=G, H=H, NS=NS, T=p["T"], shared=p["shared"]),
                    **bad}
            assert not _plan_ok(**args), bad


def test_k1_scan_plan_refuses_and_takes_the_card():
    for bad in (dict(H=129), dict(NS=0), dict(NS=9), dict(G=0),
                dict(steps_p=48), dict(steps_p=0)):
        args = {**dict(G=512, H=9, steps_p=320, NS=1), **bad}
        with pytest.raises(ValueError):
            k1_scan_plan(**args)
    # CPU tensors plan for the H100's 132 SMs; (c)'s plan is a team of 4,
    # 32 lanes a block in one wave there
    assert _build.sm_count("cpu") == _build.SM_COUNT == 132
    c = k1_scan_plan(16384, 9, 2432, 2)
    assert (c["T"], c["lanes"], c["blocks"], c["waves"]) == (4, 32, 512, 1)
    assert k1_scan_plan(16384, 9, 2432, 2, 60)["waves"] == 3


def _k3_emulated(wmat, tab, ent, cut, cut_slot, sym, val, *, steps_p, NS):
    """``csrc/k3_fix.cu`` in numpy, vectorized over lanes: each lane walks
    the step table from bit ent (entry 0 before it) a cell of 4 bits at a
    time while its cells hold a slot below cut_slot; a cell below the one
    holding cut_slot is stored whole, that one is read and spliced.
    Returns (sym, val, reads): reads[g] the cells of lane g it read."""
    st = _step_table1(tab, NS)
    w = np.asarray(wmat, dtype=np.int64) & 0xFFFFFFFF
    sym = np.asarray(sym, dtype=np.int64).copy() & 0xFFFFFFFF
    val = np.asarray(val, dtype=np.int64).copy()
    ent, cut, cs = (np.asarray(a, dtype=np.int64) for a in (ent, cut,
                                                             cut_slot))
    G = ent.size
    nseg = np.minimum((cut + 31) // 32, steps_p // 32)
    ncell = np.where(cut > 0, np.minimum(nseg * 8, (cs + 3) // 4), 0)
    node = np.zeros(G, dtype=np.int64)
    reads = [[] for _ in range(G)]
    lanes = np.arange(G)
    for c in range(int(ncell.max(initial=0))):
        on = c < ncell
        cacc = np.zeros(G, dtype=np.int64)
        nacc = np.zeros(G, dtype=np.int64)
        for k in range(4):
            jb = 4 * c + k
            word = w[jb >> 5] if jb >> 5 < w.shape[0] else np.zeros(G, int)
            b = (word >> (jb & 31)) & 1
            e = np.where(jb >= ent, st[(node | b << 2) >> 2], 0)
            node = e & STEP1_NODE
            cacc |= (e >> 16) << (8 * k)
            nacc |= ((e >> 15) & 1) << k
        kk = cs - 4 * c
        whole = on & (kk >= 4)
        part = on & (kk < 4)
        sym[c, whole] = cacc[whole]
        val[c, whole] = nacc[whole]
        for g in lanes[part]:
            reads[g].append(c)
            sm, vm = (1 << (8 * kk[g])) - 1, (1 << kk[g]) - 1
            sym[c, g] = (cacc[g] & sm) | (sym[c, g] & ~sm & 0xFFFFFFFF)
            val[c, g] = (nacc[g] & vm) | (val[c, g] & ~vm)
    return sym, val, reads


K3_CASES = [c for c in ps.K1P_CASES if c != "c-small"] + [
    pytest.param("c-small", marks=pytest.mark.interpret)]


@pytest.mark.parametrize("case", K3_CASES)
def test_k3_emulation_matches_plain(case):
    inputs, kw, cuts, _hf = ps.k1p_case(case, "cpu")
    wmat, tab, _lim = inputs
    ent, cut, cut_slot, sym, val = ps.k3p_inputs(inputs, kw, cuts)
    kk = dict(steps_p=kw["steps_p"], SEG=32, md=1, NS=kw["NS"])
    want_s, want_v = k3_fix.k3_fix_ref(wmat, tab, ent, cut, cut_slot,
                                       sym.clone(), val.clone(), **kk)
    # the old cells poisoned but for each lane's cut cell: what the kernel
    # stores whole must not depend on them
    rng = np.random.default_rng(5)
    cs = cut_slot.numpy().astype(np.int64)
    keep = np.zeros(sym.shape, dtype=bool)
    mid = (cut.numpy() > 0) & (cs % 4 != 0) & (cs // 4 < sym.shape[0])
    keep[cs[mid] // 4, np.nonzero(mid)[0]] = True
    nseg = np.minimum((cut.numpy() + 31) // 32, kw["steps_p"] // 32)
    ncell = np.where(cut.numpy() > 0, np.minimum(nseg * 8, (cs + 3) // 4), 0)
    fixed = np.arange(sym.shape[0])[:, None] < ncell[None, :]
    poison = fixed & ~keep
    s0 = np.where(poison, rng.integers(0, 2**32, sym.shape),
                  sym.numpy().astype(np.int64) & 0xFFFFFFFF)
    v0 = np.where(poison, rng.integers(0, 16, sym.shape), val.numpy())
    got_s, got_v, reads = _k3_emulated(wmat.numpy(), tab.numpy(), ent, cut,
                                       cut_slot, s0, v0,
                                       steps_p=kw["steps_p"], NS=kw["NS"])
    np.testing.assert_array_equal(got_s, want_s.numpy().astype(np.int64)
                                  & 0xFFFFFFFF)
    np.testing.assert_array_equal(got_v, want_v.numpy())
    for g, r in enumerate(reads):
        assert r == ([int(cs[g] // 4)] if mid[g] and cs[g] // 4 < ncell[g]
                     else []), g
    if case == "cut-mid":
        assert mid.sum() > 0.8 * (cut.numpy() > 0).sum()
    if case in ("cut-cell", "cut-full"):
        assert not any(reads)
    if case == "cut-full":  # a full replay: every cell of the cut lanes
        assert (ncell[cut.numpy() > 0] == kw["steps_p"] // 4).all()


def _jax_k1(inputs, kw, case):
    """The JAX k1_scan (interpret mode) on a K1P case's tensors; the sliced
    cases run on the whole staging they were cut from and keep their
    lanes."""
    wmat, tab, lim = (t.numpy() for t in inputs)
    if case in ("g1", "g37"):
        (wmat, _t, lim), _kw, _c, _hf = ps.k1p_case("ns2-255", "cpu")
        wmat, lim = wmat.numpy(), lim.numpy()
    steps_w, G = wmat.shape
    R = G // 128
    out = jws.k1_scan(jnp.asarray(wmat.reshape(steps_w, R, 128)),
                      jnp.asarray(tab), jnp.asarray(lim.reshape(R, 128)),
                      B=kw["B"], H=kw["H"], G=G, steps=kw["steps"],
                      steps_p=kw["steps_p"], SEG=32, UNROLL=8, md=1,
                      RB=min(R, 32), interpret=True)
    n = inputs[0].shape[1]
    return [np.asarray(o).reshape(-1, G)[:, :n] for o in out]


K1P_CHEAP = "h1"
#: the cases whose K1' is its own: the cut cases share ns2-255's
K1P_OWN = [c for c in ps.K1P_CASES if not c.startswith("cut-")]


@pytest.mark.parametrize("case", [
    pytest.param(c, marks=() if c == K1P_CHEAP else pytest.mark.interpret)
    for c in K1P_OWN])
def test_k1p_cases_match_jax(case):
    inputs, kw, _cuts, _hf = ps.k1p_case(case, "cpu")
    got = k1_scan.k1_scan_ref(*inputs, **kw)
    # the wrapper takes its plain version for CPU tensors
    for g, w in zip(k1_scan.k1_scan(*inputs, **kw), got):
        assert torch.equal(g, w)
    want = _jax_k1(inputs, kw, case)
    for name, g, w in zip(("sym", "val", "cntmap", "exmap", "mrowmap"), got,
                          want):
        np.testing.assert_array_equal(g.numpy(), w.astype(g.numpy().dtype),
                                      err_msg=name)


def test_k1p_cases_stage():
    # every case stages at its named shape, and the edge it is there for
    # shows in the staging
    seen = {}
    for case in ps.K1P_CASES:
        inputs, kw, cuts, hf = ps.k1p_case(case, "cpu")
        wmat, tab, lim = inputs
        assert kw["md"] == 1 and kw["SEG"] == 32
        assert (cuts is not None) == case.startswith("cut-")
        seen[case] = (lim.shape[0], kw, lim, tab)
        p = k1_scan_plan(lim.shape[0], kw["H"], kw["steps_p"], kw["NS"])
        assert _plan_ok(lim.shape[0], kw["H"], kw["NS"], p["T"], p["shared"])
    assert seen["h1"][1]["H"] == 1
    assert seen["ns1-128"][1]["NS"] == 1 and seen["ns2-255"][1]["NS"] == 2
    assert int(seen["ns1-128"][3][0, 127]) != 0  # 128 states, compact
    fib = seen["fib"][1]
    assert fib["H"] == 31
    p = k1_scan_plan(seen["fib"][0], 31, fib["steps_p"], fib["NS"])
    assert p["T"] == 32  # 30 chains on 31 threads
    assert (seen["g1"][0], seen["g37"][0]) == (1, 37)
    assert int((seen["tail-4096"][2] <= 0).sum()) > 1000
    c = seen["c-small"][1]
    p = k1_scan_plan(ps.C_SMALL_LANES, c["H"], c["steps_p"], c["NS"])
    assert p["T"] == 4 and c["steps_p"] // 32 >= 32  # (c)'s plan
    # the blank run: some chain merges only segments after its start
    inputs, kw, _c, _hf = ps.k1p_case("blank", "cpu")
    mrow = k1_scan.k1_scan_ref(*inputs, **kw)[4][1:int(kw["H"])]
    assert int(mrow[mrow < kw["steps"]].max()) >= 4 * 32

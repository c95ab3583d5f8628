"""The launch plan of the four-kernel K1s (``ops.k1_scan2.k1_plan``) and
their edge cases, on the CPU.

On the card ``k1_scan2`` and ``k1_scan2_c01`` give each lane a team of T
threads of one warp (``csrc/widescan.cuh`` ``k1_team``, the one-shot's K1):
thread 0 walks the main chain, the others the candidate chains, several in
turn where there are more chains than threads.  The plan is computed in
Python for the card's SM count and handed to the kernel, whose launcher
refuses any other.  Here, over md 2-8, trees 2-128 tall and G 512-16,384 on
132 and 114 SMs, with lanes of 256 to 8,192 bits: every chain lies on
exactly one thread of its team and the main chain on thread 0, each leader
is its thread's first chain, T divides a warp, the block's shared memory
holds the step table and every team and stays within what a block may
take, the waves are the grid's blocks over what the card holds at once,
and T follows the rule (a thread a chain, or, for long lanes on a busy
grid, a thread a leader).  The batched K1 builds its step table from each
stream's compact table: its entries do not depend on the root children,
which the kernel reads per lane, and both batch stagings give every
128-lane block one stream's children anyway.  ``probes.streams.K1_CASES``
(the card tests' and ``chip_smoke.py``'s edge cases) stage here, and the
port's plain K1 equals the JAX ``k1_scan2`` on each (its Pallas kernel in
interpret mode; one cheap case in the default run).  Tolerance: bit-exact.
"""

import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from huffmandecoderongpus_tpu.ops import pallas_batch as jpb
from huffmandecoderongpus_tpu.ops import pallas_widescan as jws
from huffmandecoderongpus_tpu_torch.ops import _build, batch, k1_scan2
from huffmandecoderongpus_tpu_torch.ops import k1_scan2_c01, widescan
from huffmandecoderongpus_tpu_torch.ops.k1_scan2 import (
    k1_plan,
    step_bytes,
    team_chains,
    team_words,
)
from huffmandecoderongpus_tpu_torch.probes import streams as ps
from torch_streams import BATCHES, as_numpy, make_batch

GS = (512, 1024, 4096, 16384)
HS = (2, 3, 4, 9, 17, 33, 64, 128)
MDS = (2, 3, 4, 5, 6, 7, 8)
SMS = (132, 114)
#: lane bits: the plan's ~500 symbols a lane at 2-16 bits a symbol
BS = (256, 2048, 8192)


def _seg(md):
    unroll = 4 * md
    return unroll * max(1, 32 // unroll)


def _rule(G, H, md, SEG, steps_p, NS, sms):
    """(T, waves) by the plan's rule, computed apart from it: a thread a
    chain, unless the lane has 32 segments or more and that grid puts more
    than 16 warps on an SM; then a thread a leader."""
    CH = max(H - 1, 1)
    NL = min(md, CH)
    T = next(t for t in (4, 8, 16, 32) if t >= CH + 1 or t == 32)
    if steps_p // SEG >= 32 and G * T / 32 > 16 * sms:
        T = next(t for t in (4, 8, 16, 32) if t >= NL + 1)
    lanes = 128 // T
    shared = step_bytes(NS) + lanes * team_words(CH, NL, SEG // 2) * 4
    per_sm = min(4, 2048 // 128, (228 * 1024) // (shared + 1024))
    return T, -(-(G * T // 128) // (sms * per_sm))


@pytest.mark.parametrize("md", MDS)
@pytest.mark.parametrize("H", HS)
@pytest.mark.parametrize("G", GS)
def test_plan_teams_and_waves(G, H, md):
    CH = max(H - 1, 1)
    NL = min(md, CH)
    SEG = _seg(md)
    for sms, NS, B in itertools.product(SMS, (1, 2, 8), BS):
        steps_p = -(-(B + H) // SEG) * SEG
        p = k1_plan(G, H, md, SEG, steps_p, NS, sms)
        T = p["T"]
        assert T in (4, 8, 16, 32)  # divides a warp
        assert p["lanes"] * T == p["threads"] == 128
        assert p["blocks"] * 128 == G * T  # whole blocks: full warps
        owners = team_chains(T, CH)
        assert owners[0] == []  # thread 0: the main chain alone
        assert sorted(c for cs in owners for c in cs) == list(range(CH))
        assert T >= NL + 1
        assert all(owners[c + 1][0] == c for c in range(NL))
        # the step table, then every team, 16-byte aligned, within a
        # block's limit; the opt-in past 48 KB is the launcher's
        assert p["shared"] % 16 == 0
        assert p["shared"] == step_bytes(NS) + p["lanes"] * 4 * team_words(
            CH, NL, SEG // 2)
        assert p["shared"] <= _build.BLOCK_SHARED_MAX
        assert p["registers"] == 128  # __launch_bounds__(128, 4)
        per_sm = min(4, _build.SM_THREADS // 128,
                     _build.SM_SHARED // (p["shared"]
                                          + _build.BLOCK_RESERVED))
        assert p["per_sm"] == per_sm
        assert p["waves"] == -(-p["blocks"] // (sms * per_sm))
        assert (T, p["waves"]) == _rule(G, H, md, SEG, steps_p, NS, sms)


def test_plan_cases():
    # the streams the rule was measured on (chip_smoke.py's): (a), G 8,192
    # lanes of 103 segments -> a thread a leader, T 4; (b), G 16,384, md 6
    # -> six leaders keep T at 8, two waves; the five-small batch, G 5,120
    # lanes of 10 segments, and (h), G 1,024, 18 tall -> a thread a chain
    a = k1_plan(8192, 9, 2, 32, 3296, 1, 132)
    assert (a["T"], a["waves"]) == (4, 1)
    b = k1_plan(16384, 20, 6, 24, 3672, 2, 132)
    assert (b["T"], b["waves"]) == (8, 2)
    five = k1_plan(5120, 10, 2, 32, 320, 1, 132)
    assert (five["T"], five["waves"]) == (16, 2)
    assert k1_plan(1024, 18, 6, 24, 1896, 2, 132)["T"] == 32
    assert k1_plan(1024, 128, 2, 32, 288, 1, 132)["T"] == 32
    # the same lanes on a card of fewer SMs can tip into the busy regime
    assert k1_plan(3072, 9, 2, 32, 2944, 1, 132)["T"] == 16
    assert k1_plan(3072, 9, 2, 32, 2944, 1, 60)["T"] == 4
    for bad in ((1024, 9, 2, 24, 96, 1),     # not the plan's SEG
                (1024, 9, 1, 32, 96, 1),     # md 1: k1_scan
                (1024, 9, 2, 32, 96, 9),     # past 1023 states
                (1024, 130, 2, 32, 160, 1),  # taller than 128
                (1024, 9, 2, 32, 100, 1),    # steps_p not whole segments
                (100, 9, 2, 32, 96, 1)):     # 100 x 16 threads: no block
        with pytest.raises(ValueError):
            k1_plan(*bad)


def test_plan_follows_the_device():
    assert _build.sm_count("cpu") == _build.SM_COUNT == 132
    assert _build.sm_count(torch.device("cpu")) == 132


def _step_table(tab, NS, C0, C1):
    """The kernel's step table (``widescan.cuh`` ``stage_step_table``) in
    numpy: entry state * 4 + chunk."""
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


@pytest.mark.parametrize("case", BATCHES)
def test_c01_step_table_needs_no_children(case):
    # the batched K1 stages each stream's compact table with C0 = C1 = 0 and
    # reads every lane's children from c01: the compact entries hold their
    # post-chunk states, so the table is the same with the real children
    _raws, hfs = make_batch(case)
    for st in (batch.stage_batch_inputs(hfs, device="cpu"),
               batch.from_jax_batch(as_numpy(jpb.stage_batch_inputs(hfs)),
                                    "cpu")):
        tabs = st["tabs"].numpy().reshape(-1, 2, 128)
        c01 = st["c01"].numpy().astype(np.int64) & 0xFFFFFFFF
        bstream = st["bstream"].numpy()
        for k, tab in enumerate(tabs):
            rc = c01[np.repeat(bstream, 128) == k][0]
            np.testing.assert_array_equal(
                _step_table(tab, 1, 0, 0),
                _step_table(tab, 1, rc & 0xFFFF, rc >> 16))
        # and each 128-lane block carries one stream's children
        blocks = c01.reshape(-1, 128)
        assert (blocks == blocks[:, :1]).all()


def test_wide_step_table_takes_the_children():
    # the wide layout (NS > 1) does bake C0/C1 into its entries: a table of
    # more than one chunk is only ever staged with its stream's own children
    _kernel, (_w, tab, _lim), kw, _hfs = ps.k1_case("alpha-16384", "cpu")
    assert kw["NS"] == 2
    real = _step_table(tab.numpy(), 2, kw["C0"], kw["C1"])
    assert not np.array_equal(real, _step_table(tab.numpy(), 2, 0, 0))


def _jax_k1(kernel, inputs, kw, hfs):
    """The JAX k1_scan2 (interpret mode) on a K1 case, in the port's
    layouts: the same tensors for a single stream, the JAX batch staging
    (which must equal the port's) for the batch."""
    if kernel == "k1_scan2":
        wmat, tab, lim = (t.numpy() for t in inputs)
        steps_w, G = wmat.shape
        R = G // 128
        out = jws.k1_scan2(
            jnp.asarray(wmat.reshape(steps_w, R, 128)), jnp.asarray(tab),
            jnp.asarray(lim.reshape(R, 128)), G=G, UNROLL=4 * kw["md"],
            RB=min(R, 32), interpret=True, **kw)
    else:
        st = as_numpy(jpb.stage_batch_inputs(hfs))
        port = batch.from_jax_batch(st, "cpu")
        wmat = widescan.words_matrix(port["words"],
                                     -(-kw["steps_p"] // 32)).numpy()
        for got, name in zip(inputs, ("wmat", "tabs", "lim", "c01",
                                      "bstream")):
            want = wmat if name == "wmat" else port[name].numpy()
            np.testing.assert_array_equal(got.numpy(), want, err_msg=name)
        p = st["plan"]
        G = p["G"]
        out = jws.k1_scan2(
            jnp.asarray(wmat.reshape(wmat.shape[0], G // 128, 128)),
            jnp.asarray(st["tabw"]), jnp.asarray(st["lim2"]),
            jnp.asarray(st["c01"]), G=G, UNROLL=p["UNROLL"], C0=0, C1=0,
            NS=1, RB=p["RB"], tab_bounds=st["tab_bounds"], interpret=True,
            **kw)
    G = inputs[0].shape[1]
    return [np.asarray(o).reshape(-1, G) for o in out]


K1_CHEAP = "h2"


@pytest.mark.parametrize("case", [
    pytest.param(c, marks=() if c == K1_CHEAP else pytest.mark.interpret)
    for c in ps.K1_CASES])
def test_k1_cases_match_jax(case):
    kernel, inputs, kw, hfs = ps.k1_case(case, "cpu")
    G = inputs[0].shape[1]
    p = k1_plan(G, kw["H"], kw["md"], kw["SEG"], kw["steps_p"],
                kw.get("NS", 1))
    assert G * p["T"] % 128 == 0
    mod = k1_scan2 if kernel == "k1_scan2" else k1_scan2_c01
    got = getattr(mod, kernel + "_ref")(*inputs, **kw)
    # the wrapper takes its plain version for CPU tensors
    for g, w in zip(getattr(mod, kernel)(*inputs, **kw), got):
        assert torch.equal(g, w)
    want = _jax_k1(kernel, inputs, kw, hfs)
    for name, g, w in zip(("sym", "val", "cntmap", "exmap", "mrowmap"), got,
                          want):
        np.testing.assert_array_equal(g.numpy(), w.astype(g.numpy().dtype),
                                      err_msg=name)


def test_k1_cases_stage():
    # every case stages at its named shape, and the edge it is there for
    # shows in the staging
    seen = {}
    for case in ps.K1_CASES:
        kernel, inputs, kw, _hfs = ps.k1_case(case, "cpu")
        seen[case] = (kernel, inputs[0].shape[1], kw)
        lim = inputs[2]
        if case in ("tail-4096", "batch-pad"):
            assert int((lim <= 0).sum()) > 0
    assert seen["text-512"][1] == 512 and seen["alpha-16384"][1] == 16384
    alpha = seen["alpha-16384"][2]
    assert alpha["md"] == 6 and alpha["NS"] == 2
    assert seen["md8"][2]["md"] == 8 and seen["h2"][2]["H"] == 2
    assert seen["tall128"][2]["H"] == seen["tall128-4096"][2]["H"] == 128
    tall = seen["tall128-4096"][2]
    assert tall["steps_p"] - tall["B"] > tall["B"]  # a halo past a lane
    assert seen["blank"][2]["md"] == 2
    assert seen["batch-pad"][0] == "k1_scan2_c01"

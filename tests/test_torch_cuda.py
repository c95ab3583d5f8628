"""The CUDA kernels on the card, against their plain torch versions.

Needs an NVIDIA GPU and nvcc; skips elsewhere.  This file imports no jax, so
on a machine without jax it runs without the suite's conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Every stream's decode path is checked kernel by kernel: K1-K4 for min code
length >= 2, the 1-bit K1'/K3' with K2/K4 for md = 1, the fused one-shot
kernel for the small streams ``lane_wide`` routes to it, and the lane-DFA
candidate and lane scans for the streams the wide program refuses, and at
the edges of their staged bit tiles (one lane, lane counts that are not
multiples of 16 or 32, the stream end mid-tile, misaligned matrices, row
slices cut under one tile, trees 40 and 140 tall).  The
encoder's E1-E3 are checked on the staging of the test shapes and on
hand-made lanes (granules shared by up to 16 lanes, trailing empty lanes,
counts reaching ORP), E1 and E2 at their edges (``probes.streams.E_CASES``,
E2 also at rows offset from their alignment), the fused E3 (offsets,
shift and placement in one launch) at its own (``E3_CASES``: three and more
lanes in a granule, runs of empty lanes, a lane clamped at ORP), E1's and
E2's look-back over calls, streams and a CUDA graph, and all three launchers refuse other plans, and
``encode_lanes`` and the ``encode`` command byte-equal to the host
encoder.  The sidecar-indexed route (K1's main scan
``k1_main``, the indexed lane scan) and the batched route (``k1_scan2_c01``,
``k3_fix2_c01``) are checked kernel by kernel and end to end with their
launch counts, and so is the self-synchronizing discovery (the short
candidate scan, the lane scan cut at W rows) of ``lane_dfa_sync``; the
dense lane decode and the compaction are checked against their plain
versions and through the dense pipeline, the dense decode also at its
edges (``DENSE_CASES``: G 1-100, out_rows under the counts, lanes ending
early, a lane a window of ranks ahead, whose own write-outs it counts as
the numpy emulation of ``test_torch_dense_plan.py`` does) and its launcher
refuses other plans; the compaction also at its edges
(``COMPACT_CASES``: G 1-4,095, steps under and off a chunk, out_rows 0,
under the counts and over steps, ranks more than two chunks apart, an
offset view) with its count of wide-union blocks held against the numpy
emulation of ``test_torch_compact_plan.py``, and its launcher and P4's
refuse other plans.  The probe
kernels (``probe_inc``, ``probe_arith``, ``probe_gather``,
``k4_stripped``, P4 also at ``P4_CASES``) are checked against
their plain versions at the scripts' shapes and at odd ones (P3's roll mode
and 16-bit indices also unaligned, past the staged row width and past
65,535 rows, each one launch and one kernel), the probe programs and the
stage profiler run on the card, and wrappers captured in a CUDA graph
(K4 among them) replay on new inputs, which holds only if each launch went
to the current stream.  The block-wide K4 is checked at its plan's edges
(one lane, three, a tail block, lanes past ORP, none valid, views at an
offset, rows in windows), the one-shot's team K1 at its (one candidate
chain, md 8, a tree 128 tall, G = 128 and 4,096, the envelope-edge
stream), its stamps against a launch's events, and both launchers refuse
a plan outside their rules.  The indexed main scan (``k1_main``) runs at
its edges (``probes.streams.K1_MAIN_CASES``) at every block size its plan
may pick, and K2 at the edges of its tiles (``K2_CASES``): one launch and
one kernel a call, each leaving its tickets at 0 and its look-back's epoch
one further, on two streams; both launchers refuse other plans.  The
indexed lane scan and the short candidate scan run at their edges
(``probes.streams.INDEXED_SCAN_CASES``, ``SHORT_SCAN_CASES``) and both
launchers refuse other plans.  The
1-bit K1' (a team a lane on the 1-bit step table) and K3' run at their
edges (``K1P_CASES``: a two-leaf tree, 128 and 255 states, a 31-bit comb
tree, 1 and 37 lanes, lanes past the stream end, a phase-locked run, (c)'s
plan at an eighth, K3' cuts on a cell boundary, mid-cell and past the last
segment), K1''s launcher refuses other plans, and trees of exactly 128
internal states decode through the four kernels and the one-shot.  K3 for
md >= 2 (``k3_fix2``, ``k3_fix2_c01``) runs at its edges (``K3_CASES``: md
2-8, NS 1, 2 and 8, odd entries and entries on a word's last bit, cuts on
a cell boundary, mid-cell and past the last segment, lanes with cut 0, G =
200, two trees in adjacent blocks).  The speculative pipeline's S1-S3
(``spec_all_bits``; S2's tile launch ``spec_tile`` and pair launches
``spec_pair`` as ``s2_plan`` says, and the one-level ``spec_double``, the
yardstick, at every level; ``spec_query``) and the one-thread S4 run
against their plain versions on paper1-sized text, the tiny inputs (0-3 levels), a stream
whose levels cross the int16 boundary, a stream cut short (found_size -1)
and ``probes.streams.SPEC_CASES`` (S2 on the case's tile: several blocks,
bits off and on a tile, a halo past the end; trees 17 and 22 tall, whose
S4 table is read from device memory), the tile launch at an odd ``bits``
after a kernel that left -32768 in every SM's shared memory, and
``spec_xla`` and
``onethread_device`` launch S1 once, S2's tile once and a pair a kept
level above its m, S3 once, and S4 once.
Tolerance: bit-exact (integer outputs).
"""

import json
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from huffmandecoderongpus_tpu import native
from huffmandecoderongpus_tpu.huffio.encoder import encode_bytes
from huffmandecoderongpus_tpu_torch.ops import _build, batch, candidate_scan
from huffmandecoderongpus_tpu_torch.ops import compact
from huffmandecoderongpus_tpu_torch.ops import e1_pack
from huffmandecoderongpus_tpu_torch.ops import e2_compact, e3_place, encode
from huffmandecoderongpus_tpu_torch.ops import encode_ops, k1_main, k1_scan
from huffmandecoderongpus_tpu_torch.ops import k1_scan2, k1_scan2_c01
from huffmandecoderongpus_tpu_torch.ops import k2_compose, k3_fix, k3_fix2
from huffmandecoderongpus_tpu_torch.ops import k3_fix2_c01, k4_compact
from huffmandecoderongpus_tpu_torch.ops import lane_scan, lane_scan_indexed
from huffmandecoderongpus_tpu_torch.ops import lane_decode_dense, lanedfa
from huffmandecoderongpus_tpu_torch.ops import lookback
from huffmandecoderongpus_tpu_torch.ops import lanedfa_decode, lanedfa_sync
from huffmandecoderongpus_tpu_torch.ops import oneshot, short_candidate_scan
from huffmandecoderongpus_tpu_torch.ops import widescan
from huffmandecoderongpus_tpu_torch.ops import k4_stripped, probe_arith
from huffmandecoderongpus_tpu_torch.ops import probe_gather, probe_inc
from huffmandecoderongpus_tpu_torch.ops import onethread, spec_all_bits
from huffmandecoderongpus_tpu_torch.ops import spec_double, spec_pair
from huffmandecoderongpus_tpu_torch.ops import spec_query, spec_tile
from huffmandecoderongpus_tpu_torch.ops import speculative
from huffmandecoderongpus_tpu_torch.probes import streams as ps
from huffmandecoderongpus_tpu_torch.utils import trace
from torch_streams import BATCHES, INDEXED, MD1_SHAPES, SHAPES, STATES128
from torch_streams import comb_stream
from torch_streams import fib_tree_data
from torch_streams import fuzz, fuzz_any, make, make_batch, make_indexed
from torch_streams import text_like

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _stream(case):
    if case.startswith("fuzz"):
        return fuzz(int(case[4:]))
    if case.startswith("any"):
        return fuzz_any(int(case[3:]))
    name, lanes = case.split("-")
    raw, hf = make(name)
    return raw, hf, None if lanes == "auto" else int(lanes)


CASES = ([f"{n}-{lanes}" for n in sorted(SHAPES) + sorted(MD1_SHAPES)
          for lanes in ("512", "auto")]
         + [f"fuzz{i}" for i in range(12)] + [f"any{i}" for i in range(12)])


def _lanedfa_kernels_match_plain(raw, hf, dev, lanes=None):
    st = lanedfa_decode.stage_lanedfa(hf, device=dev, lanes=lanes)
    kw = dict(B=st["B"], H=st["H"], N=st["N"])
    cnt, ex = candidate_scan.candidate_scan(st["bits"], st["tab"], **kw)
    rcnt, rex = candidate_scan.candidate_scan_ref(st["bits"], st["tab"], **kw)
    assert torch.equal(cnt, rcnt) and torch.equal(ex, rex)
    entry, _base, _n, _total = lanedfa_decode.compose(rcnt, rex)
    sym, valid = lane_scan.lane_scan(st["bits"], st["tab"], entry, **kw)
    rsym, rvalid = lane_scan.lane_scan_ref(st["bits"], st["tab"], entry, **kw)
    assert torch.equal(sym, rsym) and torch.equal(valid, rvalid)
    np.testing.assert_array_equal(rsym.t()[rvalid.t() > 0].cpu().numpy(), raw)


@pytest.mark.parametrize("case", CASES)
def test_kernels_match_plain(cuda, case):
    raw, hf, lanes = _stream(case)
    try:
        st = widescan.stage_widescan_inputs(hf, device=cuda, lanes=lanes)
    except widescan.EnvelopeError:  # the decode path is the lane-DFA chain
        _lanedfa_kernels_match_plain(raw, hf, cuda)
        return
    p = st["plan"]
    kw = dict(steps_p=p["steps_p"], SEG=p["SEG"], md=st["md"], NS=st["NS"])
    if st["chunk2"]:
        kw.update(C0=st["C0"], C1=st["C1"])
        scan, fix = k1_scan2.k1_scan2, k3_fix2.k3_fix2
        scan_ref, fix_ref = k1_scan2.k1_scan2_ref, k3_fix2.k3_fix2_ref
    else:
        scan, fix = k1_scan.k1_scan, k3_fix.k3_fix
        scan_ref, fix_ref = k1_scan.k1_scan_ref, k3_fix.k3_fix_ref
    k1 = dict(B=p["B"], H=st["H"], steps=p["steps"], **kw)
    wmat = widescan.words_matrix(st["words"], -(-p["steps_p"] // 32))
    got = scan(wmat, st["tab"], st["lim"], **k1)
    want = scan_ref(wmat, st["tab"], st["lim"], **k1)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    sym, val, cntmap, exmap, mrowmap = want
    entry, tot = k2_compose.k2_compose(exmap, 0)
    rentry, rtot = k2_compose.k2_compose_ref(exmap, 0)
    assert torch.equal(entry, rentry) and torch.equal(tot, rtot)
    cut, cut_slot = widescan.fix_rows(entry, mrowmap, st["lim"], st["H"],
                                      st["md"])
    s, v = fix(wmat, st["tab"], entry, cut, cut_slot, sym.clone(),
               val.clone(), **kw)
    rs, rv = fix_ref(wmat, st["tab"], entry, cut, cut_slot, sym.clone(),
                     val.clone(), **kw)
    assert torch.equal(s, rs) and torch.equal(v, rv)
    d = k4_compact.k4_compact(rs, rv, ORP=p["ORP"])
    assert torch.equal(d, k4_compact.k4_compact_ref(rs, rv, ORP=p["ORP"]))
    n = widescan.select_h(cntmap, entry, st["H"])
    if int(n.max()) <= p["ORP"]:
        mask = torch.arange(p["ORP"], device=cuda)[None, :] < n[:, None]
        np.testing.assert_array_equal(d[mask].cpu().numpy(), raw)


@pytest.mark.parametrize("name", ["text", "md1", "ns2", "md1wide"])
def test_lanedfa_kernels_match_plain(cuda, name):
    # the scans at the tiled geometry, whatever the wide program would do
    raw, hf = make(name)
    _lanedfa_kernels_match_plain(raw, hf, cuda)


def _tile_stream(k):
    if k == "tiny":  # sync discovery's tail column at one lane
        raw = text_like(np.random.default_rng(5), 2000)
        return raw, encode_bytes(raw)
    if k.startswith("comb"):  # comb<height>: L*H past 1,024 at 32 lanes
        return comb_stream(int(k[4:]) + 1, 6000)
    return make(k)


#: the lane-DFA scans at the edges of their bit tiles: stream, lanes (1,
#: and 3, 20, 100, 8: not multiples of 16 or 32), and "cut" (the stream end
#: a third into the last lane, mid-tile) or "views" (copies 1 and 4 bytes
#: past an aligned address, and row slices cut under one tile)
SCAN_TILES = [("tiny", 1, None), ("tiny", 3, "cut"), ("tiny", 20, "cut"),
              ("tiny", 20, "views"),
              ("text", 100, "cut"), ("text", 64, "views"),
              ("md1", 48, "cut"), ("comb40", 48, None),
              ("comb140", 8, "cut"), ("comb140", 64, "views")]


@pytest.mark.parametrize("k,G,how", SCAN_TILES)
def test_scan_tiles_match_plain(cuda, k, G, how):
    _raw, hf = _tile_stream(k)
    st = lanedfa_decode.stage_lanedfa(hf, device=cuda, lanes=G, tiled=False)
    bits, tab, B, H = st["bits"], st["tab"], st["B"], st["H"]
    assert bits.shape[1] == G and (k != "comb140" or H == 140)
    N = st["N"] - (B // 3 + 5 if how == "cut" else 0)
    kw = dict(B=B, H=H, N=N)
    rng = np.random.default_rng(G)
    offs = rng.integers(0, H, G).astype(np.int32)
    offs[0], offs[-1] = 0, H - 1
    starts = [torch.from_numpy(a).to(cuda) for a in (
        offs, np.zeros(G, np.int32), np.full(G, H - 1, np.int32))]
    mats = [bits]
    if how == "views":
        for off in (1, 4):
            flat = torch.empty(bits.numel() + off, dtype=torch.uint8,
                               device=cuda)
            mats.append(flat[off:].view(bits.shape))
            mats[-1].copy_(bits)
    for m in mats:
        got = candidate_scan.candidate_scan(m, tab, **kw)
        want = candidate_scan.candidate_scan_ref(m, tab, **kw)
        assert all(torch.equal(g, w) for g, w in zip(got, want))
        for start in starts:
            got = lane_scan.lane_scan(m, tab, start, **kw)
            want = lane_scan.lane_scan_ref(m, tab, start, **kw)
            assert all(torch.equal(g, w) for g, w in zip(got, want))
        if how == "views":  # rows= under one tile, on a row slice
            for W in (1, 40, 300):
                got = lane_scan.lane_scan(m[:W], tab, starts[0], rows=W,
                                          **kw)
                want = lane_scan.lane_scan_ref(m[:W], tab, starts[0],
                                               rows=W, **kw)
                assert all(torch.equal(g, w) for g, w in zip(got, want))


KERNEL_MODULES = (k1_scan2, k2_compose, k3_fix2, k4_compact, k1_scan,
                  k3_fix, candidate_scan, lane_scan, oneshot, e1_pack,
                  e2_compact, e3_place, k1_main, lane_scan_indexed,
                  k1_scan2_c01, k3_fix2_c01, short_candidate_scan,
                  lane_decode_dense, compact, probe_inc, probe_arith,
                  probe_gather, k4_stripped, spec_all_bits, spec_double,
                  spec_tile, spec_pair, spec_query, onethread)


def _launches(m) -> int:
    """Launches of kernel module ``m``'s kernel so far (its
    ``launch.<module name>`` counter)."""
    return trace.counts().get("launch." + m.__name__.rsplit(".", 1)[1], 0)


def _retries() -> int:
    """Encodes finished off their first plan so far (``encode.retry``)."""
    return trace.counts().get("encode.retry", 0)


def _launched(fn):
    """fn()'s result and the kernels it launched, {module name: count}."""
    before = [_launches(m) for m in KERNEL_MODULES]
    out = fn()
    ran = {m.__name__.rsplit(".", 1)[1]: _launches(m) - b
           for m, b in zip(KERNEL_MODULES, before) if _launches(m) != b}
    return out, ran


@pytest.mark.parametrize("name", sorted(SHAPES) + sorted(MD1_SHAPES))
def test_decode_on_cuda(cuda, name):
    # every test shape is under ONESHOT_MAX_BITS: the chunked ones take the
    # one-shot launch, the md = 1 ones the four 1-bit-path kernels
    raw, hf = make(name, seed=1)
    out, ran = _launched(lambda: widescan.decode_widescan(hf, device=cuda))
    if name in MD1_SHAPES:
        assert ran == dict.fromkeys(("k1_scan", "k2_compose", "k3_fix",
                                     "k4_compact"), 1)
    else:
        assert ran == {"oneshot": 1}
    np.testing.assert_array_equal(out, raw)
    np.testing.assert_array_equal(out, native.simple_decode(hf))


@pytest.mark.parametrize("lanes", [512, 1024])
@pytest.mark.parametrize("name", ["text", "ns2", "md3", "abcd"])
def test_oneshot_matches_plain(cuda, name, lanes):
    raw, hf = make(name)
    st = widescan.stage_widescan_inputs(hf, device=cuda, lanes=lanes)
    assert oneshot.oneshot_eligible(st)
    args = (st["words"], st["tab"], st["lim"])
    kw = oneshot.program_args(st)
    got = oneshot.oneshot_program(*args, **kw)
    want = oneshot.oneshot_program_ref(*args, **kw)
    for g, w in zip(got, want):  # the whole (G, ORP) rows, counts, total
        assert torch.equal(g, w)
    denseT, n, _total = got
    mask = torch.arange(denseT.shape[1], device=cuda)[None, :] < n[:, None]
    np.testing.assert_array_equal(denseT[mask].cpu().numpy(), raw)


def test_oneshot_phase_ms(cuda):
    # the timer stamps split one launch into its phases and change nothing
    _, hf = make("ns2")
    st = widescan.stage_widescan_inputs(hf, device=cuda)
    args = (st["words"], st["tab"], st["lim"])
    kw = oneshot.program_args(st)
    stamps = torch.zeros(len(oneshot.PHASES) + 1, dtype=torch.int64,
                         device=cuda)
    got = oneshot.oneshot_program(*args, stamps=stamps, **kw)
    for g, w in zip(got, oneshot.oneshot_program(*args, **kw)):
        assert torch.equal(g, w)
    t = stamps.tolist()
    assert t[0] > 0 and t == sorted(t)
    split = oneshot.phase_ms(*args, **kw)
    assert list(split) == list(oneshot.PHASES)
    assert all(v >= 0 for v in split.values()) and split["K1"] > 0
    # the phases are the launch's: their sum is inside a launch's events
    from huffmandecoderongpus_tpu_torch.harness.timing import event_ms

    launch = min(event_ms(lambda: oneshot.oneshot_program(*args, **kw), 5))
    assert 0 < sum(split.values()) <= launch


def test_lane_wide_small_stream_is_one_launch(cuda):
    from huffmandecoderongpus_tpu_torch.models import get_decoder

    raw = text_like(np.random.default_rng(7), 300_000)
    hf = encode_bytes(raw)
    assert hf.bits < widescan.ONESHOT_MAX_BITS
    out, ran = _launched(lambda: get_decoder("lane_wide", device=cuda)(hf))
    assert ran == {"oneshot": 1}
    np.testing.assert_array_equal(out, raw)


@pytest.mark.parametrize("case", ps.ONESHOT_CASES)
def test_oneshot_edges_match_plain(cuda, case):
    # the team K1 at its edges: one candidate chain, eight leaders, 127
    # chains (several followers a thread), the grid's smallest and largest
    # G, and the largest stream the router sends to the one-shot
    raw, st = ps.oneshot_case(case, cuda)
    p = st["plan"]
    assert oneshot.oneshot_eligible(st)
    plan = oneshot.oneshot_plan(p["G"], st["H"], st["md"], p["SEG"],
                                p["steps_p"], p["ORP"], st["NS"])
    assert plan["fits"]
    args = (st["words"], st["tab"], st["lim"])
    kw = oneshot.program_args(st)
    got = oneshot.oneshot_program(*args, **kw)
    want = oneshot.oneshot_program_ref(*args, **kw)
    for g, w in zip(got, want):  # the whole (G, ORP) rows, counts, total
        assert torch.equal(g, w)
    denseT, n, total = got
    mask = torch.arange(p["ORP"], device=cuda)[None, :] < n[:, None]
    np.testing.assert_array_equal(denseT[mask].cpu().numpy(), raw)
    assert int(total) == raw.size


@pytest.mark.parametrize("case", ps.K1_CASES)
def test_k1_edges_match_plain(cuda, case):
    # the team K1 in the four-kernel program at its edges: md 2 at G 512,
    # md 6 with two table chunks at G 16,384, seven leaders, one candidate
    # chain, a 128-tall tree (and its halo past the next lane), lanes past
    # the stream end, a blank run, and the batch's per-stream tables
    kernel, inputs, kw, _hfs = ps.k1_case(case, cuda)
    mod = k1_scan2 if kernel == "k1_scan2" else k1_scan2_c01
    got, ran = _launched(lambda: getattr(mod, kernel)(*inputs, **kw))
    assert ran == {kernel: 1}
    want = getattr(mod, kernel + "_ref")(*inputs, **kw)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("case", ps.K1P_CASES)
def test_k1p_edges_match_plain(cuda, case):
    # the 1-bit K1' (a team a lane on the 1-bit step table) and K3' (no
    # read but the cut cell) at their edges: a two-leaf tree, 128 and 255
    # states (NS 1 and 2), a 31-bit comb tree (30 chains), 1 and 37 lanes,
    # lanes past the stream end, a phase-locked run, (c)'s plan at an
    # eighth, and K3' cuts on a cell boundary, mid-cell and past the last
    # segment
    inputs, kw, cuts, _hf = ps.k1p_case(case, cuda)
    got, ran = _launched(lambda: k1_scan.k1_scan(*inputs, **kw))
    assert ran == {"k1_scan": 1}
    want = k1_scan.k1_scan_ref(*inputs, **kw)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    ent, cut, cut_slot, sym, val = ps.k3p_inputs(inputs, kw, cuts)
    k3 = dict(steps_p=kw["steps_p"], SEG=kw["SEG"], md=1, NS=kw["NS"])
    (s, v), ran = _launched(lambda: k3_fix.k3_fix(
        inputs[0], inputs[1], ent, cut, cut_slot, sym.clone(), val.clone(),
        **k3))
    assert ran == {"k3_fix": 1}
    rs, rv = k3_fix.k3_fix_ref(inputs[0], inputs[1], ent, cut, cut_slot,
                               sym.clone(), val.clone(), **k3)
    assert torch.equal(s, rs) and torch.equal(v, rv)


@pytest.mark.parametrize("case", ps.K3_CASES)
def test_k3_edges_match_plain(cuda, case):
    # K3 for md >= 2 on the step table (no read but the cut cell) at its
    # edges: md 2-8, NS 1, 2 and 8, odd entries and entries on a word's
    # last bit, cuts on a cell boundary, mid-cell and past the last
    # segment, lanes with cut 0, G = 200, and the batch's K3 on two trees
    # in adjacent blocks
    kernel, inputs, kw, _hfs = ps.k3_case(case, cuda)
    mod = k3_fix2 if kernel == "k3_fix2" else k3_fix2_c01
    head, (sym, val), tail = inputs[:5], inputs[5:7], inputs[7:]
    (s, v), ran = _launched(lambda: getattr(mod, kernel)(
        *head, sym.clone(), val.clone(), *tail, **kw))
    assert ran == {kernel: 1}
    rs, rv = getattr(mod, kernel + "_ref")(*head, sym.clone(), val.clone(),
                                           *tail, **kw)
    assert torch.equal(s, rs) and torch.equal(v, rv)


@pytest.mark.parametrize("name", sorted(STATES128))
def test_128_states_decode_on_cuda(cuda, name):
    # a tree of exactly 128 internal states (the compact layout's largest):
    # the four-kernel program, and the one-shot route for md >= 2
    raw, hf = make(name, seed=1)
    path = (("k1_scan", "k3_fix") if name == "s128md1"
            else ("k1_scan2", "k3_fix2"))
    out, ran = _launched(lambda: widescan.decode_widescan(
        hf, device=cuda, oneshot=False))
    assert ran == dict.fromkeys((*path, "k2_compose", "k4_compact"), 1)
    np.testing.assert_array_equal(out, raw)
    if name == "s128":
        out, ran = _launched(lambda: widescan.decode_widescan(
            hf, device=cuda, oneshot=True))
        assert ran == {"oneshot": 1}
        np.testing.assert_array_equal(out, raw)


def test_k1_scan_launcher_refuses_other_plans(cuda):
    # a K1' plan outside the launcher's rules is refused, nothing launched
    lib = _build.get_lib()
    G, H, NS, B = 37, 9, 1, 32
    steps, steps_p = B + H, 64
    wmat = torch.zeros((2, G), dtype=torch.int32, device=cuda)
    tab = torch.zeros((1, 128), dtype=torch.int32, device=cuda)
    lim = torch.full((G,), 32, dtype=torch.int32, device=cuda)
    sym = torch.empty((16, G), dtype=torch.int32, device=cuda)
    val = torch.empty((16, G), dtype=torch.uint8, device=cuda)
    maps = [torch.empty((16, G), dtype=torch.int32, device=cuda)
            for _ in range(3)]
    p = k1_scan.k1_scan_plan(G, H, steps_p, NS)

    def k1(G=G, H=H, NS=NS, T=p["T"], shared=p["shared"], steps_p=steps_p):
        return lib.ws_k1_scan(
            wmat.data_ptr(), tab.data_ptr(), lim.data_ptr(), sym.data_ptr(),
            val.data_ptr(), *(m.data_ptr() for m in maps), G, 2, B, H, steps,
            steps_p, NS, T, shared, _build.stream_ptr(wmat))

    assert k1() == 0
    for bad in (dict(T=2), dict(T=12), dict(T=64), dict(shared=16),
                dict(shared=p["shared"] - 16), dict(shared=p["shared"] + 8),
                dict(shared=228 * 1024), dict(G=0), dict(NS=0), dict(NS=9),
                dict(H=129), dict(steps_p=48), dict(steps_p=96)):
        assert k1(**bad) != 0, bad
    torch.cuda.synchronize()


def _tall_stream():
    # 256 skewed symbols, 17 tall: 16 candidate chains, teams of 32
    rng = np.random.default_rng(0)
    w = rng.random(256) ** 6 + 1e-5
    raw = rng.choice(np.arange(256, dtype=np.uint8), size=100000,
                     p=w / w.sum()).astype(np.uint8)
    return raw, encode_bytes(raw)


@pytest.mark.parametrize("sms", [60, 10_000])
def test_router_falls_through_off_the_card(cuda, sms, monkeypatch):
    # a one-shot grid the card cannot hold decodes through the four-kernel
    # program: planned for 60 SMs it does not fit (EnvelopeError before any
    # launch); planned for 10,000 the plan's 1,024 blocks of teams of 32
    # fit on paper, and the card's launcher refuses them (EnvelopeError)
    raw, hf = make("ns2") if sms == 60 else _tall_stream()
    st = widescan.stage_widescan_inputs(hf, device=cuda, lanes=4096)
    assert oneshot.oneshot_eligible(st) and hf.bits < widescan.ONESHOT_MAX_BITS
    monkeypatch.setattr(_build, "sm_count", lambda device: sms)
    out, ran = _launched(lambda: widescan.decode_widescan(hf, device=cuda,
                                                          lanes=4096))
    four = dict.fromkeys(("k1_scan2", "k2_compose", "k3_fix2", "k4_compact"),
                         1)
    assert ran == (four if sms == 60 else dict(four, oneshot=1))
    np.testing.assert_array_equal(out, raw)


def test_k1_launchers_refuse_other_plans(cuda):
    # a K1 plan outside the launchers' rules is refused, nothing launched
    lib = _build.get_lib()
    G, H, md, SEG, NS, B = 512, 9, 2, 32, 1, 32
    steps, steps_p = B + H, 64
    wmat = torch.zeros((2, G), dtype=torch.int32, device=cuda)
    tab = torch.zeros((2, 128), dtype=torch.int32, device=cuda)
    lim = torch.full((G,), 32, dtype=torch.int32, device=cuda)
    c01 = torch.zeros(G, dtype=torch.int32, device=cuda)
    bstream = torch.zeros(G // 128, dtype=torch.int32, device=cuda)
    sym = torch.empty((4, G), dtype=torch.int32, device=cuda)
    val = torch.empty((4, G), dtype=torch.uint8, device=cuda)
    maps = [torch.empty((16, G), dtype=torch.int32, device=cuda)
            for _ in range(3)]
    p = k1_scan2.k1_plan(G, H, md, SEG, steps_p, NS)
    outs = (sym.data_ptr(), val.data_ptr(), *(m.data_ptr() for m in maps))

    def k1(G=G, SEG=SEG, T=p["T"], shared=p["shared"]):
        return lib.ws_k1_scan2(
            wmat.data_ptr(), tab.data_ptr(), lim.data_ptr(), *outs, G, 2, B,
            H, steps, steps_p, SEG, md, 1, 2, NS, T, shared,
            _build.stream_ptr(wmat))

    def c1(G=G, T=p["T"], shared=p["shared"]):
        return lib.ws_k1_scan2_c01(
            wmat.data_ptr(), tab.data_ptr(), lim.data_ptr(), c01.data_ptr(),
            bstream.data_ptr(), *outs, G, 2, B, H, steps, steps_p, SEG, md,
            T, shared, _build.stream_ptr(wmat))

    assert k1() == 0 and c1() == 0
    for bad in (dict(T=2), dict(T=12), dict(T=64), dict(shared=16),
                dict(shared=p["shared"] + 8), dict(shared=228 * 1024),
                dict(G=100), dict(SEG=24)):
        if "SEG" not in bad:
            assert c1(**bad) != 0, bad
        assert k1(**bad) != 0, bad
    torch.cuda.synchronize()


@pytest.mark.parametrize("case", ps.K1_MAIN_CASES)
def test_k1_main_edges_match_plain(cuda, case):
    # the indexed main scan at its edges: every block ending on the last
    # bit of steps_p beside pad lanes, one lane, md 3/5/7 (SEG 96/160/224),
    # NS 2 and 8
    inputs, kw, _hf = ps.k1_main_case(case, cuda)
    want = k1_main.k1_main_ref(*inputs, **kw)
    got, ran = _launched(lambda: k1_main.k1_main(*inputs, **kw))
    assert ran == {"k1_main": 1}
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("case", ps.K2_CASES)
def test_k2_edges_match_plain(cuda, case):
    # one launch a call: one lane, part tiles, HP 128 from start 127,
    # entries past HP, 65 tiles (look-back windows), merged maps; each call
    # leaves its tickets at 0 and the look-back's epoch one further, on
    # this stream and on another
    G, HP, start, _values = case
    ex = ps.k2_exmap(case, cuda)
    want = k2_compose.k2_compose_ref(ex, start)
    for stream in (torch.cuda.current_stream(), torch.cuda.Stream()):
        with torch.cuda.stream(stream):
            k2_compose.k2_compose(ex, start)
            state, _cap = k2_compose._states.get(
                ex.device, _build.stream_ptr(ex), 1)
            before = int(state[1])
            for k in range(3):
                got, ran = _launched(lambda: k2_compose.k2_compose(ex, start))
                assert ran == {"k2_compose": 1}
                for g, w in zip(got, want):
                    assert torch.equal(g, w)
                assert (int(state[0]), int(state[1])) == (0, before + k + 1)


def test_k2_many_waves_and_a_graph(cuda):
    # 1,200 tiles, more than the card holds at once (blocks wait only on
    # earlier tickets), past the look-back buffer's first size (it grows);
    # then K2 captured in a CUDA graph on a stream no K2 ran on before
    # replays right on another stream, after the capture stream's own state
    # grew and beside eager calls there: the graph's state is its own
    G, HP = 256 * 1200, 16
    rng = np.random.default_rng(5)
    ex = torch.from_numpy(rng.integers(0, HP + 2, (HP, G)).astype(
        np.int32)).to(cuda)
    assert k2_compose.k2_plan(G, HP)["waves"] > 1
    want = k2_compose.k2_compose_ref(ex, 7)
    for g, w in zip(k2_compose.k2_compose(ex, 7), want):
        assert torch.equal(g, w)
    ex2 = ps.k2_exmap(ps.K2_CASES[5], cuda)
    want2 = k2_compose.k2_compose_ref(ex2, 0)
    stream = torch.cuda.Stream()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream):
        got = k2_compose.k2_compose(ex2, 0)
    assert (cuda.index, stream.cuda_stream) not in k2_compose._states
    other = torch.cuda.Stream()
    for _ in range(3):
        with torch.cuda.stream(stream):  # eager calls on the capture stream
            eager = [k2_compose.k2_compose(ex, 7) for _ in range(2)]
        with torch.cuda.stream(other):
            graph.replay()
        torch.cuda.synchronize()
        for g, w in zip(got, want2):
            assert torch.equal(g, w)
        for out in eager:
            for g, w in zip(out, want):
                assert torch.equal(g, w)


def test_k2_one_kernel_a_call(cuda):
    # the profiler sees one K2 kernel a call, none of the old three
    from torch.profiler import ProfilerActivity, profile

    ex = ps.k2_exmap(ps.K2_CASES[5], cuda)
    k2_compose.k2_compose(ex, 0)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(4):
            k2_compose.k2_compose(ex, 0)
        torch.cuda.synchronize()
    names = [e.key for e in prof.key_averages()
             if e.device_type == torch.autograd.DeviceType.CUDA]
    if not names:
        pytest.skip("the profiler recorded no device activity")
    k2 = [n for n in names if "k2_" in n]
    assert len(k2) == 1 and "k2_compose_kernel" in k2[0], names
    assert not any(old in n for n in names
                   for old in ("k2_groups", "k2_scan", "k2_apply"))


def test_k1_main_and_k2_launchers_refuse_other_plans(cuda):
    lib = _build.get_lib()
    G, md, NS, steps_p = 256, 2, 1, 64
    wmat = torch.zeros((2, G), dtype=torch.int32, device=cuda)
    tab = torch.zeros((2, 128), dtype=torch.int32, device=cuda)
    lim = torch.full((G,), 64, dtype=torch.int32, device=cuda)
    sym = torch.empty((8, G), dtype=torch.int32, device=cuda)
    val = torch.empty((8, G), dtype=torch.uint8, device=cuda)
    p = k1_main.k1_main_plan(G, md, NS, steps_p)

    def k1(threads=p["threads"], shared=p["shared"], steps_p=steps_p):
        return lib.ws_k1_main(
            wmat.data_ptr(), tab.data_ptr(), lim.data_ptr(), sym.data_ptr(),
            val.data_ptr(), G, 2, steps_p, md, 1, 2, NS, threads, shared,
            _build.stream_ptr(wmat))

    assert k1() == 0
    for bad in (dict(threads=32), dict(threads=64), dict(threads=96),
                dict(threads=256), dict(shared=4096), dict(steps_p=40)):
        assert k1(**bad) != 0, bad
    HP = 16
    ex = torch.zeros((HP, G), dtype=torch.int32, device=cuda)
    entry = torch.empty(G, dtype=torch.int32, device=cuda)
    tot = torch.empty(128, dtype=torch.uint8, device=cuda)
    q = k2_compose.k2_plan(G, HP)
    state, cap = k2_compose._states.get(cuda, _build.stream_ptr(ex),
                                        q["tiles"])

    def k2(tile=q["tile"], sub=q["sub"], threads=q["threads"],
           shared=q["shared"], cap=cap, start=0):
        return lib.ws_k2_compose(
            ex.data_ptr(), entry.data_ptr(), tot.data_ptr(),
            state.data_ptr(), cap, G, HP, start, tile, sub, threads, shared,
            _build.stream_ptr(ex))

    assert k2() == 0
    for bad in (dict(tile=24), dict(sub=q["sub"] + 1), dict(threads=96),
                dict(shared=q["shared"] + 16), dict(cap=0), dict(start=128)):
        assert k2(**bad) != 0, bad
    torch.cuda.synchronize()
    assert int(state[0]) == 0  # no ticket left taken


@pytest.mark.parametrize("case", ps.K4_CASES)
def test_k4_edges_match_plain(cuda, case):
    G, cells_p, ORP, _fill, off = case
    sym, val = ps.k4_cells(case, cuda)
    plan = k4_compact.k4_plan(G, cells_p, ORP, sym.data_ptr(),
                              val.data_ptr())
    if off or G % 4:
        assert plan["vec"] == 1
    out, ran = _launched(lambda: k4_compact.k4_compact(sym, val, ORP=ORP))
    assert ran == {"k4_compact": 1}
    assert torch.equal(out, k4_compact.k4_compact_ref(sym, val, ORP=ORP))


def test_launchers_refuse_other_plans(cuda):
    # a plan outside the launchers' rules is refused, nothing launched
    lib = _build.get_lib()
    G, cells_p, ORP = 64, 8, 128
    sym = torch.zeros((cells_p, G), dtype=torch.int32, device=cuda)
    val = torch.zeros((cells_p, G), dtype=torch.uint8, device=cuda)
    out = torch.empty((G, ORP), dtype=torch.uint8, device=cuda)
    p = k4_compact.k4_plan(G, cells_p, ORP, sym.data_ptr(), val.data_ptr())

    def k4(**change):
        q = {**p, **change}
        return lib.ws_k4_compact(
            sym.data_ptr() + change.pop("shift", 0), val.data_ptr(),
            out.data_ptr(), G, cells_p, ORP, q["lanes"], q["vec"],
            q["chunks"], q["window"], q["threads"], q["shared"],
            _build.stream_ptr(sym))

    assert k4() == 0
    for bad in (dict(lanes=33), dict(vec=2), dict(chunks=33),
                dict(window=24), dict(threads=p["threads"] + 32),
                dict(shared=p["shared"] + 16), dict(shift=4)):
        assert k4(**bad) != 0, bad
    torch.cuda.synchronize()


def test_oneshot_grid_not_coresident_raises(cuda):
    # more blocks than the card holds at once: the launcher refuses the
    # cooperative launch instead of running a grid that can deadlock
    L = 529
    G = 256 * L  # 1058 blocks of 128 lanes, in 256 groups of L lanes
    words = torch.zeros((G, 1), dtype=torch.int32, device=cuda)
    lim = torch.full((G,), 32, dtype=torch.int32, device=cuda)
    tab = torch.zeros((2, 128), dtype=torch.int32, device=cuda)
    before = _launches(oneshot)
    with pytest.raises(RuntimeError, match="oneshot: CUDA error"):
        oneshot.oneshot_program(words, tab, lim, B=32, H=2, steps=34,
                                steps_p=64, SEG=32, md=2, C0=1, C1=2, NS=1,
                                ORP=128)
    assert _launches(oneshot) == before + 1


def _fallback_decode(cuda, hf, **kw):
    before = (_launches(candidate_scan), _launches(lane_scan))
    out = widescan.decode_widescan(hf, device=cuda, **kw)
    assert (_launches(candidate_scan), _launches(lane_scan)) == (
        before[0] + 1, before[1] + 1)
    return out


@pytest.mark.parametrize("n", [500, 2000])
def test_tiny_decode_on_cuda(cuda, n):
    raw = text_like(np.random.default_rng(n), n)
    hf = encode_bytes(raw)
    np.testing.assert_array_equal(_fallback_decode(cuda, hf), raw)


def test_orp_overflow_decode_on_cuda(cuda, monkeypatch):
    rng = np.random.default_rng(0)
    raw = np.concatenate([np.full(15000, 0, dtype=np.uint8),
                          rng.integers(1, 8, size=45000, dtype=np.uint8)])
    hf = encode_bytes(raw)
    plan = widescan._plan
    monkeypatch.setattr(widescan, "_plan",
                        lambda *a, **k: dict(plan(*a, **k), ORP=128))
    out, ran = _launched(lambda: _fallback_decode(cuda, hf, lanes=512))
    # one-shot (a lane overflows) -> the four kernels (again) -> lane-DFA
    assert ran == dict(oneshot=1, k1_scan2=1, k2_compose=1, k3_fix2=1,
                       k4_compact=1, candidate_scan=1, lane_scan=1)
    np.testing.assert_array_equal(out, raw)


def test_cli_decode_on_cuda(cuda, tmp_path, capsys):
    from huffmandecoderongpus_tpu.huffio.format import write_huff
    from huffmandecoderongpus_tpu_torch.harness.cli import main

    raw, hf = make("text", seed=2)
    src = tmp_path / "x.huff"
    write_huff(src, hf)
    dst = tmp_path / "x.out"
    main(["decode", str(src), str(dst), "--device", "cuda"])
    np.testing.assert_array_equal(np.fromfile(dst, dtype=np.uint8), raw)
    rawf = tmp_path / "x.raw"
    raw.tofile(rawf)
    main(["decode", str(src), "--device", "cuda", "--verify", str(rawf)])
    assert "lane_wide" in capsys.readouterr().out


def _encode_kernels_match_plain(st):
    """E1, E2 and E3 on staged inputs, each kernel against its plain
    version on the same CUDA tensors; returns the kernels' payload and
    counts."""
    p = st["plan"]
    args = (st["data3"], st["lo"], st["hi"], st["nval"])
    got = e1_pack.e1_pack(*args)
    want = e1_pack.e1_pack_ref(*args)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    gran, gval, cnt, bits = want
    d = e2_compact.e2_compact(gran, gval, ORP=p["ORP"])
    assert torch.equal(d, e2_compact.e2_compact_ref(gran, gval, ORP=p["ORP"]))
    kw = dict(NROWS=p["NROWS"])
    out = e3_place.e3_place(d, cnt, bits, **kw)
    assert torch.equal(out, e3_place.e3_place_ref(d, cnt, bits, **kw))
    return out, cnt


@pytest.mark.parametrize("lanes", [None, 128])
@pytest.mark.parametrize("name", sorted(SHAPES) + sorted(MD1_SHAPES))
def test_encode_kernels_match_plain(cuda, name, lanes):
    raw, hf = make(name)
    st = encode.stage_encode_inputs(raw, lanes=lanes, device=cuda)
    out, cnt = _encode_kernels_match_plain(st)
    if int(cnt.max()) < st["plan"]["ORP"]:
        got = encode.payload_bytes(out, hf.bits).cpu().numpy()
        np.testing.assert_array_equal(got, hf.payload)


@pytest.mark.parametrize("lane_bits", [
    [5, 1, 2, 3, 1, 40] + [0] * 122,  # 1-3-bit lanes, 122 empty lanes
    [1] * 40 + [300, 17, 2] + [0] * 85,  # one granule shared by 16 lanes
    list(range(1, 129)) * 2,
])
def test_e3_shared_granules_on_cuda(cuda, lane_bits):
    denseT, cnt, bits, NROWS, gran = ps.e3_lanes(np.random.default_rng(1),
                                                 lane_bits, 128)
    n = gran.size
    args = [torch.from_numpy(x).to(cuda) for x in (denseT, cnt, bits)]
    got = e3_place.e3_place(*args, NROWS=NROWS)
    assert torch.equal(got, e3_place.e3_place_ref(*args, NROWS=NROWS))
    flat = got.reshape(-1).cpu().numpy()
    np.testing.assert_array_equal(flat[:n], gran)
    assert not flat[n:].any()


def test_encode_kernels_overflow_and_empty_lanes(cuda):
    # a tail lane of 24-bit codes overflows ORP: E2 drops its ranks past
    # ORP and E3 clamps it to its row, both as their plain versions do;
    # 40 symbols over 128 lanes leave most lanes empty
    raw, tree = fib_tree_data(np.random.default_rng(0), 600)
    st = encode.stage_encode_inputs(raw, tree=tree, lanes=128, device=cuda)
    _out, cnt = _encode_kernels_match_plain(st)
    assert int(cnt.max()) >= st["plan"]["ORP"]
    st = encode.stage_encode_inputs(raw[:40], tree=tree, lanes=128,
                                    device=cuda)
    assert int((st["nval"] == 0).sum()) == 88
    _encode_kernels_match_plain(st)


@pytest.mark.parametrize("case", ps.E3_CASES)
def test_e3_cases_match_plain(cuda, case):
    # the fused E3 at its edges: three and more lanes in a granule, runs of
    # empty lanes (one past the lanes a block stages), a lane clamped at
    # ORP, no bits, many tiles, an odd lane count; one launch, every
    # granule written (the output is not zeroed first)
    denseT, cnt, bits, NROWS, gran = ps.e3_case(case, cuda)
    got, ran = _launched(lambda: e3_place.e3_place(denseT, cnt, bits,
                                                   NROWS=NROWS))
    assert ran == {"e3_place": 1}
    assert torch.equal(got, e3_place.e3_place_ref(denseT, cnt, bits,
                                                  NROWS=NROWS))
    if case != "clamped":
        flat = got.reshape(-1).cpu().numpy()
        np.testing.assert_array_equal(flat[:gran.size], gran)
        assert not flat[gran.size:].any()


@pytest.mark.parametrize("case", ps.E_CASES)
def test_encode_edges_match_plain(cuda, case):
    # E1 and E2 at their edges: all 256 symbols, 26-bit codes, a one-symbol
    # tree, lanes with no symbol, row blocks starting in pad rows and inside
    # a granule, a lane overflowing ORP; E2 also at an ORP that drops ranks
    _raw, _tree, _lanes, st = ps.e_case(case, cuda)
    args = (st["data3"], st["lo"], st["hi"], st["nval"])
    got, ran = _launched(lambda: e1_pack.e1_pack(*args))
    assert ran == {"e1_pack": 1}
    want = e1_pack.e1_pack_ref(*args)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    gran, gval = want[:2]
    for ORP in (st["plan"]["ORP"], ps.E_SMALL_ORP):
        d, ran = _launched(lambda: e2_compact.e2_compact(gran, gval, ORP=ORP))
        assert ran == {"e2_compact": 1}
        assert torch.equal(d, e2_compact.e2_compact_ref(gran, gval, ORP=ORP))


@pytest.mark.parametrize("off", [0, 1, 3])
def test_e2_views_match_plain(cuda, off):
    # rows at an offset: a lane a thread where the addresses refuse 4
    rng = np.random.default_rng(off)
    rows, G, ORP = 600, 512, 128
    views = []
    for a, dt in ((rng.integers(0, 1 << 16, (rows, G)), torch.int32),
                  (rng.random((rows, G)) < 0.2, torch.uint8)):
        t = torch.zeros(rows * G + off, dtype=dt, device=cuda)[off:]
        t = t.view(rows, G)
        t.copy_(torch.from_numpy(np.asarray(a)).to(dt))
        views.append(t)
    gran, gval = views
    p = e2_compact.e2_plan(G, rows, ORP, _build.sm_count(cuda),
                           gran.data_ptr(), gval.data_ptr())
    assert p["vec"] == (4 if off == 0 else 1)
    d = e2_compact.e2_compact(gran, gval, ORP=ORP)
    assert torch.equal(d, e2_compact.e2_compact_ref(gran, gval, ORP=ORP))


def test_e1_e2_launchers_refuse_other_plans(cuda):
    # a plan outside the launchers' rules is refused, nothing launched
    lib = _build.get_lib()
    K, G, ORP = 48, 128, 128
    i32 = dict(dtype=torch.int32, device=cuda)
    data = torch.zeros((K, G), dtype=torch.uint8, device=cuda)
    lo, hi, nval = (torch.zeros(256, **i32), torch.zeros(256, **i32),
                    torch.zeros(G, **i32))
    gran = torch.zeros((2 * K, G), **i32)
    gval = torch.zeros((2 * K, G), dtype=torch.uint8, device=cuda)
    cnt, bits = torch.empty(G, **i32), torch.empty(G, **i32)
    out = torch.empty((G, ORP), **i32)
    stream = _build.stream_ptr(data)
    p = e1_pack.e1_plan(G, K, _build.sm_count(cuda), data.data_ptr())
    assert p["vec"] == 16
    state = torch.zeros(lookback.state_words(p["blocks"]), **i32)

    def e1(shift=0, cap=p["blocks"], **change):
        q = {**p, **change}
        return lib.ws_e1_pack(
            data.data_ptr() + shift, lo.data_ptr(), hi.data_ptr(),
            nval.data_ptr(), gran.data_ptr(), gval.data_ptr(),
            cnt.data_ptr(), bits.data_ptr(), state.data_ptr(), cap, K, G,
            q["lanes"], q["vec"], q["chunks"], q["rows"], q["row_blocks"],
            q["threads"], q["shared"], q["blocks"], stream)

    assert e1() == 0
    for bad in (dict(lanes=16), dict(vec=2), dict(chunks=33),
                dict(threads=p["threads"] + 32), dict(rows=p["rows"] + 1),
                dict(row_blocks=p["row_blocks"] + 1),
                dict(blocks=p["blocks"] - 1), dict(shared=p["shared"] + 32),
                dict(cap=p["blocks"] - 1), dict(shift=4)):
        assert e1(**bad) != 0, bad
    q = e2_compact.e2_plan(G, 2 * K, ORP, _build.sm_count(cuda),
                           gran.data_ptr(), gval.data_ptr())
    assert q["vec"] == 4

    state2 = torch.zeros(lookback.state_words(q["blocks"]), **i32)

    def e2(shift=0, cap=q["blocks"], **change):
        r = {**q, **change}
        return lib.ws_e2_compact(
            gran.data_ptr() + shift, gval.data_ptr(), out.data_ptr(),
            state2.data_ptr(), cap, 2 * K, G, ORP, r["lanes"], r["vec"],
            r["chunks"], r["block_rows"], r["row_blocks"], r["window"],
            r["threads"], r["shared"], r["blocks"], stream)

    assert e2() == 0
    for bad in (dict(lanes=33), dict(vec=2), dict(cap=q["blocks"] - 1),
                dict(chunks=33), dict(window=q["window"] + 2),
                dict(threads=q["threads"] + 32), dict(shared=q["shared"] + 16),
                dict(row_blocks=q["row_blocks"] + 1),
                dict(blocks=q["blocks"] + 1), dict(shift=4)):
        assert e2(**bad) != 0, bad
    torch.cuda.synchronize()


def test_e3_and_dense_launchers_refuse_other_plans(cuda):
    # a plan outside the launchers' rules is refused, nothing launched
    lib = _build.get_lib()
    stream = _build.stream_ptr(torch.empty(1, device=cuda))
    i32 = dict(dtype=torch.int32, device=cuda)
    G, ORP, NROWS = 100, 128, 16
    denseT = torch.zeros((G, ORP), **i32)
    cnt, bits = torch.zeros(G, **i32), torch.zeros(G, **i32)
    out = torch.empty((NROWS, 128), **i32)
    p = e3_place.e3_plan(G)

    def e3(**change):
        q = {**p, **change}
        return lib.ws_e3_place(
            denseT.data_ptr(), cnt.data_ptr(), bits.data_ptr(),
            out.data_ptr(), G, ORP, NROWS * 128, q["lanes"], q["threads"],
            q["blocks"], stream)

    assert e3() == 0
    for bad in (dict(lanes=257), dict(lanes=0), dict(threads=128),
                dict(blocks=p["blocks"] + 1)):
        assert e3(**bad) != 0, bad
    bits_t, tab, start, kw = ps.dense_case("g100", cuda)
    dense = torch.empty((kw["out_rows"], 100), dtype=torch.uint8, device=cuda)
    counts = torch.empty(100, **i32)
    d = lane_decode_dense.dense_plan(100, bits_t.data_ptr(),
                                     dense.data_ptr())
    assert d["flush_vec"] == 4

    def dd(shift=0, **change):
        q = {**d, **change}
        return lib.ws_lane_decode_dense(
            bits_t.data_ptr(), tab.data_ptr(), start.data_ptr(),
            dense.data_ptr() + shift, counts.data_ptr(), None, 100,
            kw["B"], kw["B"] + kw["H"], kw["N"], kw["out_rows"], tab.numel(),
            q["lanes"], q["rows"], q["vec"], q["window"], q["flush_vec"],
            q["shared"], stream)

    assert dd() == 0
    for bad in (dict(window=500), dict(window=8), dict(flush_vec=2),
                dict(flush_vec=16), dict(rows=d["window"]),
                dict(lanes=33), dict(rows=120), dict(shared=d["shared"] - 16),
                dict(shift=2)):
        assert dd(**bad) != 0, bad
    torch.cuda.synchronize()


def test_e1_e2_lookback_calls_and_a_graph(cuda):
    # E1 and E2 called again and again on one stream (each call's epoch
    # one further, no reset), on a second stream, past the state's first
    # size (it grows), and captured in a CUDA graph that replays on another
    # stream beside eager calls: every output equal to the plain versions'
    _raw, _tree, _lanes, st = ps.e_case("g512", cuda)
    args = (st["data3"], st["lo"], st["hi"], st["nval"])
    want = e1_pack.e1_pack_ref(*args)
    ORP = st["plan"]["ORP"]
    want2 = e2_compact.e2_compact_ref(want[0], want[1], ORP=ORP)

    def both():
        got = e1_pack.e1_pack(*args)
        return got, e2_compact.e2_compact(got[0], got[1], ORP=ORP)

    def check(got, d):
        for g, w in zip(got, want):
            assert torch.equal(g, w)
        assert torch.equal(d, want2)

    for _ in range(3):
        check(*both())
    side = torch.cuda.Stream()
    with torch.cuda.stream(side):
        out = both()
    torch.cuda.synchronize()
    check(*out)
    # 65,536 lanes: more blocks than the state's first size
    raw = text_like(np.random.default_rng(9), 65536 * 20)
    big = encode.stage_encode_inputs(raw, lanes=65536, device=cuda)
    bargs = (big["data3"], big["lo"], big["hi"], big["nval"])
    p = e1_pack.e1_plan(65536, big["plan"]["K"], _build.sm_count(cuda))
    assert p["blocks"] > lookback.MIN_BLOCKS
    for g, w in zip(e1_pack.e1_pack(*bargs), e1_pack.e1_pack_ref(*bargs)):
        assert torch.equal(g, w)
    stream, other = torch.cuda.Stream(), torch.cuda.Stream()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream):
        captured = both()
    for _ in range(3):
        with torch.cuda.stream(stream):
            eager = [both() for _ in range(2)]
        with torch.cuda.stream(other):
            graph.replay()
        torch.cuda.synchronize()
        check(*captured)
        for out in eager:
            check(*out)


#: case -> E1, E2 and E3 launches and retries of one encode_lanes: fib600
#: overflows a lane's dense row (E2 and E3 run again with a larger ORP),
#: fib30's 29-bit codes go to encode_device (no E1-E3)
ENCODE_ROUTES = {"fib600": (dict(e1_pack=1, e2_compact=2, e3_place=2), 1),
                 "fib30": ({}, 1)}


@pytest.mark.parametrize("case", ["text", "ns2", "md1", "random", "fib40",
                                  "fib600", "fib30"])
def test_encode_lanes_on_cuda(cuda, case):
    if case == "fib30":
        raw, tree = fib_tree_data(np.random.default_rng(0), 50, n_sym=30)
        lanes = None
    elif case.startswith("fib"):
        raw, tree = fib_tree_data(np.random.default_rng(0), int(case[3:]))
        lanes = 128
    else:
        raw, tree, lanes = make(case, seed=4)[0], None, None
    tries = _retries()
    got, ran = _launched(lambda: encode.encode_lanes(raw, tree=tree,
                                                     lanes=lanes,
                                                     device=cuda))
    assert (ran, _retries() - tries) == ENCODE_ROUTES.get(
        case, (dict(e1_pack=1, e2_compact=1, e3_place=1), 0))
    want = encode_bytes(raw, tree=tree)
    assert got.bits == want.bits
    np.testing.assert_array_equal(got.payload, want.payload)
    np.testing.assert_array_equal(got.tree, want.tree)
    dev = encode_ops.encode_device(raw, tree=tree, device=cuda)
    np.testing.assert_array_equal(dev.payload, want.payload)


def test_cli_encode_on_cuda(cuda, tmp_path, capsys):
    from huffmandecoderongpus_tpu.huffio.format import write_huff
    from huffmandecoderongpus_tpu_torch.harness.cli import main

    raw = text_like(np.random.default_rng(6), 200_000)
    src = tmp_path / "x.bin"
    raw.tofile(src)
    _, ran = _launched(lambda: main(["encode", str(src), "--index", "4096"]))
    assert ran == dict(e1_pack=1, e2_compact=1, e3_place=1)
    assert "index every 4096 symbols" in capsys.readouterr().out
    write_huff(tmp_path / "want.huff", encode_bytes(raw))
    huff = tmp_path / "x.bin.huff"
    assert huff.read_bytes() == (tmp_path / "want.huff").read_bytes()
    assert (tmp_path / "x.bin.huffidx").exists()
    dst = tmp_path / "x.out"
    main(["decode", str(huff), str(dst)])
    np.testing.assert_array_equal(np.fromfile(dst, dtype=np.uint8), raw)


@pytest.mark.parametrize("case", INDEXED)
def test_indexed_kernels_match_plain(cuda, case):
    raw, hf = make_indexed(case)
    offsets, k = hf.index
    st = widescan.stage_widescan_indexed(hf, offsets, k, device=cuda)
    args = widescan.indexed_args(st)
    wmat = widescan.normalize_lane_words(st["raw"], st["sh"]).t().contiguous()
    kw = dict(steps_p=args["steps_p"], md=args["md"], C0=args["C0"],
              C1=args["C1"], NS=args["NS"])
    got = k1_main.k1_main(wmat, st["tab"], st["lim"], **kw)
    want = k1_main.k1_main_ref(wmat, st["tab"], st["lim"], **kw)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    for tiled in (False, True):  # lane_dfa's geometry, the tiled one
        ls = lanedfa_decode.stage_lanedfa_indexed(hf, offsets, device=cuda,
                                                  tiled=tiled)
        a = (ls["bits"], ls["tab"], ls["lane_len"])
        got = lane_scan_indexed.lane_scan_indexed(*a)
        want = lane_scan_indexed.lane_scan_indexed_ref(*a)
        for g, w in zip(got, want):
            assert torch.equal(g, w)
        sym, valid = got
        np.testing.assert_array_equal(sym.t()[valid.t() > 0].cpu().numpy(),
                                      raw)


@pytest.mark.parametrize("case", INDEXED)
def test_indexed_decode_on_cuda(cuda, case):
    from huffmandecoderongpus_tpu_torch.models import get_decoder

    raw, hf = make_indexed(case)
    offsets, k = hf.index
    routes = (
        (lambda: widescan.decode_widescan_indexed(hf, offsets, k,
                                                  device=cuda),
         dict(k1_main=1, k4_compact=1)),
        (lambda: get_decoder("lane_dfa", device=cuda)(hf),
         dict(lane_scan_indexed=1)),
        (lambda: lanedfa_decode.decode_lanedfa_indexed_tiled(
            hf, offsets, k, device=cuda), dict(lane_scan_indexed=1)),
    )
    for fn, path in routes:
        out, ran = _launched(fn)
        assert ran == path
        np.testing.assert_array_equal(out, raw)


def test_indexed_md1_refused_and_scanned(cuda):
    from huffmandecoderongpus_tpu_torch.models import get_decoder

    raw = make("md1")[0]
    hf = encode_bytes(raw, block_symbols=4096)
    with pytest.raises(widescan.EnvelopeError):
        widescan.decode_widescan_indexed(hf, *hf.index, device=cuda)
    out, ran = _launched(lambda: get_decoder("lane_dfa", device=cuda)(hf))
    assert ran == dict(lane_scan_indexed=1)
    np.testing.assert_array_equal(out, raw)


@pytest.mark.parametrize("case", ps.INDEXED_SCAN_CASES)
def test_indexed_scan_edges_match_plain(cuda, case):
    args = ps.indexed_scan_case(case, cuda)
    got = lane_scan_indexed.lane_scan_indexed(*args)
    want = lane_scan_indexed.lane_scan_indexed_ref(*args)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("case", ps.SHORT_SCAN_CASES)
def test_short_scan_edges_match_plain(cuda, case):
    bits, tab, valid0, kw = ps.short_scan_case(case, cuda)
    got = short_candidate_scan.short_candidate_scan(bits, tab, valid0, **kw)
    want = short_candidate_scan.short_candidate_scan_ref(bits, tab, valid0,
                                                         **kw)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)


def test_scan_launchers_refuse_other_plans(cuda):
    # lane_scan_indexed's and short_candidate_scan's launchers refuse a
    # plan outside their rules, nothing launched
    lib = _build.get_lib()
    G, B, H, W = 64, 100, 9, 100
    bits = torch.zeros((B + H, G), dtype=torch.uint8, device=cuda)
    tab = torch.zeros((2, 128), dtype=torch.int32, device=cuda)
    lens = torch.zeros(G, dtype=torch.int32, device=cuda)
    sym, valid = (torch.empty((B, G), dtype=torch.uint8, device=cuda)
                  for _ in range(2))
    p = lanedfa.indexed_plan(G, bits.data_ptr() | sym.data_ptr()
                             | valid.data_ptr(), tab.numel())

    def indexed(shift=0, **change):
        q = {**p, **change}
        return lib.ws_lane_scan_indexed(
            bits.data_ptr() + shift, tab.data_ptr(), lens.data_ptr(),
            sym.data_ptr(), valid.data_ptr(), G, B, tab.numel(), q["lanes"],
            q["rows"], q["vec"], q["shared"], _build.stream_ptr(bits))

    assert p["vec"] == 16 and indexed() == 0
    for bad in (dict(lanes=33), dict(rows=24), dict(vec=2),
                dict(shared=p["shared"] - 16),
                dict(shared=lanedfa.BIT_SHARED_MAX + 16), dict(shift=4)):
        assert indexed(**bad) != 0, bad
    valid0 = torch.zeros_like(bits)
    outs = [torch.empty((H, G), dtype=d, device=cuda)
            for d in (torch.bool, torch.bool, torch.int32, torch.int32,
                      torch.int32)]
    q0 = lanedfa.short_plan(G, H, bits.data_ptr() | valid0.data_ptr())

    def short(shift=0, h=H, **change):
        q = {**q0, **change}
        return lib.ws_short_candidate_scan(
            bits.data_ptr(), tab.data_ptr(), valid0.data_ptr() + shift,
            *(o.data_ptr() for o in outs), G, B, h, B * G, W, tab.numel(),
            q["lanes"], q["rows"], q["vec"], q["shared"],
            _build.stream_ptr(bits))

    assert q0["vec"] == 16 and short() == 0
    for bad in (dict(lanes=33), dict(rows=24), dict(vec=2),
                dict(shared=q0["shared"] - 16), dict(shift=4),
                dict(h=129)):  # 32 lanes x 129 chains: past 1,024 threads
        assert short(**bad) != 0, bad
    torch.cuda.synchronize()


@pytest.mark.parametrize("case", BATCHES)
def test_batch_kernels_match_plain(cuda, case):
    raws, hfs = make_batch(case)
    st = batch.stage_batch_inputs(hfs, device=cuda)
    p = st["plan"]
    H, md = st["H"], st["md"]
    wmat = widescan.words_matrix(st["words"], -(-p["steps_p"] // 32))
    a = (wmat, st["tabs"], st["lim"], st["c01"], st["bstream"])
    k1 = dict(B=p["B"], H=H, steps=p["steps"], steps_p=p["steps_p"],
              SEG=p["SEG"], md=md)
    got = k1_scan2_c01.k1_scan2_c01(*a, **k1)
    want = k1_scan2_c01.k1_scan2_c01_ref(*a, **k1)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    sym, val, cntmap, exmap, mrowmap = want
    exmap[:, list(st["last_live"])] = 0
    entry, _tot = k2_compose.k2_compose(exmap, 0)
    cut, cut_slot = widescan.fix_rows(entry, mrowmap, st["lim"], H, md)
    kw = dict(steps_p=p["steps_p"], SEG=p["SEG"], md=md)
    fa = (wmat, st["tabs"], entry, cut, cut_slot)
    s, v = k3_fix2_c01.k3_fix2_c01(*fa, sym.clone(), val.clone(), st["c01"],
                                   st["bstream"], **kw)
    rs, rv = k3_fix2_c01.k3_fix2_c01_ref(*fa, sym.clone(), val.clone(),
                                         st["c01"], st["bstream"], **kw)
    assert torch.equal(s, rs) and torch.equal(v, rv)


@pytest.mark.parametrize("case", BATCHES)
def test_batch_decode_on_cuda(cuda, case):
    raws, hfs = make_batch(case)
    outs, ran = _launched(lambda: batch.decode_widescan_batch(
        hfs, device=cuda, auto_split=False))
    assert ran == dict(k1_scan2_c01=1, k2_compose=1, k3_fix2_c01=1,
                       k4_compact=1)
    for out, raw in zip(outs, raws):
        np.testing.assert_array_equal(out, raw)


def test_batch_auto_split_on_cuda(cuda, monkeypatch):
    # the largest member decodes alone (the one-shot route), the others in
    # one program
    raws, hfs = make_batch("four")
    monkeypatch.setattr(batch, "BATCH_SOLO_BITS", hfs[1].bits)
    outs, ran = _launched(lambda: batch.decode_widescan_batch(hfs,
                                                              device=cuda))
    assert ran == dict(oneshot=1, k1_scan2_c01=1, k2_compose=1,
                       k3_fix2_c01=1, k4_compact=1)
    for out, raw in zip(outs, raws):
        np.testing.assert_array_equal(out, raw)


SYNC = [("text", 16), ("abcd", 1), ("md1abab", 7), ("ns2", 16),
        ("random", 16), ("md3", None)]


@pytest.mark.parametrize("name,lanes", SYNC)
def test_sync_kernels_match_plain(cuda, name, lanes):
    # the sync geometry: the 0-chain, every round's short candidate scan,
    # and the lane scan cut at W rows from the true entry offsets
    raw, hf = make(name)
    st = lanedfa_decode.stage_lanedfa(hf, device=cuda, lanes=lanes,
                                      tiled=False)
    bits, tab = st["bits"], st["tab"]
    kw = dict(B=st["B"], H=st["H"], N=st["N"])
    steps, G = bits.shape
    zero = torch.zeros(G, dtype=torch.int32, device=cuda)
    sym0, valid0 = lane_scan.lane_scan(bits, tab, zero, **kw)
    for g, w in zip((sym0, valid0), lane_scan.lane_scan_ref(bits, tab, zero,
                                                            **kw)):
        assert torch.equal(g, w)
    W = min(max(lanedfa_sync.W0, st["H"] + 1), steps)
    for w_rows in sorted({W, min(2 * W, steps), steps}):
        got = short_candidate_scan.short_candidate_scan(
            bits, tab, valid0, W=w_rows, **kw)
        want = short_candidate_scan.short_candidate_scan_ref(
            bits, tab, valid0, W=w_rows, **kw)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and torch.equal(g, w)
    cnt, ex = candidate_scan.candidate_scan_ref(bits, tab, **kw)
    entry = lanedfa_decode.compose(cnt, ex)[0]
    for w_rows in (W, steps):
        got = lane_scan.lane_scan(bits[:w_rows], tab, entry, rows=w_rows,
                                  **kw)
        want = lane_scan.lane_scan_ref(bits[:w_rows], tab, entry,
                                       rows=w_rows, **kw)
        for g, w in zip(got, want):
            assert torch.equal(g, w)


@pytest.mark.parametrize("name,lanes", SYNC)
def test_lane_dfa_sync_on_cuda(cuda, name, lanes):
    from huffmandecoderongpus_tpu_torch.models import get_decoder

    raw, hf = make(name)
    r0, f0 = lanedfa_sync.rounds, lanedfa_sync.fix_scans
    out, ran = _launched(lambda: get_decoder("lane_dfa_sync", device=cuda)(
        hf, lanes))
    rounds = lanedfa_sync.rounds - r0
    fixes = lanedfa_sync.fix_scans - f0
    # one short scan a round, the 0-chain and the fix scan, the tail column
    assert ran == dict(short_candidate_scan=rounds, lane_scan=1 + fixes,
                       candidate_scan=1)
    np.testing.assert_array_equal(out, raw)
    # the same rounds as the plain versions on the CPU
    r1 = lanedfa_sync.rounds
    np.testing.assert_array_equal(lanedfa_sync.decode_lanedfa_sync(
        hf, device="cpu", lanes=lanes), raw)
    assert lanedfa_sync.rounds - r1 == rounds


@pytest.mark.parametrize("name", ["text", "ns2", "md1"])
def test_tiled_sync_on_cuda(cuda, name):
    raw, hf = make(name)
    r0 = lanedfa_sync.rounds
    out, ran = _launched(lambda: lanedfa_decode.decode_lanedfa_tiled(
        hf, device=cuda, discovery="sync"))
    assert ran["short_candidate_scan"] == lanedfa_sync.rounds - r0 >= 1
    assert ran["candidate_scan"] == 1 and 1 <= ran["lane_scan"] <= 2
    np.testing.assert_array_equal(out, raw)


def _dense_inputs(hf, dev):
    st = lanedfa_decode.stage_lanedfa(hf, device=dev)
    kw = dict(B=st["B"], H=st["H"], N=st["N"])
    cnt, ex = candidate_scan.candidate_scan(st["bits"], st["tab"], **kw)
    entry = lanedfa_decode.compose(cnt, ex)[0]
    md = lanedfa.build_lane_dfa(hf.tree).min_depth
    out_rows = min(st["B"] + st["H"], st["B"] // max(md, 1) + 2)
    return st, kw, entry, out_rows


@pytest.mark.parametrize("name", sorted(SHAPES) + sorted(MD1_SHAPES))
def test_dense_kernels_match_plain(cuda, name):
    raw, hf = make(name)
    st, kw, entry, out_rows = _dense_inputs(hf, cuda)
    a = (st["bits"], st["tab"], entry)
    for rows in (out_rows, 7):  # counts past out_rows in the second
        dense, counts = lane_decode_dense.lane_decode_dense(
            *a, out_rows=rows, **kw)
        rdense, rcounts = lane_decode_dense.lane_decode_dense_ref(
            *a, out_rows=rows, **kw)
        assert torch.equal(dense, rdense) and torch.equal(counts, rcounts)
    dense, counts = lane_decode_dense.lane_decode_dense(
        *a, out_rows=out_rows, **kw)
    keep = torch.arange(out_rows, device=cuda)[:, None] < counts[None, :]
    np.testing.assert_array_equal(dense.t()[keep.t()].cpu().numpy(), raw)
    sym, valid = lane_scan.lane_scan(*a, **kw)
    cum = torch.cumsum(valid, 0, dtype=torch.int32)
    got = compact.compact(cum, sym, out_rows=out_rows)
    assert torch.equal(got, compact.compact_ref(cum, sym, out_rows=out_rows))
    assert torch.equal(got, dense)


@pytest.mark.parametrize("case", ps.DENSE_CASES)
def test_dense_cases_match_plain(cuda, case):
    # the dense decode at its edges: G 1, 3, 20, 33, 100, out_rows under
    # the counts, lanes that end early, a lane WINDOW ranks ahead (its
    # own write-outs counted as the numpy emulation counts them), a view
    # at +1
    from test_torch_dense_plan import emulate_dense

    bits, tab, start, kw = ps.dense_case(case, cuda)
    ahead = torch.zeros(1, dtype=torch.int32, device=cuda)
    (dense, counts), ran = _launched(
        lambda: lane_decode_dense.lane_decode_dense(bits, tab, start,
                                                    ahead=ahead, **kw))
    assert ran == {"lane_decode_dense": 1}
    rdense, rcounts = lane_decode_dense.lane_decode_dense_ref(bits, tab,
                                                              start, **kw)
    assert torch.equal(dense, rdense) and torch.equal(counts, rcounts)
    sym, valid = lane_scan.lane_scan_ref(bits, tab, start, B=kw["B"],
                                         H=kw["H"], N=kw["N"])
    p = lane_decode_dense.dense_plan(bits.shape[1], bits.data_ptr(),
                                     dense.data_ptr())
    written = emulate_dense(sym.cpu().numpy(), valid.cpu().numpy() != 0,
                            start.cpu().numpy(), kw["B"], kw["N"],
                            kw["out_rows"], p)[2]
    assert int(ahead) == int(written.sum())
    assert (int(ahead) > 0) == (case == "ahead")


@pytest.mark.parametrize("steps,G,out_rows", [(77, 1024, 40), (50, 100, 30),
                                              (200, 1, 200), (64, 130, 0)])
def test_compact_matches_plain(cuda, steps, G, out_rows):
    rng = np.random.default_rng(steps + G)
    valid = torch.from_numpy(rng.random((steps, G)) < 0.5).to(cuda)
    cum = torch.cumsum(valid, 0, dtype=torch.int32)
    sym = torch.from_numpy(rng.integers(0, 256, (steps, G),
                                        np.uint8)).to(cuda)
    got, ran = _launched(lambda: compact.compact(cum, sym,
                                                 out_rows=out_rows))
    assert ran == {"compact": 1}
    assert torch.equal(got, compact.compact_ref(cum, sym, out_rows=out_rows))


@pytest.mark.parametrize("case", ps.COMPACT_CASES)
def test_compact_cases_match_plain(cuda, case):
    # the row-chunk tiles at their edges (probes.streams.COMPACT_CASES):
    # one launch, bit-exact, and the kernel's count of wide-union blocks
    # (a union wider than two chunks) equal to the numpy emulation's
    from test_torch_compact_plan import emulate_compact

    cum, sym, out_rows = ps.compact_case(case, cuda)
    stats = torch.zeros(len(compact.STATS), dtype=torch.int64, device=cuda)
    got, ran = _launched(lambda: compact.compact(cum, sym, out_rows=out_rows,
                                                 stats=stats))
    assert ran == {"compact": 1}
    assert torch.equal(got, compact.compact_ref(cum, sym, out_rows=out_rows))
    p = compact.compact_plan(*cum.shape, out_rows, cum.data_ptr(),
                             sym.data_ptr(), got.data_ptr())
    assert p["vec"] == (1 if case in ("g1", "g33", "g4095", "offset")
                        else 4)
    wide = emulate_compact(cum.cpu().numpy(), sym.cpu().numpy(), out_rows,
                           p)[2]
    st = dict(zip(compact.STATS, stats.tolist()))
    assert [st["wide_blocks"], st["wide_rows"]] == wide
    assert (st["wide_blocks"] > 0) == (case == "wide")
    assert st["cycles"] > 0 or out_rows == 0


@pytest.mark.parametrize("case", ps.P4_CASES)
@pytest.mark.parametrize("stage", k4_stripped.STAGES)
def test_k4_stripped_cases_match_plain(cuda, case, stage):
    # P4 at its edges (probes.streams.P4_CASES), one launch each
    sym, nib, ORP = ps.p4_case(case, cuda)
    got, ran = _launched(lambda: k4_stripped.k4_stripped(sym, nib, ORP=ORP,
                                                         stage=stage))
    assert ran == {"k4_stripped": 1}
    assert torch.equal(got, k4_stripped.k4_stripped_ref(sym, nib, ORP=ORP,
                                                        stage=stage))


def test_compact_and_p4_launchers_refuse_other_plans(cuda):
    # a plan outside the launchers' rules is refused, nothing launched
    lib = _build.get_lib()
    stream = _build.stream_ptr(torch.empty(1, device=cuda))
    cum, sym, out_rows = ps.compact_case("odd-steps", cuda)
    steps, G = cum.shape
    out = torch.empty((out_rows, G), dtype=torch.uint8, device=cuda)
    c = compact.compact_plan(steps, G, out_rows, cum.data_ptr(),
                             sym.data_ptr(), out.data_ptr())

    def cp(shift=0, **change):
        q = {**c, **change}
        return lib.ws_compact(
            cum.data_ptr() + shift, sym.data_ptr(), out.data_ptr(), None,
            steps, G, out_rows, q["W"], q["R"], q["vec"], q["threads"],
            q["shared"], q["tiles"], q["chunks"], q["zrows"], stream)

    assert c["vec"] == 4 and cp() == 0 and cp(vec=1) == 0
    for bad in (dict(W=64), dict(R=32), dict(threads=128), dict(vec=2),
                dict(shared=c["shared"] + 16), dict(tiles=c["tiles"] + 1),
                dict(chunks=c["chunks"] + 1), dict(zrows=c["zrows"] + 1),
                dict(shift=4)):
        assert cp(**bad) != 0, bad
    ksym, knib, ORP = ps.p4_case("cells100", cuda)
    kout = torch.empty((ksym.shape[1], ORP), dtype=torch.uint8, device=cuda)
    k = k4_stripped.p4_plan(ksym.shape[1], ksym.data_ptr(), knib.data_ptr(),
                            kout.data_ptr(), ORP)

    def p4(shift=0, G=None, ORP_=ORP, **change):
        q = {**k, **change}
        return lib.ws_k4_stripped(
            ksym.data_ptr() + shift, knib.data_ptr(), kout.data_ptr(),
            G or ksym.shape[1], ksym.shape[0], ORP_, 1, q["lanes"], q["vec"],
            q["jr"], q["threads"], q["shared"], int(q["store"] == 16),
            stream)

    assert k["vec"] == 4 and k["store"] == 16 and p4() == 0
    assert p4(vec=1, jr=16, threads=256, shared=32 * 144 + 2 * 8 * 32 * 4) == 0
    assert p4(store=4) == 0
    for bad in (dict(lanes=64), dict(jr=16), dict(threads=256), dict(vec=2),
                dict(shared=k["shared"] + 16), dict(shift=4), dict(G=96),
                dict(ORP_=132), dict(ORP_=124)):
        assert p4(**bad) != 0, bad
    torch.cuda.synchronize()


def _probe_cases():
    """The probe kernels' cases, each a ``make_(dev)`` that returns (the
    kernel's output, the plain version's) on seeded tensors on ``dev``."""
    cases = []

    def add(cid, make_):
        cases.append(pytest.param(make_, id=cid))

    def i32(shape, dev, seed=0, lo=-2**31, hi=2**31):
        rng = np.random.default_rng(seed)
        return torch.from_numpy(rng.integers(lo, hi, shape, dtype=np.int64)
                                .astype(np.int32)).to(dev)

    for shape in ((8, 128), (3, 5), (1000, 7)):
        add(f"inc{shape}", lambda dev, shape=shape: (
            lambda x: (probe_inc.probe_inc(x), probe_inc.probe_inc_ref(x)))(
                i32(shape, dev)))
    for shape in ((4, 32, 128), (3, 100, 7)):
        add(f"grid{shape}", lambda dev, shape=shape: (
            lambda x: (probe_inc.probe_grid(x), probe_inc.probe_grid_ref(x)))(
                i32(shape, dev, 1)))
    for body, P, S, dt in (("xor3", 1, 64, torch.int32),
                           ("xor3", 4, 40, torch.int32),
                           ("xor3", 8, 4000, torch.int32),
                           ("xor3", 4, 0, torch.int32),
                           ("addxor", 1, 48, torch.int32),
                           ("addxor", 1, 2000, torch.int16),
                           ("mul3", 1, 64, torch.int32)):
        add(f"{body}-P{P}-S{S}-{dt}", lambda dev, body=body, P=P, S=S, dt=dt: (
            lambda x: (probe_arith.probe_arith(x, body=body, S=S, P=P),
                       probe_arith.probe_arith_ref(x, body=body, S=S, P=P)))(
                i32((128, 128), dev, P, -30000, 30000).to(dt)))
    for R, W, axis, dt in ((256, 1536, 1, torch.int32), (8, 128, 0, torch.int32),
                           (8, 128, 0, torch.uint8), (16, 128, 1, torch.int16),
                           (16, 128, 1, torch.uint16), (5, 33, 1, torch.uint8)):
        def gather(dev, R=R, W=W, axis=axis, dt=dt):
            rng = np.random.default_rng(R + W)
            tab = torch.from_numpy(rng.integers(0, 200, (R, W)).astype(
                np.int16)).to(dev).to(dt)
            n = (R, W)[axis]
            idx = torch.from_numpy(rng.integers(-2, n + 2, (R, W)).astype(
                np.int32)).to(dev)
            return (probe_gather.probe_gather(tab, idx, axis=axis),
                    probe_gather.probe_gather_ref(tab, idx, axis=axis))
        add(f"gather{R}x{W}-ax{axis}-{dt}", gather)
    for P, S, bc in ((1, 4000, False), (4, 64, False), (8, 64, False),
                     (1, 2000, True), (4, 33, True)):
        def chain(dev, P=P, S=S, bc=bc):
            x = i32((128, 128), dev, S, 0, 1 << 20)
            tab = x[:8].contiguous() if bc else x
            return (probe_gather.probe_gather_chain(tab, x, P=P, S=S,
                                                    broadcast=bc),
                    probe_gather.probe_gather_chain_ref(tab, x, P=P, S=S,
                                                        broadcast=bc))
        add(f"chain-P{P}-S{S}-bc{int(bc)}", chain)
    for cells_p, G, ORP in ((128, 256, 256), (130, 256, 256), (1, 64, 128),
                            (412, 8192, 384), (412, 8192, 1024),
                            (0, 64, 128)):
        for stage in k4_stripped.STAGES:
            def k4(dev, cells_p=cells_p, G=G, ORP=ORP, stage=stage):
                sym = i32((cells_p, G), dev, cells_p)
                nib = i32((cells_p, G), dev, G, 0, 256).to(torch.uint8)
                return (k4_stripped.k4_stripped(sym, nib, ORP=ORP, stage=stage),
                        k4_stripped.k4_stripped_ref(sym, nib, ORP=ORP,
                                                    stage=stage))
            add(f"k4-{stage}-{cells_p}x{G}", k4)
    return cases


@pytest.mark.parametrize("make_", _probe_cases())
def test_probe_kernels_match_plain(cuda, make_):
    got, want = make_(cuda)
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        if g.dtype == torch.uint16:  # compared as their int16 bits
            g, w = g.view(torch.int16), w.view(torch.int16)
        assert torch.equal(g, w)


def test_probe_kernels_count_their_launches(cuda):
    x = torch.zeros((8, 128), dtype=torch.int32, device=cuda)
    _, ran = _launched(lambda: (
        probe_inc.probe_inc(x), probe_inc.probe_grid(x[None]),
        probe_arith.probe_arith(x, body="xor3", S=4, P=4),
        probe_gather.probe_gather(x, x, axis=1),
        probe_gather.probe_gather_chain(x, x, P=1, S=4),
        k4_stripped.k4_stripped(x[:, :64].contiguous(),
                                x[:, :64].to(torch.uint8), ORP=128,
                                stage="prefix")))
    assert ran == dict(probe_inc=2, probe_arith=1, probe_gather=2,
                       k4_stripped=1)


def _bits(t):
    """uint16 as its int16 bits: torch compares no uint16 on the card."""
    return t.view(torch.int16) if t.dtype == torch.uint16 else t


def _roll_gather_cases():
    """P3's roll mode and 16-bit indices: each a ``make_(dev)`` that returns
    (the kernel's output, the plain version's)."""
    from huffmandecoderongpus_tpu_torch.probes import probe_gather as pgp
    from huffmandecoderongpus_tpu_torch.probes import probe_vpu

    cases = []

    def seeded(shape, dt, seed, lo=0, hi=1 << 15):
        x = np.random.default_rng(seed).integers(lo, hi, shape)
        return torch.from_numpy(x.astype(np.int32)).to(dt)

    def roll(cid, shape, shift, ax, dt=torch.int32, offset=False):
        def make_(dev):
            # offset: x starts one row into its storage, off the 16 bytes
            x = seeded((shape[0] + offset, shape[1]), dt, shape[1])
            x = x.to(dev)[int(offset):]
            return (probe_gather.probe_roll(x, shift, axis=ax),
                    probe_gather.probe_roll_ref(x, shift, axis=ax))
        cases.append(pytest.param(make_, id=f"roll-{cid}"))

    for shape, shift, ax in probe_vpu.ROLLS:
        cases.append(pytest.param(
            lambda dev, shape=shape, shift=shift, ax=ax: (
                lambda x: (probe_gather.probe_roll(x, shift, axis=ax),
                           probe_gather.probe_roll_ref(x, shift, axis=ax)))(
                    probe_vpu.roll_case(shape, dev)),
            id=f"roll-script{shape}-s{shift}-ax{ax}"))
        roll(f"seeded{shape}-s{shift}-ax{ax}", shape, shift, ax)
    roll("7x33-uint8-s-40-ax1", (7, 33), -40, 1, torch.uint8)
    roll("5x1000-uint16-s999-ax0", (5, 1000), 999, 0, torch.uint16)
    roll("3x13000-s4097-ax1-unstaged", (3, 13000), 4097, 1)
    roll("70000x4-int16-s3-ax0-rows", (70000, 4), 3, 0, torch.int16)
    roll("9x33-offset-ax1", (9, 33), 5, 1, offset=True)
    roll("9x33-offset-ax0", (9, 33), 5, 0, offset=True)

    def gather(cid, tab, idx, axis, offset=False):
        def make_(dev):
            # offset: idx starts one row into its storage
            t, i = tab().to(dev), idx().to(dev)[int(offset):]
            return (probe_gather.probe_gather(t, i, axis=axis),
                    probe_gather.probe_gather_ref(t, i, axis=axis))
        cases.append(pytest.param(make_, id=f"gather-{cid}"))

    for label, axis, tab_np, idx_np in pgp.cases():
        for it in (torch.int16, torch.uint16):
            gather(f"script-{label}-{it}", lambda t=tab_np: torch.from_numpy(t),
                   lambda i=idx_np, it=it: torch.from_numpy(i).to(it), axis)
    for dt in probe_vpu.I16_CASES:
        gather(f"i16-{dt}", lambda dt=dt: probe_vpu.i16_case(dt, "cpu")[0],
               lambda dt=dt: probe_vpu.i16_case(dt, "cpu")[1], 1)
    for axis in (0, 1):
        # a negative int16 reads element 0, a uint16 above 32,767 the last
        gather(f"clamp-int16-ax{axis}",
               lambda: seeded((12, 40), torch.int32, 1, -2**20, 2**20),
               lambda: seeded((12, 40), torch.int16, 2, -2**15, 60), axis)
        gather(f"clamp-uint16-ax{axis}",
               lambda: seeded((12, 40), torch.int32, 3, -2**20, 2**20),
               lambda: seeded((12, 40), torch.uint16, 4, 0, 2**16), axis)
    gather("uint8-5x33-int16", lambda: seeded((5, 33), torch.uint8, 5, 0, 256),
           lambda: seeded((5, 33), torch.int16, 6, -3, 36), 1)
    gather("3x13000-unstaged-int16",
           lambda: seeded((3, 13000), torch.int32, 7, -2**20, 2**20),
           lambda: seeded((3, 13000), torch.int16, 8, -5, 13005), 1)
    gather("70000x4-rows-uint16-ax0",
           lambda: seeded((70000, 4), torch.int32, 9, -2**20, 2**20),
           lambda: seeded((70000, 4), torch.uint16, 10, 0, 1 << 16), 0)
    gather("offset-int32", lambda: seeded((9, 33), torch.int32, 11),
           lambda: seeded((10, 33), torch.int32, 12, -2, 36), 1, True)
    gather("offset-uint16-ax0", lambda: seeded((9, 33), torch.int16, 13),
           lambda: seeded((10, 33), torch.uint16, 14, 0, 12), 0, True)
    return cases


@pytest.mark.parametrize("make_", _roll_gather_cases())
def test_roll_and_16bit_gathers_match_plain(cuda, make_):
    got, want = make_(cuda)
    assert got.dtype == want.dtype and got.shape == want.shape
    assert torch.equal(_bits(got), _bits(want))


def _kernels_a_call(fn, calls=5, tries=3):
    """Kernels the card ran a call of ``fn`` (torch.profiler), from the
    first of ``tries`` sessions whose records are a whole number a call,
    each after a one-call session that is thrown away (it takes any records
    a session before left late), as chip_smoke.py's device_breakdown
    takes them; None where no session was whole."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]):
            fn()
            torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        n = sum(e.count for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA)
        if n and n % calls == 0:
            return n / calls
    return None


#: a fresh process that prints _kernels_a_call of each call a function of
#: this module makes (argv: the checkout, this folder, the function's name)
_FRESH = """
import json, sys, torch
sys.path[:0] = sys.argv[1:3]
import test_torch_cuda as t
calls = getattr(t, sys.argv[3])(torch.device("cuda"))
print(json.dumps([t._kernels_a_call(fn) for fn in calls]))
"""


def _kernels_a_call_fresh(make_calls):
    """_kernels_a_call of each call ``make_calls(device)`` makes, taken in a
    fresh process: the profiler of a process that has run many tests
    records no kernel, or part of a session, now and then (PERF.md section
    7), a new one's every time."""
    here = pathlib.Path(__file__).resolve().parent
    r = subprocess.run([sys.executable, "-c", _FRESH, str(here.parent),
                        str(here), make_calls.__name__], capture_output=True,
                       text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-2000:]
    return json.loads(r.stdout.strip().splitlines()[-1])


def _roll_and_16bit_gather_calls(cuda):
    """The one-shot roll along both axes and the 16-bit index gathers."""
    from huffmandecoderongpus_tpu_torch.probes import probe_vpu

    x = probe_vpu.roll_case((128, 640), cuda)
    calls = []
    for dt in probe_vpu.I16_CASES:
        tab, idx = probe_vpu.i16_case(dt, cuda)
        calls += [lambda: probe_gather.probe_roll(x, 100, axis=1),
                  lambda: probe_gather.probe_roll(x, 5, axis=0),
                  lambda tab=tab, idx=idx: probe_gather.probe_gather(
                      tab, idx, axis=1)]
    return calls


def test_roll_and_16bit_gather_launch_one_kernel(cuda):
    calls = _roll_and_16bit_gather_calls(cuda)
    for fn in calls:
        _, ran = _launched(fn)
        assert ran == {"probe_gather": 1}
    assert _kernels_a_call_fresh(_roll_and_16bit_gather_calls) == [1] * len(
        calls)


def test_launches_follow_the_current_stream(cuda):
    # captured into a CUDA graph, the launches must go to the capturing
    # stream (a launch to another stream breaks the capture), and a replay
    # must recompute from the inputs as they are then
    _, hf = make("text")
    dfa = lanedfa.build_lane_dfa(hf.tree)
    H, B, G = dfa.height, 512, 96
    kw = dict(B=B, H=H, N=B * G - 700)
    ftab = torch.from_numpy(lanedfa.pad_table(dfa.entry)).to(cuda)

    def inputs(seed):
        rng = np.random.default_rng(seed)
        return (rng.integers(-2**31, 2**31, (8, 128)).astype(np.int32),
                rng.integers(0, 1 << 20, (16, 128)).astype(np.int32),
                rng.integers(-3, 131, (16, 128)).astype(np.int16),
                rng.integers(0, 1 << 20, (64, 128)).astype(np.int32),
                rng.integers(0, 2, (B + H, G)).astype(np.uint8),
                rng.integers(0, H, G).astype(np.int32),
                rng.integers(-2**31, 2**31, (50, 96)).astype(np.int32),
                rng.integers(0, 16, (50, 96)).astype(np.uint8))

    x, tab, idx, xr, bits, start, csym, cval = (torch.from_numpy(a).to(cuda)
                                                for a in inputs(0))

    def run():
        return (probe_inc.probe_inc(x),
                probe_gather.probe_gather(tab, idx, axis=1),
                probe_gather.probe_roll(xr, 5, axis=0),
                candidate_scan.candidate_scan(bits, ftab, **kw),
                lane_scan.lane_scan(bits, ftab, start, **kw),
                k4_compact.k4_compact(csym, cval, ORP=128))

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        run()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outs = run()
    for seed in (1, 2):
        for t, a in zip((x, tab, idx, xr, bits, start, csym, cval),
                        inputs(seed)):
            t.copy_(torch.from_numpy(a))
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(outs[0], probe_inc.probe_inc_ref(x))
        assert torch.equal(outs[1], probe_gather.probe_gather_ref(
            tab, idx, axis=1))
        assert torch.equal(outs[2], probe_gather.probe_roll_ref(xr, 5,
                                                                axis=0))
        for got, want in ((outs[3], candidate_scan.candidate_scan_ref(
                bits, ftab, **kw)), (outs[4], lane_scan.lane_scan_ref(
                    bits, ftab, start, **kw))):
            assert all(torch.equal(g, w) for g, w in zip(got, want))
        assert torch.equal(outs[5], k4_compact.k4_compact_ref(csym, cval,
                                                              ORP=128))


def test_wrappers_refuse_on_cuda(cuda):
    x = torch.zeros((8, 128), dtype=torch.int32, device=cuda)
    sq = torch.zeros((16, 16), dtype=torch.int32, device=cuda)
    for call in (
            lambda: probe_gather.probe_gather(x, x.cpu(), axis=1),
            lambda: probe_gather.probe_gather(sq, sq.t(), axis=1),
            lambda: probe_gather.probe_gather(x, x.long(), axis=1),
            lambda: probe_gather.probe_roll(x[:, ::2], 1, axis=1),
            lambda: probe_inc.probe_inc(x[:, ::2]),
            lambda: probe_inc.probe_inc(x.long()),
            lambda: candidate_scan.candidate_scan(x, x, B=4, H=4, N=8),
            lambda: candidate_scan.candidate_scan(x.byte()[:, ::2], x,
                                                  B=4, H=4, N=8),
            lambda: lane_scan.lane_scan(x.byte(), x, x[0].long(), B=4, H=4,
                                        N=8),
            lambda: lane_scan.lane_scan(x.byte(), x, x[0, :7], B=4, H=4,
                                        N=8, rows=8),
            lambda: k4_compact.k4_compact(x[:, ::2], x.byte()[:, ::2],
                                          ORP=128),
            lambda: k4_compact.k4_compact(x, x.byte(), ORP=100),
            lambda: k4_compact.k4_compact(x, x.byte().cpu(), ORP=128)):
        with pytest.raises(ValueError):
            call()


@pytest.mark.parametrize("name", ["dispatch", "k1fixed", "k4", "gather",
                                  "vpu", "vpu2"])
def test_probe_programs_on_cuda(cuda, name):
    from huffmandecoderongpus_tpu_torch import probes

    probes.run(name, cuda, steps=64, nbytes=200_000)


@pytest.mark.parametrize("which", ["widescan", "lanedfa"])
def test_profile_on_cuda(cuda, which):
    from huffmandecoderongpus_tpu_torch.harness import profiling

    _raw, hf = make("text")
    fn = (profiling.profile_widescan if which == "widescan"
          else profiling.profile_lanedfa)
    report = fn(hf, reps=2, device=cuda)
    assert report["total"] > 0 and min(report.values()) >= 0


def _spec_stream(name):
    """(raw, HuffFile) of a speculative-pipeline case; raw is None for the
    stream cut 3 bits short, whose chain cannot end at its bits."""
    from huffmandecoderongpus_tpu_torch import huffio as phuffio

    rng = np.random.default_rng(19)
    if name == "paper1":
        raw = text_like(rng, ps.PAPER1_BYTES)
    elif name == "u12":  # height 4: level 13 the first int32 level
        raw = rng.choice(np.arange(65, 77, dtype=np.uint8), size=20_000)
    elif name == "cut":
        hf = phuffio.encode_bytes(text_like(rng, 9000))
        return None, phuffio.HuffFile(
            tree=hf.tree, bits=hf.bits - 3,
            uncompressed_size=hf.uncompressed_size,
            payload=hf.payload[:(hf.bits + 4) // 8])
    else:
        raw = np.frombuffer([b"a", b"ab", b"aab", b"x" * 7][int(name[4:])],
                            dtype=np.uint8)
    return raw, phuffio.encode_bytes(raw)


SPEC_STREAMS = ["paper1", "u12", "cut", "tiny0", "tiny1", "tiny2", "tiny3"]


def _s2_matches_plain(step0, plan, tile=None):
    """The kept levels by S2's tile and pair launches (``s2_plan``, on
    ``tile`` where given), each against its plain version, and the
    one-level ``spec_double`` (the yardstick) at every level against its
    plain version, its even levels against the kept ones."""
    p = spec_tile.s2_plan(plan.bits, plan.height, plan.levels,
                          sms=_build.sm_count(step0.device), tile=tile,
                          size=plan.size)
    kw = dict(bits=plan.bits, height=plan.height)
    kept = [step0]
    if p["m"]:
        got = spec_tile.spec_tile(step0, m=p["m"], tile=p["tile"], **kw)
        want = spec_tile.spec_tile_ref(step0, bits=plan.bits, m=p["m"])
        assert all(torch.equal(g, w) for g, w in zip(got, want))
        kept += got
    for k, seg in zip(p["pairs"], p["segs"]):
        dtype = spec_double.level_dtype(k, plan.height)
        got = spec_pair.spec_pair(kept[-1], bits=plan.bits, dtype=dtype,
                                  seg=seg)
        assert torch.equal(got, spec_pair.spec_pair_ref(
            kept[-1], bits=plan.bits, dtype=dtype))
        kept.append(got)
    lv = step0
    for k in range(1, max(plan.levels, 1)):
        dtype = spec_double.level_dtype(k, plan.height)
        got = spec_double.spec_double(lv, bits=plan.bits, dtype=dtype)
        assert torch.equal(got, spec_double.spec_double_ref(
            lv, bits=plan.bits, dtype=dtype))
        lv = got
        if k % 2 == 0:
            assert torch.equal(got, kept[k // 2])
    assert len(kept) == spec_query.kept_count(plan.levels)
    return kept


@pytest.mark.parametrize("name", SPEC_STREAMS)
def test_spec_kernels_match_plain(cuda, name):
    raw, hf = _spec_stream(name)
    plan, (w, s, ln) = speculative.decode_device_arrays(hf, device=cuda)
    kw = dict(bits=plan.bits, height=plan.height)
    step0, sym = spec_all_bits.spec_all_bits(w, s, ln, **kw)
    want = spec_all_bits.spec_all_bits_ref(w, s, ln, **kw)
    assert torch.equal(step0, want[0]) and torch.equal(sym, want[1])
    kept = _s2_matches_plain(step0, plan)
    q = dict(bits=plan.bits, size=plan.size, levels=plan.levels)
    result, found = spec_query.spec_query(kept, sym, **q)
    rres, rfound = spec_query.spec_query_ref(kept, sym, **q)
    assert torch.equal(result, rres) and int(found) == int(rfound)
    if raw is None:
        assert int(found) == -1
    else:
        assert int(found) == raw.size
        np.testing.assert_array_equal(result.cpu().numpy(), raw)


@pytest.mark.parametrize("seg", [2, 5, 16])
def test_spec_pair_in_span_order_matches_plain(cuda, seg):
    # the block order the plan gives top levels of large streams, here on
    # paper1-sized text: every block once, whatever the order
    _raw, hf = _spec_stream("paper1")
    plan, (w, s, ln) = speculative.decode_device_arrays(hf, device=cuda)
    step0, _sym = spec_all_bits.spec_all_bits(w, s, ln, bits=plan.bits,
                                              height=plan.height)
    lv = spec_double.spec_double_ref(step0, bits=plan.bits,
                                     dtype=torch.int16)
    got = spec_pair.spec_pair(lv, bits=plan.bits, dtype=torch.int16,
                              seg=seg)
    assert torch.equal(got, spec_pair.spec_pair_ref(lv, bits=plan.bits,
                                                    dtype=torch.int16))


@pytest.mark.parametrize("case", ps.SPEC_CASES)
def test_spec_cases_match_plain(cuda, case):
    # every launch against its plain version; the cut cases (raw None)
    # give found_size -1 from both
    raw, hf, tile = ps.spec_case(case)
    plan, (w, s, ln) = speculative.decode_device_arrays(hf, device=cuda)
    kw = dict(bits=plan.bits, height=plan.height)
    step0, sym = spec_all_bits.spec_all_bits(w, s, ln, **kw)
    want = spec_all_bits.spec_all_bits_ref(w, s, ln, **kw)
    assert torch.equal(step0, want[0]) and torch.equal(sym, want[1])
    kept = _s2_matches_plain(step0, plan, tile)
    q = dict(bits=plan.bits, size=plan.size, levels=plan.levels)
    result, found = spec_query.spec_query(kept, sym, **q)
    rres, rfound = spec_query.spec_query_ref(kept, sym, **q)
    assert torch.equal(result, rres) and int(found) == int(rfound)
    assert int(found) == (-1 if raw is None else raw.size)
    if raw is not None:
        np.testing.assert_array_equal(result.cpu().numpy(), raw)
    kw = dict(bits=plan.bits, size=plan.size, height=plan.height)
    out, n = onethread.onethread(w, s, ln, **kw)
    rout, rn = onethread.onethread_ref(w, s, ln, **kw)
    assert torch.equal(out, rout) and int(n) == int(rn)
    if raw is not None:
        assert int(n) == raw.size


@pytest.mark.parametrize("case,lengths", ps.NO_CODE_CASES)
def test_spec_all_bits_on_windows_of_no_code(cuda, case, lengths):
    # a table less some codes (length and symbol 0 at their windows, as an
    # incomplete tree's), whole in shared memory and in two levels: step0 0
    # and the symbol there as the plain version has them
    _raw, hf, _tile = ps.spec_case(case)
    _h, sym, ln = ps.table_without_codes(hf.tree, lengths)
    plan, (w, _s, _ln) = speculative.decode_device_arrays(hf, device=cuda)
    s, ln = torch.from_numpy(sym).to(cuda), torch.from_numpy(ln).to(cuda)
    for bits in (plan.bits, plan.bits - 5):
        kw = dict(bits=bits, height=plan.height)
        step0, got = spec_all_bits.spec_all_bits(w, s, ln, **kw)
        want = spec_all_bits.spec_all_bits_ref(w, s, ln, **kw)
        assert torch.equal(step0, want[0]) and torch.equal(got, want[1])
        assert (step0 == 0).any()


#: a kernel that leaves -32768 in all the shared memory its blocks get
_POISON_CU = r"""
#include <cstdint>
#include <cuda_runtime.h>

__global__ void poison_kernel(int n) {
  extern __shared__ int16_t buf[];
  volatile int16_t* v = buf;
  for (int i = threadIdx.x; i < n; i += blockDim.x) v[i] = INT16_MIN;
}

extern "C" int poison(int blocks, int shared, cudaStream_t stream) {
  cudaFuncSetAttribute(poison_kernel,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, shared);
  poison_kernel<<<blocks, 1024, shared, stream>>>(shared / 2);
  return (int)cudaGetLastError();
}
"""


@pytest.fixture(scope="module")
def poison_shared(cuda, tmp_path_factory):
    """A call that fills every SM's shared memory with -32768: four
    blocks an SM, each with the most a tile launch's block may have."""
    import ctypes

    d = tmp_path_factory.mktemp("poison")
    (d / "poison.cu").write_text(_POISON_CU)
    subprocess.run([_build.nvcc(), *_build.ARCH, "-Xcompiler", "-fPIC",
                    "-shared", "-o", str(d / "poison.so"),
                    str(d / "poison.cu")], check=True, capture_output=True)
    lib = ctypes.CDLL(str(d / "poison.so"))
    lib.poison.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    lib.poison.restype = ctypes.c_int

    def run(t):
        assert lib.poison(4 * _build.sm_count(cuda), spec_tile.SHARED_MAX,
                          _build.stream_ptr(t)) == 0

    return run


def _odd_bits_text():
    """(raw, HuffFile) of seeded text whose ``bits`` is odd."""
    from huffmandecoderongpus_tpu_torch import huffio as phuffio

    for n in range(3000, 3100):
        raw = text_like(np.random.default_rng(n), n)
        hf = phuffio.encode_bytes(raw)
        if hf.bits % 2:
            return raw, hf
    raise AssertionError("no odd bits")


@pytest.mark.parametrize("tiles", ["sliver", "plan"])
def test_spec_tile_reads_nothing_unstaged(cuda, poison_shared, tiles):
    # the last block's range ends at an odd ``bits``, so its last pair of
    # offsets has a high half past the level (never staged at level 1):
    # that half is taken as -1, whatever the shared memory held, so -32768
    # left there by another kernel changes nothing (read as a span, it
    # would index before the buffer); "sliver" gives 3 tiles and 100-123
    # offsets, "plan" the plan's own tile
    raw, hf = _odd_bits_text()
    plan, (w, s, ln) = speculative.decode_device_arrays(hf, device=cuda)
    tile = (plan.bits - 100) // 24 * 8 if tiles == "sliver" else None
    p = spec_tile.s2_plan(plan.bits, plan.height, plan.levels,
                          size=plan.size, tile=tile)
    rest = plan.bits - (p["blocks"] - 1) * p["tile"]
    assert rest % 2 and rest < p["tile"] + p["halo"]
    step0, sym = spec_all_bits.spec_all_bits(w, s, ln, bits=plan.bits,
                                             height=plan.height)
    want = spec_tile.spec_tile_ref(step0, bits=plan.bits, m=p["m"])
    for _ in range(3):
        poison_shared(step0)
        got = spec_tile.spec_tile(step0, bits=plan.bits, height=plan.height,
                                  m=p["m"], tile=p["tile"])
        torch.cuda.synchronize(cuda)
        assert all(torch.equal(g, x) for g, x in zip(got, want))
    poison_shared(step0)
    result, found = speculative.speculative_decode(
        w, s, ln, bits=plan.bits, size=plan.size, height=plan.height,
        levels=plan.levels)
    assert int(found) == raw.size
    np.testing.assert_array_equal(result.cpu().numpy(), raw)


@pytest.mark.parametrize("name", SPEC_STREAMS)
def test_onethread_matches_plain(cuda, name):
    _raw, hf = _spec_stream(name)
    plan, (w, s, ln) = speculative.decode_device_arrays(hf, device=cuda)
    kw = dict(bits=plan.bits, size=plan.size, height=plan.height)
    out, n = onethread.onethread(w, s, ln, **kw)
    rout, rn = onethread.onethread_ref(w, s, ln, **kw)
    assert torch.equal(out, rout) and int(n) == int(rn)


def test_spec_decoders_launch_their_kernels(cuda):
    from huffmandecoderongpus_tpu_torch.models import get_decoder

    for name in ("paper1", "tiny1", "tiny3"):
        raw, hf = _spec_stream(name)
        plan = speculative.make_plan(
            hf.bits, hf.uncompressed_size,
            speculative.build_decode_lut(hf.tree).height)
        p = spec_tile.s2_plan(plan.bits, plan.height, plan.levels,
                              size=plan.size, sms=_build.sm_count(cuda))
        out, ran = _launched(lambda: get_decoder("spec_xla", device=cuda)(hf))
        np.testing.assert_array_equal(out, raw)
        want = {"spec_all_bits": 1, "spec_tile": int(p["m"] > 0),
                "spec_pair": len(p["pairs"]), "spec_query": 1}
        assert ran == {k: v for k, v in want.items() if v}
        out, ran = _launched(lambda: get_decoder("onethread_device",
                                                 device=cuda)(hf))
        np.testing.assert_array_equal(out, raw)
        assert ran == {"onethread": 1}
    _raw, hf = _spec_stream("cut")
    with pytest.raises(RuntimeError, match="decoded -1 symbols"):
        get_decoder("spec_xla", device=cuda)(hf)
    # the walk checks its count only (as the JAX one): a header 10 symbols
    # short makes it raise, the cut stream does not
    _raw, hf = _spec_stream("paper1")
    hf.uncompressed_size -= 10
    with pytest.raises(RuntimeError, match="decoded 53161 symbols"):
        get_decoder("onethread_device", device=cuda)(hf)


def test_profile_speculative_on_cuda(cuda):
    from huffmandecoderongpus_tpu_torch.harness import profiling

    _raw, hf = _spec_stream("paper1")
    report = profiling.profile_speculative(hf, reps=2, device=cuda)
    assert list(report) == ["decodeAllBits", "makebigtable", "index_query",
                            "total"]
    assert report["total"] > 0 and min(report.values()) >= 0


# ---------------------------------------------------------------------------
# the multi-device layer on the card: virtual shards of one card


_SHARDED_PATHS = {
    "spec_sharded": {},  # torch ops, no kernel of its own
    "lane_sharded": {"candidate_scan": 1, "lane_scan": 1},
    "lane_sharded_wide": {"k1_scan2": 1, "k2_compose": 2, "k3_fix2": 1,
                          "k4_compact": 1},
}


@pytest.mark.parametrize("name", sorted(_SHARDED_PATHS))
def test_sharded_registry_entries_on_cuda(cuda, name):
    # one shard a visible card; each shard launches its path once (K2
    # twice: its composite map, then its entries)
    from huffmandecoderongpus_tpu_torch.models import get_decoder

    raw = text_like(np.random.default_rng(12), 200_000)
    hf = encode_bytes(raw)
    D = torch.cuda.device_count()
    out, ran = _launched(lambda: get_decoder(name, device=cuda)(hf))
    np.testing.assert_array_equal(out, raw)
    assert ran == {k: v * D for k, v in _SHARDED_PATHS[name].items()}
    hf.uncompressed_size += 7
    with pytest.raises(RuntimeError, match="decoded"):
        get_decoder(name, device=cuda)(hf)


@pytest.mark.parametrize("D", [2, 4])
def test_sharded_decodes_on_virtual_shards(cuda, D):
    from huffmandecoderongpus_tpu_torch.parallel import (
        decode_lane_sharded,
        decode_lane_sharded_indexed,
        decode_lane_sharded_wide,
        decode_sharded,
        make_mesh,
    )

    mesh = make_mesh(devices=[cuda] * D)
    raw = text_like(np.random.default_rng(13), 300_000)
    hf = encode_bytes(raw)
    for fn, name in ((decode_sharded, "spec_sharded"),
                     (decode_lane_sharded, "lane_sharded"),
                     (decode_lane_sharded_wide, "lane_sharded_wide")):
        out, ran = _launched(lambda fn=fn: fn(hf, mesh=mesh))
        np.testing.assert_array_equal(out, raw)
        assert ran == {k: v * D for k, v in _SHARDED_PATHS[name].items()}
    hfi = encode_bytes(raw, block_symbols=512)
    out, ran = _launched(lambda: decode_lane_sharded_indexed(
        hfi, *hfi.index, mesh=mesh))
    np.testing.assert_array_equal(out, raw)
    assert ran == {"k1_main": D, "k4_compact": D}


def test_wide_shards_match_plain_on_cuda(cuda):
    # each shard's K1-K4 against their plain versions on the card
    from huffmandecoderongpus_tpu_torch.parallel import lane_sharded, make_mesh

    raw = text_like(np.random.default_rng(14), 300_000)
    hf = encode_bytes(raw)
    run, materialize = lane_sharded.lane_sharded_wide_runner(
        hf, mesh=make_mesh(devices=[cuda] * 2))
    trace = {}
    out = run(trace)
    np.testing.assert_array_equal(materialize(out)[0], raw)
    st = lane_sharded.wide_sharded_staging(hf, 2, device=cuda)
    p = st["plan"]
    k1 = dict(B=p["B"], H=st["H"], steps=p["steps"], steps_p=p["steps_p"],
              SEG=p["SEG"], md=st["md"], C0=st["C0"], C1=st["C1"],
              NS=st["NS"])
    k3 = dict(steps_p=p["steps_p"], SEG=p["SEG"], md=st["md"], C0=st["C0"],
              C1=st["C1"], NS=st["NS"])
    for sh in trace["shards"]:
        wm, tab, lim = sh["inputs"]
        for g, w in zip(sh["k1"], k1_scan2.k1_scan2_ref(wm, tab, lim, **k1)):
            assert torch.equal(g, w)
        exmap = sh["k1"][3]
        assert torch.equal(sh["tot"], k2_compose.k2_compose_ref(exmap, 0)[1])
        assert torch.equal(sh["entry"],
                           k2_compose.k2_compose_ref(exmap, sh["start"])[0])
        rs, rv = k3_fix2.k3_fix2_ref(wm, tab, sh["entry"], *sh["cut"],
                                     sh["k1"][0].clone(), sh["k1"][1].clone(),
                                     **k3)
        assert torch.equal(sh["k3"][0], rs) and torch.equal(sh["k3"][1], rv)
        assert torch.equal(sh["k4"], k4_compact.k4_compact_ref(
            rs, rv, ORP=p["ORP"]))


def test_lane_shards_past_the_stream_on_cuda(cuda):
    # shards wholly past the stream: the scans' limit N - lane0*B is zero
    # or negative, the kernels clamp it and no lane is live
    from huffmandecoderongpus_tpu_torch.parallel import lane_sharded, make_mesh

    raw = text_like(np.random.default_rng(15), 400)
    hf = encode_bytes(raw)
    out = lane_sharded.decode_lane_sharded(hf, mesh=make_mesh(
        devices=[cuda] * 8))
    np.testing.assert_array_equal(out, raw)
    dfa = lanedfa.build_lane_dfa(hf.tree)
    mat, B = lanedfa.bits_matrix(hf.payload, hf.bits, 8, dfa.height,
                                 round_to=512)
    tab = torch.from_numpy(lanedfa.pad_table(dfa.entry)).to(cuda)
    for d in range(8):
        bits_d = torch.from_numpy(np.ascontiguousarray(mat[:, d:d + 1])).to(
            cuda)
        kw = dict(B=B, H=dfa.height, N=hf.bits - d * B)
        cnt, ex = candidate_scan.candidate_scan(bits_d, tab, **kw)
        rcnt, rex = candidate_scan.candidate_scan_ref(bits_d, tab, **kw)
        assert torch.equal(cnt, rcnt) and torch.equal(ex, rex)
        start = torch.zeros(1, dtype=torch.int32, device=cuda)
        sym, valid = lane_scan.lane_scan(bits_d, tab, start, **kw)
        rsym, rvalid = lane_scan.lane_scan_ref(bits_d, tab, start, **kw)
        assert torch.equal(sym, rsym) and torch.equal(valid, rvalid)
        if hf.bits - d * B <= 0:
            assert not valid.any()

"""The CUDA kernels on the card, against their plain torch versions.

Needs an NVIDIA GPU and nvcc; skips elsewhere.  This file imports no jax, so
on a machine without jax it runs without the suite's conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Every stream's decode path is checked kernel by kernel: K1-K4 for min code
length >= 2, the 1-bit K1'/K3' with K2/K4 for md = 1, the fused one-shot
kernel for the small streams ``lane_wide`` routes to it, and the lane-DFA
candidate and lane scans for the streams the wide program refuses.  The
encoder's E1-E3 are checked on the staging of the test shapes and on
hand-made lanes (granules shared by up to 16 lanes, trailing empty lanes,
counts reaching ORP), and ``encode_lanes`` and the ``encode`` command
byte-equal to the host encoder.  The sidecar-indexed route (K1's main scan
``k1_main``, the indexed lane scan) and the batched route (``k1_scan2_c01``,
``k3_fix2_c01``) are checked kernel by kernel and end to end with their
launch counts, and so is the self-synchronizing discovery (the short
candidate scan, the lane scan cut at W rows) of ``lane_dfa_sync``; the
dense lane decode and the compaction are checked against their plain
versions and through the dense pipeline.  The probe kernels (``probe_inc``,
``probe_arith``, ``probe_gather``, ``k4_stripped``) are checked against
their plain versions at the scripts' shapes and at odd ones, and the probe
programs and the stage profiler run on the card.  Tolerance: bit-exact
(integer outputs).
"""

import numpy as np
import pytest
import torch

from huffmandecoderongpus_tpu import native
from huffmandecoderongpus_tpu.huffio.encoder import encode_bytes
from huffmandecoderongpus_tpu_torch.ops import batch, candidate_scan, compact
from huffmandecoderongpus_tpu_torch.ops import e1_pack
from huffmandecoderongpus_tpu_torch.ops import e2_compact, e3_place, encode
from huffmandecoderongpus_tpu_torch.ops import encode_ops, k1_main, k1_scan
from huffmandecoderongpus_tpu_torch.ops import k1_scan2, k1_scan2_c01
from huffmandecoderongpus_tpu_torch.ops import k2_compose, k3_fix, k3_fix2
from huffmandecoderongpus_tpu_torch.ops import k3_fix2_c01, k4_compact
from huffmandecoderongpus_tpu_torch.ops import lane_scan, lane_scan_indexed
from huffmandecoderongpus_tpu_torch.ops import lane_decode_dense, lanedfa
from huffmandecoderongpus_tpu_torch.ops import lanedfa_decode, lanedfa_sync
from huffmandecoderongpus_tpu_torch.ops import oneshot, short_candidate_scan
from huffmandecoderongpus_tpu_torch.ops import widescan
from huffmandecoderongpus_tpu_torch.ops import k4_stripped, probe_arith
from huffmandecoderongpus_tpu_torch.ops import probe_gather, probe_inc
from torch_streams import BATCHES, INDEXED, MD1_SHAPES, SHAPES, fib_tree_data
from torch_streams import fuzz, fuzz_any, make, make_batch, make_indexed
from torch_streams import placed_lanes, text_like

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


KERNEL_MODULES = (k1_scan2, k2_compose, k3_fix2, k4_compact, k1_scan,
                  k3_fix, candidate_scan, lane_scan, oneshot, e1_pack,
                  e2_compact, e3_place, k1_main, lane_scan_indexed,
                  k1_scan2_c01, k3_fix2_c01, short_candidate_scan,
                  lane_decode_dense, compact, probe_inc, probe_arith,
                  probe_gather, k4_stripped)


def _launched(fn):
    """fn()'s result and the kernels it launched, {module name: count}."""
    before = [m.launches for m in KERNEL_MODULES]
    out = fn()
    ran = {m.__name__.rsplit(".", 1)[1]: m.launches - b
           for m, b in zip(KERNEL_MODULES, before) if m.launches != b}
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


def test_lane_wide_small_stream_is_one_launch(cuda):
    from huffmandecoderongpus_tpu_torch.models import get_decoder

    raw = text_like(np.random.default_rng(7), 300_000)
    hf = encode_bytes(raw)
    assert hf.bits < widescan.ONESHOT_MAX_BITS
    out, ran = _launched(lambda: get_decoder("lane_wide", device=cuda)(hf))
    assert ran == {"oneshot": 1}
    np.testing.assert_array_equal(out, raw)


def test_oneshot_grid_not_coresident_raises(cuda):
    # more blocks than the card holds at once: the launcher refuses the
    # cooperative launch instead of running a grid that can deadlock
    L = 529
    G = 256 * L  # 1058 blocks of 128 lanes, in 256 groups of L lanes
    words = torch.zeros((G, 1), dtype=torch.int32, device=cuda)
    lim = torch.full((G,), 32, dtype=torch.int32, device=cuda)
    tab = torch.zeros((2, 128), dtype=torch.int32, device=cuda)
    before = oneshot.launches
    with pytest.raises(RuntimeError, match="oneshot: CUDA error"):
        oneshot.oneshot_program(words, tab, lim, B=32, H=2, steps=34,
                                steps_p=64, SEG=32, md=2, C0=1, C1=2, NS=1,
                                ORP=128)
    assert oneshot.launches == before + 1


def _fallback_decode(cuda, hf, **kw):
    before = (candidate_scan.launches, lane_scan.launches)
    out = widescan.decode_widescan(hf, device=cuda, **kw)
    assert (candidate_scan.launches, lane_scan.launches) == (
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
    """E1, E2, shift and E3 on staged inputs, each kernel against its plain
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
    shift, word_off, occ = encode.lane_offsets(bits)
    shifted = encode.shift_lanes(d, cnt, shift)
    kw = dict(NROWS=p["NROWS"])
    e3a = (shifted, word_off, occ)
    out = e3_place.e3_place(*e3a, **kw)
    assert torch.equal(out, e3_place.e3_place_ref(*e3a, **kw))
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
    shifted, W, occ, _a, gran = placed_lanes(np.random.default_rng(1),
                                             lane_bits, 128)
    n = gran.size
    NROWS = (-(-n // 128) + 9) // 8 * 8
    args = [torch.from_numpy(x).to(cuda) for x in (shifted, W, occ)]
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
    tries = encode.device_retries
    got, ran = _launched(lambda: encode.encode_lanes(raw, tree=tree,
                                                     lanes=lanes,
                                                     device=cuda))
    assert (ran, encode.device_retries - tries) == ENCODE_ROUTES.get(
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
                            (412, 8192, 384)):
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

"""The CUDA kernels on the card, against their plain torch versions.

Needs an NVIDIA GPU and nvcc; skips elsewhere.  This file imports no jax, so
on a machine without jax it runs without the suite's conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Every stream's decode path is checked kernel by kernel: K1-K4 for min code
length >= 2, the 1-bit K1'/K3' with K2/K4 for md = 1, and the lane-DFA
candidate and lane scans for the streams the wide program refuses.
Tolerance: bit-exact (integer outputs).
"""

import numpy as np
import pytest
import torch

from huffmandecoderongpus_tpu import native
from huffmandecoderongpus_tpu.huffio.encoder import encode_bytes
from huffmandecoderongpus_tpu_torch.ops import candidate_scan, k1_scan
from huffmandecoderongpus_tpu_torch.ops import k1_scan2, k2_compose, k3_fix
from huffmandecoderongpus_tpu_torch.ops import k3_fix2, k4_compact
from huffmandecoderongpus_tpu_torch.ops import lane_scan, lanedfa_decode
from huffmandecoderongpus_tpu_torch.ops import widescan
from torch_streams import MD1_SHAPES, SHAPES, fuzz, fuzz_any, make, text_like

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


@pytest.mark.parametrize("name", sorted(SHAPES) + sorted(MD1_SHAPES))
def test_decode_on_cuda(cuda, name):
    raw, hf = make(name, seed=1)
    scan = k1_scan if name in MD1_SHAPES else k1_scan2
    before = scan.launches
    out = widescan.decode_widescan(hf, device=cuda)
    assert scan.launches == before + 1
    np.testing.assert_array_equal(out, raw)
    np.testing.assert_array_equal(out, native.simple_decode(hf))


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
    before = k1_scan2.launches
    out = _fallback_decode(cuda, hf, lanes=512)
    assert k1_scan2.launches == before + 1  # the wide program ran first
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

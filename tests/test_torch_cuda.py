"""The CUDA kernels K1-K4 on the card, against their plain torch versions.

Needs an NVIDIA GPU and nvcc; skips elsewhere.  This file imports no jax, so
on a machine without jax it runs without the suite's conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Tolerance: bit-exact (integer outputs), on every envelope shape.
"""

import numpy as np
import pytest
import torch

from huffmandecoderongpus_tpu import native
from huffmandecoderongpus_tpu_torch.ops import k1_scan2, k2_compose, k3_fix2
from huffmandecoderongpus_tpu_torch.ops import k4_compact, widescan
from torch_streams import SHAPES, fuzz, make

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _stream(case):
    if case.startswith("fuzz"):
        raw, hf, lanes = fuzz(int(case[4:]))
        return raw, hf, lanes
    name, lanes = case.split("-")
    raw, hf = make(name)
    return raw, hf, None if lanes == "auto" else int(lanes)


CASES = ([f"{n}-{lanes}" for n in sorted(SHAPES) for lanes in ("512", "auto")]
         + [f"fuzz{i}" for i in range(12)])


@pytest.mark.parametrize("case", CASES)
def test_kernels_match_plain(cuda, case):
    raw, hf, lanes = _stream(case)
    st = widescan.stage_widescan_inputs(hf, device=cuda, lanes=lanes)
    p = st["plan"]
    kw = dict(steps_p=p["steps_p"], SEG=p["SEG"], md=st["md"], C0=st["C0"],
              C1=st["C1"], NS=st["NS"])
    k1 = dict(B=p["B"], H=st["H"], steps=p["steps"], **kw)
    wmat = widescan.words_matrix(st["words"], -(-p["steps_p"] // 32))
    got = k1_scan2.k1_scan2(wmat, st["tab"], st["lim"], **k1)
    want = k1_scan2.k1_scan2_ref(wmat, st["tab"], st["lim"], **k1)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    sym, val, cntmap, exmap, mrowmap = want
    entry, tot = k2_compose.k2_compose(exmap, 0)
    rentry, rtot = k2_compose.k2_compose_ref(exmap, 0)
    assert torch.equal(entry, rentry) and torch.equal(tot, rtot)
    cut, cut_slot = widescan.fix_rows(entry, mrowmap, st["lim"], st["H"],
                                      st["md"])
    s, v = k3_fix2.k3_fix2(wmat, st["tab"], entry, cut, cut_slot,
                           sym.clone(), val.clone(), **kw)
    rs, rv = k3_fix2.k3_fix2_ref(wmat, st["tab"], entry, cut, cut_slot,
                                 sym.clone(), val.clone(), **kw)
    assert torch.equal(s, rs) and torch.equal(v, rv)
    d = k4_compact.k4_compact(rs, rv, ORP=p["ORP"])
    assert torch.equal(d, k4_compact.k4_compact_ref(rs, rv, ORP=p["ORP"]))
    n = widescan.select_h(cntmap, entry, st["H"])
    mask = torch.arange(p["ORP"], device=cuda)[None, :] < n[:, None]
    np.testing.assert_array_equal(d[mask].cpu().numpy(), raw)


@pytest.mark.parametrize("name", sorted(SHAPES))
def test_decode_on_cuda(cuda, name):
    raw, hf = make(name, seed=1)
    before = k1_scan2.launches
    out = widescan.decode_widescan(hf, device=cuda)
    assert k1_scan2.launches == before + 1
    np.testing.assert_array_equal(out, raw)
    np.testing.assert_array_equal(out, native.simple_decode(hf))


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

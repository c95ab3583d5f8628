"""The PyTorch port's decode path against the JAX package, on the CPU.

Stage parity: the JAX Pallas kernels K1-K4 run in interpret mode on one
text-like stream (512 lanes); the port's plain torch versions of the same
stages take the same staged inputs (``from_jax_staging``) and must give the
same sym/val cells, maps, entries, spliced cells and dense bytes.  Slice
parity: the port's whole decode equals the raw input and the serial native
oracle on every envelope shape.  Tolerance: bit-exact everywhere (integer
outputs; the dense rows are compared up to each lane's count, where the TPU
kernel leaves unspecified bytes).

The CUDA kernels themselves run only on a card (``python3 chip_smoke.py``);
here every wrapper takes its plain version because the tensors are on the
CPU.
"""

import dataclasses
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from huffmandecoderongpus_tpu import native
from huffmandecoderongpus_tpu.huffio.encoder import encode_bytes
from huffmandecoderongpus_tpu.huffio.format import write_huff
from huffmandecoderongpus_tpu.ops import pallas_widescan as jws
from huffmandecoderongpus_tpu_torch.models import all_decoders, get_decoder
from huffmandecoderongpus_tpu_torch.ops import k1_scan, k1_scan2, k2_compose
from huffmandecoderongpus_tpu_torch.ops import k3_fix, k3_fix2, k4_compact
from huffmandecoderongpus_tpu_torch.ops import candidate_scan, lane_scan
from huffmandecoderongpus_tpu_torch.ops import widescan
from torch_streams import SHAPES, as_numpy, fuzz, make, text_like

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _jax_stages(hf, lanes, RB=None):
    """Every stage output of the JAX program (Pallas kernels in interpret
    mode: k1_scan2/k3_fix2, or k1_scan/k3_fix for md=1), in the port's
    logical layouts, plus the staging it ran on."""
    st = jws.stage_widescan_inputs(hf, lanes=lanes)
    p = st["plan"]
    G, H, md = p["G"], st["H"], st["md"]
    R = G // 128
    wmat = jws.words_matrix_device(st["words"], -(-p["steps_p"] // 32))
    kw = dict(G=G, steps_p=p["steps_p"], SEG=p["SEG"], UNROLL=p["UNROLL"],
              md=md, RB=RB or p["RB"], interpret=True)
    if st["chunk2"]:
        kw.update(C0=st["C0"], C1=st["C1"], NS=st["NS"])
        scan, fix = jws.k1_scan2, jws.k3_fix2
    else:
        scan, fix = jws.k1_scan, jws.k3_fix
    sym, val, cntm, exm, mrm = scan(
        wmat, st["tabw"], st["lim2"], B=p["B"], H=H, steps=p["steps"], **kw)
    HP = cntm.shape[0]
    Rg, NG = p["Rg"], p["NG"]
    ex3 = jnp.pad(exm.reshape(HP, G).T.reshape(NG, Rg, HP).transpose(1, 0, 2),
                  ((0, 0), (0, 0), (0, 128 - HP)))
    ent3, tot = jws.k2_compose(ex3, jnp.zeros((1, 1), jnp.int32), Rg=Rg,
                               NG=NG, interpret=True)
    entry = ent3[:, :, 0].T.reshape(G).astype(jnp.int32)
    n = jws._select_h(cntm.reshape(HP, G), entry, H)
    cut = jnp.where(entry == 0, 0,
                    jws._select_h(mrm.reshape(HP, G), entry, H) + 1)
    cut = jnp.where(st["lim2"].reshape(G) > 0, cut, 0)
    cut_slot = jnp.where(cut > 0, (cut - 1) // md + 1, 0)
    msym, mval = fix(wmat, st["tabw"], entry.reshape(R, 128),
                     cut.reshape(R, 128), cut_slot.reshape(R, 128), sym, val,
                     **kw)
    denseT = jws.k4_compact(msym, mval, G=G, cells_p=p["steps_p"] // md // 4,
                            ORP=p["ORP"], interpret=True)
    cells = sym.shape[0]
    out = dict(sym=sym.reshape(cells, G), val=val.reshape(cells, G),
               cntmap=cntm.reshape(HP, G), exmap=exm.reshape(HP, G),
               mrowmap=mrm.reshape(HP, G), entry=entry, tot=tot.reshape(-1),
               n=n, cut=cut, cut_slot=cut_slot,
               msym=msym.reshape(cells, G), mval=mval.reshape(cells, G),
               denseT=denseT)
    return {k: np.asarray(v) for k, v in out.items()}, as_numpy(st)


def _port_stages(st):
    """The port's plain torch stages on staged tensors ``st``."""
    p = st["plan"]
    H, md = st["H"], st["md"]
    kw = dict(steps_p=p["steps_p"], SEG=p["SEG"], md=md, NS=st["NS"])
    if st["chunk2"]:
        kw.update(C0=st["C0"], C1=st["C1"])
        scan, fix = k1_scan2.k1_scan2_ref, k3_fix2.k3_fix2_ref
    else:
        scan, fix = k1_scan.k1_scan_ref, k3_fix.k3_fix_ref
    wmat = widescan.words_matrix(st["words"], -(-p["steps_p"] // 32))
    sym, val, cntmap, exmap, mrowmap = scan(
        wmat, st["tab"], st["lim"], B=p["B"], H=H, steps=p["steps"], **kw)
    entry, tot = k2_compose.k2_compose_ref(exmap, 0)
    n = widescan.select_h(cntmap, entry, H)
    cut, cut_slot = widescan.fix_rows(entry, mrowmap, st["lim"], H, md)
    msym, mval = fix(wmat, st["tab"], entry, cut, cut_slot, sym.clone(),
                     val.clone(), **kw)
    denseT = k4_compact.k4_compact_ref(msym, mval, ORP=p["ORP"])
    out = dict(sym=sym, val=val, cntmap=cntmap, exmap=exmap, mrowmap=mrowmap,
               entry=entry, tot=tot, n=n, cut=cut, cut_slot=cut_slot,
               msym=msym, mval=mval, denseT=denseT)
    return {k: v.numpy() for k, v in out.items()}


def _assert_stages_equal(got, want, keys):
    for k in keys:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def _assert_dense_equal(got, want):
    n = want["n"]
    ORP = want["denseT"].shape[1]
    mask = np.arange(ORP)[None, :] < np.minimum(n, ORP)[:, None]
    np.testing.assert_array_equal(got["denseT"][mask], want["denseT"][mask])


@pytest.fixture(scope="module")
def text_stages():
    """One interpret-mode JAX run (~30 s) and the port's stages on the same
    staged inputs."""
    raw, hf = make("text")
    want, jst = _jax_stages(hf, lanes=512)
    got = _port_stages(widescan.from_jax_staging(jst, "cpu"))
    return raw, got, want


def test_k1_cells_match_jax(text_stages):
    _, got, want = text_stages
    _assert_stages_equal(got, want, ["sym", "val"])


def test_k1_maps_match_jax(text_stages):
    _, got, want = text_stages
    _assert_stages_equal(got, want, ["cntmap", "exmap", "mrowmap"])
    # the stream really exercises the candidate machinery
    assert (want["mrowmap"][1:] >= 0).any() and want["entry"].max() > 0


def test_k2_entries_match_jax(text_stages):
    _, got, want = text_stages
    _assert_stages_equal(got, want, ["entry", "tot", "n"])


def test_fix_rows_match_jax(text_stages):
    _, got, want = text_stages
    _assert_stages_equal(got, want, ["cut", "cut_slot"])


def test_k3_splice_matches_jax(text_stages):
    _, got, want = text_stages
    _assert_stages_equal(got, want, ["msym", "mval"])


def test_k4_dense_matches_jax(text_stages):
    raw, got, want = text_stages
    _assert_dense_equal(got, want)
    ORP = got["denseT"].shape[1]
    mask = np.arange(ORP)[None, :] < got["n"][:, None]
    np.testing.assert_array_equal(got["denseT"][mask], raw)


@pytest.mark.interpret
@pytest.mark.parametrize("name,RB", [("ns2", None), ("md3", None),
                                     ("text", 2), ("abcd", None)])
def test_stages_match_jax_interpret(name, RB):
    # NS=2 wide tables, odd md, a multi-row-group K1 grid (RB=2) and
    # phase-locked late resolution, stage by stage
    raw, hf = make(name)
    want, jst = _jax_stages(hf, lanes=512, RB=RB)
    got = _port_stages(widescan.from_jax_staging(jst, "cpu"))
    _assert_stages_equal(got, want, [
        "sym", "val", "cntmap", "exmap", "mrowmap", "entry", "tot", "n",
        "cut", "cut_slot", "msym", "mval"])
    _assert_dense_equal(got, want)


@pytest.mark.parametrize("lanes", [512, None])
@pytest.mark.parametrize("name", sorted(SHAPES))
def test_decode_matches_input_and_oracle(name, lanes):
    raw, hf = make(name, seed=1)
    out = widescan.decode_widescan(hf, device="cpu", lanes=lanes)
    assert out.dtype == np.uint8
    np.testing.assert_array_equal(out, raw)
    np.testing.assert_array_equal(out, native.simple_decode(hf))


@pytest.mark.parametrize("seed", range(12))
def test_decode_fuzz(seed):
    # seeded random alphabets, skews, lengths and lane counts
    raw, hf, lanes = fuzz(seed)
    out = widescan.decode_widescan(hf, device="cpu", lanes=lanes)
    np.testing.assert_array_equal(out, raw)
    np.testing.assert_array_equal(out, native.simple_decode(hf))


def test_corrupt_size_raises():
    _, hf = make("text")
    bad = dataclasses.replace(hf, uncompressed_size=hf.uncompressed_size + 1)
    with pytest.raises(RuntimeError, match="header says"):
        widescan.decode_widescan(bad, device="cpu", lanes=512)


def test_orp_overflow_raises(monkeypatch):
    # a dense row narrower than the lanes' counts (~190 symbols per lane
    # against 128 columns) no longer raises: the lane-DFA chain decodes
    # the stream, and only then
    raw = text_like(np.random.default_rng(2), 100000)
    hf = encode_bytes(raw)
    plan = widescan._plan

    def small_orp(*a, **k):
        return dict(plan(*a, **k), ORP=128)

    monkeypatch.setattr(widescan, "_plan", small_orp)
    st = widescan.stage_widescan_inputs(hf, device="cpu", lanes=512)
    assert st["plan"]["ORP"] == 128
    calls = []
    tiled = widescan.decode_lanedfa_tiled
    monkeypatch.setattr(widescan, "decode_lanedfa_tiled",
                        lambda *a, **k: calls.append(1) or tiled(*a, **k))
    out = widescan.decode_widescan(hf, device="cpu", lanes=512)
    assert calls == [1]
    np.testing.assert_array_equal(out, raw)


def test_cuda_never_falls_back():
    _, hf = make("text")
    if torch.cuda.is_available():
        pytest.skip("CUDA is available: the check is for hosts without it")
    with pytest.raises(RuntimeError, match="cuda"):
        widescan.decode_widescan(hf, device="cuda", lanes=512)
    with pytest.raises(RuntimeError, match="cuda"):
        get_decoder("lane_wide", device="cuda")(hf)
    # a wrapper given tensors off the CPU launches its kernel or raises
    meta = torch.empty((4, 512), dtype=torch.int32, device="meta")
    lim = torch.empty(512, dtype=torch.int32, device="meta")
    tab = torch.empty((2, 128), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        k1_scan2.k1_scan2(meta, tab, lim, B=96, H=4, steps=100, steps_p=128,
                          SEG=32, md=2, C0=1, C1=2, NS=1)
    with pytest.raises(ValueError, match="CUDA"):
        k2_compose.k2_compose(meta)
    with pytest.raises(ValueError, match="CUDA"):
        k4_compact.k4_compact(meta, meta.to(torch.uint8), ORP=128)
    with pytest.raises(ValueError, match="CUDA"):
        k1_scan.k1_scan(meta, tab[:1], lim, B=96, H=4, steps=100,
                        steps_p=128, SEG=32, md=1, NS=1)
    cells = torch.empty((32, 512), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        k3_fix.k3_fix(meta, tab[:1], lim, lim, lim, cells,
                      cells.to(torch.uint8), steps_p=128, SEG=32, md=1, NS=1)
    bits = torch.empty((100, 512), dtype=torch.uint8, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        candidate_scan.candidate_scan(bits, tab, B=96, H=4, N=40000)
    with pytest.raises(ValueError, match="CUDA"):
        lane_scan.lane_scan(bits, tab, lim, B=96, H=4, N=40000)
    # the lane-DFA decoders refuse an absent card the same way
    for dec in ("lane_dfa", "lane_dfa_pallas"):
        with pytest.raises(RuntimeError, match="cuda"):
            get_decoder(dec, device="cuda")(hf)


def test_registry():
    _, hf = make("md3")
    dec = get_decoder("lane_wide", device="cpu")
    assert dec.device == "cpu" and dec.backend == "cuda"
    np.testing.assert_array_equal(dec(hf, 512), native.simple_decode(hf))
    assert set(all_decoders(device="cpu")) == {
        "lane_wide", "lane_oneshot", "lane_dfa", "lane_dfa_pallas",
        "lane_dfa_sync", "spec_xla", "spec_xla_cpu", "pes_numpy",
        "onethread_device", "justreaddata", "simple", "simple_rp",
        "bigtable_v1", "bigtable_simple", "bigtable_multisym", "jumptable",
        "lin", "spec_sharded", "lane_sharded_wide", "lane_sharded"}
    with pytest.raises(TypeError):
        get_decoder("lane_wide")  # the device is never picked implicitly


def test_cli_decode(tmp_path, capsys):
    from huffmandecoderongpus_tpu_torch.harness.cli import main

    raw, hf = make("abcd")
    src = tmp_path / "x.huff"
    write_huff(src, hf)
    dst = tmp_path / "x.out"
    main(["decode", str(src), str(dst), "--device", "cpu"])
    np.testing.assert_array_equal(np.fromfile(dst, dtype=np.uint8), raw)
    rawf = tmp_path / "x.raw"
    raw.tofile(rawf)
    main(["decode", str(src), "--device", "cpu", "--verify", str(rawf),
          "--repeats", "1"])
    assert "lane_wide" in capsys.readouterr().out


def test_port_never_imports_jax(tmp_path):
    # neither jax nor the JAX package: the port and its smoke run stand alone
    prog = (
        "import sys, numpy as np\n"
        "from huffmandecoderongpus_tpu_torch.huffio import encode_bytes\n"
        "from huffmandecoderongpus_tpu_torch.models import get_decoder\n"
        "import huffmandecoderongpus_tpu_torch.harness.cli\n"
        "import huffmandecoderongpus_tpu_torch.ops.widescan as ws\n"
        "import huffmandecoderongpus_tpu_torch.ops.lanedfa_decode\n"
        "import huffmandecoderongpus_tpu_torch.ops.oneshot\n"
        "import huffmandecoderongpus_tpu_torch.ops.batch\n"
        "import huffmandecoderongpus_tpu_torch.ops.lanedfa_sync\n"
        "import huffmandecoderongpus_tpu_torch.ops.lane_decode_dense\n"
        "import huffmandecoderongpus_tpu_torch.ops.compact\n"
        "import chip_smoke\n"
        "raw = np.tile(np.arange(97, 105, dtype=np.uint8), 2000)\n"
        "md1 = np.where(np.arange(raw.size) % 5 == 0, raw, 0)\n"
        "for r in (raw, md1.astype(np.uint8), raw[:300]):\n"
        "    for name in ('lane_wide', 'lane_oneshot', 'lane_dfa',\n"
        "                 'lane_dfa_pallas', 'lane_dfa_sync'):\n"
        "        out = get_decoder(name, device='cpu')(encode_bytes(r))\n"
        "        assert np.array_equal(out, r), name\n"
        "out = get_decoder('lane_dfa', device='cpu')(\n"
        "    encode_bytes(raw, block_symbols=512))\n"
        "assert np.array_equal(out, raw)\n"
        "assert 'jax' not in sys.modules, 'jax was imported'\n"
        "bad = [m for m in sys.modules\n"
        "       if m.split('.')[0] == 'huffmandecoderongpus_tpu']\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    res = subprocess.run([sys.executable, "-c", prog], cwd=tmp_path, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"


@pytest.mark.parametrize("G,start,HP", [
    pytest.param(512, 0, 16, id="512-0"),
    pytest.param(1024, 3, 16, id="1024-3"),
    pytest.param(256, 5, 16, id="256-5"),
    # the card's tiles (k2_plan): one lane; one part tile; HP 128 (tiles of
    # 128) from start 127 over a tile and a part; a start past HP over 65
    # tiles, three look-back windows for the last
    pytest.param(1, 1, 2, id="1-1-hp2"),
    pytest.param(200, 7, 9, id="200-7-hp9"),
    pytest.param(300, 127, 128, id="300-127-hp128"),
    pytest.param(16640, 30, 24, id="16640-30-hp24"),
])
def test_k2_composes_sequentially(G, start, HP):
    # the composition equals the lane-by-lane definition, including entry
    # offsets at or past the map rows (they read 0)
    rng = np.random.default_rng(G + start)
    exmap = torch.from_numpy(rng.integers(0, min(HP + 4, 128), size=(HP, G),
                                          dtype=np.int32))
    entry, tot = k2_compose.k2_compose(exmap, start)
    ex = exmap.numpy().tolist()

    def walk(e):
        seen = []
        for lane in range(G):
            seen.append(e)
            e = ex[e][lane] if e < HP else 0
        return seen, e

    want, _ = walk(start)
    np.testing.assert_array_equal(entry.numpy(), want)
    assert entry.dtype == torch.int32 and tot.dtype == torch.uint8
    np.testing.assert_array_equal(tot.numpy(), [walk(e)[1] for e in range(128)])


def test_k4_ranks_and_overflow():
    # valid slots land at their rank in slot order; ranks past ORP drop,
    # and the rest of each row is zero
    rng = np.random.default_rng(4)
    cells, G, ORP = 70, 256, 128
    sym = torch.from_numpy(rng.integers(-2**31, 2**31, size=(cells, G),
                                        dtype=np.int64).astype(np.int32))
    val = torch.from_numpy(rng.integers(0, 16, size=(cells, G),
                                        dtype=np.uint8))
    val[:, :8] = 0  # empty lanes
    out = k4_compact.k4_compact(sym, val, ORP=ORP).numpy()
    s = sym.numpy().view(np.uint32)
    for g in (0, 9, 100, 255):
        row = [(int(s[c, g]) >> (8 * b)) & 0xFF for c in range(cells)
               for b in range(4) if (int(val[c, g]) >> b) & 1]
        want = np.zeros(ORP, np.uint8)
        want[:min(len(row), ORP)] = row[:ORP]
        np.testing.assert_array_equal(out[g], want)

"""The port's sidecar-indexed decode against the JAX package, on the CPU.

With a `.huffidx` block index every block is a lane that starts at the DFA
root, so the wide program is K1's main scan alone (``k1_main``, the JAX
``k1_scan2(discover=False)``) and K4, and the lane-DFA route one scan
(``lane_scan_indexed``).  Staging must be byte-equal to
``stage_widescan_indexed``; the plain K1 main scan must equal the JAX kernel
in interpret mode, and the plain indexed scan the XLA ``_lane_scan_indexed``
and, in one case, the Pallas ``lane_scan_indexed_pallas``; every decode
entry point must equal the input and the JAX result; the reader must load a
sidecar exactly when the JAX reader does.  Tolerance: bit-exact everywhere
(integer outputs; dense rows are compared up to each lane's count, where
the TPU kernel leaves unspecified bytes).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from huffmandecoderongpus_tpu import native
from huffmandecoderongpus_tpu.huffio import format as jformat
from huffmandecoderongpus_tpu.huffio import sidecar as jsidecar
from huffmandecoderongpus_tpu.huffio.encoder import encode_bytes
from huffmandecoderongpus_tpu.ops import lanedfa as jlanedfa
from huffmandecoderongpus_tpu.ops import pallas_lanedfa as jpl
from huffmandecoderongpus_tpu.ops import pallas_widescan as jws
from huffmandecoderongpus_tpu_torch import huffio
from huffmandecoderongpus_tpu_torch.models import get_decoder
from huffmandecoderongpus_tpu_torch.ops import k1_main, k4_compact
from huffmandecoderongpus_tpu_torch.ops import lane_scan_indexed
from huffmandecoderongpus_tpu_torch.ops import lanedfa_decode, widescan
from torch_streams import INDEXED, as_numpy, make, make_indexed


@pytest.mark.parametrize("case", INDEXED)
def test_stage_indexed_matches_jax(case):
    _, hf = make_indexed(case)
    offsets, k = hf.index
    want = as_numpy(jws.stage_widescan_indexed(hf, offsets, k))
    got = widescan.stage_widescan_indexed(hf, offsets, k, device="cpu")
    assert got["plan"] == want["plan"]
    for key in ("H", "md", "C0", "C1", "NS", "nb"):
        assert got[key] == want[key], key
    assert got["counts"].dtype == want["counts"].dtype
    np.testing.assert_array_equal(got["counts"], want["counts"])
    for key, jkey in (("tab", "tabw"), ("raw", "raw"), ("sh", "sh"),
                      ("lim", "lim2")):
        g = got[key].numpy()
        assert g.dtype == want[jkey].dtype == np.int32, key
        np.testing.assert_array_equal(g, want[jkey].reshape(g.shape),
                                      err_msg=key)
    # the port's staging from the JAX dict is the same tensors
    again = widescan.from_jax_staging(want, "cpu")
    for key in ("tab", "raw", "sh", "lim"):
        assert torch.equal(again[key], got[key]), key


def _both_raise(exc, match, hf, offsets, k):
    jexc = jws.EnvelopeError if exc is widescan.EnvelopeError else exc
    with pytest.raises(jexc, match=match):
        jws.stage_widescan_indexed(hf, offsets, k)
    with pytest.raises(exc, match=match):
        widescan.stage_widescan_indexed(hf, offsets, k, device="cpu")


def test_stage_indexed_envelope_errors():
    raw = make("md1")[0]
    hf = encode_bytes(raw, block_symbols=128)
    _both_raise(widescan.EnvelopeError, "min code length", hf, *hf.index)
    hf = encode_bytes(make("text")[0], block_symbols=256)  # 79 blocks
    _both_raise(widescan.EnvelopeError, "too few", hf, *hf.index)
    _both_raise(widescan.EnvelopeError, "too long", hf,
                np.arange(200, dtype=np.int64) * 8, 2048)


def test_stage_indexed_corrupt_offsets():
    _, hf = make_indexed("text256")
    offsets, k = hf.index
    bad = offsets.copy()
    bad[5], bad[6] = bad[6], bad[5]
    _both_raise(ValueError, "corrupt block index", hf, bad, k)
    _both_raise(ValueError, "corrupt block index", hf, offsets + 1, k)
    short = dataclasses.replace(hf, uncompressed_size=1000)
    _both_raise(ValueError, "inconsistent with the header", short, offsets, k)


@pytest.mark.parametrize("seed", range(3))
def test_normalize_lane_words_matches_jax(seed):
    rng = np.random.default_rng(seed)
    raw = rng.integers(-2**31, 2**31, size=(300, 9), dtype=np.int64).astype(
        np.int32)
    sh = rng.integers(0, 32, size=300).astype(np.int32)
    sh[:40] = 0
    want = np.asarray(jws.normalize_lane_words(jnp.asarray(raw),
                                               jnp.asarray(sh)))
    got = widescan.normalize_lane_words(torch.from_numpy(raw),
                                        torch.from_numpy(sh)).numpy()
    assert got.dtype == want.dtype == np.int32
    np.testing.assert_array_equal(got, want)


def _jax_indexed(hf):
    """The JAX indexed program's stages (K1 ``discover=False`` and K4 in
    interpret mode) and the staging it ran on."""
    offsets, k = hf.index
    st = jws.stage_widescan_indexed(hf, offsets, k)
    p = st["plan"]
    G = p["G"]
    w2 = jws.normalize_lane_words(st["raw"], st["sh"])
    wmat = w2.T.reshape(-(-p["steps_p"] // 32), G // 128, 128)
    sym, val, *_ = jws.k1_scan2(
        wmat, st["tabw"], st["lim2"], B=p["B"], H=st["H"], G=G,
        steps=p["steps_p"], steps_p=p["steps_p"], SEG=p["SEG"],
        UNROLL=p["UNROLL"], md=st["md"], C0=st["C0"], C1=st["C1"],
        NS=st["NS"], RB=p["RB"], discover=False, interpret=True)
    cells = sym.shape[0]
    denseT = jws.k4_compact(sym, val, G=G, cells_p=cells, ORP=p["ORP"],
                            interpret=True)
    out = dict(w2=w2, sym=sym.reshape(cells, G), val=val.reshape(cells, G),
               denseT=denseT)
    return {key: np.asarray(v) for key, v in out.items()}, as_numpy(st)


def _port_indexed(st):
    args = widescan.indexed_args(st)
    w2 = widescan.normalize_lane_words(st["raw"], st["sh"])
    sym, val = k1_main.k1_main_ref(
        w2.t().contiguous(), st["tab"], st["lim"], steps_p=args["steps_p"],
        md=args["md"], C0=args["C0"], C1=args["C1"], NS=args["NS"])
    denseT = k4_compact.k4_compact_ref(sym, val, ORP=args["ORP"])
    # the whole program, through the wrappers
    prog = widescan.wide_decode_indexed_program(st["raw"], st["sh"],
                                                st["tab"], st["lim"], **args)
    assert torch.equal(prog, denseT)
    out = dict(w2=w2, sym=sym, val=val, denseT=denseT)
    return {key: v.numpy() for key, v in out.items()}


def _assert_indexed_stages(raw, got, want, counts):
    for key in ("w2", "sym", "val"):
        assert got[key].dtype == want[key].dtype, key
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    ORP = want["denseT"].shape[1]
    mask = np.arange(ORP)[None, :] < counts[:, None]
    np.testing.assert_array_equal(got["denseT"][mask], want["denseT"][mask])
    np.testing.assert_array_equal(got["denseT"][mask], raw)


@pytest.fixture(scope="module")
def text_indexed():
    """One interpret-mode JAX run of the indexed program and the port's
    stages on the same staged inputs."""
    raw, hf = make_indexed("text256")
    want, jst = _jax_indexed(hf)
    got = _port_indexed(widescan.from_jax_staging(jst, "cpu"))
    return raw, got, want, jst["counts"]


def test_k1_main_cells_match_jax(text_indexed):
    raw, got, want, counts = text_indexed
    _assert_indexed_stages(raw, got, want, counts)
    assert (want["val"] > 0).any()


@pytest.mark.interpret
@pytest.mark.parametrize("case", ["text129", "md3", "ns2"])
def test_k1_main_cells_match_jax_interpret(case):
    # odd blocks, odd md with SEG 96, the wide table with md 6 (SEG 96)
    raw, hf = make_indexed(case)
    want, jst = _jax_indexed(hf)
    got = _port_indexed(widescan.from_jax_staging(jst, "cpu"))
    _assert_indexed_stages(raw, got, want, jst["counts"])


@pytest.mark.parametrize("case", INDEXED)
def test_lane_scan_indexed_matches_xla(case):
    raw, hf = make_indexed(case)
    offsets, _k = hf.index
    st = lanedfa_decode.stage_lanedfa_indexed(hf, offsets, device="cpu",
                                              tiled=False)
    B, G = st["bits"].shape
    sym, valid = lane_scan_indexed.lane_scan_indexed(st["bits"], st["tab"],
                                                     st["lane_len"])
    jsym, jvalid = jlanedfa._lane_scan_indexed(
        jnp.asarray(st["bits"].numpy()),
        jnp.asarray(jlanedfa.build_lane_dfa(hf.tree).entry),
        jnp.asarray(st["lane_len"].numpy()), B=B, G=G)
    np.testing.assert_array_equal(valid.numpy(), np.asarray(jvalid))
    np.testing.assert_array_equal(sym.numpy(), np.asarray(jsym))
    np.testing.assert_array_equal(sym.t()[valid.t() > 0].numpy(), raw)


def test_lane_scan_indexed_matches_pallas():
    raw, hf = make_indexed("text256")
    offsets, _k = hf.index
    st = lanedfa_decode.stage_lanedfa_indexed(hf, offsets, device="cpu")
    B, G = st["bits"].shape
    assert G == 1024
    sym, valid = lane_scan_indexed.lane_scan_indexed(st["bits"], st["tab"],
                                                     st["lane_len"])
    jsym, jvalid = jpl.lane_scan_indexed_pallas(
        jnp.asarray(st["bits"].numpy()), jnp.asarray(st["tab"].numpy()),
        jnp.asarray(st["lane_len"].numpy()), B=B, G=G, interpret=True)
    assert valid.dtype == torch.uint8
    np.testing.assert_array_equal(valid.numpy(), np.asarray(jvalid))
    np.testing.assert_array_equal(sym.numpy(), np.asarray(jsym))


def test_stage_lanedfa_indexed_geometries():
    _, hf = make_indexed("text129")
    offsets, _k = hf.index
    tiled = lanedfa_decode.stage_lanedfa_indexed(hf, offsets, device="cpu")
    xla = lanedfa_decode.stage_lanedfa_indexed(hf, offsets, device="cpu",
                                               tiled=False)
    nb = offsets.shape[0]
    assert xla["bits"].shape[1] == nb and tiled["bits"].shape[1] == 1024
    assert torch.equal(tiled["bits"][:, :nb], xla["bits"])
    assert not tiled["lane_len"][nb:].any()
    with pytest.raises(ValueError, match="corrupt block index"):
        lanedfa_decode.stage_lanedfa_indexed(hf, offsets[::-1].copy(),
                                             device="cpu")


@pytest.mark.parametrize("case", INDEXED)
def test_decodes_match_input_and_jax(case):
    # the indexed entry points: the wide program, the lane-DFA scan in both
    # geometries, the registry's lane_dfa
    raw, hf = make_indexed(case)
    offsets, k = hf.index
    want = jlanedfa.decode_lanedfa_indexed(hf, offsets, k)
    np.testing.assert_array_equal(want, raw)
    outs = {
        "widescan": widescan.decode_widescan_indexed(hf, offsets, k,
                                                     device="cpu"),
        "lanedfa": lanedfa_decode.decode_lanedfa_indexed(hf, offsets, k,
                                                         device="cpu"),
        "tiled": lanedfa_decode.decode_lanedfa_indexed_tiled(
            hf, offsets, k, device="cpu"),
        "lane_dfa": get_decoder("lane_dfa", device="cpu")(hf),
    }
    for name, out in outs.items():
        assert out.dtype == np.uint8, name
        np.testing.assert_array_equal(out, want, err_msg=name)


@pytest.mark.interpret
@pytest.mark.parametrize("case", ["text256", "md3"])
def test_decodes_match_jax_pallas_interpret(case):
    raw, hf = make_indexed(case)
    offsets, k = hf.index
    np.testing.assert_array_equal(
        widescan.decode_widescan_indexed(hf, offsets, k, device="cpu"),
        jws.decode_widescan_indexed(hf, offsets, k, interpret=True))
    np.testing.assert_array_equal(
        lanedfa_decode.decode_lanedfa_indexed_tiled(hf, offsets, k,
                                                    device="cpu"),
        jpl.decode_lanedfa_indexed_pallas(hf, offsets, k, interpret=True))


def test_few_blocks_take_the_xla_geometry(monkeypatch):
    # under LANE_TILE // 4 blocks the tiled decode hands over, as in JAX
    raw = make("text")[0]
    hf = encode_bytes(raw, block_symbols=1024)
    offsets, k = hf.index
    calls = []
    real = lanedfa_decode.decode_lanedfa_indexed
    monkeypatch.setattr(lanedfa_decode, "decode_lanedfa_indexed",
                        lambda *a, **kw: calls.append(1) or real(*a, **kw))
    out = lanedfa_decode.decode_lanedfa_indexed_tiled(hf, offsets, k,
                                                      device="cpu")
    assert calls == [1]
    np.testing.assert_array_equal(out, raw)
    np.testing.assert_array_equal(
        out, jpl.decode_lanedfa_indexed_pallas(hf, offsets, k))


def test_size_mismatch_raises():
    _, hf = make_indexed("text256")
    offsets, k = hf.index
    # the wide program's counts come from the header and the index: a
    # last block past block_symbols is refused before any decode
    bad = dataclasses.replace(hf, uncompressed_size=hf.uncompressed_size
                              + 300)
    with pytest.raises(ValueError, match="inconsistent with the header"):
        widescan.decode_widescan_indexed(bad, offsets, k, device="cpu")
    with pytest.raises(RuntimeError, match="header says"):
        lanedfa_decode.decode_lanedfa_indexed(bad, offsets, k, device="cpu")


def _write_indexed(tmp_path, hf):
    path = tmp_path / "x.huff"
    jformat.write_huff(path, hf)
    offsets, k = hf.index
    jsidecar.write_index(jsidecar.index_path(path), offsets, k, bits=hf.bits,
                         uncompressed_size=hf.uncompressed_size,
                         payload=hf.payload)
    return path


def _same_index(got, want):
    if want is None:
        return got is None
    return (got is not None and got[1] == want[1]
            and np.array_equal(got[0], want[0]))


@pytest.mark.parametrize("sidecar", ["ok", "missing", "stale", "corrupt",
                                     "truncated", "version1", "no_load"])
def test_read_huff_index_matches_jax(tmp_path, sidecar):
    raw, hf = make_indexed("text256")
    path = _write_indexed(tmp_path, hf)
    idx = jsidecar.index_path(path)
    if sidecar == "missing":
        idx.unlink()
    elif sidecar == "stale":  # bound to another payload
        other = encode_bytes(raw[::-1].copy(), block_symbols=256)
        jsidecar.write_index(idx, *other.index, bits=other.bits,
                             uncompressed_size=other.uncompressed_size,
                             payload=other.payload)
    elif sidecar == "corrupt":
        idx.write_bytes(b"NOPE" + idx.read_bytes()[4:])
    elif sidecar == "truncated":
        idx.write_bytes(idx.read_bytes()[:30])
    elif sidecar == "version1":
        data = bytearray(idx.read_bytes())
        data[4:8] = (1).to_bytes(4, "big")
        idx.write_bytes(bytes(data))
    load = sidecar != "no_load"
    want = jformat.read_huff(path, load_index=load)
    got = huffio.read_huff(path, load_index=load)
    assert _same_index(got.index, want.index)
    assert (got.index is not None) == (sidecar == "ok")
    np.testing.assert_array_equal(got.payload, want.payload)


def test_lane_dfa_decodes_through_sidecar(tmp_path, monkeypatch):
    raw, hf = make_indexed("text256")
    got = huffio.read_huff(_write_indexed(tmp_path, hf))
    calls = []
    real = lane_scan_indexed.lane_scan_indexed_ref
    monkeypatch.setattr(lane_scan_indexed, "lane_scan_indexed_ref",
                        lambda *a: calls.append(1) or real(*a))
    out = get_decoder("lane_dfa", device="cpu")(got)
    assert calls == [1]
    np.testing.assert_array_equal(out, raw)
    np.testing.assert_array_equal(out, native.simple_decode(hf))


def test_cli_decode_through_sidecar(tmp_path, capsys):
    from huffmandecoderongpus_tpu_torch.harness.cli import main

    raw, _ = make_indexed("text129")
    src = tmp_path / "x.bin"
    raw.tofile(src)
    main(["encode", str(src), "--index", "129", "--device", "cpu"])
    assert "index every 129 symbols" in capsys.readouterr().out
    huff = tmp_path / "x.bin.huff"
    assert huffio.read_huff(huff).index is not None
    for dec in ("lane_dfa", "lane_wide"):
        dst = tmp_path / f"{dec}.out"
        main(["decode", str(huff), str(dst), "--device", "cpu", "--decoder",
              dec])
        np.testing.assert_array_equal(np.fromfile(dst, dtype=np.uint8), raw)
    main(["decode", str(huff), "--device", "cpu", "--decoder", "lane_dfa",
          "--verify", str(src), "--repeats", "1"])
    assert "lane_dfa" in capsys.readouterr().out

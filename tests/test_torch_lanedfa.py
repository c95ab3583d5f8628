"""The port's lane-DFA chain against the JAX package, on the CPU.

``decode_widescan`` falls back to the lane-DFA decode for streams the wide
program does not take (too small, trees taller than K2's 128 entry
offsets, more than 1023 states) and for a lane overflowing its dense row.
Host staging (``bits_matrix``, ``pick_lanes``, ``pad_table``) must be
byte-equal to the JAX package's; the plain candidate and lane scans must
equal the XLA scans ``_candidate_scan``/``_lane_scan`` and, in one case,
the Pallas kernels in interpret mode; ``compose`` must equal ``_compose``;
whole decodes must equal the raw input and the serial native oracle.
Tolerance: bit-exact everywhere (integer outputs).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from huffmandecoderongpus_tpu import native
from huffmandecoderongpus_tpu.huffio import bitio
from huffmandecoderongpus_tpu.huffio.encoder import encode_bytes
from huffmandecoderongpus_tpu.ops import lanedfa as jlanedfa
from huffmandecoderongpus_tpu.ops import pallas_lanedfa as jpl
from huffmandecoderongpus_tpu_torch import huffio
from huffmandecoderongpus_tpu_torch.models import get_decoder
from huffmandecoderongpus_tpu_torch.ops import lanedfa, lanedfa_decode, widescan
from huffmandecoderongpus_tpu_torch.ops.candidate_scan import candidate_scan
from huffmandecoderongpus_tpu_torch.ops.lane_scan import lane_scan
from test_torch_md1 import _spy
from torch_streams import MD1_SHAPES, SHAPES, comb_stream, fuzz_any, make
from torch_streams import text_like

NAMES = sorted(SHAPES) + sorted(MD1_SHAPES)


def _port_scans(hf, G):
    """The port's staging and plain scans at G lanes, as numpy."""
    dfa = lanedfa.build_lane_dfa(hf.tree)
    H = max(dfa.height, 1)
    mat, B = lanedfa.bits_matrix(hf.payload, hf.bits, G, H, round_to=512)
    bits_t = torch.from_numpy(mat)
    tab = torch.from_numpy(lanedfa.pad_table(dfa.entry))
    cnt, ex = candidate_scan(bits_t, tab, B=B, H=H, N=hf.bits)
    entry, base, n, total = lanedfa_decode.compose(cnt, ex)
    sym, valid = lane_scan(bits_t, tab, entry, B=B, H=H, N=hf.bits)
    out = dict(cnt=cnt, ex=ex, entry=entry, base=base, n=n, total=total,
               sym=sym, valid=valid)
    return {k: v.numpy() for k, v in out.items()}, mat, B, H


@pytest.mark.parametrize("name", NAMES)
def test_unpack_bits_matches(name):
    _, hf = make(name)
    got = huffio.unpack_bits(hf.payload, hf.bits)
    assert got.dtype == np.uint8
    np.testing.assert_array_equal(got, bitio.unpack_bits(hf.payload, hf.bits))


@pytest.mark.parametrize("lanes,halo,round_to", [
    (1, 4, 1), (7, 9, 1), (64, 9, 512), (1024, 20, 512), (3, 1, 512)])
def test_bits_matrix_matches(lanes, halo, round_to):
    _, hf = make("text")
    got, B = lanedfa.bits_matrix(hf.payload, hf.bits, lanes, halo, round_to)
    want, jB = jlanedfa.bits_matrix(hf.payload, hf.bits, lanes, halo,
                                    round_to)
    assert B == jB and got.dtype == want.dtype == np.uint8
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("bits", [1, 4095, 4096, 97441, 26_716_362,
                                  1 << 31])
@pytest.mark.parametrize("max_lanes", [1 << 14, 1 << 15])
def test_pick_lanes_matches(bits, max_lanes):
    assert lanedfa.pick_lanes(bits, max_lanes=max_lanes) == \
        jlanedfa.pick_lanes(bits, max_lanes=max_lanes)
    assert lanedfa.pick_lanes(bits) == jlanedfa.pick_lanes(bits)


@pytest.mark.parametrize("name", NAMES)
def test_pad_table_matches(name):
    _, hf = make(name)
    entry = jlanedfa.build_lane_dfa(hf.tree).entry
    got = lanedfa.pad_table(entry)
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, jpl._pad_table(entry))


@pytest.fixture(scope="module", params=["text", "md1", "ns2"])
def xla_scans(request):
    """The JAX XLA scans and composition at 100 lanes (not a power of two:
    the composition pads its groups) beside the port's."""
    raw, hf = make(request.param)
    got, mat, B, H = _port_scans(hf, G=100)
    dfa = jlanedfa.build_lane_dfa(hf.tree)
    bits_t, tab = jnp.asarray(mat), jnp.asarray(dfa.entry)
    cnt, ex = jlanedfa._candidate_scan(bits_t, tab, B=B, H=H, N=hf.bits,
                                       G=100)
    entry, base, n, total = jlanedfa._compose(cnt, ex, G=100)
    sym, valid = jlanedfa._lane_scan(bits_t, tab, entry, B=B, H=H,
                                     N=hf.bits, G=100)
    want = dict(cnt=cnt, ex=ex, entry=entry, base=base, n=n, total=total,
                sym=sym, valid=valid)
    return raw, got, {k: np.asarray(v) for k, v in want.items()}


def test_candidate_scan_matches_xla(xla_scans):
    _, got, want = xla_scans
    for k in ("cnt", "ex"):
        assert got[k].dtype == want[k].dtype == np.int32
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert (want["ex"] > 0).any()


def test_compose_matches_jax(xla_scans):
    _, got, want = xla_scans
    for k in ("entry", "base", "n", "total"):
        assert got[k].dtype == want[k].dtype == np.int32
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_lane_scan_matches_xla(xla_scans):
    raw, got, want = xla_scans
    np.testing.assert_array_equal(got["valid"], want["valid"])
    # sym is the entry's symbol field on every row, valid or not
    np.testing.assert_array_equal(got["sym"], want["sym"])
    np.testing.assert_array_equal(got["sym"].T[got["valid"].T > 0], raw)


@pytest.fixture(scope="module")
def pallas_scans():
    """The JAX Pallas candidate and lane scans in interpret mode at one
    lane tile (G=1024), beside the port's."""
    raw, hf = make("text")
    G = 1024
    got, mat, B, H = _port_scans(hf, G)
    tab = jnp.asarray(jpl._pad_table(jlanedfa.build_lane_dfa(hf.tree).entry))
    bits_t = jnp.asarray(mat)
    cnt, ex = jpl.candidate_scan_pallas(bits_t, tab, B=B, H=H, N=hf.bits,
                                        G=G, interpret=True)
    entry, *_ = jlanedfa._compose(cnt, ex, G=G)
    sym, valid = jpl.lane_scan_pallas(bits_t, tab, entry, B=B, H=H,
                                      N=hf.bits, G=G, interpret=True)
    want = dict(cnt=cnt, ex=ex, entry=entry, sym=sym, valid=valid)
    return got, {k: np.asarray(v) for k, v in want.items()}


def test_candidate_scan_matches_pallas(pallas_scans):
    got, want = pallas_scans
    for k in ("cnt", "ex", "entry"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_lane_scan_matches_pallas(pallas_scans):
    got, want = pallas_scans
    assert got["valid"].dtype == want["valid"].dtype == np.uint8
    np.testing.assert_array_equal(got["valid"], want["valid"])
    np.testing.assert_array_equal(got["sym"], want["sym"])


@pytest.mark.parametrize("name,n", [("text", 2000), ("md1", 3000),
                                    ("two", 5000)])
def test_decode_lanedfa_matches_jax(name, n):
    raw = make(name)[0][:n]
    hf = encode_bytes(raw)
    out = lanedfa_decode.decode_lanedfa(hf, device="cpu")
    np.testing.assert_array_equal(out, raw)
    np.testing.assert_array_equal(out, jlanedfa.decode_lanedfa(hf))
    np.testing.assert_array_equal(out, native.simple_decode(hf))


@pytest.mark.parametrize("name", ["text", "md1", "ns2"])
def test_decode_lanedfa_tiled_matches(name):
    raw, hf = make(name)
    # every shape here fills a 1024-lane tile
    st = lanedfa_decode.stage_lanedfa(hf, device="cpu")
    assert st["bits"].shape[1] % lanedfa.LANE_TILE == 0
    out = lanedfa_decode.decode_lanedfa_tiled(hf, device="cpu")
    np.testing.assert_array_equal(out, raw)
    np.testing.assert_array_equal(out, native.simple_decode(hf))


def test_tiny_stream_decodes_through_lanedfa(monkeypatch):
    raw = text_like(np.random.default_rng(0), 2000)
    hf = encode_bytes(raw)
    with pytest.raises(widescan.EnvelopeError, match="too small"):
        widescan.stage_widescan_inputs(hf, device="cpu")
    # under LANE_TILE * H bits: decode_lanedfa's geometry, 2 lanes
    shape = lanedfa_decode.stage_lanedfa(hf, device="cpu")["bits"].shape
    assert shape == lanedfa_decode.stage_lanedfa(
        hf, device="cpu", tiled=False)["bits"].shape and shape[1] == 2
    tiled = _spy(monkeypatch, widescan, "decode_lanedfa_tiled")
    out = get_decoder("lane_wide", device="cpu")(hf)
    assert len(tiled) == 1
    np.testing.assert_array_equal(out, raw)
    np.testing.assert_array_equal(out, native.simple_decode(hf))


def _orp_stream():
    # a run of the 2-bit-coded dominant byte packs ~B/2 symbols into its
    # lanes, above an ORP of 128 (the JAX package's one-shot overflow case)
    rng = np.random.default_rng(0)
    raw = np.concatenate([np.full(15000, 0, dtype=np.uint8),
                          rng.integers(1, 8, size=45000, dtype=np.uint8)])
    return raw, encode_bytes(raw)


def _small_orp(monkeypatch):
    plan = widescan._plan
    monkeypatch.setattr(widescan, "_plan",
                        lambda *a, **k: dict(plan(*a, **k), ORP=128))


def test_orp_overflow_decodes_through_lanedfa(monkeypatch):
    raw, hf = _orp_stream()
    _small_orp(monkeypatch)
    tiled = _spy(monkeypatch, widescan, "decode_lanedfa_tiled")
    out = widescan.decode_widescan(hf, device="cpu", lanes=512)
    assert len(tiled) == 1
    np.testing.assert_array_equal(out, raw)
    np.testing.assert_array_equal(out, native.simple_decode(hf))


def test_size_mismatch_raises_before_overflow(monkeypatch):
    # the header check comes first, as in the JAX package: no fallback
    _, hf = _orp_stream()
    bad = dataclasses.replace(hf, uncompressed_size=hf.uncompressed_size + 1)
    _small_orp(monkeypatch)
    tiled = _spy(monkeypatch, widescan, "decode_lanedfa_tiled")
    with pytest.raises(RuntimeError, match="header says"):
        widescan.decode_widescan(bad, device="cpu", lanes=512)
    assert not tiled


def test_tall_tree_decodes_through_lanedfa(monkeypatch):
    # H = 140 > 128: K2 composes 128 entry offsets, so staging refuses it
    # and the lane-DFA chain decodes it
    raw, hf = comb_stream()
    with pytest.raises(widescan.EnvelopeError, match="height 140"):
        widescan.stage_widescan_inputs(hf, device="cpu")
    tiled = _spy(monkeypatch, widescan, "decode_lanedfa_tiled")
    out = widescan.decode_widescan(hf, device="cpu")
    assert len(tiled) == 1
    np.testing.assert_array_equal(out, raw)
    np.testing.assert_array_equal(out, native.simple_decode(hf))


@pytest.mark.parametrize("seed", range(12))
def test_decode_fuzz_any(seed):
    # seeded streams of every shape: md=1, tiny, chunked
    raw, hf, lanes = fuzz_any(seed)
    out = widescan.decode_widescan(hf, device="cpu", lanes=lanes)
    np.testing.assert_array_equal(out, raw)
    np.testing.assert_array_equal(out, native.simple_decode(hf))


@pytest.mark.parametrize("name", ["lane_dfa", "lane_dfa_pallas", "lane_wide"])
def test_registry_serves_lanedfa(name):
    raw, hf = make("md1")
    dec = get_decoder(name, device="cpu")
    assert dec.backend == "cuda"
    np.testing.assert_array_equal(dec(hf), raw)


def test_lane_dfa_refuses_sidecar():
    # a valid sidecar index is decoded through (one lane per block, the
    # indexed scan); one that does not fit its stream is refused, as the
    # JAX lane_dfa refuses it
    raw = make("text")[0]
    hf = encode_bytes(raw, block_symbols=256)
    assert hf.index is not None
    np.testing.assert_array_equal(get_decoder("lane_dfa", device="cpu")(hf),
                                  raw)
    bad = dataclasses.replace(hf, index=(hf.index[0][::-1].copy(), 256))
    with pytest.raises(ValueError, match="corrupt block index"):
        get_decoder("lane_dfa", device="cpu")(bad)
    with pytest.raises(ValueError, match="corrupt block index"):
        jlanedfa.decode_lanedfa_indexed(bad, *bad.index)

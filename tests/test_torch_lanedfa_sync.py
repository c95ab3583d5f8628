"""The port's self-synchronizing lane-DFA discovery against the JAX package.

``ops/lanedfa_sync.py`` discovers each lane's entry offset from the lane
scan at offset 0: short candidate scans until every chain merges with it or
leaves its lane, the full candidate scan for the lane holding the stream
end, and a fix scan (``lane_scan(..., rows=W)``) spliced over the lanes
entering elsewhere.  On the CPU the kernels' plain versions run; each stage
must equal the JAX package's (``_short_candidate_scan``, ``_fix_scan``,
``discover_and_splice``, with the same number of rounds), and the decodes
(``decode_lanedfa_sync``, the registry's ``lane_dfa_sync`` and
``decode_lanedfa_tiled(discovery="sync")``) must equal the JAX decodes, the
input and the serial native oracle.  Tolerance: bit-exact everywhere
(integer and bool outputs).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from huffmandecoderongpus_tpu import native
from huffmandecoderongpus_tpu.huffio.encoder import encode_bytes
from huffmandecoderongpus_tpu.ops import lanedfa as jlanedfa
from huffmandecoderongpus_tpu.ops import lanedfa_sync as jsync
from huffmandecoderongpus_tpu.ops import pallas_lanedfa as jpl
from huffmandecoderongpus_tpu_torch.models import get_decoder
from huffmandecoderongpus_tpu_torch.ops import lanedfa_decode, lanedfa_sync
from huffmandecoderongpus_tpu_torch.ops import short_candidate_scan as scs
from huffmandecoderongpus_tpu_torch.ops.candidate_scan import candidate_scan
from huffmandecoderongpus_tpu_torch.ops.lane_scan import lane_scan
from torch_streams import make


def _periodic():
    """A periodic stream whose chains stay offset: W doubles to the whole
    lane (the JAX package's non-merging case)."""
    raw = np.tile(np.arange(8, dtype=np.uint8), 4000)
    return raw, encode_bytes(raw)


def _stream(name):
    return _periodic() if name == "periodic" else make(name)


def _zero_chain(name, lanes):
    """(raw, hf, staged inputs, sym0, valid0): the sync geometry and the
    plain lane scan from offset 0."""
    raw, hf = _stream(name)
    st = lanedfa_decode.stage_lanedfa(hf, device="cpu", lanes=lanes,
                                      tiled=False)
    zero = torch.zeros(st["bits"].shape[1], dtype=torch.int32)
    sym0, valid0 = lane_scan(st["bits"], st["tab"], zero, B=st["B"],
                             H=st["H"], N=st["N"])
    return raw, hf, st, sym0, valid0


def _jax_tab(hf):
    return jnp.asarray(jlanedfa.build_lane_dfa(hf.tree).entry)


def _first_w(st):
    return min(max(lanedfa_sync.W0, st["H"] + 1), st["B"] + st["H"])


@pytest.mark.parametrize("name", ["text", "md3", "ns2", "abcd", "md1"])
def test_short_candidate_scan_matches_jax(name):
    _, hf, st, _, valid0 = _zero_chain(name, 16)
    B, H, N = st["B"], st["H"], st["N"]
    G = st["bits"].shape[1]
    keys = ("merged", "exited", "mrow", "cnt", "exit_off")
    for W in (_first_w(st), 2 * _first_w(st)):
        got = scs.short_candidate_scan(st["bits"], st["tab"], valid0, B=B,
                                       H=H, N=N, W=W)
        want = jsync._short_candidate_scan(
            jnp.asarray(st["bits"].numpy()), _jax_tab(hf),
            jnp.asarray(valid0.numpy().astype(bool)), B=B, H=H, N=N, G=G, W=W)
        for k, g, w in zip(keys, got, want):
            w = np.asarray(w)
            assert g.numpy().dtype == w.dtype, k
            # whole arrays: entries a chain never set are 0 in both
            np.testing.assert_array_equal(g.numpy(), w, err_msg=f"{k} W={W}")
        merged, exited = got[0], got[1]
        assert not (merged & exited).any()
    assert merged.any()


def test_short_candidate_scan_merge_before_exit():
    # a chain whose resolving emission is both on a 0-chain row and past
    # the lane end counts as merged, as in the reference
    # (codes 1, 00, 01): chain 0 emits on row 1, a 0-chain row at the lane
    # end; chain 1 emits on row 2, past it
    entry = np.array([1, 1 << 10, 1 << 10, 1 << 10], dtype=np.int32)
    tab = torch.zeros((1, 128), dtype=torch.int32)
    tab[0, :4] = torch.from_numpy(entry)
    bits = torch.tensor([[0], [0], [1], [1]], dtype=torch.uint8)
    valid0 = torch.tensor([[0], [1], [0], [0]], dtype=torch.uint8)
    got = scs.short_candidate_scan(bits, tab, valid0, B=2, H=2, N=4, W=4)
    want = jsync._short_candidate_scan(
        jnp.asarray(bits.numpy()), jnp.asarray(entry),
        jnp.asarray(valid0.numpy().astype(bool)), B=2, H=2, N=4, G=1, W=4)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    merged, exited, mrow, cnt, ex = (t[:, 0].tolist() for t in got)
    assert merged == [True, False] and exited == [False, True]
    assert mrow == [1, 0] and cnt == [1, 1] and ex == [0, 1]


@pytest.mark.parametrize("name", ["text", "abcd", "md1abab"])
def test_fix_scan_matches_jax(name):
    _, hf, st, _, _ = _zero_chain(name, 16)
    B, H, N = st["B"], st["H"], st["N"]
    G = st["bits"].shape[1]
    cnt, ex = candidate_scan(st["bits"], st["tab"], B=B, H=H, N=N)
    entry = lanedfa_decode.compose(cnt, ex)[0]
    # true entry offsets, and offsets drawn at random below H
    starts = (entry, torch.from_numpy(np.random.default_rng(5).integers(
        0, H, size=G, dtype=np.int32)))
    for start in starts:
        for W in (_first_w(st), B + H):
            sym, valid = lane_scan(st["bits"][:W], st["tab"], start, B=B, H=H,
                                   N=N, rows=W)
            wsym, wvalid = jsync._fix_scan(
                jnp.asarray(st["bits"].numpy()), _jax_tab(hf),
                jnp.asarray(start.numpy()), B=B, H=H, N=N, G=G, W=W)
            np.testing.assert_array_equal(sym.numpy(), np.asarray(wsym))
            np.testing.assert_array_equal(valid.numpy(),
                                          np.asarray(wvalid).astype(np.uint8))
    whole = lane_scan(st["bits"], st["tab"], entry, B=B, H=H, N=N)
    cut = lane_scan(st["bits"], st["tab"], entry, B=B, H=H, N=N, rows=B + H)
    for g, w in zip(whole, cut):  # rows=B+H is the whole scan
        assert torch.equal(g, w)
    with pytest.raises(ValueError, match="rows"):
        lane_scan(st["bits"], st["tab"], entry, B=B, H=H, N=N, rows=B)


def _jax_discover(monkeypatch, hf, st, sym0, valid0):
    """The JAX discover_and_splice on the same inputs, with its rounds."""
    calls = []
    short = jsync._short_candidate_scan

    def counted(*a, **k):
        calls.append(k["W"])
        return short(*a, **k)

    monkeypatch.setattr(jsync, "_short_candidate_scan", counted)
    out = jsync.discover_and_splice(
        jnp.asarray(st["bits"].numpy()), _jax_tab(hf),
        jnp.asarray(sym0.numpy()), jnp.asarray(valid0.numpy().astype(bool)),
        B=st["B"], H=st["H"], N=st["N"], G=st["bits"].shape[1])
    return [np.asarray(v) for v in out], len(calls)


@pytest.mark.parametrize("name,lanes,rounds", [
    ("text", 16, 1),
    ("abcd", 1, 1),  # G = 1: every chain is the tail lane's
    ("md1abab", 7, 4),  # md = 1, chains merge late
    ("periodic", 16, 7),  # chains never resolve: W reaches the whole lane
    ("ns2", 16, 3),  # 255 states, two table chunks
    pytest.param("random", 16, 7, marks=pytest.mark.interpret),
])
def test_discover_and_splice_matches_jax(monkeypatch, name, lanes, rounds):
    raw, hf, st, sym0, valid0 = _zero_chain(name, lanes)
    r0, f0 = lanedfa_sync.rounds, lanedfa_sync.fix_scans
    sym, valid, base, n, total = lanedfa_sync.discover_and_splice(
        st["bits"], st["tab"], sym0, valid0, B=st["B"], H=st["H"], N=st["N"])
    want, jrounds = _jax_discover(monkeypatch, hf, st, sym0, valid0)
    assert lanedfa_sync.rounds - r0 == jrounds == rounds
    for k, g, w in zip(("sym", "valid", "base", "n", "total"),
                       (sym, valid, base, n, total), want):
        np.testing.assert_array_equal(g.numpy(), w.astype(g.numpy().dtype),
                                      err_msg=k)
    assert int(total) == raw.size
    np.testing.assert_array_equal(sym.t()[valid.t() > 0].numpy(), raw)
    # at most one fix scan, and one wherever rows were spliced
    fixes = lanedfa_sync.fix_scans - f0
    assert fixes in (0, 1)
    if not (torch.equal(sym, sym0) and torch.equal(valid, valid0)):
        assert fixes == 1


@pytest.mark.parametrize("name,lanes", [("text", 16), ("md1", None)])
def test_decode_lanedfa_sync_matches_jax(name, lanes):
    raw, hf = make(name)
    out = lanedfa_sync.decode_lanedfa_sync(hf, device="cpu", lanes=lanes)
    np.testing.assert_array_equal(out, raw)
    np.testing.assert_array_equal(out, native.simple_decode(hf))
    np.testing.assert_array_equal(out, jsync.decode_lanedfa_sync(hf,
                                                                 lanes=lanes))


@pytest.mark.parametrize("name", ["text", "md3", "abcd", "md1", "two",
                                  "md1abab"])
def test_registry_lane_dfa_sync(name):
    raw, hf = _stream(name)
    dec = get_decoder("lane_dfa_sync", device="cpu")
    assert dec.backend == "cuda"
    out = dec(hf)
    np.testing.assert_array_equal(out, raw)
    np.testing.assert_array_equal(out, native.simple_decode(hf))
    np.testing.assert_array_equal(dec(hf, 4), raw)  # param: the lane count


def test_lane_dfa_sync_ignores_sidecar():
    raw = make("text")[0]
    hf = encode_bytes(raw, block_symbols=256)
    assert hf.index is not None
    r0 = lanedfa_sync.rounds
    np.testing.assert_array_equal(
        get_decoder("lane_dfa_sync", device="cpu")(hf), raw)
    assert lanedfa_sync.rounds > r0  # discovery ran, not the index


def test_sync_bad_header_raises():
    _, hf = make("text")
    bad = type(hf)(tree=hf.tree, bits=hf.bits,
                   uncompressed_size=hf.uncompressed_size + 5,
                   payload=hf.payload)
    with pytest.raises(RuntimeError, match="decoded"):
        lanedfa_sync.decode_lanedfa_sync(bad, device="cpu", lanes=8)
    with pytest.raises(RuntimeError, match="decoded"):
        lanedfa_decode.decode_lanedfa_tiled(bad, device="cpu",
                                            discovery="sync")


def test_sync_needs_the_card_for_cuda():
    _, hf = make("text")
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="cuda"):
        get_decoder("lane_dfa_sync", device="cuda")(hf)
    with pytest.raises(RuntimeError, match="cuda"):
        lanedfa_decode.decode_lanedfa_tiled(hf, device="cuda",
                                            discovery="sync")
    bits = torch.empty((100, 512), dtype=torch.uint8, device="meta")
    tab = torch.empty((1, 128), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        scs.short_candidate_scan(bits, tab, bits, B=96, H=4, N=40000, W=50)


@pytest.mark.parametrize("name", ["text", pytest.param(
    "ns2", marks=pytest.mark.interpret)])
def test_tiled_sync_matches_pallas(name):
    raw, hf = make(name)
    r0 = lanedfa_sync.rounds
    out = lanedfa_decode.decode_lanedfa_tiled(hf, device="cpu",
                                              discovery="sync")
    assert lanedfa_sync.rounds > r0  # the sync route, not the candidates
    np.testing.assert_array_equal(out, raw)
    np.testing.assert_array_equal(out, jpl.decode_lanedfa_pallas(
        hf, interpret=True, discovery="sync"))


def test_tiled_sync_small_stream_takes_candidates():
    # under LANE_TILE * H bits: decode_lanedfa's geometry and candidate
    # discovery, as in the JAX package
    raw = make("text")[0][:2000]
    hf = encode_bytes(raw)
    r0 = lanedfa_sync.rounds
    out = lanedfa_decode.decode_lanedfa_tiled(hf, device="cpu",
                                              discovery="sync")
    assert lanedfa_sync.rounds == r0
    np.testing.assert_array_equal(out, raw)
    with pytest.raises(ValueError, match="discovery"):
        lanedfa_decode.decode_lanedfa_tiled(hf, device="cpu",
                                            discovery="fast")


def test_cli_decode_lane_dfa_sync(tmp_path):
    from huffmandecoderongpus_tpu.huffio.format import write_huff
    from huffmandecoderongpus_tpu_torch.harness.cli import main

    raw, hf = make("md3")
    src = tmp_path / "x.huff"
    write_huff(src, hf)
    dst = tmp_path / "x.out"
    r0 = lanedfa_sync.rounds
    main(["decode", str(src), str(dst), "--device", "cpu", "--decoder",
          "lane_dfa_sync"])
    assert lanedfa_sync.rounds > r0
    np.testing.assert_array_equal(np.fromfile(dst, dtype=np.uint8), raw)

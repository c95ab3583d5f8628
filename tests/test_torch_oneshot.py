"""The PyTorch port's one-shot route against the JAX package, on the CPU.

Parity: the JAX ``oneshot_program`` (its Pallas kernel in interpret mode)
and the port's plain ``oneshot_program_ref`` take the same staged inputs
(``from_jax_staging``); the counts must be equal and the dense rows equal
up to each lane's count, where the TPU kernel leaves unspecified bytes.
The port's rows are zero past the counts.  Routing: the port's
``oneshot_eligible`` equals the JAX package's, and ``decode_widescan``
takes the route, skips it or falls through from it as the JAX router does.
Tolerance: bit-exact everywhere (integer outputs).

The CUDA kernel itself runs only on a card (``tests/test_torch_cuda.py``,
``python3 chip_smoke.py``); here the wrapper takes its plain version because
the tensors are on the CPU.
"""

import dataclasses

import numpy as np
import pytest
import torch

from huffmandecoderongpus_tpu import native
from huffmandecoderongpus_tpu.huffio.encoder import encode_bytes
from huffmandecoderongpus_tpu.ops import pallas_oneshot as jons
from huffmandecoderongpus_tpu.ops import pallas_widescan as jws
from huffmandecoderongpus_tpu_torch.models import get_decoder
from huffmandecoderongpus_tpu_torch.models import lanedfa as registry
from huffmandecoderongpus_tpu_torch.ops import _build, oneshot, widescan
from huffmandecoderongpus_tpu_torch.ops.lanedfa import EnvelopeError
from torch_streams import as_numpy, make

ELIGIBLE = ["text", "ns2", "md3", "abcd"]


def largest_eligible():
    """(raw, HuffFile) of the largest 8-symbol stream, in 64 KB steps, that
    the JAX package still routes to the one-shot (under ONESHOT_MAX_BITS
    and eligible at its default lanes), built as ``tests/test_oneshot.py``
    builds its envelope-edge stream."""
    rng = np.random.default_rng(0)
    probs = np.array([0.35, 0.2, 0.12, 0.1, 0.08, 0.06, 0.05, 0.04])
    raw_full = rng.choice(np.arange(8, dtype=np.uint8), size=1 << 20,
                          p=probs / probs.sum()).astype(np.uint8)
    best = None
    for size in range(1 << 16, 1 << 20, 1 << 16):
        hf = encode_bytes(raw_full[:size])
        if hf.bits >= jws.ONESHOT_MAX_BITS:
            break
        if jons.oneshot_eligible(jws.stage_widescan_inputs(hf)):
            best = (raw_full[:size], hf)
    return best


@pytest.fixture(scope="module")
def edge():
    return largest_eligible()


def _stream(name, edge=None):
    return edge if name == "edge" else make(name)


def _jax_oneshot(hf, lanes):
    """The JAX one-shot program (interpret mode) and the staging it ran
    on, as numpy."""
    st = jws.stage_widescan_inputs(hf, lanes=lanes)
    p = st["plan"]
    denseT, n, _fence = jons.oneshot_program(
        st["words"], st["tabw"], st["lim2"], B=p["B"], H=st["H"], G=p["G"],
        steps=p["steps"], steps_p=p["steps_p"], SEG=p["SEG"], md=st["md"],
        C0=st["C0"], C1=st["C1"], NS=st["NS"], ORP=p["ORP"], interpret=True)
    return dict(denseT=np.asarray(denseT), n=np.asarray(n)), as_numpy(st)


def _port_oneshot(jst):
    st = widescan.from_jax_staging(jst, "cpu")
    denseT, n, total = oneshot.oneshot_program_ref(
        st["words"], st["tab"], st["lim"], **oneshot.program_args(st))
    return dict(denseT=denseT.numpy(), n=n.numpy(), total=int(total))


def _assert_parity(raw, got, want):
    np.testing.assert_array_equal(got["n"], want["n"])
    assert got["n"].dtype == want["n"].dtype == np.int32
    ORP = want["denseT"].shape[1]
    assert got["denseT"].shape == want["denseT"].shape
    mask = np.arange(ORP)[None, :] < np.minimum(want["n"], ORP)[:, None]
    np.testing.assert_array_equal(got["denseT"][mask], want["denseT"][mask])
    np.testing.assert_array_equal(got["denseT"][mask], raw)
    assert not got["denseT"][~mask].any()  # zero past the counts
    assert got["total"] == raw.size


@pytest.fixture(scope="module")
def text_parity():
    """One interpret-mode run of the JAX one-shot program (~30 s) on the
    text shape at 512 lanes, and the port's plain version on the same
    staged inputs."""
    raw, hf = make("text")
    want, jst = _jax_oneshot(hf, lanes=512)
    return raw, _port_oneshot(jst), want, jst


def test_text_counts_match_jax(text_parity):
    raw, got, want, jst = text_parity
    np.testing.assert_array_equal(got["n"], want["n"])
    assert got["total"] == int(want["n"].sum()) == raw.size
    assert jst["plan"]["G"] == 512 and jst["md"] == 2


def test_text_dense_matches_jax(text_parity):
    raw, got, want, _ = text_parity
    _assert_parity(raw, got, want)


def test_text_program_matches_four_kernel_program(text_parity):
    # on the CPU the one-shot runs the four-kernel program's plain stages:
    # the same counts and total, the same rows up to the counts, and zeros
    # past them, where the four-kernel rows may keep a replayed lane's halo
    _, got, _, jst = text_parity
    st = widescan.from_jax_staging(jst, "cpu")
    denseT, n, total = widescan.wide_decode_program(
        st["words"], st["tab"], st["lim"], **widescan.program_args(st))
    np.testing.assert_array_equal(got["n"], n.numpy())
    assert got["total"] == int(total)
    keep = np.arange(denseT.shape[1])[None, :] < n.numpy()[:, None]
    np.testing.assert_array_equal(got["denseT"],
                                  np.where(keep, denseT.numpy(), 0))


@pytest.mark.interpret
@pytest.mark.parametrize("name", ["ns2", "md3", "edge"])
def test_oneshot_matches_jax_interpret(name, edge):
    # NS=2 wide tables, odd md slot splitting, and the largest stream the
    # envelope routes (default lanes)
    raw, hf = _stream(name, edge)
    want, jst = _jax_oneshot(hf, lanes=None if name == "edge" else 512)
    _assert_parity(raw, _port_oneshot(jst), want)


@pytest.mark.parametrize("lanes", [512, None])
@pytest.mark.parametrize("name", ELIGIBLE + ["random", "md1", "md1wide",
                                             "edge"])
def test_eligible_matches_jax(name, lanes, edge):
    _, hf = _stream(name, edge)
    port = oneshot.oneshot_eligible(
        widescan.stage_widescan_inputs(hf, device="cpu", lanes=lanes))
    assert port == jons.oneshot_eligible(
        jws.stage_widescan_inputs(hf, lanes=lanes))
    if name.startswith("md1") or lanes is None:
        assert port == (not name.startswith("md1"))


def _plan_dict(G=1024, B=1792, H=9, md=2, ORP=640, chunk2=True):
    SEG = 4 * md * max(1, 32 // (4 * md))
    steps_p = -(-(B + H) // SEG) * SEG
    return dict(plan=dict(G=G, B=B, steps_p=steps_p, SEG=SEG, ORP=ORP), H=H,
                md=md, chunk2=chunk2)


@pytest.mark.parametrize("kw,want", [
    (dict(), True),
    (dict(G=4096, B=448, ORP=256), True),   # 32 row blocks
    (dict(G=8192, B=256), False),          # more than 32 row blocks
    (dict(B=32, H=40), False),             # halo wider than a lane
    (dict(chunk2=False, md=1), False),     # md = 1
    (dict(G=4096, B=1792, ORP=1280), False),  # working set over budget
    (dict(G=2048, B=2560, ORP=2048), False),
    (dict(G=2048, B=1024, ORP=640, H=20, md=6), True),
])
def test_eligibility_rule_matches_jax(kw, want):
    # the rule itself on synthetic plans, including both sides of the
    # working-set budget
    st = _plan_dict(**kw)
    assert oneshot.oneshot_eligible(st) == jons.oneshot_eligible(st) == want


def _spy(monkeypatch, module, name):
    calls = []
    real = getattr(module, name)

    def spy(*a, **k):
        calls.append(name)
        try:
            return real(*a, **k)
        except EnvelopeError:
            calls.append(name + " raised")
            raise

    monkeypatch.setattr(module, name, spy)
    return calls


@pytest.mark.parametrize("name", ELIGIBLE)
def test_router_takes_oneshot(name, monkeypatch):
    raw, hf = make(name, seed=1)
    calls = _spy(monkeypatch, oneshot, "decode_oneshot_staged")
    four = _spy(monkeypatch, widescan, "wide_decode_program")
    out = widescan.decode_widescan(hf, device="cpu")
    assert calls == ["decode_oneshot_staged"] and four == []
    np.testing.assert_array_equal(out, raw)
    np.testing.assert_array_equal(out, native.simple_decode(hf))


def test_router_oneshot_false_skips(monkeypatch):
    raw, hf = make("text", seed=1)
    calls = _spy(monkeypatch, oneshot, "decode_oneshot_staged")
    four = _spy(monkeypatch, widescan, "wide_decode_program")
    out = widescan.decode_widescan(hf, device="cpu", oneshot=False)
    assert calls == [] and four == ["wide_decode_program"]
    np.testing.assert_array_equal(out, raw)


def test_router_threshold(monkeypatch):
    # at or above ONESHOT_MAX_BITS the route is skipped unless forced
    raw, hf = make("md3", seed=1)
    monkeypatch.setattr(widescan, "ONESHOT_MAX_BITS", hf.bits)
    calls = _spy(monkeypatch, oneshot, "decode_oneshot_staged")
    np.testing.assert_array_equal(
        widescan.decode_widescan(hf, device="cpu"), raw)
    assert calls == []
    np.testing.assert_array_equal(
        widescan.decode_widescan(hf, device="cpu", oneshot=True), raw)
    assert calls == ["decode_oneshot_staged"]


@pytest.mark.parametrize("name", ["md1", "md1wide"])
def test_router_skips_md1(name, monkeypatch):
    raw, hf = make(name, seed=1)
    calls = _spy(monkeypatch, oneshot, "decode_oneshot_staged")
    out = widescan.decode_widescan(hf, device="cpu", oneshot=True)
    assert calls == []
    np.testing.assert_array_equal(out, raw)


def _plan_of(st, sms):
    p = st["plan"]
    return oneshot.oneshot_plan(p["G"], st["H"], st["md"], p["SEG"],
                                p["steps_p"], p["ORP"], st["NS"], sms)


def test_plan_takes_the_sm_count():
    # a G = 4,096 stream with six leaders: planned for 132 SMs its teams of
    # 16 make 512 blocks, more than an H100 PCIe's 114 SMs hold at 4 an SM
    # (the launch the port used to make there, and have refused); planned
    # for 114 the team halves to 8 (still a thread a leader) and fits
    _, hf = make("ns2")
    st = widescan.stage_widescan_inputs(hf, device="cpu", lanes=4096)
    assert st["plan"]["G"] == 4096 and st["md"] == 6
    sxm, pcie = _plan_of(st, 132), _plan_of(st, 114)
    assert (sxm["T"], sxm["blocks"], sxm["fits"]) == (16, 512, True)
    assert sxm["blocks"] > 114 * sxm["per_sm"]
    assert (pcie["T"], pcie["blocks"], pcie["fits"]) == (8, 256, True)
    # below the smallest team's grid no plan fits
    assert not _plan_of(st, 60)["fits"]


@pytest.mark.parametrize("sms", [114, 60])
def test_router_follows_the_plans_fit(sms, monkeypatch):
    # the router plans for the card's SMs (SM_COUNT on the CPU): at 114 the
    # one-shot takes the stream; at 60 its grid does not fit, the one-shot
    # refuses it (EnvelopeError) and the four-kernel program decodes it
    raw, hf = make("ns2")
    monkeypatch.setattr(_build, "SM_COUNT", sms)
    calls = _spy(monkeypatch, oneshot, "decode_oneshot_staged")
    launched = _spy(monkeypatch, oneshot, "oneshot_program")
    four = _spy(monkeypatch, widescan, "wide_decode_program")
    out = widescan.decode_widescan(hf, device="cpu", lanes=4096)
    if sms == 114:
        assert calls == ["decode_oneshot_staged"]
        assert launched == ["oneshot_program"] and four == []
    else:
        assert calls == ["decode_oneshot_staged",
                         "decode_oneshot_staged raised"]
        assert launched == [] and four == ["wide_decode_program"]
    np.testing.assert_array_equal(out, raw)


def _overflow_stream():
    # a run of the 2-bit-coded dominant symbol packs ~B/2 symbols into its
    # lanes, over the 128-column dense rows the clamp leaves
    rng = np.random.default_rng(0)
    raw = np.concatenate([np.full(15000, 0, dtype=np.uint8),
                          rng.integers(1, 8, size=45000, dtype=np.uint8)])
    return raw, encode_bytes(raw)


def test_orp_overflow_falls_through(monkeypatch):
    raw, hf = _overflow_stream()
    plan = widescan._plan
    monkeypatch.setattr(widescan, "_plan",
                        lambda *a, **k: dict(plan(*a, **k), ORP=128))
    st = widescan.stage_widescan_inputs(hf, device="cpu", lanes=512)
    assert oneshot.oneshot_eligible(st)
    with pytest.raises(EnvelopeError, match="overflowed"):
        oneshot.decode_oneshot_staged(hf, st)
    calls = _spy(monkeypatch, oneshot, "decode_oneshot_staged")
    four = _spy(monkeypatch, widescan, "wide_decode_program")
    tiled = _spy(monkeypatch, widescan, "decode_lanedfa_tiled")
    out = widescan.decode_widescan(hf, device="cpu", lanes=512)
    # one-shot -> four-kernel program -> lane-DFA chain, as in the JAX router
    assert calls == ["decode_oneshot_staged", "decode_oneshot_staged raised"]
    assert four == ["wide_decode_program"]
    assert tiled == ["decode_lanedfa_tiled"]
    np.testing.assert_array_equal(out, raw)


def test_size_mismatch_raises():
    _, hf = make("text")
    bad = dataclasses.replace(hf, uncompressed_size=hf.uncompressed_size + 1)
    st = widescan.stage_widescan_inputs(bad, device="cpu", lanes=512)
    with pytest.raises(RuntimeError, match="header says"):
        oneshot.decode_oneshot_staged(bad, st)
    with pytest.raises(RuntimeError, match="header says"):
        oneshot.decode_oneshot(bad, device="cpu", lanes=512)


def test_halo_wider_than_lane_raises():
    # 32-bit lanes and a 40-bit halo: the JAX program refuses it the same
    G = 512
    words = torch.zeros((G, 1), dtype=torch.int32)
    lim = torch.full((G,), 32, dtype=torch.int32)
    tab = torch.zeros((2, 128), dtype=torch.int32)
    with pytest.raises(EnvelopeError, match="halo"):
        oneshot.oneshot_program(words, tab, lim, B=32, H=40, steps=72,
                                steps_p=96, SEG=32, md=2, C0=1, C1=2, NS=1,
                                ORP=128)


def test_decode_oneshot_refuses_out_of_envelope():
    for name in ("md1", "two"):
        _, hf = make(name)
        with pytest.raises(EnvelopeError):
            oneshot.decode_oneshot(hf, device="cpu")
    tiny = encode_bytes(np.arange(300, dtype=np.uint8) % 7 + 97)
    with pytest.raises(EnvelopeError):
        oneshot.decode_oneshot(tiny, device="cpu")


def test_lane_oneshot_registry(monkeypatch):
    dec = get_decoder("lane_oneshot", device="cpu")
    assert dec.device == "cpu" and dec.backend == "cuda"
    raw, hf = make("ns2", seed=2)
    fallback = _spy(monkeypatch, registry, "decode_widescan")
    np.testing.assert_array_equal(dec(hf, 512), native.simple_decode(hf))
    np.testing.assert_array_equal(dec(hf), raw)
    assert fallback == []
    # min code length 1 is outside the envelope: lane_wide decodes it
    raw, hf = make("md1", seed=2)
    np.testing.assert_array_equal(dec(hf), raw)
    assert fallback == ["decode_widescan"]


def test_oneshot_never_falls_back():
    _, hf = make("text")
    if torch.cuda.is_available():
        pytest.skip("CUDA is available: the check is for hosts without it")
    with pytest.raises(RuntimeError, match="cuda"):
        oneshot.decode_oneshot(hf, device="cuda")
    with pytest.raises(RuntimeError, match="cuda"):
        get_decoder("lane_oneshot", device="cuda")(hf)
    # tensors off the CPU launch the kernel or raise
    words = torch.empty((512, 2), dtype=torch.int32, device="meta")
    lim = torch.empty(512, dtype=torch.int32, device="meta")
    tab = torch.empty((2, 128), dtype=torch.int32, device="meta")
    kw = dict(B=64, H=4, steps=68, steps_p=96, SEG=32, md=2, C0=1, C1=2,
              NS=1, ORP=128)
    with pytest.raises(ValueError, match="CUDA"):
        oneshot.oneshot_program(words, tab, lim, **kw)
    # the phase stamps come only from the kernel, never from the CPU
    stamps = torch.zeros(len(oneshot.PHASES) + 1, dtype=torch.int64)
    with pytest.raises(ValueError, match="CUDA"):
        oneshot.oneshot_program(torch.zeros((512, 2), dtype=torch.int32),
                                torch.zeros((2, 128), dtype=torch.int32),
                                torch.zeros(512, dtype=torch.int32),
                                stamps=stamps, **kw)


def test_envelope_edge_stream_matches_jax(edge):
    # the port's envelope-edge stream (``probes.streams``, which the card
    # tests and chip_smoke.py take since the card's host has no JAX) is
    # the JAX package's, byte for byte
    from huffmandecoderongpus_tpu_torch.probes.streams import (
        envelope_edge_stream,
    )

    raw, hf = envelope_edge_stream()
    np.testing.assert_array_equal(raw, edge[0])
    assert hf.bits == edge[1].bits
    np.testing.assert_array_equal(hf.payload, edge[1].payload)


@pytest.mark.parametrize("case", ["h2", "md8", "text-128", "alpha-128"])
def test_oneshot_cases_match_four_kernel_program(case):
    # the card's one-shot edge cases, on the CPU: the plain one-shot equals
    # the plain four-kernel program up to the counts and decodes the input
    # (G = 128 is outside the JAX plan's lanes; the 128-tall tree, whose
    # 127 chains take the plain K1 two minutes here, runs on the card)
    from huffmandecoderongpus_tpu_torch.probes.streams import oneshot_case

    raw, st = oneshot_case(case, "cpu")
    assert oneshot.oneshot_eligible(st)
    args = (st["words"], st["tab"], st["lim"])
    denseT, n, total = oneshot.oneshot_program(*args,
                                               **oneshot.program_args(st))
    d4, n4, t4 = widescan.wide_decode_program(*args,
                                              **widescan.program_args(st))
    assert torch.equal(n, n4) and int(total) == int(t4) == raw.size
    mask = torch.arange(denseT.shape[1])[None, :] < n[:, None]
    assert torch.equal(denseT[mask], d4[mask])
    np.testing.assert_array_equal(denseT[mask].numpy(), raw)

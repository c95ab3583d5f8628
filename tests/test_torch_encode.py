"""The PyTorch port's device encoder against the JAX package, on the CPU.

Parity: the same seeded inputs go through the JAX ``encode_pallas`` (its
E1-E3 Pallas kernels in interpret mode) and the port's ``encode_lanes``,
stage by stage: the staging (symbol matrix, lane counts, pack tables and
plan), E1 on every row, E2 up to each lane's count (the TPU kernel leaves
the words past the counts undefined), ``shift_lanes``, E3's placement on
the whole payload array and against the JAX package's host placement
``place_lanes``, the fused E3 (offsets, shift and placement from E2's rows)
against the JAX package's three steps, also on ``probes.streams.E3_CASES``,
the whole ``encode_program`` and the wrapper's HuffFile;
and the port's ``encode_device`` against the JAX one.  Tolerance: bit-exact
everywhere (every output is an integer).

The CUDA kernels run only on a card (``tests/test_torch_cuda.py``,
``python3 chip_smoke.py``); here each wrapper takes its plain version
because the tensors are on the CPU.
"""

import functools

import numpy as np
import pytest
import torch

from huffmandecoderongpus_tpu.huffio import encoder as jencoder
from huffmandecoderongpus_tpu.huffio import format as jformat
from huffmandecoderongpus_tpu.huffio import sidecar as jsidecar
from huffmandecoderongpus_tpu.huffio.tree import build_tree as jbuild_tree
from huffmandecoderongpus_tpu.huffio.tree import tree_codes as jtree_codes
from huffmandecoderongpus_tpu.ops import encode_ops as jencode_ops
from huffmandecoderongpus_tpu.ops import pallas_encode as pe
from huffmandecoderongpus_tpu_torch import huffio
from huffmandecoderongpus_tpu_torch.ops import encode, encode_ops
from huffmandecoderongpus_tpu_torch.ops.e1_pack import e1_pack_ref
from huffmandecoderongpus_tpu_torch.ops.e2_compact import e2_compact_ref
from huffmandecoderongpus_tpu_torch.ops.e3_place import (
    e3_place,
    e3_place_ref,
    occupancy,
    place_ref,
)
from huffmandecoderongpus_tpu_torch.probes import streams as ps
from huffmandecoderongpus_tpu_torch.utils import trace
from torch_streams import (
    fib_tree_data,
    full_alphabet,
    md1,
    odd_md,
    random_bytes,
    text_like,
)

CPU = torch.device("cpu")


def _ns2_all(rng, n):
    """full_alphabet with every one of the 256 symbols present."""
    return np.concatenate([np.arange(256, dtype=np.uint8),
                           full_alphabet(rng, n - 256)])


#: name -> (generator, bytes); "fib" cases carry their own tree and
#: run at 128 lanes
CASES = {
    "text-11": (text_like, 11),
    "text-500": (text_like, 500),
    "text-20000": (text_like, 20000),
    "text-140000": (text_like, 140000),  # G = 256: two rows of 128 lanes
    "random-20000": (random_bytes, 20000),
    "md3-20000": (odd_md, 20000),
    "ns2-30000": (_ns2_all, 30000),
    "ns2-140000": (_ns2_all, 140000),
    "md1-20000": (md1, 20000),
    "fib600": ("fib", 600),  # a tail lane overflows ORP: E2, E3 run again
    "fib40": ("fib", 40),  # near the boundary: the first plan holds
}
OVERFLOWS = {"fib600"}


@functools.lru_cache(maxsize=None)
def _case(name):
    """(raw, tree or None, lanes) of one case, from a fixed seed."""
    gen, n = CASES[name]
    rng = np.random.default_rng(5)
    if gen == "fib":
        raw, tree = fib_tree_data(rng, n)
        return raw, tree, 128
    return gen(rng, n), None, None


@functools.lru_cache(maxsize=None)
def _jax_run(name):
    """One JAX ``encode_pallas`` (interpret mode) of a case, with the
    arguments and outputs of the ``encode_program`` it ran."""
    raw, tree, lanes = _case(name)
    seen = {}
    real = pe.encode_program

    def spy(*args, **kw):
        seen.update(args=[np.asarray(a) for a in args], kw=kw)
        out = real(*args, **kw)
        seen["out"] = [np.asarray(o) for o in out[:2]]
        return out

    pe.encode_program = spy
    try:
        hf = pe.encode_pallas(raw, tree=tree, lanes=lanes, interpret=True)
    finally:
        pe.encode_program = real
    return dict(seen, hf=hf)


@functools.lru_cache(maxsize=None)
def _jax_kernels(name):
    """The JAX package's E1, E2, shift and E3 (interpret mode) on the
    staging of one case, each as ``encode_program`` calls it."""
    run = _jax_run(name)
    data3, lo, hi, nval2 = run["args"]
    kw = run["kw"]
    K, G, SEG = kw["K"], kw["G"], kw["SEG"]
    rows_p, ORP = kw["rows_p"], kw["ORP"]
    gran, gval, cnt2, bits2 = (np.asarray(x) for x in pe.e1_pack(
        data3, lo, hi, nval2, K=K, G=G, SEG=SEG, interpret=True))
    rows = 2 * K
    granT = np.zeros((G, rows_p), np.int32)
    gvalT = np.zeros((G, rows_p), np.uint8)
    granT[:, :rows] = gran.reshape(rows, G).T
    gvalT[:, :rows] = gval.reshape(rows, G).T
    denseT = np.asarray(pe.e2_compact(granT, gvalT, G=G, rows_p=rows_p,
                                      ORP=ORP, interpret=True))
    L = bits2.reshape(G).astype(np.int64)
    P = np.cumsum(L) - L
    shift = (P & 15).astype(np.int32)
    word_off = (P >> 4).astype(np.int32)
    shifted = np.asarray(pe.shift_lanes(denseT, cnt2.reshape(G), shift,
                                        G=G, ORP=ORP))
    out2 = np.asarray(pe.e3_place(
        shifted.reshape(G, ORP // 128, 128), word_off.reshape(1, G), G=G,
        ORPW=ORP // 128, NROWS=kw["NROWS"], interpret=True))
    return dict(gran=gran.reshape(rows, G), gval=gval.reshape(rows, G),
                cnt=cnt2.reshape(G), bits=L, denseT=denseT, shift=shift,
                word_off=word_off, shifted=shifted, out2=out2)


def _stage(name):
    raw, tree, lanes = _case(name)
    return encode.stage_encode_inputs(raw, tree=tree, lanes=lanes, device=CPU)


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("name", sorted(CASES))
def test_staging_matches_jax(name):
    run, st = _jax_run(name), _stage(name)
    data3, lo, hi, nval2 = run["args"]
    p = st["plan"]
    K, G = p["K"], p["G"]
    np.testing.assert_array_equal(st["data3"].numpy(), data3.reshape(K, G))
    np.testing.assert_array_equal(st["lo"].numpy(), lo.reshape(-1)[:256])
    np.testing.assert_array_equal(st["hi"].numpy(), hi.reshape(-1)[:256])
    np.testing.assert_array_equal(st["nval"].numpy(), nval2.reshape(G))
    assert {k: p[k] for k in run["kw"] if k != "interpret"} == {
        k: v for k, v in run["kw"].items() if k != "interpret"}
    assert p["total_bits"] == run["hf"].bits
    assert p["n_granules"] == -(-run["hf"].bits // 16)


@pytest.mark.parametrize("name", sorted(CASES))
def test_e1_matches_jax(name):
    st, want = _stage(name), _jax_kernels(name)
    gran, gval, cnt, bits = e1_pack_ref(st["data3"], st["lo"], st["hi"],
                                        st["nval"])
    np.testing.assert_array_equal(gran.numpy(), want["gran"])  # every row
    np.testing.assert_array_equal(gval.numpy(), want["gval"])
    np.testing.assert_array_equal(cnt.numpy(), want["cnt"])
    np.testing.assert_array_equal(bits.numpy(), want["bits"])


@pytest.mark.parametrize("name", sorted(CASES))
def test_e2_matches_jax(name):
    want = _jax_kernels(name)
    ORP = _stage(name)["plan"]["ORP"]
    got = e2_compact_ref(_t(want["gran"]), _t(want["gval"]), ORP=ORP).numpy()
    n = np.minimum(want["cnt"], ORP)
    mask = np.arange(ORP)[None, :] < n[:, None]
    np.testing.assert_array_equal(got[mask], want["denseT"][mask])
    assert not got[~mask].any()  # the port's rows are zero past the counts


@pytest.mark.parametrize("name", sorted(CASES))
def test_shift_lanes_matches_jax(name):
    # fed the JAX E2's rows, whose words past the counts are undefined:
    # both versions must mask them
    want = _jax_kernels(name)
    got = encode.shift_lanes(_t(want["denseT"]), _t(want["cnt"]),
                             _t(want["shift"]))
    np.testing.assert_array_equal(got.numpy(), want["shifted"])


@pytest.mark.parametrize("name", sorted(CASES))
def test_e3_matches_jax(name):
    want = _jax_kernels(name)
    p = _stage(name)["plan"]
    occ = occupancy(_t(want["shift"]), _t(want["bits"]))
    got = place_ref(_t(want["shifted"]), _t(want["word_off"]), occ,
                    NROWS=p["NROWS"]).numpy()
    np.testing.assert_array_equal(got, want["out2"])  # the whole array
    if name in OVERFLOWS:
        return  # an overflowing lane's row was cut: the bytes are thrown away
    n = p["n_granules"]
    placed = pe.place_lanes(want["shifted"].astype(np.int64), want["shift"],
                            want["bits"], want["word_off"].astype(np.int64), n)
    np.testing.assert_array_equal(got.reshape(-1)[:n], placed)
    assert not got.reshape(-1)[n:].any()


def _jax_shift_and_e3(denseT, cnt, bits, NROWS):
    """The JAX package's offsets, ``shift_lanes`` and ``e3_place``
    (interpret mode) as ``encode_program`` runs them, on G padded to whole
    128-lane grid steps with empty lanes (which add nothing)."""
    G, ORP = denseT.shape
    Gp = -(-G // 128) * 128
    d = np.zeros((Gp, ORP), np.int32)
    d[:G] = denseT
    c = np.zeros(Gp, np.int32)
    c[:G] = cnt
    L = np.zeros(Gp, np.int64)
    L[:G] = bits
    P = np.cumsum(L) - L
    shifted = np.asarray(pe.shift_lanes(d, c, (P & 15).astype(np.int32),
                                        G=Gp, ORP=ORP))
    return np.asarray(pe.e3_place(
        shifted.reshape(Gp, ORP // 128, 128),
        (P >> 4).astype(np.int32).reshape(1, Gp), G=Gp, ORPW=ORP // 128,
        NROWS=NROWS, interpret=True))


@pytest.mark.parametrize("name", sorted(CASES) + [f"e3:{c}"
                                                  for c in ps.E3_CASES])
def test_fused_e3_matches_jax(name):
    # the fused E3's plain version (offsets, shift and placement from E2's
    # rows and E1's counts) against the JAX package's three steps: on the
    # encode streams (fed the JAX E2's rows, undefined past the counts),
    # and on E3's own cases: three and more lanes in a granule, runs of
    # empty lanes, a lane clamped at ORP, no bits at all
    if name.startswith("e3:"):
        denseT, cnt, bits, NROWS, gran = ps.e3_case(name[3:], "cpu")
        denseT, cnt, bits = denseT.numpy(), cnt.numpy(), bits.numpy()
    else:
        k = _jax_kernels(name)
        denseT, cnt, bits = k["denseT"], k["cnt"], k["bits"].astype(np.int32)
        NROWS, gran = _stage(name)["plan"]["NROWS"], None
    got = e3_place(_t(denseT), _t(cnt), _t(bits), NROWS=NROWS).numpy()
    np.testing.assert_array_equal(got, _jax_shift_and_e3(denseT, cnt, bits,
                                                         NROWS))
    if name in ("e3:clamped", *OVERFLOWS):
        assert int(cnt.max()) >= denseT.shape[1]
    elif gran is not None:  # the whole stream, zero past it
        flat = got.reshape(-1)
        np.testing.assert_array_equal(flat[:gran.size], gran)
        assert not flat[gran.size:].any()


@pytest.mark.parametrize("name", sorted(CASES))
def test_encode_program_matches_jax(name):
    run, st = _jax_run(name), _stage(name)
    p = st["plan"]
    out, cnt = encode.encode_program(st["data3"], st["lo"], st["hi"],
                                     st["nval"], ORP=p["ORP"],
                                     NROWS=p["NROWS"])
    out2, cnt2 = run["out"]
    np.testing.assert_array_equal(cnt.numpy(), cnt2.reshape(-1))
    if name not in OVERFLOWS:
        np.testing.assert_array_equal(out.numpy(), out2)


def _retries() -> int:
    """Encodes finished off their first plan so far (``encode.retry``)."""
    return trace.counts().get("encode.retry", 0)


@pytest.mark.parametrize("name", sorted(CASES))
def test_encode_lanes_matches_jax(name):
    raw, tree, lanes = _case(name)
    want = _jax_run(name)["hf"]
    before = _retries()
    got = encode.encode_lanes(raw, tree=tree, lanes=lanes, device="cpu")
    assert _retries() - before == (name in OVERFLOWS)
    host = huffio.encode_bytes(raw, tree=tree)
    for other in (want, host):
        np.testing.assert_array_equal(got.tree, other.tree)
        assert (got.bits, got.uncompressed_size) == (
            other.bits, other.uncompressed_size)
        np.testing.assert_array_equal(got.payload, other.payload)


def _refuse(*args, **kw):
    raise AssertionError("not on this stream's route")


def test_long_codes_go_to_encode_device(monkeypatch):
    # 30 Fibonacci-weighted symbols: the deepest codes are 29 bits, past
    # the two 13-bit halves; the JAX package encodes them on the host, the
    # port with encode_device on the same device, to the same bytes
    raw, tree = fib_tree_data(np.random.default_rng(2), 50, n_sym=30)
    assert jtree_codes(tree)[1].max() > 26
    monkeypatch.setattr(encode, "e1_pack", _refuse)
    before = _retries()
    got = encode.encode_lanes(raw, tree=tree, device="cpu")
    assert _retries() == before + 1
    want = pe.encode_pallas(raw, tree=tree, interpret=True)
    assert got.bits == want.bits
    np.testing.assert_array_equal(got.payload, want.payload)
    with pytest.raises(ValueError, match="26"):
        encode.stage_encode_inputs(raw, tree=tree, device="cpu")


def test_overflow_reruns_e2_e3_with_larger_orp(monkeypatch):
    # fib600's tail lanes overflow ORP: E2 and E3 run again on E1's rows
    # with ORP past the largest count, and nothing else is called
    raw, tree, lanes = _case("fib600")
    p = _stage("fib600")["plan"]
    orps, real = [], encode.e2_compact

    def e2(gran, gval, *, ORP):
        orps.append(ORP)
        return real(gran, gval, ORP=ORP)

    monkeypatch.setattr(encode, "e2_compact", e2)
    monkeypatch.setattr(encode, "encode_device", _refuse)
    got = encode.encode_lanes(raw, tree=tree, lanes=lanes, device="cpu")
    cnt = _jax_kernels("fib600")["cnt"]
    assert orps[0] == p["ORP"] <= cnt.max() < orps[1] and len(orps) == 2
    assert orps[1] % 128 == 0 and orps[1] - 128 <= cnt.max()
    want = huffio.encode_bytes(raw, tree=tree)
    np.testing.assert_array_equal(got.payload, want.payload)


@pytest.mark.parametrize("block_symbols", [1, 777])
def test_encode_lanes_block_index_matches_jax(block_symbols):
    raw = text_like(np.random.default_rng(4), 20000)
    got = encode.encode_lanes(raw, device="cpu", block_symbols=block_symbols)
    want = jencoder.encode_bytes(raw, block_symbols=block_symbols)
    np.testing.assert_array_equal(got.index[0], want.index[0])
    assert got.index[1] == want.index[1] == block_symbols
    assert encode.encode_lanes(raw, device="cpu").index is None


def test_missing_symbol_raises():
    # a tree with no code for symbol 7: the port raises, as encode_bytes
    # and encode_device do; the JAX encode_pallas does not check and drops
    # the symbol's bits (a recorded divergence)
    rng = np.random.default_rng(0)
    raw = rng.integers(0, 8, size=3000, dtype=np.uint8)
    freqs = np.bincount(raw, minlength=256)
    freqs[7] = 0
    tree = jbuild_tree(freqs)
    for fn in (lambda: encode.encode_lanes(raw, tree=tree, device="cpu"),
               lambda: encode.stage_encode_inputs(raw, tree=tree,
                                                  device="cpu"),
               lambda: encode_ops.encode_device(raw, tree=tree, device="cpu"),
               lambda: huffio.encode_bytes(raw, tree=tree)):
        with pytest.raises(ValueError, match=r"no code for symbols \[7\]"):
            fn()
    dropped = pe.encode_pallas(raw, tree=tree, interpret=True)
    length = jtree_codes(tree)[1]
    assert dropped.bits == int(length[raw].astype(np.int64).sum())
    assert dropped.uncompressed_size == raw.size


def test_empty_input_raises():
    for fn in (lambda: encode.encode_lanes(b"", device="cpu"),
               lambda: encode_ops.encode_device(b"", device="cpu")):
        with pytest.raises(ValueError, match="empty"):
            fn()


def test_cuda_requested_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("CUDA is available: the check is for hosts without it")
    for fn in (encode.encode_lanes, encode_ops.encode_device):
        with pytest.raises(RuntimeError, match="cuda"):
            fn(b"abc", device="cuda")


@pytest.mark.parametrize("lane_bits", [
    [5, 1, 2, 3, 1, 40, 0, 0],  # 1-3-bit lanes share granules both ways
    [1] * 40 + [300, 17, 2, 0, 0, 0],  # one granule shared by 16 lanes
    [16, 16, 15, 1, 33, 0, 0, 0, 0, 0],
])
def test_e3_shared_granules(lane_bits):
    # every lane's bits from one random stream: E3 must assemble the stream
    # exactly, and agree with the JAX package's host placement
    denseT, cnt, bits, NROWS, gran = ps.e3_lanes(np.random.default_rng(1),
                                                 lane_bits, 128)
    shift, W, occ = encode.lane_offsets(_t(bits))
    shifted = encode.shift_lanes(_t(denseT), _t(cnt), shift)
    n = gran.size
    got = place_ref(shifted, W, occ, NROWS=NROWS).numpy()
    np.testing.assert_array_equal(got.reshape(-1)[:n], gran)
    assert not got.reshape(-1)[n:].any()
    placed = pe.place_lanes(shifted.numpy().astype(np.int64), shift.numpy(),
                            np.asarray(lane_bits), W.numpy().astype(np.int64),
                            n)
    np.testing.assert_array_equal(placed, gran)


def test_encode_lanes_past_jax_vmem_route():
    # a payload over 8 MiB of granule rows, where the JAX package places
    # the lanes on the host (place_lanes); the port runs E3 all the same
    rng = np.random.default_rng(9)
    raw = full_alphabet(rng, 5_000_000)
    st = encode.stage_encode_inputs(raw, device=CPU)
    p = st["plan"]
    assert p["NROWS"] * 128 * 4 > 8 * 2**20
    gran, gval, cnt, bits = e1_pack_ref(st["data3"], st["lo"], st["hi"],
                                        st["nval"])
    assert int(cnt.max()) < p["ORP"]
    denseT = e2_compact_ref(gran, gval, ORP=p["ORP"])
    shift, word_off, occ = encode.lane_offsets(bits)
    L = bits.numpy().astype(np.int64)
    P = np.cumsum(L) - L
    np.testing.assert_array_equal(shift.numpy(), P & 15)
    np.testing.assert_array_equal(word_off.numpy(), P >> 4)
    shifted = encode.shift_lanes(denseT, cnt, shift)
    np.testing.assert_array_equal(
        shifted.numpy(),
        np.asarray(pe.shift_lanes(denseT.numpy(), cnt.numpy(), shift.numpy(),
                                  G=p["G"], ORP=p["ORP"])))
    out = place_ref(shifted, word_off, occ, NROWS=p["NROWS"])
    assert torch.equal(out, e3_place_ref(denseT, cnt, bits, NROWS=p["NROWS"]))
    n = p["n_granules"]
    placed = pe.place_lanes(shifted.numpy().astype(np.int64),
                            shift.numpy(), L, P >> 4, n)
    np.testing.assert_array_equal(out.numpy().reshape(-1)[:n], placed)
    got = encode.encode_lanes(raw, device="cpu")
    want = huffio.encode_bytes(raw)
    assert got.bits == want.bits == p["total_bits"]
    np.testing.assert_array_equal(got.payload, want.payload)


@pytest.mark.parametrize("n", [1, 2, 11, 1000, 65537])
def test_encode_device_matches_jax(n):
    raw = text_like(np.random.default_rng(n), n)
    got = encode_ops.encode_device(raw, device="cpu")
    want = jencode_ops.encode_device(raw)
    np.testing.assert_array_equal(got.tree, want.tree)
    assert (got.bits, got.uncompressed_size) == (want.bits,
                                                 want.uncompressed_size)
    np.testing.assert_array_equal(got.payload, want.payload)


@pytest.mark.parametrize("index", [None, 1000])
def test_cli_encode_matches_jax(tmp_path, capsys, index):
    from huffmandecoderongpus_tpu_torch.harness.cli import main

    raw = text_like(np.random.default_rng(3), 30000)
    src = tmp_path / "x.bin"
    raw.tofile(src)
    argv = ["encode", str(src), "--device", "cpu"]
    main(argv + (["--index", str(index)] if index else []))
    out = capsys.readouterr().out
    want = jencoder.encode_bytes(raw, block_symbols=index)
    ref = tmp_path / "want.huff"
    jformat.write_huff(ref, want)
    huff = tmp_path / "x.bin.huff"
    assert huff.read_bytes() == ref.read_bytes()
    assert out.startswith(f"{src}: {raw.size} -> {want.file_bytes()} bytes")
    idx = jsidecar.index_path(huff)
    if index:
        jsidecar.write_index(tmp_path / "want.huffidx", *want.index,
                             bits=want.bits,
                             uncompressed_size=want.uncompressed_size,
                             payload=want.payload)
        assert idx.read_bytes() == (tmp_path / "want.huffidx").read_bytes()
        assert f"index every {index} symbols" in out
    else:
        assert not idx.exists()
    dst = tmp_path / "x.out"
    main(["decode", str(huff), str(dst), "--device", "cpu"])
    np.testing.assert_array_equal(np.fromfile(dst, dtype=np.uint8), raw)


def test_cli_runs_on_the_card_by_default(tmp_path):
    from huffmandecoderongpus_tpu_torch.harness.cli import main

    if torch.cuda.is_available():
        pytest.skip("CUDA is available: the check is for hosts without it")
    src = tmp_path / "x.bin"
    src.write_bytes(b"abracadabra")
    with pytest.raises(RuntimeError, match="cuda"):
        main(["encode", str(src)])

"""The speculative pipeline and the one-thread decode against the JAX
package's, on the CPU.

The port's decode table, window extraction and plan against
``huffmandecoderongpus_tpu.ops.lut``/``ops.speculative``; the whole pipeline
(the plain versions of S1-S3: ``spec_all_bits``, S2's tile and pair
launches, ``spec_query``) against ``speculative_decode_xla``, once on the port's
table and once on the JAX table carried across by ``lut_from_arrays``;
each stage against its XLA twin; the numpy oracle against the JAX one; the
one-thread walk (S4's plain version) against ``_onethread_decode``; and the
registry entries and the ``decode``/``prof`` commands.  Streams are seeded
numpy data encoded by ``encode_bytes``.  The text and 12-symbol streams put
a doubling level on the int16 boundary (2^k * height past 32767: level 12
at height 9, level 13 at height 4), the full-alphabet streams sit at 2^14
and 2^14 + 1 symbols, and the tiny inputs give 0-3 levels.  Tolerance 0
(integer outputs).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from huffmandecoderongpus_tpu.models import onethread as jonethread
from huffmandecoderongpus_tpu.ops import lut as jlut
from huffmandecoderongpus_tpu.ops import speculative as jspec
from huffmandecoderongpus_tpu_torch import huffio
from huffmandecoderongpus_tpu_torch.harness import cli, profiling
from huffmandecoderongpus_tpu_torch.models import get_decoder
from huffmandecoderongpus_tpu_torch.ops import lut, onethread
from huffmandecoderongpus_tpu_torch.ops import spec_double, spec_query
from huffmandecoderongpus_tpu_torch.ops import speculative as spec
from torch_streams import full_alphabet, text_like

SEED = 19
TINY = [b"a", b"ab", b"aab", b"x" * 7]


def fib_tree(n_sym):
    """The Huffman tree of Fibonacci weights over ``n_sym`` symbols: its
    deepest codes are ``n_sym - 1`` bits."""
    fib = [1, 1]
    while len(fib) < n_sym:
        fib.append(fib[-1] + fib[-2])
    freqs = np.zeros(256, dtype=np.int64)
    freqs[:n_sym] = fib[::-1]
    return huffio.build_tree(freqs)


def _raw(name):
    rng = np.random.default_rng(SEED)
    if name == "skewed":  # the JAX test_xla_roundtrip_random_skewed shape
        probs = np.arange(1, 33, dtype=np.float64) ** 3
        return rng.choice(np.arange(32, dtype=np.uint8), size=65_537,
                          p=probs / probs.sum())
    if name == "text":  # height 9, 15 levels
        return text_like(rng, 20_000)
    if name == "alpha2k":
        return full_alphabet(rng, 1 << 14)
    if name == "alpha2k1":
        return full_alphabet(rng, (1 << 14) + 1)
    if name == "u12":  # height 4, 15 levels
        return rng.choice(np.arange(65, 77, dtype=np.uint8), size=20_000)
    return np.frombuffer(TINY[int(name[4:])], dtype=np.uint8)


STREAMS = ["skewed", "text", "alpha2k", "alpha2k1", "u12",
           *(f"tiny{i}" for i in range(len(TINY)))]
_CACHE = {}


def stream(name):
    if name not in _CACHE:
        raw = _raw(name)
        _CACHE[name] = (raw, huffio.encode_bytes(raw))
    return _CACHE[name]


def corrupt():
    """The skewed stream with its payload cut 3 bits short: the chain of
    ``size`` codewords cannot end at the new ``bits``, so both packages
    report -1."""
    raw, hf = stream("skewed")
    bits = hf.bits - 3
    return raw, huffio.HuffFile(tree=hf.tree, bits=bits,
                                uncompressed_size=hf.uncompressed_size,
                                payload=hf.payload[:(bits + 7) // 8])


def flipped(byte, bit):
    """The skewed stream with one payload bit flipped."""
    raw, hf = stream("skewed")
    payload = hf.payload.copy()
    payload[byte] ^= 1 << bit
    return raw, dataclasses.replace(hf, payload=payload)


#: corrupt streams: cut 3 bits short, and two flips that break the chain
#: (the numpy oracle raises RuntimeError on the first, IndexError on the
#: second, in both packages)
CORRUPT = {"cut": corrupt, "flip4.2": lambda: flipped(4, 2),
           "flip0.2": lambda: flipped(0, 2)}


def jax_decode(hf, jtable=None):
    plan, (w, s, ln) = jspec.decode_device_arrays(hf, jtable)
    r, f = jspec.speculative_decode_xla(w, s, ln, bits=plan.bits,
                                        size=plan.size, height=plan.height,
                                        levels=plan.levels)
    return np.asarray(r), int(f)


def port_decode(hf, table):
    plan, (w, s, ln) = spec.decode_device_arrays(hf, table, device="cpu")
    r, f = spec.speculative_decode(w, s, ln, bits=plan.bits, size=plan.size,
                                   height=plan.height, levels=plan.levels)
    return r.numpy(), int(f)


# ---- the table --------------------------------------------------------------

TREES = {"h1": lambda: stream("tiny0")[1].tree,
         "h4": lambda: stream("u12")[1].tree,
         "h9": lambda: stream("text")[1].tree,
         "h14": lambda: stream("alpha2k")[1].tree,
         "h16": lambda: fib_tree(17), "h20": lambda: fib_tree(21),
         "h22": lambda: fib_tree(23)}


@pytest.mark.parametrize("name", sorted(TREES))
def test_lut_matches_jax(name):
    tree = TREES[name]()
    want = jlut.build_decode_lut(tree)
    got = lut.build_decode_lut(tree)
    assert got.height == want.height == max(int(name[1:]), 1)
    assert got.min_depth == want.min_depth and got.mask == want.mask
    assert got.sym.dtype == np.uint8 and got.length.dtype == np.int32
    np.testing.assert_array_equal(got.sym, want.sym)
    np.testing.assert_array_equal(got.length, want.length)


@pytest.mark.parametrize("n_sym", [24, 30])
def test_lut_refuses_trees_taller_than_22_like_jax(n_sym):
    tree = fib_tree(n_sym)  # 23- and 29-bit codes
    for build in (jlut.build_decode_lut, lut.build_decode_lut):
        with pytest.raises(NotImplementedError):
            build(tree)


def test_one_symbol_gets_the_padded_two_leaf_table():
    table = lut.build_decode_lut(huffio.encode_bytes(b"a").tree)
    assert table.height == 1
    np.testing.assert_array_equal(table.length, [1, 1])
    assert ord("a") in table.sym.tolist()


def test_explicit_height_matches_jax():
    tree = stream("text")[1].tree
    want = jlut.build_decode_lut(tree, height=12)
    got = lut.build_decode_lut(tree, height=12)
    np.testing.assert_array_equal(got.sym, want.sym)
    np.testing.assert_array_equal(got.length, want.length)


def test_lut_from_arrays_carries_the_jax_table():
    want = jlut.build_decode_lut(stream("text")[1].tree)
    got = lut.lut_from_arrays(want.height, want.sym, want.length,
                              want.min_depth)
    assert (got.height, got.min_depth) == (want.height, want.min_depth)
    np.testing.assert_array_equal(got.sym, want.sym)
    with pytest.raises(ValueError):
        lut.lut_from_arrays(want.height + 1, want.sym, want.length, 2)


# ---- windows and plan -------------------------------------------------------

def test_payload_words_match_jax():
    from huffmandecoderongpus_tpu.huffio.bitio import payload_to_words_u32

    _raw_, hf = stream("text")
    for extra in (1, 2):
        np.testing.assert_array_equal(
            huffio.payload_to_words_u32(hf.payload, hf.bits, extra),
            payload_to_words_u32(hf.payload, hf.bits, extra))


@pytest.mark.parametrize("height", [1, 9, 20, 22])
def test_extract_windows_match_jax(height):
    _raw_, hf = stream("skewed")
    words = huffio.payload_to_words_u32(hf.payload, hf.bits, 1)
    rng = np.random.default_rng(height)
    b = np.concatenate([rng.integers(0, hf.bits, 500), np.arange(64),
                        np.arange(hf.bits - 40, hf.bits)]).astype(np.int32)
    assert set((b & 31).tolist()) == set(range(32))
    want = np.asarray(jspec.extract_windows(jnp.asarray(words),
                                            jnp.asarray(b), height))
    got = spec.extract_windows(torch.from_numpy(words.view(np.int32)),
                               torch.from_numpy(b), height)
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))


@pytest.mark.parametrize("bits,size,height", [
    (32, 11, 4), (10, 1, 2), (10, 2, 2), (24585561, 5504597, 19),
    (10, 0, 1), (100, 1 << 14, 9), (100, (1 << 14) + 1, 9)])
def test_plan_matches_jax(bits, size, height):
    got = spec.make_plan(bits, size, height)
    want = jspec.make_plan(bits, size, height)
    assert dataclasses.astuple(got) == dataclasses.astuple(want)
    assert got.n_words == want.n_words


# ---- the pipeline -----------------------------------------------------------

@pytest.mark.parametrize("table", ["port", "jax"])
@pytest.mark.parametrize("name", STREAMS)
def test_pipeline_matches_jax(name, table):
    raw, hf = stream(name)
    jt = jlut.build_decode_lut(hf.tree)
    pt = (lut.build_decode_lut(hf.tree) if table == "port" else
          lut.lut_from_arrays(jt.height, jt.sym, jt.length, jt.min_depth))
    want_r, want_f = jax_decode(hf, jt)
    got_r, got_f = port_decode(hf, pt)
    assert got_f == want_f == raw.size
    np.testing.assert_array_equal(got_r, want_r)
    np.testing.assert_array_equal(got_r, raw)


@pytest.mark.parametrize("case", sorted(CORRUPT))
def test_corrupt_stream_found_minus_one_in_both(case):
    raw, hf = CORRUPT[case]()
    want_r, want_f = jax_decode(hf)
    got_r, got_f = port_decode(hf, None)
    assert got_f == want_f == -1
    np.testing.assert_array_equal(got_r, want_r)
    with pytest.raises(RuntimeError, match="decoded -1 symbols, header says "
                       "65537"):
        spec.decode_spec(hf, "cpu")
    out = spec.decode_spec(hf, "cpu", check_size=False)
    np.testing.assert_array_equal(out, want_r)
    assert not np.array_equal(out, raw)


def test_short_header_found_minus_one_in_both():
    # a header that says fewer symbols than the payload holds
    _raw_, hf = stream("text")
    short = dataclasses.replace(hf, uncompressed_size=hf.uncompressed_size
                                - 10)
    want_r, want_f = jax_decode(short)
    got_r, got_f = port_decode(short, None)
    assert got_f == want_f == -1
    np.testing.assert_array_equal(got_r, want_r)


def _jax_stage1(words, table, bits):
    b = jnp.arange(bits, dtype=jnp.int32)
    win = jspec.extract_windows(jnp.asarray(words), b,
                                table.height).astype(jnp.int32)
    ln = jnp.take(jnp.asarray(table.length), win, mode="clip")
    sym = jnp.take(jnp.asarray(table.sym), win, mode="clip")
    return np.asarray(jnp.where(b + ln <= bits, ln, -1)), np.asarray(sym)


def _numpy_levels(step0, bits, levels):
    """Every doubling level by the JAX package's recurrence
    (``speculative_decode_numpy``)."""
    b = np.arange(bits, dtype=np.int64)
    steps = [step0.astype(np.int64)]
    for _ in range(max(levels - 1, 0)):
        s = steps[-1]
        t = b + s
        w = s[np.clip(t, 0, bits - 1)]
        ok = (s != -1) & (t < bits) & (w != -1) & (t + w <= bits)
        steps.append(np.where(ok, s + w, -1))
    return steps


@pytest.mark.parametrize("name", ["text", "u12", "alpha2k1", "tiny1",
                                  "tiny3"])
def test_stages_match_jax(name):
    raw, hf = stream(name)
    table = lut.build_decode_lut(hf.tree)
    plan, (w, s, ln) = spec.decode_device_arrays(hf, table, device="cpu")
    st = spec.speculative_stages(w, s, ln, bits=plan.bits, size=plan.size,
                                 height=plan.height, levels=plan.levels)
    # S1 against the XLA window extraction and lookups
    step0, sym = _jax_stage1(w.numpy().view(np.uint32),
                             jlut.build_decode_lut(hf.tree), plan.bits)
    assert st["step0"].dtype == torch.int16
    np.testing.assert_array_equal(st["step0"].numpy(), step0)
    np.testing.assert_array_equal(st["sym"].numpy(), sym)
    # S2: the kept levels, each in the JAX keep() type
    steps = _numpy_levels(step0, plan.bits, plan.levels)
    assert len(st["kept"]) == spec_query.kept_count(plan.levels)
    for j, lv in enumerate(st["kept"]):
        assert lv.dtype == spec_double.level_dtype(2 * j, plan.height)
        np.testing.assert_array_equal(lv.numpy(), steps[2 * j])
    # S3
    assert int(st["found"]) == raw.size
    np.testing.assert_array_equal(st["result"].numpy(), raw)


@pytest.mark.parametrize("name,k", [("text", 12), ("u12", 13)])
def test_int16_boundary_levels(name, k):
    # level k is the first int32 level at this height; k - 1 the last int16
    _raw_, hf = stream(name)
    table = lut.build_decode_lut(hf.tree)
    assert (1 << (k - 1)) * table.height <= 32767 < (1 << k) * table.height
    assert spec_double.level_dtype(k - 1, table.height) == torch.int16
    assert spec_double.level_dtype(k, table.height) == torch.int32
    assert spec.make_plan(hf.bits, hf.uncompressed_size,
                          table.height).levels > k


def test_double_reads_minus_one_back_from_int16():
    s = torch.tensor([2, -1, 1, 3, -1, 1, 1], dtype=torch.int16)
    want = torch.tensor([3, -1, 4, 4, -1, 2, -1], dtype=torch.int32)
    for dtype in (torch.int16, torch.int32):
        got = spec_double.spec_double(s, bits=7, dtype=dtype)
        assert got.dtype == dtype
        assert torch.equal(got.to(torch.int32), want)
    with pytest.raises(ValueError):
        spec_double.spec_double(s.to(torch.int32), bits=7, dtype=torch.int16)


@pytest.mark.parametrize("name,levels,tiles,pairs", [
    ("tiny0", 0, 0, 0), ("tiny1", 1, 0, 0), ("tiny2", 2, 0, 0),
    ("tiny3", 3, 1, 0), ("text", 15, 1, 3), ("u12", 15, 1, 2),
    ("skewed", 17, 1, 4)])
def test_s2_launches_follow_the_plan(monkeypatch, name, levels, tiles,
                                     pairs):
    # one tile launch for the kept levels 2..m and a pair launch for each
    # kept level above (s2_plan), none below 3 levels; no odd level written
    _raw_, hf = stream(name)
    plan, (w, s, ln) = spec.decode_device_arrays(hf, device="cpu")
    assert plan.levels == levels
    calls = []
    for mod, fn in ((spec, "spec_tile"), (spec, "spec_pair"),
                    (spec_double, "spec_double")):
        real = getattr(mod, fn)

        def counting(*a, fn=fn, real=real, **kw):
            calls.append(fn)
            return real(*a, **kw)

        monkeypatch.setattr(mod, fn, counting)
    st = spec.speculative_stages(w, s, ln, bits=plan.bits, size=plan.size,
                                 height=plan.height, levels=plan.levels)
    assert calls.count("spec_tile") == tiles
    assert calls.count("spec_pair") == pairs
    assert "spec_double" not in calls
    p = spec.s2_plan(plan.bits, plan.height, plan.levels, size=plan.size)
    assert p["launches"] == tiles + pairs
    assert int(st["found"]) == plan.size


def test_empty_header_matches_jax():
    # size 0: no query launch; the chain ends at bit 0, never at bits
    _raw_, hf = stream("tiny1")
    empty = dataclasses.replace(hf, uncompressed_size=0)
    want_r, want_f = jax_decode(empty)
    got_r, got_f = port_decode(empty, None)
    assert got_f == want_f == -1 and got_r.size == want_r.size == 0


# ---- the numpy oracle -------------------------------------------------------

@pytest.mark.parametrize("name", ["skewed", "text", "alpha2k", "u12",
                                  "tiny0", "tiny3"])
def test_pes_numpy_matches_jax(name):
    raw, hf = stream(name)
    got = spec.speculative_decode_numpy(hf)
    np.testing.assert_array_equal(got, jspec.speculative_decode_numpy(hf))
    np.testing.assert_array_equal(got, raw)


@pytest.mark.parametrize("case,error", [("flip4.2", RuntimeError),
                                        ("flip0.2", IndexError)])
def test_pes_numpy_raises_like_jax(case, error):
    _raw_, hf = CORRUPT[case]()
    with pytest.raises(error) as want:
        jspec.speculative_decode_numpy(hf)
    with pytest.raises(error) as got:
        spec.speculative_decode_numpy(hf)
    assert str(got.value) == str(want.value)


def test_pes_numpy_on_the_cut_stream_matches_jax():
    # the oracle checks the highest index reached, not the chain's end, so
    # the cut stream passes it in both packages
    _raw_, hf = corrupt()
    np.testing.assert_array_equal(spec.speculative_decode_numpy(hf),
                                  jspec.speculative_decode_numpy(hf))


# ---- one thread -------------------------------------------------------------

def _onethread_both(hf):
    plan, (w, s, ln) = jspec.decode_device_arrays(hf)
    out, n = jonethread._onethread_decode(w, s, ln, bits=plan.bits,
                                          size=plan.size, height=plan.height)
    plan, (pw, ps, pln) = spec.decode_device_arrays(hf, device="cpu")
    got, gn = onethread.onethread(pw, ps, pln, bits=plan.bits,
                                  size=plan.size, height=plan.height)
    assert got.dtype == torch.uint8 and gn.dtype == torch.int32
    return (np.asarray(out), int(n)), (got.numpy(), int(gn))


@pytest.mark.parametrize("name", ["text", "u12", "tiny0", "tiny2"])
def test_onethread_matches_jax(name):
    raw, hf = stream(name)
    (want, wn), (got, gn) = _onethread_both(hf)
    assert gn == wn == raw.size
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, raw)


@pytest.mark.parametrize("delta", [-10, 7])
def test_onethread_header_off_matches_jax(delta):
    # -10: the walk decodes 10 symbols past size (writes dropped, n counts);
    # 7: it ends 7 short and the tail stays 0
    _raw_, hf = stream("text")
    off = dataclasses.replace(hf, uncompressed_size=hf.uncompressed_size
                              + delta)
    (want, wn), (got, gn) = _onethread_both(off)
    assert gn == wn == hf.uncompressed_size
    np.testing.assert_array_equal(got, want)
    with pytest.raises(RuntimeError, match="header says"):
        get_decoder("onethread_device", device="cpu")(off)


def test_onethread_corrupt_matches_jax():
    _raw_, hf = corrupt()
    (want, wn), (got, gn) = _onethread_both(hf)
    assert gn == wn
    np.testing.assert_array_equal(got, want)


# ---- registry and commands --------------------------------------------------

NAMES = ["spec_xla", "spec_xla_cpu", "pes_numpy", "onethread_device"]


@pytest.mark.parametrize("name", NAMES)
def test_registry_decodes_on_cpu(name):
    raw, hf = stream("text")
    dec = get_decoder(name, device="cpu")
    assert dec.name == name
    np.testing.assert_array_equal(dec(hf), raw)


def test_spec_xla_cpu_ignores_the_named_device(monkeypatch):
    raw, hf = stream("tiny2")
    seen = []
    real = spec.decode_device_arrays

    def spy(*a, **kw):
        seen.append(str(kw["device"]))
        return real(*a, **kw)

    monkeypatch.setattr(spec, "decode_device_arrays", spy)
    # on a host without a card, spec_xla on "cuda" raises; the CPU entry
    # decodes on the CPU whatever the lookup names
    out = get_decoder("spec_xla_cpu", device="cuda:0")(hf)
    np.testing.assert_array_equal(out, raw)
    assert seen == ["cpu"]


def test_spec_xla_raises_on_corrupt():
    _raw_, hf = corrupt()
    with pytest.raises(RuntimeError, match="decoded -1 symbols"):
        get_decoder("spec_xla", device="cpu")(hf)


def test_spec_xla_on_cuda_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the check is for hosts without one")
    _raw_, hf = stream("tiny2")
    for name in ("spec_xla", "onethread_device"):
        with pytest.raises(RuntimeError, match="cuda"):
            get_decoder(name, device="cuda")(hf)


@pytest.mark.parametrize("name", NAMES)
def test_decode_command_verifies(tmp_path, capsys, name):
    raw, hf = stream("text")
    huffio.write_huff(tmp_path / "x.huff", hf)
    raw.tofile(tmp_path / "x.bin")
    cli.main(["decode", str(tmp_path / "x.huff"), "--decoder", name,
              "--device", "cpu", "--verify", str(tmp_path / "x.bin"),
              "--repeats", "1"])
    assert name in capsys.readouterr().out


def test_prof_speculative_prints_every_stage(tmp_path, capsys):
    _raw_, hf = stream("text")
    huffio.write_huff(tmp_path / "x.huff", hf)
    report = cli.prof(str(tmp_path / "x.huff"), "speculative", None, "cpu")
    out = capsys.readouterr().out
    keys = ["decodeAllBits", "makebigtable", "index_query", "total"]
    assert list(report) == keys
    assert all(v >= 0 for v in report.values())
    for k in keys:
        assert k in out
    assert report["total"] == pytest.approx(sum(
        v for k, v in report.items() if k != "total"))


def test_profile_speculative_keys_match_jax():
    from huffmandecoderongpus_tpu.harness import profiling as jprof

    _raw_, hf = stream("tiny3")
    want = jprof.profile_speculative(hf, reps=1)
    got = profiling.profile_speculative(hf, reps=1, device="cpu")
    assert list(got) == list(want)

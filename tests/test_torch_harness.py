"""The port's harness, corpus loader and command line against the JAX
package's.

``harness/evaluate.py``, ``harness/truncate.py``, ``data.py`` and the
suites and commands of ``harness/cli.py`` are the port's copies of the JAX
package's.  They run on a temporary corpus directory (``HUFF_FILES_DIR``)
of five seeded synthetic streams under the reference's ``MAINRUN_NAMES``,
each with its raw file, and must print what the JAX package prints:
exactly where no time is printed, the same decoder, corpus and param
columns in the same order where one is.  Tolerance 0.
"""

import importlib
import io
import re

import numpy as np
import pytest

from huffmandecoderongpus_tpu import data as jdata
from huffmandecoderongpus_tpu.harness import cli as jcli
from huffmandecoderongpus_tpu.huffio import encoder as jencoder
from huffmandecoderongpus_tpu.models import all_decoders as jax_decoders
from huffmandecoderongpus_tpu_torch import data, huffio
from huffmandecoderongpus_tpu_torch.harness import (
    DecodeMismatch,
    cli,
    compare_uncompressed,
    graph_rows,
    set_target_sizes,
)
from huffmandecoderongpus_tpu_torch.models import get_decoder
from huffmandecoderongpus_tpu_torch.utils import debug
from torch_streams import batch_text, make, md1, odd_md, text_like

# the harness packages export functions named like their modules
evaluate = importlib.import_module(
    "huffmandecoderongpus_tpu_torch.harness.evaluate")
truncate = importlib.import_module(
    "huffmandecoderongpus_tpu_torch.harness.truncate")
jevaluate = importlib.import_module("huffmandecoderongpus_tpu.harness.evaluate")
jtruncate = importlib.import_module("huffmandecoderongpus_tpu.harness.truncate")


def corpus_bytes():
    """The five corpora, seeded: min code length 2 or more for the batch
    suite's three (paper1, news, book2), 1 for kjv.txt."""
    rng = np.random.default_rng(22)
    return {"hello": odd_md(rng, 12),
            "paper1": text_like(rng, 8000, 16),
            "news": odd_md(rng, 4000),
            "book2": batch_text(rng, 5000),
            "kjv.txt": md1(rng, 6000)}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op torch thread while this module runs: its CPU decodes
    are small, and test workers running side by side, each with a thread
    a core, stall one another in torch's thread pool many times over."""
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def corpus_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("files")
    for name, raw in corpus_bytes().items():
        raw.tofile(d / name)
        huffio.write_huff(d / f"{name}.huff", huffio.encode_bytes(raw))
    return d


@pytest.fixture
def corpora(corpus_dir, tmp_path, monkeypatch):
    """Both packages pointed at the corpus directory, each with an empty
    cache."""
    monkeypatch.setenv("HUFF_FILES_DIR", str(corpus_dir))
    monkeypatch.setenv("HUFF_CACHE_DIR", str(tmp_path / "cache"))
    monkeypatch.setattr(jdata, "REFERENCE_FILES", corpus_dir)
    monkeypatch.setattr(jdata, "CACHE_DIR", tmp_path / "jcache")
    return corpus_dir


def _port_hf(hf):
    return huffio.HuffFile(tree=hf.tree, bits=hf.bits,
                           uncompressed_size=hf.uncompressed_size,
                           payload=hf.payload)


# ---- evaluate -------------------------------------------------------------

@pytest.mark.parametrize("got,want", [
    ([1, 2, 3, 4], [1, 2, 3, 4]),
    ([1, 2, 3, 4], [1, 9, 3, 9]),
    ([1, 2, 3, 4], [1, 2, 3]),
    (list(range(40)), [0] * 41),  # more differences than it reports
])
def test_compare_uncompressed_matches_jax(got, want):
    got, want = np.array(got, np.uint8), np.array(want, np.uint8)
    a, b = io.StringIO(), io.StringIO()
    assert compare_uncompressed(got, want, out=a) == \
        jevaluate.compare_uncompressed(got, want, out=b)
    assert a.getvalue() == b.getvalue()


class _Fake:
    """A decoder stub with the registry's fields: ``bad`` flips a byte."""

    def __init__(self, name, bad=False, checks_output=True,
                 suite_budget_s=None):
        self.name, self.bad = name, bad
        self.checks_output = checks_output
        self.suite_budget_s = suite_budget_s
        self.calls = []

    def __call__(self, hf, param=None):
        self.calls.append(param)
        out = MD3[0].copy()
        if self.bad:
            out[7] ^= 1
        return out


MD3 = make("md3")


def _td(mod_data):
    raw, hf = MD3
    return mod_data.TestData(name="md3", cd=hf, ucd=raw)


def test_evaluate_raises_on_a_mismatch():
    for ev, dm in ((evaluate, DecodeMismatch),
                   (jevaluate, jevaluate.DecodeMismatch)):
        with pytest.raises(dm, match="bad on md3"):
            ev.evaluate(_Fake("bad", bad=True), _td(data), repeats=0)
    # a decoder that makes no bytes is not compared
    r = evaluate.evaluate(_Fake("bad", bad=True, checks_output=False),
                          _td(data), repeats=0)
    assert len(r.times) == 1
    assert issubclass(DecodeMismatch, RuntimeError)


@pytest.mark.parametrize("budget", [None, 0.0])
def test_evaluate_budget_matches_jax(budget):
    # suite_budget_s 0: the verify run alone is past the cap, so it is the
    # only sample; None: verify run, a second run, then repeats - 1 more
    runs = []
    for ev in (evaluate, jevaluate):
        dec = _Fake("fake", suite_budget_s=budget)
        r = ev.evaluate(dec, _td(data), repeats=3, param=5)
        runs.append((len(r.times), dec.calls, r.decoder, r.dataset,
                     r.uncompressed_bytes, r.compressed_bytes))
        assert r.min_seconds == min(r.times)
    assert runs[0] == runs[1]
    assert runs[0][0] == (1 if budget == 0.0 else 4)


def _columns(text):
    """Each row's decoder, corpus and param columns (no times)."""
    cols = []
    for line in text.splitlines():
        t = line.split()
        if len(t) == 6 and t[-1] == "GB/s":
            cols.append(tuple(t[:2]) + ((t[2],) if t[3] != "ms" else ()))
    return cols


@pytest.mark.parametrize("decoder,param", [("simple", None),
                                           ("jumptable", None),
                                           ("lin", 3)])
def test_evalandshow_row_matches_jax(decoder, param):
    from huffmandecoderongpus_tpu.models import get_decoder as jget

    raw, hf = make("md3")
    rows = []
    for mod, dec, h in ((evaluate, get_decoder(decoder, device="cpu"),
                         _port_hf(hf)),
                        (jevaluate, jget(decoder), hf)):
        out = io.StringIO()
        td = (data if mod is evaluate else jdata).TestData("md3", h, raw)
        mod.evalandshow(dec, td, repeats=1, param=param, out=out)
        rows.append(out.getvalue())
    assert _columns(rows[0]) == _columns(rows[1]) != []
    # the same format, letter for letter, apart from the numbers
    assert re.sub(r" *[\d.]+", " N", rows[0]) == \
        re.sub(r" *[\d.]+", " N", rows[1])


# ---- truncate -------------------------------------------------------------

@pytest.mark.parametrize("name", ["text", "md1", "ns2"])
def test_set_target_sizes_matches_jax(name):
    raw, hf = make(name)
    port = _port_hf(hf)
    for target in (0, 1, 100, hf.bits // 3, hf.bits - 1, hf.bits,
                   hf.bits + 999):
        got = set_target_sizes(port, target)
        want = jtruncate.set_target_sizes(hf, target)
        assert (got.bits, got.uncompressed_size) == (want.bits,
                                                     want.uncompressed_size)
        np.testing.assert_array_equal(got.payload, want.payload)
        np.testing.assert_array_equal(got.tree, want.tree)
        out = get_decoder("simple", device="cpu")(got)
        np.testing.assert_array_equal(out, raw[:got.uncompressed_size])


def test_graph_rows_match_jax():
    from huffmandecoderongpus_tpu.models import get_decoder as jget

    raw, hf = make("md3")
    got = list(graph_rows(get_decoder("bigtable_simple", device="cpu"),
                          data.TestData("md3", _port_hf(hf), raw), 9000,
                          repeats=1))
    want = list(jtruncate.graph_rows(jget("bigtable_simple"),
                                     jdata.TestData("md3", hf, raw), 9000,
                                     repeats=1))
    assert [s for s, _ in got] == [s for s, _ in want] != []
    assert [(r.uncompressed_bytes, r.compressed_bytes) for _, r in got] == \
        [(r.uncompressed_bytes, r.compressed_bytes) for _, r in want]
    out = io.StringIO()
    truncate.graphtest(get_decoder("simple", device="cpu"),
                       data.TestData("md3", _port_hf(hf), raw), 20000,
                       repeats=0, out=out)
    assert [line.split()[0] for line in out.getvalue().splitlines()] == \
        [str(s) for s in range(20000, hf.bits, 20000)]


# ---- data -----------------------------------------------------------------

def test_load_test_data_matches_jax(corpora):
    assert data.available_corpora() == jdata.available_corpora() == \
        data.MAINRUN_NAMES
    assert data.MAINRUN_NAMES == jdata.MAINRUN_NAMES
    assert data.CORPUS_NAMES == jdata.CORPUS_NAMES
    for name, raw in corpus_bytes().items():
        assert data.has_raw(name) and data.huff_path(name) == \
            jdata.huff_path(name)
        got, want = data.load_test_data(name), jdata.load_test_data(name)
        assert got.info() == want.info()
        np.testing.assert_array_equal(got.ucd, raw)
        np.testing.assert_array_equal(got.ucd, want.ucd)
        np.testing.assert_array_equal(got.cd.payload, want.cd.payload)
        np.testing.assert_array_equal(got.cd.tree, want.cd.tree)


def test_ground_truth_decoded_and_cached(tmp_path, monkeypatch):
    from huffmandecoderongpus_tpu_torch import native

    raw, hf = make("text")
    (tmp_path / "files").mkdir()
    huffio.write_huff(tmp_path / "files" / "E.coli.huff", _port_hf(hf))
    monkeypatch.setenv("HUFF_FILES_DIR", str(tmp_path / "files"))
    monkeypatch.setenv("HUFF_CACHE_DIR", str(tmp_path / "cache"))
    assert data.available_corpora() == ["E.coli"]
    assert not data.has_raw("E.coli")
    np.testing.assert_array_equal(data.load_ground_truth("E.coli"), raw)
    np.testing.assert_array_equal(
        np.fromfile(tmp_path / "cache" / "E.coli.raw", dtype=np.uint8), raw)

    def refuse(hf):
        raise AssertionError("decoded again")

    monkeypatch.setattr(native, "simple_decode", refuse)
    np.testing.assert_array_equal(data.load_test_data("E.coli").ucd, raw)
    # a cache of another size is decoded again
    raw[:10].tofile(tmp_path / "cache" / "E.coli.raw")
    with pytest.raises(AssertionError, match="decoded again"):
        data.load_ground_truth("E.coli")


def test_no_corpus_directory(tmp_path, monkeypatch):
    monkeypatch.setenv("HUFF_FILES_DIR", str(tmp_path / "absent"))
    assert data.available_corpora() == []
    with pytest.raises(FileNotFoundError):
        data.load_test_data("hello")
    monkeypatch.delenv("HUFF_FILES_DIR")
    monkeypatch.delenv("HUFF_CACHE_DIR", raising=False)
    assert data.files_dir() == data.REPO_ROOT / "files"
    assert data.cache_dir() == data.REPO_ROOT / ".cache"


# ---- the command line -----------------------------------------------------

def _out(capsys, fn, *args):
    """What ``fn(*args)`` prints on stdout; a SystemExit(0), the JAX
    ``verify``'s way to end, counts as a return."""
    capsys.readouterr()
    try:
        fn(*args)
    except SystemExit as e:
        if e.code not in (0, None):
            raise
    return capsys.readouterr().out


@pytest.mark.parametrize("argv", [
    ["info"], ["info", "news", "kjv.txt"], ["info", "{dir}/book2.huff"],
    ["bits"], ["bits", "paper1", "100"], ["bits", "{dir}/kjv.txt.huff", "7"],
    ["corpora"], ["verify", "{dir}/news.huff", "{dir}/news"]])
def test_commands_print_what_jax_prints(corpora, capsys, argv):
    argv = [a.format(dir=corpora) for a in argv]
    got = _out(capsys, cli.main, argv + ["--device", "cpu"])
    assert got == _out(capsys, jcli.main, argv) != ""


def test_verify_fails_on_a_wrong_file(corpora, capsys):
    with pytest.raises(SystemExit) as e:
        cli.main(["verify", f"{corpora}/news.huff", f"{corpora}/paper1",
                  "--device", "cpu", "--decoder", "simple"])
    assert e.value.code == 1
    assert "FAILED" in capsys.readouterr().out


def test_default_suite_matches_jax(corpora, capsys):
    got = _out(capsys, lambda: cli.run_suite("default", 1, device="cpu"))
    assert got == _out(capsys, jcli.run_suite, "default", 1) != ""


@pytest.mark.parametrize("suite", ["bts", "testall"])
def test_host_suites_match_jax(corpora, capsys, suite):
    got = _columns(_out(capsys, cli.main,
                        [suite, "--device", "cpu", "--repeats", "0"]))
    want = _columns(_out(capsys, jcli.main, [suite, "--repeats", "0"]))
    assert got == want
    assert len(got) == {"bts": 5, "testall": 5 * 32}[suite]


#: the rows each device suite prints (decoder, corpus), on --device cpu
DEVICE_ROWS = {
    "hello": [(d, "hello") for d in ("simple", "spec_xla", "lane_dfa_pallas",
                                     "lane_wide", "pes_numpy")],
    "kjv": [(d, "kjv.txt") for d in ("spec_xla", "lane_dfa_pallas",
                                     "lane_wide")],
    "opt": [(d, "kjv.txt") for d in ("spec_xla", "lane_wide",
                                     "lane_dfa_pallas")],
    "bigtable": [(d, c) for d in ("spec_xla", "lane_dfa_pallas", "lane_wide",
                                  "pes_numpy", "simple", "bigtable_multisym",
                                  "bigtable_simple")
                 for c in cli.BIGTABLE_NAMES],
}


@pytest.mark.parametrize("suite", sorted(DEVICE_ROWS))
def test_device_suites_on_cpu(corpora, capsys, suite):
    out = _out(capsys, cli.main, [suite, "--device", "cpu", "--repeats", "0"])
    assert _columns(out) == DEVICE_ROWS[suite]


def test_graph_and_batch_suites_on_cpu(corpora, capsys):
    out = _out(capsys, cli.main, ["quickgraph2", "--device", "cpu",
                                  "--repeats", "0"])
    bits = huffio.read_huff(corpora / "paper1.huff").bits
    assert [int(line.split()[0]) for line in out.splitlines()] == \
        list(range(10000, bits, 10000)) * 3 != []
    out = _out(capsys, cli.main, ["batch", "--device", "cpu", "--repeats",
                                  "0"])
    assert [line.split()[:3] for line in out.splitlines()[:3]] == [
        ["batch", n + ":", "OK"] for n in ("paper1", "news", "book2")]
    assert out.splitlines()[3].startswith("batched 3 streams:")


def test_suites_raise_without_the_card(corpora, capsys):
    import torch

    if torch.cuda.is_available():
        pytest.skip("CUDA is available: the check is for hosts without it")
    for suite in ("bts", "testall", "hello"):
        with pytest.raises(RuntimeError, match="cuda"):
            cli.run_suite(suite, 1, device="cuda")
    with pytest.raises(SystemExit, match="unknown test"):
        cli.run_suite("nosuch", 1, device="cpu")


def test_a_wrong_raw_file_stops_the_suite(corpus_dir, tmp_path, monkeypatch,
                                          capsys):
    d = tmp_path / "files"
    d.mkdir()
    for f in corpus_dir.iterdir():
        (d / f.name).write_bytes(f.read_bytes())
    wrong = np.fromfile(d / "news", dtype=np.uint8)
    wrong[100] ^= 1
    wrong.tofile(d / "news")
    monkeypatch.setenv("HUFF_FILES_DIR", str(d))
    with pytest.raises(DecodeMismatch, match="bigtable_simple on news"):
        cli.run_suite("bts", 1, device="cpu")
    assert len(_columns(capsys.readouterr().out)) == 2  # paper1, hello


def test_decoders_command(capsys):
    out = _out(capsys, cli.main, ["decoders", "--device", "cpu"])
    names = [line.split()[0] for line in out.splitlines()]
    assert len(names) == 20 and names == sorted(names)
    assert set(jax_decoders()) == set(names)
    assert "jumptable  backend=host-native" in out


def test_decode_verify_prints_the_evalandshow_row(tmp_path, capsys):
    raw, hf = make("md3")
    huffio.write_huff(tmp_path / "x.huff", _port_hf(hf))
    raw.tofile(tmp_path / "x.bin")
    path = re.escape(str(tmp_path / "x.huff"))
    for decoder, row in (("lane_wide", r" +[\d.]+ ms"),
                         ("jumptable", r" +8 [\d.]+")):
        out = _out(capsys, cli.main,
                   ["decode", str(tmp_path / "x.huff"), "--device", "cpu",
                    "--decoder", decoder, "--verify", str(tmp_path / "x.bin"),
                    "--repeats", "1"])
        assert re.fullmatch(rf" *{decoder} {path}{row}   +[\d.]+ GB/s\n",
                            out), out
    raw[5] ^= 1
    raw.tofile(tmp_path / "x.bin")
    with pytest.raises(DecodeMismatch):
        cli.main(["decode", str(tmp_path / "x.huff"), "--device", "cpu",
                  "--verify", str(tmp_path / "x.bin"), "--repeats", "1"])


def test_debug_dump(capsys, monkeypatch):
    import torch

    monkeypatch.delenv("HUFF_DEBUG", raising=False)
    debug.set_debug(None)
    debug.dump("x", np.arange(5))
    assert capsys.readouterr().err == ""
    monkeypatch.setenv("HUFF_DEBUG", "1")
    assert debug.debug_enabled()
    debug.dump("x", torch.arange(40), limit=4)
    assert capsys.readouterr().err == "[huff-debug] x: [0 1 2 3] ... (40 total)\n"
    debug.set_debug(False)
    assert not debug.debug_enabled()
    debug.set_debug(None)
    monkeypatch.setenv("HUFF_DEBUG", "0")
    assert not debug.debug_enabled()


def test_speculative_stages_dump_under_debug(capsys, monkeypatch):
    from huffmandecoderongpus_tpu_torch.ops.speculative import (
        decode_device_arrays,
        speculative_stages,
    )

    raw, hf = MD3
    plan, arrays = decode_device_arrays(_port_hf(hf), device="cpu")
    kw = dict(bits=plan.bits, size=plan.size, height=plan.height,
              levels=plan.levels)
    monkeypatch.delenv("HUFF_DEBUG", raising=False)
    debug.set_debug(None)
    speculative_stages(*arrays, **kw)
    assert capsys.readouterr().err == ""
    monkeypatch.setenv("HUFF_DEBUG", "1")
    st = speculative_stages(*arrays, **kw)
    err = [line for line in capsys.readouterr().err.splitlines()
           if line.startswith("[huff-debug]")]
    assert [line.split(":")[0] for line in err] == [
        "[huff-debug] " + n for n in
        ["S1 sym"] + [f"S2 level {2 * i}" for i in range(len(st["kept"]))]
        + ["S3 result", "S3 found"]]
    assert len(st["kept"]) > 1
    assert err[-2].startswith("[huff-debug] S3 result: "
                              + np.array2string(raw[:32],
                                                max_line_width=120))
    assert err[-1] == f"[huff-debug] S3 found: [{plan.size}]"


def test_package_root_exports(tmp_path):
    import huffmandecoderongpus_tpu_torch as port

    raw = make("text")[0]
    hf = port.encode_bytes(raw)
    port.write_huff(tmp_path / "x.huff", hf)
    back = port.read_huff(tmp_path / "x.huff")
    assert isinstance(back, port.HuffFile)
    np.testing.assert_array_equal(port.get_decoder("simple", device="cpu")(
        back), raw)
    want = jencoder.encode_bytes(raw)
    np.testing.assert_array_equal(hf.payload, want.payload)
    with pytest.raises(TypeError):
        port.get_decoder("simple")  # the device is never picked implicitly

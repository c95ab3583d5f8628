"""The port's timing and stage profiler against the JAX package's, and the
``prof`` and ``probe`` commands on the CPU.

``harness/timing.py``'s ``Timer``, ``report_resolution`` and ``gb_per_s``
and ``harness/profiling.py``'s ``format_report`` are copies of the JAX
package's and must behave the same; ``profile_lanedfa`` and
``profile_widescan`` must report the JAX versions' stages, in their order
(the JAX ``profile_lanedfa`` runs here on the same small stream; the JAX
``profile_widescan`` runs its Pallas kernels, so its keys are read from its
report's code below).  On the CPU every stage runs the plain versions under
the host clock: the tests check keys and signs, never a time.
"""

import math

import numpy as np
import pytest
import torch

from huffmandecoderongpus_tpu.harness import profiling as jprof
from huffmandecoderongpus_tpu.harness import timing as jtiming
from huffmandecoderongpus_tpu_torch import huffio, probes
from huffmandecoderongpus_tpu_torch.harness import cli, profiling, timing
from torch_streams import make, text_like

#: the JAX profile_widescan's report keys, in order
#: (huffmandecoderongpus_tpu/harness/profiling.py:252-256)
WIDESCAN_KEYS = ["k1_scan_discovery", "k2_compose", "k3_fix_splice",
                 "k4_compact", "total"]


def _check(report, keys):
    assert list(report) == keys
    assert all(isinstance(v, float) and math.isfinite(v) and v >= 0
               for v in report.values()), report


def test_profile_lanedfa_keys_match_jax():
    _raw, hf = make("text")
    want = jprof.profile_lanedfa(hf, reps=1)
    got = profiling.profile_lanedfa(hf, reps=1, device="cpu")
    _check(got, list(want))
    assert got["total"] == pytest.approx(sum(
        v for k, v in got.items() if k != "total"))


@pytest.mark.parametrize("lanes", [None, 512])
def test_profile_widescan_keys(lanes):
    _raw, hf = make("text")
    _check(profiling.profile_widescan(hf, lanes=lanes, reps=1,
                                      device="cpu"), WIDESCAN_KEYS)


def test_profile_widescan_refuses_like_the_program():
    raw = text_like(np.random.default_rng(0), 300)
    with pytest.raises(profiling.ws.EnvelopeError):
        profiling.profile_widescan(huffio.encode_bytes(raw), device="cpu")


@pytest.mark.parametrize("report", [
    {"k1_scan_discovery": 0.000544, "k2_compose": 1.2e-4, "total": 0.001},
    {"host_bit_matrix": 0.15, "candidate_scan": 0.002, "compose": 0.0,
     "main_scan": 1e-6, "host_compaction": 0.0123456, "total": 0.2},
])
def test_format_report_matches_jax(report):
    assert profiling.format_report(report) == jprof.format_report(report)


@pytest.mark.parametrize("nbytes,seconds", [(5_504_597, 0.001), (1, 1e-9),
                                            (10, 0.0), (0, 2.5), (7, -1.0)])
def test_gb_per_s_matches_jax(nbytes, seconds):
    assert timing.gb_per_s(nbytes, seconds) == jtiming.gb_per_s(nbytes,
                                                                seconds)


def test_timer_and_resolution_match_jax():
    assert timing.report_resolution() == jtiming.report_resolution()
    ours, theirs = timing.Timer(), jtiming.Timer()
    assert ours.__slots__ == theirs.__slots__
    for t in (ours, theirs):
        t.start()
        t.stop()
        assert t.ns >= 0 and t.ms == t.ns / 1e6 and t.seconds == t.ns / 1e9


def test_launch_ms_on_the_cpu():
    calls = []
    ms = timing.launch_ms(lambda: calls.append(1), device="cpu", launches=4,
                          trials=3, warmup=2)
    assert ms >= 0 and len(calls) == 2 + 3 * 4
    assert len(timing.event_ms(lambda: None, 5, device="cpu")) == 5


@pytest.fixture(scope="module")
def small_huff(tmp_path_factory):
    raw = text_like(np.random.default_rng(5), 20000)
    path = tmp_path_factory.mktemp("prof") / "x.huff"
    huffio.write_huff(str(path), huffio.encode_bytes(raw))
    return str(path)


@pytest.mark.parametrize("which,keys", [
    ("widescan", WIDESCAN_KEYS),
    ("lanedfa", ["host_bit_matrix", "candidate_scan", "compose",
                 "main_scan", "host_compaction", "total"])])
def test_prof_command_cpu(small_huff, which, keys, capsys):
    cli.main(["prof", small_huff, which, "--device", "cpu"])
    out = capsys.readouterr().out.splitlines()
    assert out[0] == f"{which} stage breakdown on {small_huff}:"
    assert [line.split()[0] for line in out[1:]] == keys
    assert all(line.endswith(" ms") for line in out[1:])


def test_prof_returns_report(small_huff):
    _check(cli.prof(small_huff, "widescan", 512, "cpu"), WIDESCAN_KEYS)


def test_trace_writes_a_chrome_trace(tmp_path):
    x = torch.arange(1000)
    with profiling.trace(str(tmp_path / "tr")):
        (x * 2).sum()
    assert (tmp_path / "tr" / "trace.json").stat().st_size > 0


def test_prof_refuses_speculative(small_huff):
    with pytest.raises(SystemExit):
        cli.main(["prof", small_huff, "speculative", "--device", "cpu"])


#: the first word of a line each probe prints, in order
PROBE_LINES = {
    "dispatch": ["rep0", "rep0", "rep1", "rep1", "rep2", "rep2", "on",
                 "triv", "med", "card:"],
    "k1fixed": ["trivial", "5", "gridded", "trivial", "gridded", "(f)",
                "(f)", "(a)", "(a)", "card:"],
    "k4": ["(a)", "K4[transpose]:", "K4[prefix", "K4[full", "K4[transpose]",
           "K4[prefix]", "card:"],
    "gather": ["axis1"] * 5 + ["axis0"] * 2 + ["card:"],
    "vpu": ["i16", "i16", "roll", "roll", "roll", "floor", "arith", "arith",
            "arith", "arith", "gather", "gather", "card:"],
    "vpu2": ["floor"] + ["arith", "arith"] * 3 + ["gather", "gather"] * 6
            + ["card:"],
}


@pytest.mark.parametrize("name", sorted(probes.PROBES))
def test_probe_command_cpu(name, capsys):
    cli.main(["probe", name, "--device", "cpu"])
    out = capsys.readouterr().out.splitlines()
    assert [line.split()[0] for line in out] == PROBE_LINES[name], out
    assert "WRONG" not in "\n".join(out)
    assert out[-1] == "card: cpu (plain versions, host clock)"


def test_probe_unknown_raises():
    with pytest.raises(ValueError, match="unknown probe"):
        probes.run("nope", "cpu")


def test_probe_cuda_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the check is for hosts without one")
    with pytest.raises(RuntimeError, match="cuda"):
        probes.run("dispatch", "cuda")

"""The readers of the program's own spans and counters
(``program_trace`` and the metrics that read it) on a canned trace."""

import json

import pytest

from codecbench import devtrace, harness, program_trace
from codecbench.spec import Spec
from codecbench.tests.conftest import ROOT

#: the new readers, each with the span it reads (None: a counter)
READERS = {"tables_ms": "huff.stage.tables", "words_ms": "huff.stage.words",
           "hist_ms": "huff.stage.hist", "lanes_ms": "huff.stage.lanes",
           "upload_ms": "huff.upload", "download_ms": "huff.download",
           "wait_ms": "huff.wait", "launch_ms": "huff.launch",
           "copy_gbps": None, "launches": None}


def ev(cat, name, ts, dur):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}


def canned():
    """Two requests (0-100 and 150-250 us).  Each span the program opens
    comes twice: as a host ``user_annotation`` and as its device
    projection (``gpu_user_annotation``), which the readers skip.  In each
    request every span holds 10 us, but ``huff.wait``, which nests a
    second call inside the first (held once) and runs 5 us past the
    window's end in the second request.  Copies: 20 us HtoD, 30 us DtoH,
    and a device-to-device one that is not counted."""
    events = [ev("user_annotation", devtrace.REQUEST_SPAN, 0, 100),
              ev("user_annotation", devtrace.REQUEST_SPAN, 150, 100)]
    for t0 in (0, 150):
        for k, span in enumerate(s for s in READERS.values() if s):
            for cat in ("user_annotation", "gpu_user_annotation"):
                events.append(ev(cat, span, t0 + 10 * k, 10))
    events += [ev("user_annotation", "huff.wait", 62, 4),
               ev("user_annotation", "huff.wait", 245, 10),
               ev("gpu_memcpy", "Memcpy HtoD (Pageable -> Device)", 5, 20),
               ev("gpu_memcpy", "Memcpy DtoH (Device -> Pageable)", 160, 30),
               ev("gpu_memcpy", "Memcpy DtoD (Device -> Device)", 200, 40)]
    return devtrace.from_chrome(json.loads(json.dumps(
        {"traceEvents": events})))


def run_of(trace):
    reqs = [dict(t0=0.0, t1=0.1, ok=True, in_bytes=1, out_bytes=1,
                 moved_bytes=2),
            dict(t0=0.15, t1=0.25, ok=True, in_bytes=1, out_bytes=1,
                 moved_bytes=2)]
    return harness.Run(setup_s=1.0, window_s=0.25, requests=reqs, spans={},
                       trace=trace)


@pytest.fixture
def counts(monkeypatch):
    """The program's traced counters, canned."""
    table = {"launch.k1_scan2": 2, "launch.k4_compact": 2,
             "launch.oneshot": 1, "bytes.upload": 300_000,
             "bytes.download": 200_000, "encode.retry": 1}
    monkeypatch.setattr(program_trace, "traced_counts",
                        lambda run: None if run.trace is None else table)
    return table


@pytest.mark.parametrize("name", [n for n, s in READERS.items() if s])
def test_span_readers_sum_host_annotations_alone(name):
    got = Spec().reader(name)(run_of(canned()))
    # 10 us a request; the wait: 10 + 10 - 5 (clipped) in the second
    want = 10e-3 if name != "wait_ms" else (10 + 15) / 2 * 1e-3
    assert got == pytest.approx(want)


def test_counter_readers(counts):
    run = run_of(canned())
    assert Spec().reader("launches")(run) == pytest.approx(5 / 2)
    # 500 kB over 50 us of HtoD and DtoH (not the DtoD copy)
    assert Spec().reader("copy_gbps")(run) == pytest.approx(
        500_000 / 50e-6 / 1e9)


@pytest.mark.parametrize("name", sorted(READERS))
def test_readers_read_nothing_without_a_trace(name, counts):
    assert Spec().reader(name)(run_of(None)) is None


@pytest.mark.parametrize("name", sorted(READERS))
def test_readers_read_nothing_from_a_program_without_them(name, monkeypatch):
    # a trace with the window and the copies, but no span of the program,
    # and a program that keeps no counters
    monkeypatch.setattr(program_trace, "traced_counts", lambda run: None)
    trace = devtrace.from_chrome({"traceEvents": [
        ev("user_annotation", devtrace.REQUEST_SPAN, 0, 100),
        ev("gpu_memcpy", "Memcpy HtoD (Pageable -> Device)", 5, 20)]})
    assert Spec().reader(name)(run_of(trace)) is None


def test_every_new_entry_has_its_reader():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    new = [m for m in bench["per_layer"]
           if m["name"].split(".")[0] in READERS]
    assert len(new) == 24
    for m in new:
        base = m["name"].split(".")[0]
        assert (ROOT / "codecbench" / "metrics" / f"{base}.py").exists()
        assert callable(Spec().reader(m["name"]))
        assert m["source"] == ("program_counter" if READERS[base] is None
                               else "program_span")


def test_the_counters_come_from_the_program():
    from huffmandecoderongpus_tpu_torch.utils import trace

    run = run_of(canned())
    assert program_trace.traced_counts(run) == trace.traced_counts()
    assert program_trace.traced_counts(run_of(None)) is None


#: the span metrics a traced run of each cell reports on the CPU (the
#: counters count CUDA launches and copies alone)
SPANS_OF = {"enwik8-decode": ("tables_ms", "words_ms", "upload_ms",
                              "download_ms", "wait_ms", "launch_ms"),
            "enwik8-pages": ("tables_ms", "words_ms", "upload_ms",
                             "download_ms", "wait_ms", "launch_ms"),
            "enwik8-encode": ("hist_ms", "lanes_ms", "upload_ms",
                              "download_ms", "wait_ms", "launch_ms")}


@pytest.mark.parametrize("cell", sorted(SPANS_OF))
def test_a_traced_run_reads_the_programs_spans(tiny_root, cell):
    import time

    spec = Spec(tiny_root)
    res, _lines = harness.run_cell(spec, cell, 2**31 + 26, 0.0, True,
                                   device="cpu", t_start=time.perf_counter())
    assert res["correct"]
    fam = spec.metrics(cell, "per_layer")[0]["name"].split(".")[1]
    got = res["metrics"]
    for base in SPANS_OF[cell]:
        assert got[f"{base}.{fam}"]["value"] > 0, base
    staged = sum(got[f"{b}.{fam}"]["value"] for b in SPANS_OF[cell][:3])
    assert staged <= got[f"stage_ms.{fam}"]["value"] * 1.05

"""The trace reader and every metric reader on a canned profiler trace and
a canned run."""

import json

import pytest

from codecbench import devtrace, harness, roofline
from codecbench.spec import Spec
from codecbench.tests.conftest import ROOT


def ev(cat, name, ts, dur):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}


#: two requests of 100 us each (0-100, 150-250); device work at 10-30
#: (copy), 25-45 (kernel, overlapping the copy), 60-70 (kernel), 160-200
#: (copy) and 240-260 (kernel, half outside the window); the host is in
#: the stage span 0-50 and 150-180
CANNED = {"traceEvents": [
    {"ph": "M", "name": "process_name"},
    ev("user_annotation", devtrace.REQUEST_SPAN, 0, 100),
    ev("user_annotation", devtrace.REQUEST_SPAN, 150, 100),
    ev("user_annotation", "codecbench.stage", 0, 50),
    ev("user_annotation", "codecbench.stage", 150, 30),
    ev("cpu_op", "aten::copy_", 5, 30),
    ev("gpu_memcpy", "Memcpy HtoD (Pageable -> Device)", 10, 20),
    ev("kernel", "k1_scan2_kernel", 25, 20),
    ev("kernel", "k4_compact_kernel", 60, 10),
    ev("gpu_memcpy", "Memcpy DtoH (Device -> Pageable)", 160, 40),
    ev("kernel", "k1_scan2_kernel", 240, 20),
    ev("gpu_user_annotation", "codecbench.request", 0, 100),
]}


@pytest.fixture
def trace():
    return devtrace.from_chrome(json.loads(json.dumps(CANNED)))


def test_trace_window_busy_and_sums(trace):
    assert trace.window() == (0.0, 250.0)
    assert devtrace.window_s(trace) == pytest.approx(250e-6)
    # union: 10-45, 60-70, 160-200, 240-250
    assert devtrace.busy_s(trace) == pytest.approx(95e-6)
    assert devtrace.summed_s(trace, devtrace.KERNEL) == pytest.approx(40e-6)
    assert devtrace.summed_s(trace, devtrace.COPY) == pytest.approx(60e-6)


def test_breakdown(trace):
    ops = devtrace.top_ops(trace)
    assert ops[0] == ["Memcpy DtoH (Device -> Pageable)", pytest.approx(40e-6)]
    assert ["k1_scan2_kernel", pytest.approx(30e-6)] in ops
    gaps = devtrace.idle_gaps(trace)
    # 70-160 is the longest gap, between the requests at its midpoint; the
    # others are named by the spans open at theirs, outermost first
    assert gaps == [
        ["(no host span)", pytest.approx(90e-6)],
        [devtrace.REQUEST_SPAN, pytest.approx(40e-6)],
        [devtrace.REQUEST_SPAN, pytest.approx(15e-6)],
        [f"{devtrace.REQUEST_SPAN} > codecbench.stage > aten::copy_",
         pytest.approx(10e-6)]]


def canned_run(trace):
    reqs = [dict(t0=0.0, t1=0.1, ok=True, in_bytes=100, out_bytes=300,
                 moved_bytes=400),
            dict(t0=0.15, t1=0.25, ok=True, in_bytes=100, out_bytes=300,
                 moved_bytes=400),
            dict(t0=0.25, t1=0.5, ok=False, in_bytes=100, out_bytes=300,
                 moved_bytes=400)]
    return harness.Run(setup_s=12.5, window_s=0.5, requests=reqs,
                       spans={"stage": [0.05, 0.03]}, trace=trace)


def test_every_reader(trace):
    spec = Spec()
    run = canned_run(trace)
    got = {m["name"]: spec.reader(m["name"])(run)
           for kind in ("end_to_end", "per_layer") for m in spec.bench[kind]}
    assert got["setup_s"] == 12.5
    # failed requests bring no bytes
    assert got["decode_gbps"] == pytest.approx(600 / 0.5 / 1e9)
    assert got["paged_decode_gbps"] == got["decode_gbps"]
    assert got["encode_gbps"] == pytest.approx(200 / 0.5 / 1e9)
    assert got["request_p95_ms.decode"] == pytest.approx(100.0)
    assert got["stage_ms.encode"] == pytest.approx(40.0)
    assert got["copy_ms.paged"] == pytest.approx(60e-3 / 2)
    assert got["kernels_roofline.decode"] == pytest.approx(
        100 * roofline.bound_s(800) / 40e-6)
    assert got["device_idle_pct.decode"] == pytest.approx(100 * (1 - 95 / 250))


def test_trace_readers_read_nothing_without_a_trace():
    spec = Spec()
    run = canned_run(None)
    run.spans = {}
    for m in spec.bench["per_layer"]:
        if m["source"] in ("device_trace", "program_span"):
            assert spec.reader(m["name"])(run) is None, m["name"]


def test_trace_round_trips_through_a_file(tmp_path, trace):
    class Prof:  # what from_profiler needs of a torch.profiler.profile
        def export_chrome_trace(self, path):
            with open(path, "w") as f:
                json.dump(CANNED, f)

    assert devtrace.from_profiler(Prof()).events == trace.events


def test_roofline_counts():
    assert roofline.decode_bytes(64, 100) == 164
    assert roofline.encode_bytes(100, 64) == 164
    assert roofline.bound_s(3.35e12) == pytest.approx(1.0)
    assert roofline.share_pct(3.35e9, 0.002) == pytest.approx(50.0)
    assert roofline.share_pct(1, 0.0) is None


def test_every_metric_has_a_reader():
    spec = Spec()
    names = [m["name"] for k in ("end_to_end", "per_layer")
             for m in spec.bench[k]]
    assert all(callable(spec.reader(n)) for n in names)
    assert (ROOT / "codecbench" / "metrics" / "stage_ms.py").exists()

"""Whole runs of the harness on the CPU, on the small copy of the
benchmark: every cell is correct through the port's plain versions; each
fault of the timed path, and each cell's control, makes ``correct``
false; a new cell, configuration, traffic mix and metric come in as new
files and entries alone; a run that loaded JAX prints no result."""

import json
import shutil
import sys
import time
import types

import numpy as np
import pytest

from codecbench import controls, harness
from codecbench.spec import Spec

CELLS = ("enwik8-decode", "mozilla-decode", "enwik8-encode", "enwik8-pages")


def run(root, cell, trace=False, request=None, seconds=0.0, seed=2**31 + 9,
        min_requests=1):
    return harness.run_cell(Spec(root), cell, seed, seconds, trace,
                            device="cpu", t_start=time.perf_counter(),
                            request=request, min_requests=min_requests)[0]


@pytest.mark.parametrize("cell", CELLS)
def test_cell_is_correct(tiny_root, cell):
    res = run(tiny_root, cell)
    assert res["correct"] and res["failed"] == 0 and res["attempted"] >= 1
    want = {m["name"] for m in Spec(tiny_root).metrics(cell, "end_to_end")}
    assert set(res["metrics"]) == want
    assert list(res)[-1] == "checks"
    assert all(c["value"] == 0 for c in res["checks"].values())


def test_traced_run_reports_its_layers(tiny_root):
    res = run(tiny_root, "enwik8-decode", trace=True, seconds=1.5)
    assert res["correct"]
    assert "stage_ms.decode" in res["metrics"]
    assert res["metrics"]["stage_ms.decode"]["value"] > 0
    assert {"busy_s", "window_s"} <= set(res["device"])
    assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}


def flip_one(out):
    out = np.array(out, copy=True)
    out[len(out) // 2] ^= 0x40
    return out


def altered(state, i):
    """A byte altered where the answer is produced."""
    ans = state.request(i)
    if isinstance(ans, list):
        return [flip_one(ans[0])] + ans[1:]
    if hasattr(ans, "payload"):
        ans.payload = flip_one(ans.payload)
        return ans
    return flip_one(ans)


def half_left_out(state, i):
    """Half of the batch (pages) or of the answer's bytes left out."""
    ans = state.request(i)
    if isinstance(ans, list):
        return ans[:len(ans) // 2]
    if hasattr(ans, "payload"):
        ans.payload = ans.payload[:ans.payload.size // 2]
        return ans
    return ans[:len(ans) // 2]


def unchanged(state, i):
    """The step hands back its input unchanged: the compressed payload for
    a decode, the raw bytes as the payload for the encode."""
    if isinstance(state.current, list):
        return [hf.payload for hf in state.current]
    if hasattr(state.current, "payload"):
        return state.current.payload
    ans = state.request(i)
    ans.payload = state.data
    return ans


@pytest.mark.parametrize("fault", [altered, half_left_out, unchanged],
                         ids=lambda f: f.__name__)
@pytest.mark.parametrize("cell", ("enwik8-decode", "enwik8-encode",
                                  "enwik8-pages"))
def test_fault_is_caught(tiny_root, cell, fault):
    res = run(tiny_root, cell, request=fault)
    assert not res["correct"]
    assert res["failed"] >= 1
    assert any(c["value"] > c["limit"] for c in res["checks"].values())


@pytest.mark.parametrize("cell", CELLS)
def test_control_is_caught(tiny_root, cell):
    entry = Spec(tiny_root).traffic(
        Spec(tiny_root).workload(cell)["traffic"])["entry"]
    res = run(tiny_root, cell, request=controls.control(entry))
    assert not res["correct"]
    assert res["checks"]["bad_bytes"]["value"] > 0


def test_a_new_cell_is_new_files(tiny_root, tmp_path):
    """A configuration, a traffic mix, a metric reader and a cell added as
    files and BENCHMARK.json entries; no file of the harness changes."""
    root = tmp_path / "root"
    shutil.copytree(tiny_root, root)
    bench_dir = root / "codecbench"
    before = {p: p.read_bytes() for p in bench_dir.rglob("*.py")}
    cfg = json.loads((root / "codecbench/configs/enwik8.json").read_text())
    cfg.update(name="dummy", bytes=120_000, symbols=60, tail_symbols=10)
    (bench_dir / "configs/dummy.json").write_text(json.dumps(cfg))
    (bench_dir / "traffic/dummy-whole.json").write_text(
        json.dumps({"entry": "lane_wide", "clients": 1}))
    (bench_dir / "metrics/dummy_requests.py").write_text(
        "def read(run):\n    return len(run.completed)\n")
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "dummy", "source": "a test",
                             "file": "codecbench/configs/dummy.json",
                             "reduced": [], "why": "a test"})
    bench["workloads"].append({"name": "dummy-cell", "config": "dummy",
                               "traffic": "dummy-whole", "chips": 1,
                               "why": "a test"})
    for m in bench["end_to_end"]:
        if m["name"] == "decode_gbps":
            m["workloads"].append("dummy-cell")
    bench["per_layer"].append({"name": "dummy_requests", "unit": "count",
                               "better": "higher", "source": "host_clock",
                               "layer": "entry", "moves": "decode_gbps",
                               "workloads": ["dummy-cell"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))

    res = run(root, "dummy-cell")
    assert res["correct"]
    assert set(res["metrics"]) == {"decode_gbps", "setup_s"}
    traced = run(root, "dummy-cell", trace=True)
    assert traced["metrics"]["dummy_requests"]["value"] == traced["attempted"]
    assert {p: p.read_bytes() for p in before} == before


def stale_cache():
    """A cache keyed on the input: every request answered with the first
    request's answer."""
    kept = []

    def stale(state, i):
        if not kept:
            kept.append(state.request(i))
        return kept[0]

    return stale


@pytest.mark.parametrize("cell", CELLS)
def test_a_stale_cache_is_caught(tiny_root, cell):
    res = run(tiny_root, cell, request=stale_cache(), min_requests=3)
    assert res["attempted"] == 3
    assert not res["correct"]
    assert res["failed"] == res["attempted"] - 1
    assert res["checks"]["glanced_bad_bytes"]["value"] > 0


@pytest.mark.parametrize("cell", CELLS)
def test_every_request_is_a_new_input(tiny_root, cell):
    """No two requests hand the program the same tree and payload."""
    seen = []

    def record(state, i):
        cur = state.current if isinstance(state.current, list) else [
            state.current]
        seen.append(b"".join(
            np.asarray(c.tree if hasattr(c, "tree") else state.tree).tobytes()
            + np.asarray(getattr(c, "payload", c)).tobytes() for c in cur))
        return state.request(i)

    res = run(tiny_root, cell, request=record, min_requests=3)
    assert res["correct"] and len(seen) == 3
    assert len(set(seen)) == len(seen)


def test_a_run_that_loaded_jax_prints_no_result(tiny_root, tmp_path,
                                                monkeypatch, capsys):
    """A metric reader that imports JAX after the window: the look comes
    last, so the run prints no result line."""
    fake = tmp_path / "fake"
    (fake / "jax").mkdir(parents=True)
    (fake / "jax" / "__init__.py").write_text("")
    monkeypatch.syspath_prepend(str(fake))
    monkeypatch.delitem(sys.modules, "jax", raising=False)
    root = tmp_path / "root"
    shutil.copytree(tiny_root, root)
    (root / "codecbench/metrics/jax_probe.py").write_text(
        "def read(run):\n    import jax  # noqa: F401\n    return 1.0\n")
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["per_layer"].append({"name": "jax_probe", "unit": "count",
                               "better": "lower", "source": "host_clock",
                               "layer": "entry", "moves": "encode_gbps",
                               "workloads": ["enwik8-encode"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    try:
        result, lines = harness.run_cell(
            Spec(root), "enwik8-encode", 3, 0.0, True, device="cpu",
            t_start=time.perf_counter())
        assert "jax" in sys.modules and result["correct"]
        capsys.readouterr()
        assert harness.emit(result, lines) == 3
    finally:
        sys.modules.pop("jax", None)
    said = capsys.readouterr()
    assert said.out == ""
    assert "forbidden modules loaded: jax" in said.err


def test_emit_prints_the_checks_then_the_result(capsys):
    result = {"correct": True, "checks": {}}
    assert harness.emit(result, ["check bad_bytes 0 limit 0"]) == 0
    said = capsys.readouterr()
    assert said.out.splitlines()[-1] == json.dumps(result)
    assert said.err.splitlines()[-1] == "check bad_bytes 0 limit 0"

"""No module a run loads is JAX or the JAX package, compared by whole
top-level names (the port's own name begins with the JAX package's), and
the benchmark reads nothing of the root ``bench.py``."""

import ast
import subprocess
import sys
import types

import pytest

from codecbench import harness
from codecbench.tests.conftest import BENCH, ROOT


def top_level_imports(path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", sorted(BENCH.rglob("*.py")),
                         ids=lambda p: str(p.relative_to(BENCH)))
def test_sources_import_nothing_forbidden(path):
    assert not top_level_imports(path) & set(harness.FORBIDDEN)
    if path.parent.name != "tests":  # the tests name it to check this
        assert "bench.py" not in path.read_text()


def test_a_run_loads_nothing_forbidden():
    """Import what a run imports, in a fresh interpreter: the harness,
    every entry and metric reader (which load the port) and the controls."""
    code = f"""
import sys
sys.path[0] = {str(ROOT)!r}
from codecbench import harness, controls
from codecbench.spec import Spec
spec = Spec()
for name in ("lane_wide", "widescan_batch", "encode_lanes"):
    spec.entry(name)
for kind in ("end_to_end", "per_layer"):
    for m in spec.bench[kind]:
        spec.reader(m["name"])
import huffmandecoderongpus_tpu_torch
from huffmandecoderongpus_tpu_torch.ops import batch, encode, widescan
print(",".join(harness.forbidden_modules()) or "none")
print("huffmandecoderongpus_tpu_torch" in sys.modules)
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["none", "True"]


def test_names_are_compared_whole(monkeypatch):
    for name in ("huffmandecoderongpus_tpu_torch", "jaxtyping", "flaxen"):
        monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
    assert not set(harness.forbidden_modules()) & {
        "huffmandecoderongpus_tpu_torch", "jaxtyping", "flaxen"}
    monkeypatch.setitem(sys.modules, "huffmandecoderongpus_tpu.ops",
                        types.ModuleType("huffmandecoderongpus_tpu.ops"))
    assert "huffmandecoderongpus_tpu" in harness.forbidden_modules()


def test_run_without_a_card_prints_no_result():
    """Here there is no card: run.py exits 2 and prints nothing on stdout."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    out = subprocess.run(
        [sys.executable, "codecbench/run.py", "--workload", "enwik8-decode",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert out.returncode == 2
    assert out.stdout == ""

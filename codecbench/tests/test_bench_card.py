"""The benchmark on the card at the small copy's sizes: every cell correct,
each control caught, and a checkout without the port refused.  Marked
``cuda``; each test skips inside itself where there is no card.  On the
card: ``python -m pytest -p no:cacheprovider codecbench/tests -m cuda``."""

import shutil
import subprocess
import sys
import time

import pytest

from codecbench import controls, harness
from codecbench.spec import Spec
from codecbench.tests.conftest import ROOT

CELLS = ("enwik8-decode", "mozilla-decode", "enwik8-encode", "enwik8-pages")


def need_card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


def run(root, cell, request=None):
    return harness.run_cell(Spec(root), cell, 2**31 + 21, 0.5, False,
                            device="cuda", t_start=time.perf_counter(),
                            request=request)[0]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_cell_on_card(tiny_root, cell):
    need_card()
    res = run(tiny_root, cell)
    assert res["correct"], res["checks"]
    assert res["device"]["platform"] == "gpu"
    entry = Spec(tiny_root).traffic(
        Spec(tiny_root).workload(cell)["traffic"])["entry"]
    ctl = run(tiny_root, cell, request=controls.control(entry))
    assert not ctl["correct"]
    assert ctl["checks"]["bad_bytes"]["value"] > 0


@pytest.mark.cuda
def test_checkout_without_the_port_is_refused(tmp_path):
    need_card()
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "codecbench", tmp_path / "codecbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run(
        [sys.executable, "codecbench/run.py", "--workload", "enwik8-encode",
         "--seed", "5", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=600, cwd=tmp_path)
    assert out.returncode != 0
    assert '"correct"' not in out.stdout

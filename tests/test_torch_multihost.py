"""The port's two-process block decode on one machine: two gloo processes,
each running two virtual CPU shards of a global mesh of four, must return
the same bytes, equal to the input (tests/torch_multihost_runner.py)."""

import hashlib
import pathlib
import subprocess
import sys

import numpy as np

from huffmandecoderongpus_tpu_torch.probes.streams import text_like

_RUNNER = pathlib.Path(__file__).with_name("torch_multihost_runner.py")
sys.path.insert(0, str(_RUNNER.parent))
import torch_multihost_runner as runner  # noqa: E402

#: seconds each worker may take before the test fails
WORKER_TIMEOUT = 120


def test_two_process_decode(tmp_path):
    init = f"file://{tmp_path / 'store'}"
    procs = [subprocess.Popen(
        [sys.executable, str(_RUNNER), init, "2", str(pid), "2", "cpu"],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for pid in range(2)]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=WORKER_TIMEOUT)
            assert p.returncode == 0, f"worker failed:\n{out}\n{err}"
            outs.append(out)
    finally:
        for p in procs:
            p.kill()
            p.wait()
    raw = text_like(np.random.default_rng(runner.SEED), runner.SIZE)
    want = hashlib.sha256(raw.tobytes()).hexdigest()
    for pid, out in enumerate(outs):
        lines = [ln for ln in out.splitlines()
                 if ln.startswith(("OK:", "MISMATCH:"))]
        assert lines, f"no status from worker {pid}: {out}"
        assert lines[-1] == f"OK:{pid}:{want}", out

"""What a run measures, found by name.

``BENCHMARK.json`` at the root names the cells (a configuration and a
traffic mix each), the metrics and the files of the configurations.  The
rest sits in files of its own under ``codecbench/``:

  traffic/<traffic>.json   the mix: the entry it drives and its parameters
  entries/<entry>.py       the code of an entry: set-up, the timed call,
                           the work a request does and the check
  metrics/<metric>.py      a metric's reader; a name with a dot falls back
                           to the reader of the part before the dot, so
                           ``stage_ms.decode`` reads ``metrics/stage_ms.py``

A new cell, configuration, traffic mix or metric is a new entry in
``BENCHMARK.json`` and new files; nothing here changes.
"""

from __future__ import annotations

import importlib.util
import json
import pathlib

BENCH_DIR = pathlib.Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent


class Spec:
    """The benchmark as ``root/BENCHMARK.json`` and ``root/codecbench/``
    describe it."""

    def __init__(self, root=ROOT):
        self.root = pathlib.Path(root)
        self.dir = self.root / BENCH_DIR.name
        self.bench = json.loads((self.root / "BENCHMARK.json").read_text())

    def workload(self, name: str) -> dict:
        for w in self.bench["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def config(self, name: str) -> dict:
        for c in self.bench["configs"]:
            if c["name"] == name:
                return json.loads((self.root / c["file"]).read_text())
        raise KeyError(f"no config {name!r} in BENCHMARK.json")

    def traffic(self, name: str) -> dict:
        return json.loads((self.dir / "traffic" / f"{name}.json").read_text())

    def entry(self, name: str):
        return _load(self.dir / "entries" / f"{name}.py", f"entry_{name}")

    def metrics(self, cell: str, kind: str) -> list[dict]:
        """The metrics of ``kind`` (``end_to_end`` or ``per_layer``) that
        ``cell`` reports: those that list it, and those that list no
        cells."""
        return [m for m in self.bench[kind]
                if cell in m.get("workloads", (cell,))]

    def reader(self, metric: str):
        """The ``read`` function of a metric's reader."""
        base = self.dir / "metrics"
        path = base / f"{metric}.py"
        if not path.exists():
            path = base / f"{metric.split('.')[0]}.py"
        return _load(path, f"metric_{path.stem}").read


def _load(path: pathlib.Path, tag: str):
    if not path.exists():
        raise FileNotFoundError(f"{path} not found")
    mod_name = "codecbench._found." + tag.replace(".", "_").replace("-", "_")
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod

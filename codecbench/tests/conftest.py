"""A small copy of the benchmark for the CPU tests: the real
``codecbench/`` beside a ``BENCHMARK.json`` whose configurations are cut
to a few hundred KB (pages of 128 KiB, two a request), run through the
port's plain torch versions on the CPU."""

import json
import pathlib
import shutil

import pytest

BENCH = pathlib.Path(__file__).resolve().parent.parent
ROOT = BENCH.parent
#: bytes of each configuration in the small copy
TINY_BYTES = {"enwik8": 3 * 131072 + 1000, "silesia-mozilla": 150_000}
PAGE = 131072


def make_root(dst: pathlib.Path) -> pathlib.Path:
    """``dst`` holding BENCHMARK.json and codecbench/ cut to TINY_BYTES."""
    shutil.copytree(BENCH, dst / BENCH.name,
                    ignore=shutil.ignore_patterns("tests", "__pycache__"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    for c in bench["configs"]:
        cfg = json.loads((ROOT / c["file"]).read_text())
        cfg["bytes"] = TINY_BYTES[c["name"]]
        cfg["min_count"] = 2
        cfg["shuffle_block_bytes"] = PAGE
        (dst / c["file"]).write_text(json.dumps(cfg))
    pages = dst / BENCH.name / "traffic" / "decode-pages-1MiB.json"
    t = json.loads(pages.read_text())
    t.update(page_bytes=PAGE, pages_per_request=2)
    pages.write_text(json.dumps(t))
    (dst / "BENCHMARK.json").write_text(json.dumps(bench))
    return dst


@pytest.fixture(scope="session")
def tiny_root(tmp_path_factory):
    return make_root(tmp_path_factory.mktemp("bench"))

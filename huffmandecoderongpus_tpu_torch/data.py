"""Corpus access: the reference's test datasets as TestData pairs.

The port's copy of the JAX package's ``data.py``.  Mirrors loadTestData
(huffdata.c:205-215): a test dataset pairs an uncompressed ground-truth
file with its ``<name>.huff``.  Where a raw original is missing, the ground
truth is decoded once by the port's serial oracle (``native.simple_decode``)
and cached.

``HUFF_FILES_DIR`` names the corpus directory (default: ``files/`` under
the repository root) and ``HUFF_CACHE_DIR`` the cache (default: ``.cache/``
under the repository root); both are read at each call.  Without a corpus
directory ``available_corpora()`` is empty: nothing here makes a corpus.
"""

from __future__ import annotations

import dataclasses
import os
import pathlib

import numpy as np

from huffmandecoderongpus_tpu_torch.huffio import HuffFile, read_huff

REPO_ROOT = pathlib.Path(__file__).resolve().parent.parent

#: All 8 corpora, in the reference's naming.  mainrun.c:503-509 loads the
#: first five; the others are exercised by the wider suites.
CORPUS_NAMES = [
    "hello",
    "paper1",
    "news",
    "book2",
    "kjv.txt",
    "E.coli",
    "bible.txt",
    "world192.txt",
]

#: The five datasets mainrun.c loads for its suites (mainrun.c:503-509).
MAINRUN_NAMES = ["hello", "paper1", "news", "book2", "kjv.txt"]


def files_dir() -> pathlib.Path:
    return pathlib.Path(os.environ.get("HUFF_FILES_DIR", REPO_ROOT / "files"))


def cache_dir() -> pathlib.Path:
    return pathlib.Path(os.environ.get("HUFF_CACHE_DIR", REPO_ROOT / ".cache"))


@dataclasses.dataclass
class TestData:
    """A named (compressed, uncompressed ground truth) pair
    (reference: struct TestData, huffdata.h:19-23)."""

    name: str
    cd: HuffFile
    ucd: np.ndarray  # uint8 ground-truth bytes

    def info(self) -> str:
        return (
            f"{self.name} nodes {self.cd.nodes}, bits {self.cd.bits}, "
            f"uncompressedsize {self.cd.uncompressed_size}"
        )


def huff_path(name: str) -> pathlib.Path:
    return files_dir() / f"{name}.huff"


def raw_path(name: str) -> pathlib.Path:
    return files_dir() / name


def has_raw(name: str) -> bool:
    return raw_path(name).exists()


def load_huff(name: str) -> HuffFile:
    return read_huff(huff_path(name))


def load_ground_truth(name: str, decoder=None) -> np.ndarray:
    """Uncompressed ground-truth bytes for a corpus.

    Reads the raw file where it is present.  Otherwise decodes the `.huff`
    once with a trusted serial decoder (the port's C++ oracle by default)
    and caches the result, which later calls take when its size is the
    header's.
    """
    p = raw_path(name)
    if p.exists():
        return np.fromfile(p, dtype=np.uint8)
    cached = cache_dir() / f"{name}.raw"
    hf = load_huff(name)
    if cached.exists():
        data = np.fromfile(cached, dtype=np.uint8)
        if data.size == hf.uncompressed_size:
            return data
    if decoder is None:
        from huffmandecoderongpus_tpu_torch.native import simple_decode

        decoder = simple_decode
    out = decoder(hf)
    cached.parent.mkdir(parents=True, exist_ok=True)
    out.tofile(cached)
    return out


def load_test_data(name: str) -> TestData:
    """Load one corpus as a TestData pair (huffdata.c:205-215 semantics)."""
    return TestData(name=name, cd=load_huff(name), ucd=load_ground_truth(name))


def available_corpora() -> list[str]:
    return [n for n in CORPUS_NAMES if huff_path(n).exists()]

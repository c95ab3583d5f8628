"""The port's host layer against the JAX package's, and the port's imports.

``huffmandecoderongpus_tpu_torch.huffio`` is the port's own copy of the
reader, the tree helpers and the encoder.  Tolerance: bit-exact — the same
tree, bit count and payload bytes as the JAX package's encoder, and the
same parse of a file the JAX package wrote.
"""

import ast
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

from huffmandecoderongpus_tpu.huffio import encoder as jencoder
from huffmandecoderongpus_tpu.huffio import format as jformat
from huffmandecoderongpus_tpu.huffio import tree as jtree
from huffmandecoderongpus_tpu_torch import huffio
from torch_streams import SHAPES, make

REPO = pathlib.Path(__file__).resolve().parent.parent


@pytest.mark.parametrize("name", sorted(SHAPES))
def test_encode_matches_jax(name):
    raw, want = make(name)
    got = huffio.encode_bytes(raw)
    np.testing.assert_array_equal(got.tree, want.tree)
    assert (got.bits, got.uncompressed_size) == (want.bits,
                                                 want.uncompressed_size)
    np.testing.assert_array_equal(got.payload, want.payload)
    assert huffio.table_height(got.tree) == jtree.table_height(want.tree)
    assert huffio.table_min_depth(got.tree) == jtree.table_min_depth(want.tree)
    for g, w in zip(huffio.tree_codes(got.tree), jtree.tree_codes(want.tree)):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("raw", [b"a", b"\x00", b"ab", bytes(range(256)) * 3])
def test_encode_edge_alphabets_match_jax(raw):
    # one symbol (padding sibling), symbol 0 alone, two symbols, uniform 256
    got, want = huffio.encode_bytes(raw), jencoder.encode_bytes(raw)
    np.testing.assert_array_equal(got.tree, want.tree)
    np.testing.assert_array_equal(got.payload, want.payload)
    assert got.bits == want.bits


def test_read_huff_matches_jax(tmp_path):
    raw, hf = make("ns2")
    path = tmp_path / "x.huff"
    jformat.write_huff(path, hf)
    got = huffio.read_huff(path)
    np.testing.assert_array_equal(got.tree, hf.tree)
    np.testing.assert_array_equal(got.payload, hf.payload)
    assert (got.bits, got.uncompressed_size, got.payload_bytes) == (
        hf.bits, hf.uncompressed_size, hf.payload_bytes)


@pytest.mark.parametrize("corrupt,match", [
    (lambda b: b"HUFX" + b[4:], "magic"),
    (lambda b: b[:10], "truncated header"),
    (lambda b: b[:-1], "truncated file"),
    # node 0's izero -> node 0: the root reachable twice
    (lambda b: b[:17] + (0).to_bytes(4, "big") + b[21:], "reachable twice"),
])
def test_read_huff_rejects_malformed(tmp_path, corrupt, match):
    _, hf = make("text")
    path = tmp_path / "x.huff"
    jformat.write_huff(path, hf)
    path.write_bytes(corrupt(path.read_bytes()))
    with pytest.raises(ValueError, match=match):
        huffio.read_huff(path)


def _imports(path):
    """Top-level package of every module the file imports."""
    out = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".")[0])
    return out


@pytest.mark.parametrize("path", sorted(
    [REPO / "chip_smoke.py"]
    + list((REPO / "huffmandecoderongpus_tpu_torch").rglob("*.py"))),
    ids=lambda p: str(p.relative_to(REPO)))
def test_no_jax_package_import(path):
    # anywhere in the file, including imports inside functions
    assert not _imports(path) & {"jax", "jaxlib", "huffmandecoderongpus_tpu"}


def test_chip_smoke_fails_without_cuda(tmp_path):
    import torch

    if torch.cuda.is_available():
        pytest.skip("CUDA is available: the check is for hosts without it")
    res = subprocess.run([sys.executable, str(REPO / "chip_smoke.py")],
                         cwd=tmp_path, capture_output=True, text=True,
                         env=dict(os.environ, PYTHONPATH=str(REPO)),
                         timeout=120)
    assert res.returncode != 0
    assert '"ok"' not in res.stdout

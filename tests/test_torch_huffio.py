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


@pytest.mark.parametrize("block_symbols", [None, 1, 1000, 4096])
def test_encode_with_tree_and_index_matches_jax(block_symbols):
    # a tree built from other data's frequencies, and the block index
    raw, _ = make("text")
    tree = jtree.build_tree(np.bincount(make("text", seed=1)[0],
                                        minlength=256) + 1)
    got = huffio.encode_bytes(raw, tree=tree, block_symbols=block_symbols)
    want = jencoder.encode_bytes(raw, tree=tree, block_symbols=block_symbols)
    np.testing.assert_array_equal(got.tree, want.tree)
    np.testing.assert_array_equal(got.payload, want.payload)
    assert got.bits == want.bits
    if block_symbols is None:
        assert got.index is None and want.index is None
    else:
        np.testing.assert_array_equal(got.index[0], want.index[0])
        assert got.index[1] == want.index[1] == block_symbols


def test_encode_missing_symbol_raises_like_jax():
    raw = np.array([1, 2, 3, 9], dtype=np.uint8)
    tree = jtree.build_tree(np.bincount([1, 2, 3], minlength=256))
    for enc in (huffio.encode_bytes, jencoder.encode_bytes):
        with pytest.raises(ValueError, match=r"no code for symbols \[9\]"):
            enc(raw, tree=tree)


@pytest.mark.parametrize("name", ["text", "ns2", "md1"])
def test_write_huff_matches_jax(tmp_path, name):
    raw, hf = make(name)
    got = huffio.encode_bytes(raw)
    huffio.write_huff(tmp_path / "port.huff", got)
    jformat.write_huff(tmp_path / "jax.huff", hf)
    assert (tmp_path / "port.huff").read_bytes() == (
        tmp_path / "jax.huff").read_bytes()
    assert got.file_bytes() == hf.file_bytes()
    assert got.nodes == hf.nodes
    back = huffio.read_huff(tmp_path / "port.huff")
    np.testing.assert_array_equal(back.payload, got.payload)


@pytest.mark.parametrize("block_symbols", [1, 777, 4096])
def test_sidecar_writer_matches_jax(tmp_path, block_symbols):
    from huffmandecoderongpus_tpu.huffio import sidecar as jsidecar

    raw, _ = make("random")
    got = huffio.encode_bytes(raw, block_symbols=block_symbols)
    want = jencoder.encode_bytes(raw, block_symbols=block_symbols)
    huff = tmp_path / "x.huff"
    assert huffio.index_path(huff) == jsidecar.index_path(huff)
    lens = jtree.tree_codes(want.tree)[1][raw]
    np.testing.assert_array_equal(
        huffio.build_block_index(lens, block_symbols),
        jsidecar.build_block_index(lens, block_symbols))
    assert huffio.payload_binding(got.bits, got.uncompressed_size,
                                  got.payload) == jsidecar.payload_binding(
        want.bits, want.uncompressed_size, want.payload)
    meta = dict(bits=got.bits, uncompressed_size=got.uncompressed_size,
                payload=got.payload)
    huffio.write_index(tmp_path / "port.huffidx", *got.index, **meta)
    jsidecar.write_index(tmp_path / "jax.huffidx", *want.index, **meta)
    assert (tmp_path / "port.huffidx").read_bytes() == (
        tmp_path / "jax.huffidx").read_bytes()
    offsets, k, crc = huffio.read_index(tmp_path / "jax.huffidx")
    j_offsets, j_k, j_crc = jsidecar.read_index(tmp_path / "jax.huffidx")
    np.testing.assert_array_equal(offsets, j_offsets)
    assert (k, crc) == (j_k, j_crc)
    # the JAX reader accepts the port's sidecar as bound to its payload
    jformat.write_huff(huff, want)
    huffio.write_index(huffio.index_path(huff), *got.index, **meta)
    loaded = jformat.read_huff(huff)
    np.testing.assert_array_equal(loaded.index[0], want.index[0])


@pytest.mark.parametrize("corrupt,match", [
    (lambda b: b"HIDY" + b[4:], "magic"),
    (lambda b: b[:4] + (1).to_bytes(4, "big") + b[8:], "version"),
    (lambda b: b[:-1], "bad index header"),
])
def test_read_index_rejects_malformed(tmp_path, corrupt, match):
    raw, _ = make("text")
    hf = huffio.encode_bytes(raw, block_symbols=100)
    path = tmp_path / "x.huffidx"
    huffio.write_index(path, *hf.index, bits=hf.bits,
                       uncompressed_size=hf.uncompressed_size,
                       payload=hf.payload)
    path.write_bytes(corrupt(path.read_bytes()))
    with pytest.raises(ValueError, match=match):
        huffio.read_index(path)


@pytest.mark.parametrize("name", sorted(SHAPES) + ["md1", "two", "s128"])
def test_tree_metrics_match_jax(name):
    _, hf = make(name)
    tree = hf.tree
    assert huffio.tree_size(tree) == jtree.tree_size(tree) == hf.nodes
    for bits in (1, 2, 3, 4, 8, 14):
        assert huffio.table_num_groups(tree, bits) == \
            jtree.table_num_groups(tree, bits)
    got, want = huffio.HuffTree(tree), jtree.HuffTree(tree)
    assert (got.nodes, got.height, got.min_depth, got.size) == (
        want.nodes, want.height, want.min_depth, want.size)
    assert got.num_groups(4) == want.num_groups(4)
    assert got.format_codes() == want.format_codes()
    assert got.format_table() == want.format_table()


@pytest.mark.parametrize("pad", [0, 3, 4])
def test_payload_padded_matches_jax(pad):
    _, hf = make("md3")
    got = huffio.HuffFile(tree=hf.tree, bits=hf.bits,
                          uncompressed_size=hf.uncompressed_size,
                          payload=hf.payload).payload_padded(pad)
    np.testing.assert_array_equal(got, hf.payload_padded(pad))
    assert got.size == hf.payload_bytes + pad

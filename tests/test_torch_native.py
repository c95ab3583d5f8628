"""The port's C++ host runtime against the JAX package's.

``huffmandecoderongpus_tpu_torch.native`` is the port's own copy of the JAX
package's ``native`` module (``huffc.cpp`` and its ctypes wrappers).  Each
of its entry points runs on the same seeded streams as the JAX one.
Tolerance 0: the same bytes and integers, and the same refusals.
"""

import functools
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

from huffmandecoderongpus_tpu import native as jnative
from huffmandecoderongpus_tpu.huffio.tree import table_height, tree_codes
from huffmandecoderongpus_tpu.models.serial import (
    build_multisym_lut as jax_multisym_lut,
)
from huffmandecoderongpus_tpu.models.serial import (
    build_packed_lut as jax_packed_lut,
)
from huffmandecoderongpus_tpu_torch import huffio, native
from torch_streams import make

REPO = pathlib.Path(__file__).resolve().parent.parent
#: chunked and 1-bit trees, a 256-symbol tree, 128 internal states
SHAPES = ["text", "random", "md3", "ns2", "md1", "two", "s128"]


@functools.lru_cache(maxsize=None)
def stream(name):
    """(raw, the JAX package's HuffFile, the port's HuffFile)."""
    raw, hf = make(name)
    port = huffio.HuffFile(tree=hf.tree, bits=hf.bits,
                           uncompressed_size=hf.uncompressed_size,
                           payload=hf.payload)
    return raw, hf, port


@pytest.mark.parametrize("name", SHAPES)
def test_simple_decoders_match_jax(name):
    raw, jhf, hf = stream(name)
    for fn in ("simple_decode", "simple_decode_rp"):
        got = getattr(native, fn)(hf)
        np.testing.assert_array_equal(got, getattr(jnative, fn)(jhf))
        np.testing.assert_array_equal(got, raw)


@pytest.mark.parametrize("name", SHAPES)
def test_bigtable_decoders_match_jax(name):
    raw, jhf, hf = stream(name)
    h = table_height(jhf.tree)
    for height in (h, h + 2):
        got = native.build_lut(hf.tree, height)
        for g, w in zip(got, jnative.build_lut(jhf.tree, height)):
            np.testing.assert_array_equal(g, w)
        out = native.bigtable_decode(hf, *got, height)
        np.testing.assert_array_equal(out, jnative.bigtable_decode(jhf, *got,
                                                                   height))
        np.testing.assert_array_equal(out, raw)
    np.testing.assert_array_equal(native.bigtable_decode(hf), raw)
    packed, h = jax_packed_lut(jhf.tree)
    out = native.bigtable_decode_packed(hf, packed, h)
    np.testing.assert_array_equal(
        out, jnative.bigtable_decode_packed(jhf, packed, h))
    np.testing.assert_array_equal(out, raw)


@pytest.mark.parametrize("name", SHAPES)
def test_multisym_and_tail_match_jax(name):
    raw, jhf, hf = stream(name)
    syms, count, consumed, h, maxsym = jax_multisym_lut(jhf.tree)
    syms = np.ascontiguousarray(syms)
    data = hf.payload_padded(4)
    head, pos = native.multisym_decode_raw(syms, count, consumed, maxsym, h,
                                           data, hf.bits, hf.uncompressed_size)
    jhead, jpos = jnative.multisym_decode_raw(syms, count, consumed, maxsym,
                                              h, jhf.payload_padded(4),
                                              jhf.bits, jhf.uncompressed_size)
    np.testing.assert_array_equal(head, jhead)
    assert pos == jpos and hf.bits - pos < h
    tail = native.tail_decode(hf.tree, 0, data, pos, hf.bits,
                              hf.uncompressed_size - head.size)
    np.testing.assert_array_equal(tail, jnative.tail_decode(
        jhf.tree, 0, data, pos, hf.bits, hf.uncompressed_size - head.size))
    np.testing.assert_array_equal(np.concatenate([head, tail]), raw)
    # mid-walk: the first code's first bit taken, its node the start
    bit0 = int(hf.payload[0] & 1)
    node = int(hf.tree[0, 2 if bit0 else 1])
    if hf.tree[node, 1] != -1:
        got = native.tail_decode(hf.tree, node, data, 1, hf.bits, raw.size)
        np.testing.assert_array_equal(got, jnative.tail_decode(
            jhf.tree, node, data, 1, hf.bits, raw.size))
        np.testing.assert_array_equal(got, raw)


@pytest.mark.parametrize("k", [3, 8])  # 8: the byte path
@pytest.mark.parametrize("name", SHAPES)
def test_dfa_loops_match_jax(name, k):
    from huffmandecoderongpus_tpu.models.dfa import (
        build_jump_dfa,
        build_lin_dfa,
    )

    raw, jhf, hf = stream(name)
    data = hf.payload_padded(4)
    syms, cnt, nxt, _nodes = build_jump_dfa(jhf.tree, k)
    args = (syms, cnt, nxt, k, k, data, hf.bits, hf.uncompressed_size)
    got = native.dfa_decode_raw(*args)
    want = jnative.dfa_decode_raw(*args)
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1:] == want[1:] and hf.bits - got[1] < k
    syms, cnt, nxt, base, width, _nodes = build_lin_dfa(jhf.tree, k)
    args = (syms, cnt, nxt, base, width, k, data, hf.bits,
            hf.uncompressed_size)
    got = native.vdfa_decode_raw(*args)
    want = jnative.vdfa_decode_raw(*args)
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1:] == want[1:]
    np.testing.assert_array_equal(got[0], raw[:got[0].size])


@pytest.mark.parametrize("name", SHAPES)
def test_truncate_scan_matches_jax(name):
    raw, jhf, hf = stream(name)
    data = hf.payload_padded()
    _code, length, _ = tree_codes(jhf.tree)
    ends = np.cumsum(length[raw])  # the bit after each symbol
    for target in (0, 1, hf.bits // 2, hf.bits - 1, hf.bits):
        got = native.truncate_scan(hf.tree, data, target)
        assert got == jnative.truncate_scan(jhf.tree, data, target)
        nsym = int(np.searchsorted(ends, target, side="right"))
        assert got == (int(ends[nsym - 1]) if nsym else 0, nsym)


@pytest.mark.parametrize("name", SHAPES)
def test_pack_codes_and_sum_bytes_match_jax(name):
    raw, jhf, hf = stream(name)
    code, length, _ = tree_codes(jhf.tree)
    payload, bits = native.pack_codes(raw, code, length)
    jpayload, jbits = jnative.pack_codes(raw, code, length)
    assert bits == jbits == hf.bits
    np.testing.assert_array_equal(payload, jpayload)
    np.testing.assert_array_equal(payload, hf.payload)
    assert native.sum_bytes(hf.payload) == jnative.sum_bytes(hf.payload) \
        == int(hf.payload.astype(np.int64).sum())


def test_errors_match_jax():
    raw, jhf, hf = stream("text")
    h = table_height(jhf.tree)
    # a table under the tree's height: native error -2 in both
    for mod in (native, jnative):
        with pytest.raises(RuntimeError, match="-2"):
            mod.build_lut(hf.tree, h - 1)
    # a stream cut one bit short ends mid-codeword: -2 from the walks
    cut = huffio.HuffFile(tree=hf.tree, bits=hf.bits - 1,
                          uncompressed_size=hf.uncompressed_size,
                          payload=hf.payload[:(hf.bits + 6) // 8])
    for mod in (native, jnative):
        for fn in ("simple_decode", "simple_decode_rp"):
            with pytest.raises(RuntimeError, match="-2"):
                getattr(mod, fn)(cut)
        with pytest.raises(RuntimeError, match="-5"):
            mod.bigtable_decode(cut)
    # an output one symbol short: -4
    small = huffio.HuffFile(tree=hf.tree, bits=hf.bits,
                            uncompressed_size=hf.uncompressed_size - 9,
                            payload=hf.payload)
    for mod in (native, jnative):
        with pytest.raises(RuntimeError, match="-4"):
            mod.simple_decode(small)


def test_library_is_keyed_by_source_and_flags(monkeypatch):
    path = native.lib_path()
    native.get_lib()
    assert path.exists() and path.parent == native.BUILD_DIR
    assert path.name.startswith("libhuffc_") and len(path.stem) == 25
    monkeypatch.setattr(native, "CXX_FLAGS", native.CXX_FLAGS + ("-g",))
    assert native.lib_path() != path


def test_concurrent_builds_rename_into_place(tmp_path):
    # three processes build into one empty directory at once: each writes
    # its own temporary file and renames it, so every one loads a whole
    # library and none is left behind
    prog = (
        "import pathlib, sys\n"
        "from huffmandecoderongpus_tpu_torch import native\n"
        "native.BUILD_DIR = pathlib.Path(sys.argv[1])\n"
        "import numpy as np\n"
        "print(native.sum_bytes(np.arange(10, dtype=np.uint8)))\n")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    procs = [subprocess.Popen([sys.executable, "-c", prog, str(tmp_path)],
                              stdout=subprocess.PIPE, text=True, env=env)
             for _ in range(3)]
    outs = [p.communicate(timeout=120)[0] for p in procs]
    assert [p.returncode for p in procs] == [0, 0, 0]
    assert outs == ["45\n"] * 3
    assert [p.name for p in tmp_path.iterdir()] == [native.lib_path().name]


def test_failed_build_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(native, "CXX_FLAGS",
                        native.CXX_FLAGS + ("-DHUFFC_NO_SUCH", "-include",
                                            str(tmp_path / "missing.h")))
    with pytest.raises(RuntimeError, match="failed"):
        native.build()
    assert list(tmp_path.iterdir()) == []

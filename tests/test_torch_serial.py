"""The port's host decoders and table builders against the JAX package's.

``models/serial.py`` and ``models/dfa.py`` of the port are copies of the
JAX package's, on the port's C++ runtime and its numpy ``build_decode_lut``.
Every decoder runs on the same seeded streams as its JAX counterpart and
must return the raw bytes; every table builder must return the same
arrays.  Tolerance 0: bytes and integers.
"""

import functools

import numpy as np
import pytest

from huffmandecoderongpus_tpu.huffio import encoder as jencoder
from huffmandecoderongpus_tpu.huffio.tree import table_height
from huffmandecoderongpus_tpu.models import dfa as jdfa
from huffmandecoderongpus_tpu.models import get_decoder as jax_decoder
from huffmandecoderongpus_tpu.models import serial as jserial
from huffmandecoderongpus_tpu_torch import huffio
from huffmandecoderongpus_tpu_torch.models import dfa, get_decoder, serial
from huffmandecoderongpus_tpu_torch.ops.lut import MAX_LUT_HEIGHT
from torch_streams import make

SERIAL = ["justreaddata", "simple", "simple_rp", "bigtable_v1",
          "bigtable_simple", "bigtable_multisym", "jumptable", "lin"]
SHAPES = ["text", "random", "md3", "ns2", "md1", "two", "s128"]
JUMPBITS = [1, 3, 8, 11, 14]


@functools.lru_cache(maxsize=None)
def stream(name):
    """(raw, the JAX package's HuffFile, the port's HuffFile)."""
    raw, hf = make(name)
    port = huffio.HuffFile(tree=hf.tree, bits=hf.bits,
                           uncompressed_size=hf.uncompressed_size,
                           payload=hf.payload)
    return raw, hf, port


@pytest.mark.parametrize("name", SHAPES)
@pytest.mark.parametrize("decoder", SERIAL)
def test_serial_decoder_matches_jax(decoder, name):
    raw, jhf, hf = stream(name)
    dec = get_decoder(decoder, device="cpu")
    want = jax_decoder(decoder)
    assert (dec.backend, dec.param, dec.checks_output) == (
        want.backend, want.param, want.checks_output) == (
        "host-native", want.param, decoder != "justreaddata")
    got = dec(hf)
    np.testing.assert_array_equal(got, want(jhf))
    np.testing.assert_array_equal(got, raw if dec.checks_output else
                                  np.zeros(0, np.uint8))


@pytest.mark.parametrize("k", [1, 14])
@pytest.mark.parametrize("name", SHAPES)
def test_dfa_decoders_finish_the_tail(name, k):
    # the stream less its last symbols until it ends off a chunk boundary
    # (at k = 14), so the DFA stops inside a state and the tail walk
    # finishes from that state's node
    raw, jhf, _hf = stream(name)
    while k > 1 and jhf.bits % k == 0:
        raw = raw[:-1]
        jhf = jencoder.encode_bytes(raw, tree=jhf.tree)
    hf = huffio.encode_bytes(raw, tree=jhf.tree)
    for decoder in ("jumptable", "lin"):
        got = get_decoder(decoder, device="cuda")(hf, k)  # runs on the host
        np.testing.assert_array_equal(got, jax_decoder(decoder)(jhf, k))
        np.testing.assert_array_equal(got, raw)


@pytest.mark.parametrize("cut", [1, 2, 3, 5, 13])
def test_dfa_decoders_on_cut_streams(cut):
    # the first ``cut`` bytes of odd-md text end at every offset in a chunk
    raw, _ = make("md3")
    raw = raw[:100 + cut]
    hf = huffio.encode_bytes(raw)
    for k in (1, 3, 7, 8, 14):
        for decoder in ("jumptable", "lin", "bigtable_multisym"):
            np.testing.assert_array_equal(
                get_decoder(decoder, device="cpu")(hf, k), raw)


def _builders(tree, k):
    """Each builder's arrays at jumpbits k in both packages; the LUT
    builders at height max(tree height, k)."""
    h = max(table_height(tree), k)
    return {
        "packed": (serial.build_packed_lut(tree, h),
                   jserial.build_packed_lut(tree, h)),
        "multisym": (serial.build_multisym_lut(tree, h),
                     jserial.build_multisym_lut(tree, h)),
        "jump": (dfa.build_jump_dfa(tree, k), jdfa.build_jump_dfa(tree, k)),
        "lin": (dfa.build_lin_dfa(tree, k), jdfa.build_lin_dfa(tree, k)),
    }


@pytest.mark.parametrize("k", JUMPBITS)
@pytest.mark.parametrize("name", SHAPES)
def test_table_builders_match_jax(name, k):
    _raw, jhf, _hf = stream(name)
    if max(table_height(jhf.tree), k) > MAX_LUT_HEIGHT:
        pytest.fail("no shape is taller than the LUT's limit")
    for builder, (got, want) in _builders(jhf.tree, k).items():
        assert len(got) == len(want), builder
        for g, w in zip(got, want):
            if isinstance(w, np.ndarray):
                assert g.dtype == w.dtype, builder
                np.testing.assert_array_equal(g, w, err_msg=builder)
            else:
                assert g == w, builder


@pytest.mark.parametrize("k", [0, 17, -1])
def test_jumpbits_out_of_range_raise(k):
    _raw, jhf, _hf = stream("md3")
    for build in (dfa.build_jump_dfa, dfa.build_lin_dfa,
                  jdfa.build_jump_dfa, jdfa.build_lin_dfa):
        with pytest.raises(ValueError, match="jumpbits"):
            build(jhf.tree, k)


def test_subtree_heights_match_jax():
    for name in SHAPES:
        tree = stream(name)[1].tree
        np.testing.assert_array_equal(dfa._subtree_heights(tree),
                                      jdfa._subtree_heights(tree))
        assert dfa._subtree_heights(tree)[0] == table_height(tree)

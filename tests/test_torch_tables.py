"""Host staging of the PyTorch port against the JAX package.

The port builds the tables in numpy (the JAX modules that build them
import jax).  Tolerance: bit-exact everywhere — tables, plans, lane
words, limits and the staged tensors must equal the reference's.
"""

import numpy as np
import pytest
import torch

from huffmandecoderongpus_tpu.huffio.encoder import encode_bytes
from huffmandecoderongpus_tpu.ops import lanedfa as jlanedfa
from huffmandecoderongpus_tpu.ops import pallas_widescan as jws
from huffmandecoderongpus_tpu_torch.ops import lanedfa, widescan
from torch_streams import SHAPES, as_numpy, make, md1, text_like

SHAPE_NAMES = sorted(SHAPES)


@pytest.mark.parametrize("name", SHAPE_NAMES)
def test_build_lane_dfa_matches(name):
    _, hf = make(name)
    got = lanedfa.build_lane_dfa(hf.tree)
    want = jlanedfa.build_lane_dfa(hf.tree)
    np.testing.assert_array_equal(got.entry, want.entry)
    assert (got.nodes, got.height, got.min_depth) == (
        want.nodes, want.height, want.min_depth)
    assert (lanedfa.EMIT_BIT, lanedfa.STATE_MASK) == (
        jlanedfa.EMIT_BIT, jlanedfa.STATE_MASK)


@pytest.mark.parametrize("name", SHAPE_NAMES)
def test_pack_quad_tables_matches(name):
    _, hf = make(name)
    dfa = jlanedfa.build_lane_dfa(hf.tree)
    tab, C0, C1, NS = widescan.pack_quad_tables(dfa)
    jtab, jC0, jC1, jNS = jws.pack_quad_tables(dfa)
    assert tab.dtype == np.int32
    np.testing.assert_array_equal(tab, np.asarray(jtab))
    assert (C0, C1, NS) == (jC0, jC1, jNS)
    if name == "ns2":
        assert NS == 2  # the wide entry layout


@pytest.mark.parametrize("lanes", [None, 512, 1000, 5000])
@pytest.mark.parametrize("bits,H,md,avg", [
    (96650, 9, 2, 4.83), (216003, 15, 6, 7.2), (4_855_510, 9, 2, 4.86),
    (26_716_362, 9, 2, 4.85), (59_694_639, 20, 6, 7.12), (80000, 4, 3, None),
])
def test_plan_matches(bits, H, md, avg, lanes):
    assert widescan._plan(bits, H, md, lanes=lanes, avg_len=avg) == jws._plan(
        bits, H, md, lanes=lanes, avg_len=avg)


@pytest.mark.parametrize("name", SHAPE_NAMES)
def test_payload_lane_words_matches(name):
    _, hf = make(name)
    for G, B in [(512, 192), (1024, 96)]:
        got = widescan.payload_lane_words(hf.payload, hf.bits, G, B)
        want = jws.payload_lane_words(hf.payload, hf.bits, G, B)
        assert got.dtype == np.int32 and got.shape == (G, B // 32)
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("lanes", [512, None])
@pytest.mark.parametrize("name", SHAPE_NAMES)
def test_stage_matches(name, lanes):
    _, hf = make(name)
    got = widescan.stage_widescan_inputs(hf, device="cpu", lanes=lanes)
    want = as_numpy(jws.stage_widescan_inputs(hf, lanes=lanes))
    assert got["plan"] == want["plan"]
    for k in ("H", "md", "C0", "C1", "NS"):
        assert got[k] == want[k], k
    np.testing.assert_array_equal(got["tab"].numpy(), want["tabw"])
    np.testing.assert_array_equal(got["words"].numpy(), want["words"])
    np.testing.assert_array_equal(got["lim"].numpy(),
                                  want["lim2"].reshape(-1))
    # the JAX staging carried across gives the same tensors
    carried = widescan.from_jax_staging(want, "cpu")
    for k in ("tab", "words", "lim"):
        assert carried[k].dtype == torch.int32
        assert torch.equal(carried[k], got[k]), k
    assert carried["plan"] == got["plan"]


@pytest.mark.parametrize("name", ["text", "ns2"])
def test_words_matrix_matches(name):
    _, hf = make(name)
    st = widescan.stage_widescan_inputs(hf, device="cpu", lanes=512)
    for steps_w in (st["words"].shape[1], st["words"].shape[1] + 1,
                    2 * st["words"].shape[1] + 1):
        got = widescan.words_matrix(st["words"], steps_w)
        want = np.asarray(jws.words_matrix_device(st["words"].numpy(),
                                                  steps_w))
        np.testing.assert_array_equal(got.numpy(),
                                      want.reshape(steps_w, -1))


def test_md1_raises_envelope():
    rng = np.random.default_rng(0)
    raw = md1(rng, 30000)
    hf = encode_bytes(raw)
    assert jlanedfa.build_lane_dfa(hf.tree).min_depth == 1
    assert not jws.stage_widescan_inputs(hf, lanes=512)["chunk2"]
    with pytest.raises(widescan.EnvelopeError, match="Queue 1 item 4"):
        widescan.stage_widescan_inputs(hf, device="cpu", lanes=512)
    with pytest.raises(widescan.EnvelopeError):
        widescan.from_jax_staging(
            as_numpy(jws.stage_widescan_inputs(hf, lanes=512)), "cpu")


def test_tiny_stream_raises_envelope():
    rng = np.random.default_rng(0)
    hf = encode_bytes(text_like(rng, 500))
    with pytest.raises(jws.EnvelopeError):
        jws.stage_widescan_inputs(hf)
    with pytest.raises(widescan.EnvelopeError, match="Queue 1 item 6"):
        widescan.stage_widescan_inputs(hf, device="cpu")

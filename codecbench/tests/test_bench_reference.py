"""The frozen plain reference: its encoder round-trips through its serial
decoder, agrees with the port's host encoder byte for byte, and its
control breaks the stream."""

import numpy as np
import pytest
import torch

from codecbench import reference
from huffmandecoderongpus_tpu_torch import huffio


def draw(n, symbols, seed):
    rng = np.random.default_rng(seed)
    p = rng.random(symbols) ** 3
    return rng.choice(symbols, size=n, p=p / p.sum()).astype(np.uint8)


@pytest.mark.parametrize("n, symbols, seed", [
    (1, 1, 0), (7, 2, 1), (5000, 3, 2), (20000, 90, 3), (30000, 256, 4)])
def test_round_trip(n, symbols, seed):
    data = draw(n, symbols, seed)
    tree, bits, payload = reference.encode(torch.from_numpy(data))
    assert payload.numel() == (bits + 7) // 8
    out = reference.decode(tree, payload.numpy(), bits, n)
    np.testing.assert_array_equal(out, data)


@pytest.mark.parametrize("seed", [5, 6])
def test_equals_the_port_host_encoder(seed):
    data = draw(40000, 200, seed)
    tree, bits, payload = reference.encode(torch.from_numpy(data))
    hf = huffio.encode_bytes(data)
    np.testing.assert_array_equal(tree, hf.tree)
    assert bits == hf.bits
    np.testing.assert_array_equal(payload.numpy(), hf.payload)


def test_decode_refuses_a_cut_stream():
    data = draw(3000, 20, 7)
    tree, bits, payload = reference.encode(torch.from_numpy(data))
    with pytest.raises(ValueError):
        reference.decode(tree, payload.numpy(), bits - 1, data.size)


def test_lane_aligned_control_breaks_the_stream():
    data = torch.from_numpy(draw(20000, 60, 8))
    tree, bits, payload = reference.encode(data)
    _t, cbits, cpay = reference.lane_aligned_encode(data, tree, 16)
    assert cbits > bits
    assert reference.bad_bytes(cpay.numpy(), payload.numpy()) > 0


def test_bad_bytes_counts_length_differences():
    want = np.arange(10, dtype=np.uint8)
    assert reference.bad_bytes(want, want) == 0
    assert reference.bad_bytes(want[:6], want) == 4
    got = want.copy()
    got[3] ^= 1
    assert reference.bad_bytes(got, want) == 1

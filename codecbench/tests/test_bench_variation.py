"""Each request's new input: a relabelled tree decodes to the relabelled
bytes, and flipped pairs change the payload and the plain bytes alike,
as the plain reference decodes them."""

import random

import numpy as np
import pytest
import torch

from codecbench import reference, variation


def stream(n, seed):
    rng = np.random.default_rng(seed)
    p = rng.random(40) ** 3
    return rng.choice(40, size=n, p=p / p.sum()).astype(np.uint8)


def test_relabel_decodes_to_the_permuted_bytes():
    data = stream(3000, 1)
    tree, bits, payload = reference.encode(torch.from_numpy(data))
    perm = np.array(random.Random(2).sample(range(256), 256), np.uint8)
    out = reference.decode(variation.relabel(tree, perm), payload.numpy(),
                           bits, data.size)
    np.testing.assert_array_equal(out, perm[data])


@pytest.mark.parametrize("seed", [3, 4])
def test_flipped_pairs_decode_to_the_swapped_bytes(seed):
    data = stream(5000, seed)
    t = torch.from_numpy(data)
    tree, bits, payload = reference.encode(t)
    payload = payload.numpy().copy()
    base = payload.copy()
    _code, length, _present = reference.tree_codes(tree)
    pos = variation.pick_pairs(data, 16, lo=100)
    assert pos.size == 16 and pos.min() >= 100
    assert np.all(np.diff(pos) >= 2) and np.all(data[pos] != data[pos + 1])
    plain = data.copy()
    swaps = variation.Swaps(plain, pos, variation.bit_offsets(t, pos, length),
                            tree)
    rng = random.Random(seed)
    for _ in range(4):
        state = swaps.draw(rng)
        swaps.move(state, plain, payload)
        want = data.copy()
        for k, p in enumerate(pos):
            if state >> k & 1:
                want[p], want[p + 1] = want[p + 1], want[p]
        np.testing.assert_array_equal(plain, want)
        np.testing.assert_array_equal(
            reference.decode(tree, payload, bits, data.size), want)
        # the payload as the reference would encode it, and as the check
        # works it out from the unflipped payload
        np.testing.assert_array_equal(
            payload, reference.encode(torch.from_numpy(want), tree)[2].numpy())
        exp = base.copy()
        for b, v in swaps.payload_bytes(base, state).items():
            exp[b] = v
        np.testing.assert_array_equal(payload, exp)
        assert swaps.pair_values(payload) == swaps.expected_values(state)

"""The seeded generator: the same bytes for a seed, the same histogram
(whole and a block at a time) for every seed, and the configurations'
stated statistics."""

import json

import numpy as np
import pytest
import torch

from codecbench import datagen, reference
from codecbench.tests.conftest import ROOT

SMALL = dict(bytes=50_000, symbols=40, tail_symbols=8, min_count=3,
             zipf_q=6.0, zipf_s=1.5, shuffle_block_bytes=16_384)


def config(name):
    return json.loads((ROOT / "codecbench" / "configs" / f"{name}.json")
                      .read_text())


def test_same_seed_same_bytes():
    a = datagen.generate(SMALL, 2**31 + 7, "cpu")
    b = datagen.generate(SMALL, 2**31 + 7, "cpu")
    assert torch.equal(a, b)
    assert a.dtype == torch.uint8 and a.numel() == SMALL["bytes"]


def test_seeds_reorder_the_same_blocks():
    a = datagen.generate(SMALL, 1, "cpu").numpy()
    b = datagen.generate(SMALL, 2, "cpu").numpy()
    assert not np.array_equal(a, b)
    block = SMALL["shuffle_block_bytes"]
    for start in range(0, SMALL["bytes"], block):
        np.testing.assert_array_equal(
            np.bincount(a[start:start + block], minlength=256),
            np.bincount(b[start:start + block], minlength=256))
    np.testing.assert_array_equal(np.bincount(a, minlength=256),
                                  datagen.histogram(SMALL))


@pytest.mark.parametrize("name, entropy, height, min_depth, states, bits", [
    ("enwik8", 5.08, 23, 3, 204, 510_698_455),
    ("silesia-mozilla", 6.0, 18, 2, 255, 309_121_545),
])
def test_configs_state_their_statistics(name, entropy, height, min_depth,
                                        states, bits):
    cfg = config(name)
    hist = datagen.histogram(cfg)
    assert hist.sum() == cfg["bytes"]
    assert np.count_nonzero(hist) == cfg["symbols"]
    assert hist[hist > 0].min() == cfg["min_count"]
    assert abs(datagen.entropy_bits(hist) - entropy) < 0.005
    stats = reference.code_stats(reference.build_tree(hist), hist)
    assert stats == dict(height=height, min_depth=min_depth, states=states,
                         bits=bits)
    if cfg["lead_share"]:
        assert abs(hist[0] / cfg["bytes"] - cfg["lead_share"]) < 1e-4

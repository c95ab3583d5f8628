"""The seeded streams of the probe programs, of ``chip_smoke.py`` and of the
port's tests.

The scripts load ``paper1`` and ``kjv.txt`` from a corpus mount the port
does not have; the probes take text-like streams of those sizes instead:
Zipf(1.1) over 84 symbols (min code length 2, height 9), a kjv-sized
stream (``chip_smoke.py``'s (a)) and a paper1-sized one (the size of its
(f)).  ``chip_smoke.py`` draws its text streams with ``text_like``.
``comb_stream`` is a tree taller than any encoder builds, for the lane-DFA
scans' tall-tree cases.
"""

from __future__ import annotations

import numpy as np

from huffmandecoderongpus_tpu_torch.huffio import HuffFile, encode_bytes

SEED = 0
TEXT_SYMBOLS = 84
KJV_BYTES = 5_504_597
PAPER1_BYTES = 53_161
STREAMS = {"a": ("kjv-sized text", KJV_BYTES),
           "f": ("paper1-sized text", PAPER1_BYTES)}


def text_like(rng, n, symbols=TEXT_SYMBOLS):
    z = 1.0 / np.arange(1, symbols + 1) ** 1.1
    return rng.choice(np.arange(32, 32 + symbols, dtype=np.uint8),
                      size=n, p=z / z.sum()).astype(np.uint8)


def stream(key: str, nbytes: int | None = None):
    """(name, raw, HuffFile) of stream ``key`` ("a" or "f"), ``nbytes`` long
    if given, drawn from its own generator (seed 0; "a" is then the first
    stream ``chip_smoke.py`` draws)."""
    name, n = STREAMS[key]
    n = nbytes or n
    raw = text_like(np.random.default_rng(SEED), n)
    return f"({key}) {name}, {n} bytes", raw, encode_bytes(raw)


def comb_stream(leaves=141, n=60000, seed=SEED, deep=0):
    """(raw, HuffFile) of ``n`` symbols over a comb tree (leaf k has code
    1^k 0, the last leaf 1^(leaves-1); height leaves - 1) whose payload
    draws the five shortest codes from ``seed`` and, with ``deep``, has a
    run of that many of the deepest code mid-stream."""
    tree = np.zeros((2 * leaves - 1, 3), dtype=np.int32)
    for i in range(leaves - 1):  # internal node 2i: leaf 2i+1, next 2i+2
        tree[2 * i] = (0, 2 * i + 1, 2 * i + 2)
        tree[2 * i + 1] = (i, -1, -1)
    tree[2 * leaves - 2] = (leaves - 1, -1, -1)
    raw = np.random.default_rng(seed).integers(0, 5, size=n, dtype=np.uint8)
    raw[n // 2:n // 2 + deep] = leaves - 1
    code = [[1] * k + [0] for k in range(leaves - 1)] + [[1] * (leaves - 1)]
    bits = np.concatenate([code[s] for s in raw]).astype(np.uint8)
    return raw, HuffFile(tree=tree, bits=int(bits.size), uncompressed_size=n,
                         payload=np.packbits(bits, bitorder="little"))

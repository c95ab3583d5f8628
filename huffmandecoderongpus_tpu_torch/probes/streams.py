"""The seeded text streams of the probe programs and of ``chip_smoke.py``.

The scripts load ``paper1`` and ``kjv.txt`` from a corpus mount the port
does not have; the probes take text-like streams of those sizes instead:
Zipf(1.1) over 84 symbols (min code length 2, height 9), a kjv-sized
stream (``chip_smoke.py``'s (a)) and a paper1-sized one (the size of its
(f)).  ``chip_smoke.py`` draws its text streams with ``text_like``.
"""

from __future__ import annotations

import numpy as np

from huffmandecoderongpus_tpu_torch.huffio import encode_bytes

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

"""Seeded synthetic streams shared by the PyTorch port's tests.

Every stream is made with numpy from a fixed seed (no corpus files): the
shapes the port's envelope must hold against the JAX reference.
"""

import numpy as np

from huffmandecoderongpus_tpu.huffio.encoder import encode_bytes
from huffmandecoderongpus_tpu.huffio.tree import table_height, table_min_depth


def text_like(rng, n, symbols=84):
    """Zipf(1.1) over ``symbols`` byte values: a text-like tree (min code
    length 2, height 9 at 84 symbols)."""
    z = 1.0 / np.arange(1, symbols + 1) ** 1.1
    return rng.choice(np.arange(32, 32 + symbols, dtype=np.uint8), size=n,
                      p=z / z.sum()).astype(np.uint8)


def random_bytes(rng, n):
    return rng.integers(0, 256, size=n, dtype=np.uint8)


def odd_md(rng, n):
    """12 near-uniform symbols: every code is 3 or 4 bits (md=3)."""
    w = 1.0 + rng.random(12)
    return rng.choice(np.arange(65, 77, dtype=np.uint8), size=n,
                      p=w / w.sum()).astype(np.uint8)


def full_alphabet(rng, n):
    """All 256 symbols, skewed: 255 internal states (two table chunks)."""
    w = rng.random(256) ** 3 + 1e-4
    return rng.choice(np.arange(256, dtype=np.uint8), size=n,
                      p=w / w.sum()).astype(np.uint8)


def phase_locked(rng, n_tiles=2000):
    """Periodic 'abcd' runs with rare 'e'/'f': candidate chains phase-lock
    and resolve late."""
    data = np.tile(np.array([97, 98, 99, 100], dtype=np.uint8), n_tiles)
    rare = rng.integers(0, data.size, size=20)
    data[rare] = rng.choice(np.array([101, 102], dtype=np.uint8), size=20)
    return data


def md1(rng, n):
    """One dominant symbol: a 1-bit code (md=1)."""
    w = np.full(16, 1.0)
    w[0] = 40.0
    return rng.choice(np.arange(16, dtype=np.uint8), size=n,
                      p=w / w.sum()).astype(np.uint8)


#: name -> (generator, symbols): the envelope shapes of the port
SHAPES = {
    "text": (text_like, 20000),
    "random": (random_bytes, 9000),
    "md3": (odd_md, 20000),
    "ns2": (full_alphabet, 30000),
    "abcd": (phase_locked, None),
}


def make(name, seed=0):
    """(raw bytes, HuffFile) of one named shape."""
    gen, n = SHAPES[name]
    rng = np.random.default_rng(seed)
    raw = gen(rng) if n is None else gen(rng, n)
    return raw, encode_bytes(raw)


def fuzz(seed):
    """(raw, HuffFile, lanes) of a seeded random stream inside the port's
    envelope: 3-256 symbols, random skew and length, min code length >= 2
    and at least 1024*max(H, 8) bits (drawn again until both hold)."""
    rng = np.random.default_rng(1000 + seed)
    while True:
        k = int(rng.integers(3, 257))
        w = rng.random(k) ** float(rng.uniform(0.0, 4.0)) + 1e-3
        alpha = rng.choice(256, size=k, replace=False).astype(np.uint8)
        raw = rng.choice(alpha, size=int(rng.integers(5000, 60000)),
                         p=w / w.sum()).astype(np.uint8)
        hf = encode_bytes(raw)
        H, md = table_height(hf.tree), table_min_depth(hf.tree)
        if md >= 2 and hf.bits >= 1024 * max(H, 8):
            lanes = [512, 1024, None][int(rng.integers(0, 3))]
            return raw, hf, lanes


def as_numpy(st):
    """A staging dict with its arrays (JAX or torch) taken as numpy."""
    return {k: (np.asarray(v) if hasattr(v, "shape") else v)
            for k, v in st.items()}

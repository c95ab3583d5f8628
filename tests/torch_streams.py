"""Seeded synthetic streams shared by the PyTorch port's tests.

Every stream is made with numpy from a fixed seed (no corpus files): the
shapes the port's envelope must hold against the JAX reference.
"""

import numpy as np

from huffmandecoderongpus_tpu.huffio.encoder import encode_bytes
from huffmandecoderongpus_tpu.huffio.format import HuffFile
from huffmandecoderongpus_tpu.huffio.tree import table_height, table_min_depth
from huffmandecoderongpus_tpu_torch.probes import streams as port_streams
# Zipf(1.1) over ``symbols`` byte values: a text-like tree (min code length
# 2, height 9 at 84 symbols), as the probes and chip_smoke.py draw it
from huffmandecoderongpus_tpu_torch.probes.streams import text_like  # noqa: F401


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


def comb_stream(leaves=141, n=60000):
    """``probes.streams.comb_stream`` (a comb tree ``leaves - 1`` tall, which
    no encoder builds) as the JAX package's HuffFile, like every stream
    here."""
    raw, hf = port_streams.comb_stream(leaves, n)
    return raw, HuffFile(tree=hf.tree, bits=hf.bits, uncompressed_size=n,
                         payload=hf.payload)


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


def md1_wide(rng, n):
    """Byte 0 at weight 300 over all 256 symbols: md=1 with 255 internal
    states (the wide pair table, NS=2).  Seed 3 at 20000 symbols is the
    JAX package's leader halo-publish regression stream."""
    w = np.full(256, 1.0)
    w[0] = 300.0
    return rng.choice(np.arange(256, dtype=np.uint8), size=n,
                      p=w / w.sum()).astype(np.uint8)


def two_symbol(rng, n):
    """Bytes 0/1, 30 % ones: a two-leaf tree (height 1, md=1)."""
    return (rng.random(n) < 0.3).astype(np.uint8)


def md1_phase_locked(rng):
    """Runs of 'a' (a 1-bit code) between periodic 'xy' runs, with 12 rare
    deeper symbols: md=1 candidate chains phase-lock and merge late, and
    several followers exist beside the leader."""
    blocks = []
    for _ in range(20):
        blocks.append(np.full(600, 97, dtype=np.uint8))
        blocks.append(np.tile(np.array([120, 121], dtype=np.uint8), 300))
    data = np.concatenate(blocks)
    rare = rng.integers(0, data.size, size=12)
    data[rare] = (122 + np.arange(12) % 4).astype(np.uint8)
    return data


def states128_md1(rng, n):
    """129 symbols, byte 0 at weight 300: md 1 over a tree of exactly 128
    internal states, the most the compact table layout holds."""
    return port_streams.dominant_byte(rng, n, 129)


def states128(rng, n):
    """129 near-uniform symbols: md >= 2 over 128 internal states."""
    return port_streams.near_uniform(rng, n, 129)


#: trees of exactly 128 internal states (drawn from seed 1): the port packs
#: them compact in one table chunk, the JAX package wide, which its readers
#: take for compact (ROADMAP Queue 3)
STATES128 = {"s128md1": (states128_md1, 60000), "s128": (states128, 60000)}

#: name -> (generator, symbols): the shapes of the chunked (md >= 2) path
SHAPES = {
    "text": (text_like, 20000),
    "random": (random_bytes, 9000),
    "md3": (odd_md, 20000),
    "ns2": (full_alphabet, 30000),
    "abcd": (phase_locked, None),
}
#: the min-code-length-1 shapes (the 1-bit kernels)
MD1_SHAPES = {
    "md1": (md1, 30000),
    "md1wide": (md1_wide, 20000),
    "two": (two_symbol, 30000),
    "md1abab": (md1_phase_locked, None),
}


def make(name, seed=0):
    """(raw bytes, HuffFile) of one named shape."""
    gen, n = {**SHAPES, **MD1_SHAPES, **STATES128}[name]
    rng = np.random.default_rng(seed)
    raw = gen(rng) if n is None else gen(rng, n)
    return raw, encode_bytes(raw)


#: the indexed cases: text at 256 symbols a block, odd blocks of 129, md 3
#: (SEG 96), 256 symbols (NS 2, md 6, SEG 96)
INDEXED = ["text256", "text129", "md3", "ns2"]


def make_indexed(case):
    """(raw, HuffFile with its `.huffidx` index) of a named indexed case."""
    rng = np.random.default_rng(7)
    raw, k = {"text256": (text_like(rng, 40000), 256),
              "text129": (text_like(rng, 40000), 129),
              "md3": (odd_md(rng, 30000), 200),
              "ns2": (full_alphabet(rng, 40000), 300)}[case]
    return raw, encode_bytes(raw, block_symbols=k)


def batch_text(rng, n, alphabet=8, skew=3.0):
    """Bounded weight ratio (max/min <= skew + 1): no symbol reaches a
    1-bit code, so the tree stays in the batch envelope
    (``tests/test_batch.py``)."""
    w = rng.random(alphabet) * skew + 1.0
    return rng.choice(np.arange(alphabet, dtype=np.uint8), size=n,
                      p=w / w.sum()).astype(np.uint8)


#: the batch cases: two distinct trees; md 2 and 3 with a one-lane member;
#: text-like trees of height 9 and 8; four members, one over two lane
#: blocks
BATCHES = ["two", "mixed", "text", "four"]


def make_batch(case):
    """(raws, HuffFiles) of a named batch."""
    rng = np.random.default_rng(12)
    if case == "two":
        raws = [batch_text(rng, 9000), batch_text(rng, 12000, 16, 2.0)]
    elif case == "mixed":
        raws = [batch_text(rng, 30000), batch_text(rng, 20000, 64, 1.0),
                np.tile(np.arange(8, dtype=np.uint8), 5)]
    elif case == "text":
        raws = [make("text")[0], make("text", seed=3)[0][:7000]]
    else:
        raws = [batch_text(rng, n, a) for n, a in
                ((4000, 6), (60000, 16), (800, 32), (15000, 8))]
    return raws, [encode_bytes(r) for r in raws]


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


def fuzz_any(seed):
    """(raw, HuffFile, lanes) of a seeded random stream of any shape:
    ``fuzz`` without its filters, its alphabet size and length drawn
    log-uniform and a dominant symbol in some draws, so that min code
    length 1 and streams too small for the wide lanes come up as well as
    the chunked path's."""
    rng = np.random.default_rng(3000 + seed)
    k = int(2 ** rng.uniform(1.0, 8.0))
    w = rng.random(k) ** float(rng.uniform(0.0, 4.0)) + 1e-3
    if rng.random() < 0.4:
        w[0] = w.sum() * float(rng.uniform(1.0, 4.0))
    alpha = rng.choice(256, size=k, replace=False).astype(np.uint8)
    n = int(np.exp(rng.uniform(np.log(300), np.log(60000))))
    raw = rng.choice(alpha, size=n, p=w / w.sum()).astype(np.uint8)
    lanes = [512, 1024, None][int(rng.integers(0, 3))]
    return raw, encode_bytes(raw), lanes


def as_numpy(st):
    """A staging dict with its arrays (JAX or torch) taken as numpy."""
    return {k: (np.asarray(v) if hasattr(v, "shape") else v)
            for k, v in st.items()}


def fib_tree_data(rng, n_deep, n_sym=26, body=16000):
    """(raw, tree): a tree built from Fibonacci weights over ``n_sym``
    symbols (its deepest codes 24 bits at 26 symbols) and a body drawn from
    those weights followed by ``n_deep`` copies of the deepest symbol, so
    the encoder's tail lanes carry far more granules than the mean
    (``tests/test_pallas_encode.py``'s overflow stream)."""
    from huffmandecoderongpus_tpu.huffio.tree import build_tree

    fib = [1, 1]
    while len(fib) < n_sym:
        fib.append(fib[-1] + fib[-2])
    counts = np.array(fib[::-1], dtype=np.int64)  # symbol 0 most common
    head = rng.choice(np.arange(n_sym, dtype=np.uint8), size=body,
                      p=counts / counts.sum()).astype(np.uint8)
    raw = np.concatenate([head, np.full(n_deep, n_sym - 1, dtype=np.uint8)])
    freqs = np.zeros(256, dtype=np.int64)
    freqs[:n_sym] = counts
    return raw, build_tree(freqs)

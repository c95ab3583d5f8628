"""The seeded streams of the probe programs, of ``chip_smoke.py`` and of the
port's tests.

The scripts load ``paper1`` and ``kjv.txt`` from a corpus mount the port
does not have; the probes take text-like streams of those sizes instead:
Zipf(1.1) over 84 symbols (min code length 2, height 9), a kjv-sized
stream (``chip_smoke.py``'s (a)) and a paper1-sized one (the size of its
(f)).  ``chip_smoke.py`` draws its text streams with ``text_like``.
``comb_stream`` is a tree taller than any encoder builds, for the lane-DFA
scans' tall-tree cases; ``forked_comb_stream`` one as tall with min code
length 2, for the one-shot kernel's tallest eligible tree.
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


def forked_comb_stream(height=128, n=60000, seed=SEED, deep=0):
    """(raw, HuffFile) of ``n`` symbols over a tree ``height`` tall with min
    code length 2: symbols 0 and 1 have codes 00 and 01 (first bit first),
    symbol k + 1 has 1^k 0 for k = 1 .. height - 1 and the last symbol
    1^height.  The payload draws symbols 0-4 from ``seed`` and, with
    ``deep``, has a run of that many of the deepest code mid-stream."""
    m = height + 2  # symbols
    tree = np.zeros((2 * m - 1, 3), dtype=np.int32)
    # root 0: left the pair node 1 (leaves 2, 3), right the comb from 4
    tree[0] = (0, 1, 4)
    tree[1] = (0, 2, 3)
    tree[2] = (0, -1, -1)
    tree[3] = (1, -1, -1)
    node = 4
    for k in range(1, height):  # comb node at depth k: leaf 1^k 0, next
        tree[node] = (0, node + 1, node + 2)
        tree[node + 1] = (k + 1, -1, -1)
        node += 2
    tree[node] = (height + 1, -1, -1)
    raw = np.random.default_rng(seed).integers(0, 5, size=n, dtype=np.uint8)
    raw[n // 2:n // 2 + deep] = height + 1
    code = ([[0, 0], [0, 1]] + [[1] * k + [0] for k in range(1, height)]
            + [[1] * height])
    bits = np.concatenate([code[s] for s in raw]).astype(np.uint8)
    return raw, HuffFile(tree=tree, bits=int(bits.size), uncompressed_size=n,
                         payload=np.packbits(bits, bitorder="little"))


def staging_at(hf, G, device):
    """``widescan.stage_widescan_inputs`` of ``hf`` at exactly G lanes (a
    multiple of 128, where the plan would pick 512 or more): B the lane bits
    in whole words, ORP the plan's hard bound (no lane overflows)."""
    import torch

    from huffmandecoderongpus_tpu_torch.ops import widescan as ws

    st = ws.stage_widescan_inputs(hf, device=device)
    p = dict(st["plan"])
    B = -(-(-(-hf.bits // G)) // 32) * 32
    steps = B + st["H"]
    steps_p = -(-steps // p["SEG"]) * p["SEG"]
    ORP = -(-min(B // st["md"] + 2, steps_p // st["md"]) // 128) * 128
    p.update(G=G, B=B, steps=steps, steps_p=steps_p, ORP=ORP)
    words = ws.payload_lane_words(hf.payload, hf.bits, G, B)
    lim = np.clip(hf.bits - np.arange(G, dtype=np.int64) * B, -(1 << 30),
                  1 << 30).astype(np.int32)
    return dict(st, plan=p, words=torch.from_numpy(words).to(device),
                lim=torch.from_numpy(lim).to(device))


def envelope_edge_stream():
    """(raw, HuffFile) of the largest 8-symbol stream, in 64 KB steps, that
    ``lane_wide`` still routes to the one-shot (under ONESHOT_MAX_BITS and
    ``oneshot_eligible`` at the plan's lanes), as the JAX package's
    ``tests/test_oneshot.py`` builds its envelope-edge stream."""
    from huffmandecoderongpus_tpu_torch.ops import oneshot
    from huffmandecoderongpus_tpu_torch.ops import widescan as ws

    rng = np.random.default_rng(0)
    probs = np.array([0.35, 0.2, 0.12, 0.1, 0.08, 0.06, 0.05, 0.04])
    raw_full = rng.choice(np.arange(8, dtype=np.uint8), size=1 << 20,
                          p=probs / probs.sum()).astype(np.uint8)
    best = None
    for size in range(1 << 16, 1 << 20, 1 << 16):
        hf = encode_bytes(raw_full[:size])
        if hf.bits >= ws.ONESHOT_MAX_BITS:
            break
        if oneshot.oneshot_eligible(ws.stage_widescan_inputs(hf,
                                                             device="cpu")):
            best = (raw_full[:size], hf)
    return best


#: the one-shot kernel's edge cases (``oneshot_case``): a candidate chain
#: alone (H 2, CH 1), md 8, the tallest eligible tree (128, min code
#: length 2, CH 127: several followers a thread), the envelope-edge stream,
#: and G = 128 and 4,096 (the envelope's ends)
ONESHOT_CASES = ("h2", "md8", "tall128", "edge", "text-128", "text-4096",
                 "alpha-128")


def oneshot_case(case, device):
    """(raw, staged stream) of one of ONESHOT_CASES, drawn from seed 21."""
    from huffmandecoderongpus_tpu_torch.ops import widescan as ws

    rng = np.random.default_rng(21)
    if case == "tall128":
        raw, hf = forked_comb_stream(128, 60000, deep=50)
    elif case == "edge":
        raw, hf = envelope_edge_stream()
    elif case in ("h2", "md8"):
        raw = rng.integers(0, 4 if case == "h2" else 256,
                           60000 if case == "h2" else 40000).astype(np.uint8)
        hf = encode_bytes(raw)
    else:  # <text or alpha>-<G>: that many lanes
        name, G = case.split("-")
        if name == "text":
            raw = text_like(rng, 300_000)
        else:  # all 256 symbols, skewed (md 5-6, two table chunks)
            w = rng.random(256) ** 3 + 1e-4
            raw = rng.choice(np.arange(256, dtype=np.uint8), size=30000,
                             p=w / w.sum()).astype(np.uint8)
        return raw, staging_at(encode_bytes(raw), int(G), device)
    return raw, ws.stage_widescan_inputs(hf, device=device)


#: K1's edge cases (``k1_case``): md 2 at the plan's smallest G (512); 256
#: symbols (md 6, two table chunks) at G = 16,384; md 8 (H 8: seven
#: leaders, no follower); one candidate chain (H 2); a tree 128 tall (CH
#: 127, several followers a thread) at the plan's G and at G = 4,096, where
#: its 128-bit halo spans the next two 64-bit lanes (word rows to the end
#: of the word matrix); lanes past the stream end (lim <= 0); (d)'s blank
#: run at a smaller size (chains live for many segments); and a batch whose
#: streams end in pad lanes (``k1_scan2_c01``, each stream on its table)
K1_CASES = ("text-512", "alpha-16384", "md8", "h2", "tall128",
            "tall128-4096", "tail-4096", "blank", "batch-pad")
#: the blank-run case: text bytes, and the run of its most frequent byte
BLANK_BYTES, BLANK_RUN = 400_000, (150_000, 190_000)


def k1_case(case, device):
    """(kernel, inputs, kw, hfs) of one of K1_CASES, drawn from seed 31:
    the K1 wrapper that takes it ("k1_scan2", or "k1_scan2_c01" for the
    batch), its tensors on ``device`` in the wrapper's order, its keyword
    arguments and the streams (a list of HuffFiles)."""
    from huffmandecoderongpus_tpu_torch.ops import batch
    from huffmandecoderongpus_tpu_torch.ops import widescan as ws

    rng = np.random.default_rng(31)
    if case == "batch-pad":
        hfs = [encode_bytes(text_like(rng, n, k))
               for n, k in ((9000, 84), (30000, 40), (300, 12))]
        st = batch.stage_batch_inputs(hfs, device=device)
        p = st["plan"]
        wmat = ws.words_matrix(st["words"], -(-p["steps_p"] // 32))
        kw = dict(B=p["B"], H=st["H"], steps=p["steps"],
                  steps_p=p["steps_p"], SEG=p["SEG"], md=st["md"])
        return ("k1_scan2_c01",
                (wmat, st["tabs"], st["lim"], st["c01"], st["bstream"]), kw,
                hfs)
    G = None
    if case == "text-512":
        hf = encode_bytes(text_like(rng, 200_000))
    elif case == "alpha-16384":
        w = rng.random(256) ** 3 + 1e-4
        hf = encode_bytes(rng.choice(np.arange(256, dtype=np.uint8),
                                     size=60_000, p=w / w.sum())
                          .astype(np.uint8))
        G = 16384
    elif case in ("md8", "h2"):
        hf = encode_bytes(rng.integers(0, 256 if case == "md8" else 4,
                                       40_000).astype(np.uint8))
    elif case.startswith("tall128"):
        _raw, hf = forked_comb_stream(128, 60000, deep=50)
        G = 4096 if case.endswith("4096") else None
    elif case == "tail-4096":
        hf = encode_bytes(text_like(rng, 20_000))
        G = 4096
    else:  # blank
        raw = text_like(rng, BLANK_BYTES)
        raw[slice(*BLANK_RUN)] = np.bincount(raw).argmax()
        hf = encode_bytes(raw)
    if G is not None:
        st = staging_at(hf, G, device)
    else:
        st = ws.stage_widescan_inputs(
            hf, device=device, lanes=512 if case == "text-512" else None)
    p = st["plan"]
    wmat = ws.words_matrix(st["words"], -(-p["steps_p"] // 32))
    kw = dict(B=p["B"], H=st["H"], steps=p["steps"], steps_p=p["steps_p"],
              SEG=p["SEG"], md=st["md"], C0=st["C0"], C1=st["C1"],
              NS=st["NS"])
    return "k1_scan2", (wmat, st["tab"], st["lim"]), kw, [hf]


#: K4's edge cases (``k4_cells``): (G, cells_p, ORP, fill, offset of the
#: views in elements): one lane, three, a tail block of 4 lanes (100), the
#: standalone path's width, lanes past ORP, no valid slot, views at an
#: offset (1-lane loads), rows wider than a block's staging (16 lanes a
#: block) and than any (windows of ranks)
K4_CASES = ((1, 40, 128, "random", 0), (3, 40, 128, "random", 0),
            (100, 60, 256, "random", 0), (8192, 41, 1024, "random", 0),
            (64, 300, 512, "full", 0), (96, 50, 128, "empty", 0),
            (128, 50, 256, "random", 1), (36, 80, 256, "full", 3),
            (40, 700, 1536, "random", 0), (2, 16400, 65536, "full", 0))


def k4_cells(case, device):
    """(sym, val) (cells_p, G) views at the case's offset on ``device``:
    random nibbles (every seventh lane with no valid slot), every slot
    valid ("full", as md 1 fills its cells) or none ("empty")."""
    import torch

    G, cells_p, _ORP, fill, off = case
    rng = np.random.default_rng(G + cells_p)
    sym = rng.integers(-2**31, 2**31, (cells_p, G)).astype(np.int32)
    if fill == "full":
        val = np.full((cells_p, G), 15, dtype=np.uint8)
    elif fill == "empty":
        val = np.zeros((cells_p, G), dtype=np.uint8)
    else:
        val = rng.integers(0, 16, (cells_p, G)).astype(np.uint8)
        val[:, ::7] = 0
    n = cells_p * G
    views = []
    for a, dt in ((sym, torch.int32), (val, torch.uint8)):
        t = torch.empty(n + off, dtype=dt, device=device)[off:].view(
            cells_p, G)
        t.copy_(torch.from_numpy(a))
        views.append(t)
    return tuple(views)

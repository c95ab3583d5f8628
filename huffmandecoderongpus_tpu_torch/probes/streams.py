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

from huffmandecoderongpus_tpu_torch.huffio import (
    HuffFile,
    encode_bytes,
    tree_codes,
)
from huffmandecoderongpus_tpu_torch.ops.spec_query import BLOCK_LEVELS

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


def spread_states(tab, C0: int, C1: int, NS: int, NS_to: int, seed=0):
    """(tab, C0, C1) of the wide-layout quad table ``tab`` (2 * NS, 128)
    int32 relabelled onto NS_to table chunks: every state but the root
    moves to a distinct state below 128 * NS_to (at most 1023) drawn from
    ``seed``.  The relabelled table decodes every stream as the original
    does; no byte tree has enough states to fill eight chunks itself."""
    if NS < 2 or NS_to < NS:
        raise ValueError("spread_states takes a wide-layout table")
    n = NS * 128
    top = min(128 * NS_to, 1024)
    rng = np.random.default_rng(seed)
    perm = np.zeros(n, dtype=np.int64)
    perm[1:] = rng.choice(np.arange(1, top), size=n - 1, replace=False)
    t = np.asarray(tab, dtype=np.int64) & 0xFFFFFFFF
    out = np.zeros((2 * NS_to, 128), dtype=np.int64)
    for s in range(n):
        s2 = int(perm[s])
        for b0 in (0, 1):
            w = int(t[b0 * NS + s // 128, s % 128])
            for b1 in (0, 1):
                e = (w >> (16 * b1)) & 0xFFFF
                if not e & 0x8000:  # a bare state: relabel it
                    e = int(perm[e])
                out[b0 * NS_to + s2 // 128, s2 % 128] |= e << (16 * b1)
    return (out.astype(np.uint32).view(np.int32), int(perm[C0]),
            int(perm[C1]))


#: K1's main scan (``k1_main``) at its edges (``k1_main_case``): every
#: block's limit at steps_p with its last code ending on the last bit,
#: beside pad lanes (the cheap case); the same at G = 1; text at 512
#: symbols a block ((a)'s index); md 3, 5 and 7 (SEG 96, 160 and 224: the
#: kernel's segments 24, 20 and 28 divide them); 256 symbols (md 5-6, NS 2)
#: and its table spread over eight chunks (NS 8)
K1_MAIN_CASES = ("full", "full-g1", "text-512", "md3", "md5", "md7", "ns2",
                 "ns8")


def k1_main_case(case, device):
    """(inputs, kw, hf) of one of K1_MAIN_CASES, drawn from seed 41:
    ``k1_main``'s tensors (wmat, tab, lim) on ``device``, its keyword
    arguments and the indexed stream (a HuffFile with its index)."""
    import torch

    from huffmandecoderongpus_tpu_torch.ops import widescan as ws

    rng = np.random.default_rng(41)
    if case.startswith("full"):  # 4 symbols, 2-bit codes: 128-bit blocks
        raw, k = rng.integers(0, 4, 64 * 130).astype(np.uint8), 64
    elif case == "text-512":
        raw, k = text_like(rng, 512 * 130), 512
    elif case == "md3":
        raw, k = rng.integers(65, 77, 200 * 130).astype(np.uint8), 200
    elif case in ("md5", "md7"):
        sym = 32 if case == "md5" else 128
        raw, k = rng.integers(0, sym, 256 * 130).astype(np.uint8), 256
    else:  # ns2, ns8: all 256 symbols, skewed
        w = rng.random(256) ** 3 + 1e-4
        raw = rng.choice(np.arange(256, dtype=np.uint8), size=300 * 130,
                         p=w / w.sum()).astype(np.uint8)
        k = 300
    hf = encode_bytes(raw, block_symbols=k)
    st = ws.stage_widescan_indexed(hf, *hf.index, device=device)
    wmat = ws.normalize_lane_words(st["raw"], st["sh"]).t().contiguous()
    tab, lim = st["tab"], st["lim"]
    kw = dict(steps_p=st["plan"]["steps_p"], md=st["md"], C0=st["C0"],
              C1=st["C1"], NS=st["NS"])
    if case == "ns8":
        t, C0, C1 = spread_states(tab.cpu().numpy(), st["C0"], st["C1"],
                                  st["NS"], 8)
        tab = torch.from_numpy(t).to(device)
        kw.update(C0=C0, C1=C1, NS=8)
    if case == "full-g1":
        wmat, lim = wmat[:, :1].contiguous(), lim[:1].contiguous()
    return (wmat, tab, lim), kw, hf


#: K2 (``k2_compose``) at the edges of its tiles (``k2_case``): (G, HP,
#: start, values): one lane; one tile, not a multiple of 16; a tile and a
#: part; HP 128 with start 127; entries past HP (values up to HP + 3,
#: start past HP); (a)'s shape (32 tiles, one look-back window); 65 tiles
#: (three windows for the last); maps that mostly agree, as merged chains
#: leave them
K2_CASES = ((1, 2, 1, "random"), (200, 9, 5, "random"),
            (300, 64, 0, "random"), (1024, 128, 127, "random"),
            (4096, 24, 30, "past"), (8192, 16, 0, "random"),
            (16640, 16, 3, "random"), (8192, 16, 0, "merged"))


def k2_exmap(case, device):
    """The (HP, G) int32 exit maps of one of K2_CASES on ``device``, drawn
    from seed G + HP: entry offsets below HP ("random"), up to HP + 3
    ("past"), or every row but a few lanes' equal to row 0's ("merged")."""
    import torch

    G, HP, _start, values = case
    rng = np.random.default_rng(G + HP)
    top = HP + 4 if values == "past" else HP
    ex = rng.integers(0, min(top, 128), size=(HP, G)).astype(np.int32)
    if values == "merged":
        keep = rng.random(G) < 0.02
        ex[1:, ~keep] = ex[0, ~keep]
    return torch.from_numpy(ex).to(device)


def dominant_byte(rng, n, symbols=256, weight=300.0):
    """``n`` bytes over ``symbols`` byte values, byte 0 at ``weight`` and the
    rest at 1: byte 0 takes a 1-bit code (md 1), and the tree has
    ``symbols - 1`` internal states (``chip_smoke.py``'s (c) at 256)."""
    w = np.full(symbols, 1.0)
    w[0] = weight
    return rng.choice(np.arange(symbols, dtype=np.uint8), size=n,
                      p=w / w.sum()).astype(np.uint8)


def near_uniform(rng, n, symbols):
    """``n`` bytes over ``symbols`` byte values at weights 1-2."""
    w = 1.0 + rng.random(symbols)
    return rng.choice(np.arange(symbols, dtype=np.uint8), size=n,
                      p=w / w.sum()).astype(np.uint8)


def fib_md1_stream(rng, n, n_sym=32):
    """(raw, HuffFile) of ``n`` bytes drawn from Fibonacci weights over
    ``n_sym`` symbols, with each of the 8 deepest symbols 20 times: a comb
    tree (md 1, codes up to n_sym - 1 bits), which the encoder builds from
    the weights, not the sample."""
    from huffmandecoderongpus_tpu_torch.huffio import build_tree

    fib = [1, 1]
    while len(fib) < n_sym:
        fib.append(fib[-1] + fib[-2])
    counts = np.array(fib[::-1], dtype=np.int64)
    raw = rng.choice(np.arange(n_sym, dtype=np.uint8), size=n,
                     p=counts / counts.sum()).astype(np.uint8)
    raw[rng.choice(n, size=160, replace=False)] = np.repeat(
        np.arange(n_sym - 8, n_sym, dtype=np.uint8), 20)
    freqs = np.zeros(256, dtype=np.int64)
    freqs[:n_sym] = counts
    return raw, encode_bytes(raw, tree=build_tree(freqs))


#: K1''s and K3''s edge cases (``k1p_case``; md 1 throughout): a two-leaf
#: tree (height 1: the leader alone, no follower; the cheap case); a tree of
#: exactly 128 internal states (129 symbols: the compact layout's largest,
#: NS 1) and of 255 (256 symbols, the most a byte tree has: NS 2); a comb
#: tree from Fibonacci weights (codes up to 31 bits: 30 candidate chains,
#: several followers a thread); small and odd G (1 and 37 lanes cut from a
#: staging); lanes past the stream end; a run of a 10-bit code, where
#: chains phase-lock and live for many segments; (c)'s shape at an eighth
#: of its size (its plan's team of 4); and K3' cuts on a cell boundary,
#: mid-cell and past the last segment (a full replay), set by hand
K1P_CASES = ("h1", "ns1-128", "ns2-255", "fib", "g1", "g37", "tail-4096",
             "blank", "c-small", "cut-cell", "cut-mid", "cut-full")
#: (c)'s shape at an eighth: the bytes and the lanes, which keep (c)'s ~76
#: segments a lane and a grid busy enough for its plan's team of 4
C_SMALL_BYTES, C_SMALL_LANES = 1 << 20, 4352


def k1p_case(case, device):
    """(inputs, kw, cuts, hf) of one of K1P_CASES, drawn from seed 51:
    ``k1_scan``'s tensors (wmat, tab, lim) on ``device``, its keyword
    arguments, K3''s (ent, cut, cut_slot) where the case sets them by hand
    (else None: they come from K1', K2 and ``fix_rows``) and the stream."""
    import torch

    from huffmandecoderongpus_tpu_torch.ops import widescan as ws

    rng = np.random.default_rng(51)
    G = None
    if case == "h1":
        hf = encode_bytes((rng.random(60_000) < 0.3).astype(np.uint8))
    elif case == "ns1-128":
        hf = encode_bytes(dominant_byte(rng, 60_000, 129))
    elif case == "fib":
        _raw, hf = fib_md1_stream(rng, 40_000)
    elif case == "tail-4096":
        hf = encode_bytes(dominant_byte(rng, 20_000))
        G = 4096
    elif case == "blank":
        raw = dominant_byte(rng, 200_000)
        raw[60_000:100_000] = 1  # a 10-bit code, over and over
        hf = encode_bytes(raw)
    elif case == "c-small":
        hf = encode_bytes(dominant_byte(rng, C_SMALL_BYTES))
        G = C_SMALL_LANES
    else:  # ns2-255, g1, g37 and the cuts: 256 symbols
        hf = encode_bytes(dominant_byte(rng, 40_000))
    st = (staging_at(hf, G, device) if G is not None
          else ws.stage_widescan_inputs(hf, device=device))
    p = st["plan"]
    wmat = ws.words_matrix(st["words"], -(-p["steps_p"] // 32))
    tab, lim = st["tab"], st["lim"]
    if case in ("g1", "g37"):  # a lane's K1 reads its own column only
        n = int(case[1:])
        wmat, lim = wmat[:, :n].contiguous(), lim[:n].contiguous()
    kw = dict(B=p["B"], H=st["H"], steps=p["steps"], steps_p=p["steps_p"],
              SEG=p["SEG"], md=st["md"], NS=st["NS"])
    cuts = None
    if case.startswith("cut-"):
        Gl = lim.shape[0]
        ent = rng.integers(0, st["H"], Gl)
        if case == "cut-full":  # past the last segment: every cell
            cut = np.full(Gl, p["steps_p"] + 1)
        else:  # past the entry, on a cell's first slot or its third
            k = rng.integers(st["H"] // 4 + 1, p["steps_p"] // 4, Gl)
            cut = 4 * k + (2 if case == "cut-mid" else 0)
        cut = np.where(rng.random(Gl) < 0.1, 0, cut)
        cuts = tuple(torch.from_numpy(a.astype(np.int32)).to(device)
                     for a in (ent, cut, cut))
    return (wmat, tab, lim), kw, cuts, hf


def k3p_inputs(inputs, kw, cuts):
    """K3''s (ent, cut, cut_slot, sym, val) on a K1P case: its own cuts or
    those the plain K1', K2 and ``fix_rows`` give, and the plain K1''s
    cells (which K3' splices in place: callers clone them)."""
    from huffmandecoderongpus_tpu_torch.ops import k1_scan, k2_compose
    from huffmandecoderongpus_tpu_torch.ops import widescan as ws

    wmat, tab, lim = inputs
    sym, val, _cntmap, exmap, mrowmap = k1_scan.k1_scan_ref(wmat, tab, lim,
                                                            **kw)
    if cuts is None:
        entry, _tot = k2_compose.k2_compose_ref(exmap, 0)
        cut, cut_slot = ws.fix_rows(entry, mrowmap, lim, kw["H"], 1)
        cuts = (entry, cut, cut_slot)
    return (*cuts, sym, val)


#: K3's edge cases (``k3_case``; md >= 2): text at G 512 with the cuts the
#: plain K1, K2 and ``fix_rows`` give (md 2, NS 1; the cheap case); md 3
#: (12-bit cells across word boundaries) at G 200, not a multiple of 128;
#: md 4, 5 and 7 (SEG 32, 20 and 28); 256 symbols (two table chunks, NS 2)
#: and their table spread over eight (NS 8); md 8 (NS 2, a word a cell); and
#: the batch's K3 on two streams of different trees in adjacent 128-lane
#: blocks (``k3_fix2_c01``), with its own cuts and with hand-set ones.  The
#: hand-set cuts take entries from 0 to 2H, odd ones among them, a lane in
#: seven on a word's last bit (31 or 63), cut slots on a cell's first slot
#: ("cell"), inside a cell ("mid") or past the last segment ("full"), a lane
#: in ten with cut 0, and random old cells
K3_CASES = ("text-512", "md3-g200", "md4-cell", "md5-mid", "md6-ns2",
            "ns8-mid", "md7-full", "md8-cell", "batch-pair", "batch-mid")
#: the hand-set cuts of each case that has them
K3_CUTS = {"md3-g200": "mid", "md4-cell": "cell", "md5-mid": "mid",
           "md6-ns2": "mid", "ns8-mid": "mid", "md7-full": "full",
           "md8-cell": "cell", "batch-mid": "mid"}


def k3_cuts(rng, G, H, steps_p, md, how):
    """(ent, cut, cut_slot) (G,) int64 set by hand (see K3_CASES); cut_slot
    is the first md-slot at or past the cut, as ``fix_rows`` makes it."""
    ent = rng.integers(0, 2 * max(H, 2), G)
    ent[::7] = np.where(rng.random(ent[::7].size) < 0.5, 31, 63)
    cells = steps_p // (4 * md)
    if how == "full":  # past the last segment: every cell of the lane
        cs = np.full(G, cells * 4 + 1 + rng.integers(0, 9))
        cut = md * cs
    else:
        cs = 4 * rng.integers(1, cells, G)
        if how == "mid":
            cs = cs - rng.integers(1, 4, G)
        cut = md * cs - rng.integers(0, md, G)  # ceil(cut / md) == cs
    off = rng.random(G) < 0.1
    cut = np.where(off, 0, cut)
    return ent, cut, np.where(off, 0, cs)


def k3_case(case, device):
    """(kernel, inputs, kw, hfs) of one of K3_CASES, drawn from seed 61: the
    K3 wrapper that takes it ("k3_fix2", or "k3_fix2_c01" for the batch),
    its tensors on ``device`` in the wrapper's order (wmat, tab, ent, cut,
    cut_slot, sym, val, and c01, bstream for the batch), its keyword
    arguments and the streams (a list of HuffFiles).  sym/val are the plain
    K1's cells where the cuts are K1's, else random (nibbles in val); the
    kernel splices them in place, so callers clone them."""
    import torch

    from huffmandecoderongpus_tpu_torch.ops import batch, k1_scan2
    from huffmandecoderongpus_tpu_torch.ops import k1_scan2_c01, k2_compose
    from huffmandecoderongpus_tpu_torch.ops import widescan as ws

    rng = np.random.default_rng(61)
    how = K3_CUTS.get(case)
    if case.startswith("batch"):
        hfs = [encode_bytes(text_like(rng, n, k))
               for n, k in ((20_000, 84), (12_000, 40))]
        st = batch.stage_batch_inputs(hfs, device="cpu")
        p = st["plan"]
        tab, extra = st["tabs"], (st["c01"], st["bstream"])
        kw = dict(steps_p=p["steps_p"], SEG=p["SEG"], md=st["md"])
        kernel = "k3_fix2_c01"
    else:
        G = 512
        if case == "text-512":
            raw = text_like(rng, 20_000)
        elif case == "md3-g200":
            raw, G = rng.integers(65, 77, 30_000).astype(np.uint8), 256
        elif case[:3] in ("md4", "md5", "md7", "md8"):
            n_sym = 1 << int(case[2])
            raw = rng.integers(0, n_sym, 40_000).astype(np.uint8)
        else:  # md6-ns2, ns8-mid: all 256 symbols, skewed
            w = rng.random(256) ** 3 + 1e-4
            raw = rng.choice(np.arange(256, dtype=np.uint8), size=40_000,
                             p=w / w.sum()).astype(np.uint8)
        hfs = [encode_bytes(raw)]
        st = staging_at(hfs[0], G, "cpu")
        p = st["plan"]
        tab, extra = st["tab"], ()
        kw = dict(steps_p=p["steps_p"], SEG=p["SEG"], md=st["md"],
                  C0=st["C0"], C1=st["C1"], NS=st["NS"])
        if case == "ns8-mid":
            t, C0, C1 = spread_states(tab.numpy(), st["C0"], st["C1"],
                                      st["NS"], 8)
            tab = torch.from_numpy(t)
            kw.update(C0=C0, C1=C1, NS=8)
        kernel = "k3_fix2"
    wmat = ws.words_matrix(st["words"], -(-p["steps_p"] // 32))
    G = wmat.shape[1]
    if how is None:  # the cuts K1, K2 and fix_rows give
        k1 = dict(B=p["B"], H=st["H"], steps=p["steps"],
                  steps_p=p["steps_p"], SEG=p["SEG"], md=st["md"])
        if extra:
            sym, val, _cnt, exmap, mrowmap = k1_scan2_c01.k1_scan2_c01_ref(
                wmat, tab, st["lim"], *extra, **k1)
            exmap[:, list(st["last_live"])] = 0
        else:
            sym, val, _cnt, exmap, mrowmap = k1_scan2.k1_scan2_ref(
                wmat, tab, st["lim"], C0=kw["C0"], C1=kw["C1"], NS=kw["NS"],
                **k1)
        entry, _tot = k2_compose.k2_compose_ref(exmap, 0)
        cuts = ws.fix_rows(entry, mrowmap, st["lim"], st["H"], st["md"])
        cuts = (entry, *cuts)
    else:
        cuts = tuple(torch.from_numpy(a.astype(np.int32)) for a in k3_cuts(
            rng, G, st["H"], p["steps_p"], st["md"], how))
        cells = p["steps_p"] // (4 * st["md"])
        sym = torch.from_numpy(rng.integers(-2**31, 2**31, (cells, G))
                               .astype(np.int32))
        val = torch.from_numpy(rng.integers(0, 16, (cells, G))
                               .astype(np.uint8))
    if case == "md3-g200":  # a lane's K3 reads its own column only
        wmat, sym, val = (t[:, :200].contiguous() for t in (wmat, sym, val))
        cuts = tuple(t[:200].contiguous() for t in cuts)
    inputs = (wmat, tab, *cuts, sym, val, *extra)
    return kernel, tuple(t.to(device) for t in inputs), kw, hfs


#: the encoder's edge cases (``e_case``): every one of the 256 symbols; the
#: longest codes E1 takes (26 bits, both halves 13, from Fibonacci weights
#: over 27 symbols); a one-symbol tree (a 1-bit code); 40 symbols over 128
#: lanes (88 lanes with no symbol); 32 lanes of exactly 32 symbols but the
#: last (E1's last row block starts in every lane's pad rows); a text
#: stream at 512 lanes (row blocks start inside a granule); and the
#: Fibonacci stream whose tail lanes overflow their dense rows (ranks past
#: ORP).  E2 also runs each at a smaller ORP (``E_SMALL_ORP``)
E_CASES = ("alpha256", "code26", "one-symbol", "nval0", "pad-start", "g512",
           "fib600")
#: an ORP that cuts the longest rows of most cases, not a multiple of 4
E_SMALL_ORP = 37


def fib_tree_stream(rng, n_sym, body, deep):
    """(raw, tree) over a tree built from Fibonacci weights over ``n_sym``
    symbols (not the sample, so the deepest symbol keeps its code): a body
    of ``body`` symbols drawn from the weights, then ``deep`` copies of the
    deepest symbol."""
    from huffmandecoderongpus_tpu_torch.huffio import build_tree

    fib = [1, 1]
    while len(fib) < n_sym:
        fib.append(fib[-1] + fib[-2])
    counts = np.array(fib[::-1], dtype=np.int64)
    head = rng.choice(np.arange(n_sym, dtype=np.uint8), size=body,
                      p=counts / counts.sum()).astype(np.uint8)
    raw = np.concatenate([head, np.full(deep, n_sym - 1, dtype=np.uint8)])
    freqs = np.zeros(256, dtype=np.int64)
    freqs[:n_sym] = counts
    return raw, build_tree(freqs)


def e_case(case, device):
    """(raw, tree or None, lanes, staged encoder inputs on ``device``) of
    one of E_CASES, drawn from seed 14 (``encode.stage_encode_inputs``)."""
    from huffmandecoderongpus_tpu_torch.ops import encode

    rng = np.random.default_rng(14)
    tree, lanes = None, None
    if case == "alpha256":
        w = rng.random(256) ** 3 + 1e-4
        raw = np.concatenate([
            np.arange(256, dtype=np.uint8),
            rng.choice(np.arange(256, dtype=np.uint8), size=19744,
                       p=w / w.sum()).astype(np.uint8)])
    elif case == "code26":
        raw, tree = fib_tree_stream(rng, 27, 4000, 200)
        lanes = 128
    elif case == "one-symbol":
        raw = np.full(5000, 65, dtype=np.uint8)
    elif case == "nval0":
        raw, lanes = text_like(rng, 40), 128
    elif case == "pad-start":
        raw, lanes = text_like(rng, 32 * 32 - 10), 32
    elif case == "g512":
        raw, lanes = text_like(rng, 512 * 100), 512
    elif case == "fib600":
        raw, tree = fib_tree_stream(rng, 26, 16000, 600)
        lanes = 128
    else:
        raise ValueError(f"unknown encoder case {case!r}")
    st = encode.stage_encode_inputs(raw, tree=tree, lanes=lanes,
                                    device=device)
    return raw, tree, lanes, st


#: E3's own edge cases (``e3_case``): lanes of 1-5 bits, three and more in
#: one granule; one granule shared by 16 lanes; runs of empty lanes, one of
#: 70 between two lanes that meet in a granule (past the 32 lanes a block
#: stages after its tile); a lane clamped at ORP (its count past ORP); no
#: bits at all; 1,000 lanes of 0-300 bits over many tiles, the last short;
#: and an odd lane count.  Each lists its lanes' bit counts and its ORP.
E3_CASES = ("tiny-lanes", "share16", "empty-runs", "clamped", "no-bits",
            "many-lanes", "odd-g")


def e3_lanes(rng, lane_bits, ORP):
    """E3's inputs for lanes of ``lane_bits`` code bits cut from one random
    bit stream, as E1 and E2 give them: (denseT (G, ORP) int32, each lane's
    bits from granule 0, zero past its count; cnt (G,) int32, its granules
    ceil(L / 16), past ORP where it is clamped; bits (G,) int32; NROWS, with
    the encoder's slack of ORPW + 8 rows; granules (n,) int64, the whole
    stream's u16 granules, the payload when no lane is clamped)."""
    L = np.asarray(lane_bits, dtype=np.int64)
    P = np.cumsum(L) - L
    total = int(L.sum())
    n = -(-total // 16)
    bit = rng.integers(0, 2, size=n * 16 + 16).astype(np.int64)
    bit[total:] = 0
    gran = (bit[:n * 16].reshape(n, 16) << np.arange(16)).sum(axis=1)
    G = L.size
    cnt = -(-L // 16)
    denseT = np.zeros((G, ORP), dtype=np.int64)
    for g in range(G):
        k = min(int(cnt[g]), ORP)
        lane = np.zeros(16 * int(cnt[g]), np.int64)
        lane[:L[g]] = bit[P[g]:P[g] + L[g]]
        denseT[g, :k] = (lane[:16 * k].reshape(k, 16)
                         << np.arange(16)).sum(axis=1)
    NROWS = (-(-n // 128) + -(-ORP // 128) + 8) // 8 * 8
    return (denseT.astype(np.int32), cnt.astype(np.int32),
            L.astype(np.int32), NROWS, gran)


def e3_case(case, device):
    """(denseT, cnt, bits, NROWS, granules) of one of E3_CASES on
    ``device`` (granules stays numpy), drawn from seed 17 (``e3_lanes``)."""
    import torch

    rng = np.random.default_rng(17)
    ORP = 128
    if case == "tiny-lanes":
        L = [5, 1, 2, 3, 1, 40, 0, 0, 3, 3, 3, 3, 16, 16, 15, 1, 33]
    elif case == "share16":
        L = [1] * 40 + [300, 17, 2] + [0] * 85
    elif case == "empty-runs":
        L = ([7] + [0] * 70 + [5] + [0] * 3 + [20] + [0] * 40 + [2, 30]
             + [0] * 33 + [9] + [0] * 10)
    elif case == "clamped":
        L = [3000, 5, 17, 0, 40, 2100, 2048, 2049, 7]
    elif case == "no-bits":
        L = [0] * 300
    elif case == "many-lanes":
        L = rng.integers(0, 301, 1000)
        L[-1] = 3
    elif case == "odd-g":
        L = rng.integers(0, 40, 77)
    else:
        raise ValueError(f"unknown E3 case {case!r}")
    denseT, cnt, bits, NROWS, gran = e3_lanes(rng, L, ORP)
    return (*(torch.from_numpy(a).to(device) for a in (denseT, cnt, bits)),
            NROWS, gran)


#: ``lane_scan_indexed``'s edge cases (``indexed_scan_case``): G = 1, 3, 31
#: and 33 (past one block of 32, not a multiple of 4: byte copies); an
#: index's lanes untiled (G odd: byte copies) and tiled (padded to 1,024
#: with zero-length lanes); B under one tile and not a multiple of 8; an
#: md = 1 tree; a 255-state table padded to 16 chunks (1,023 states: the
#: 2-bit table's 16 KB shrink the tiles); copies of the matrix at 1 and 4
#: bytes past an aligned address.  Lane lengths 0, 1, B, B - 1 and 7 lead,
#: the rest are drawn
INDEXED_SCAN_CASES = ("g1", "g3", "g31", "g33", "index-odd", "index-tiled",
                      "short-b", "md1", "16-chunks", "view+1", "view+4")
#: ``short_candidate_scan``'s edge cases (``short_scan_case``): a text
#: stream's sync geometry at W = H + 1, 128 (the first round, one tile) and
#: every row (steps = B + H, past one tile); the stream end cut mid-lane
#: (the last lanes dead); a comb tree 140 tall (L shrinks to 4); chains
#: that never resolve within W (the 0-chain never emits); merges and exits
#: on the same row (the two-leaf tree: a chain emits every row); the
#: 0-chain's emissions as bool and both matrices 1 byte past an aligned
#: address
SHORT_SCAN_CASES = ("w=h+1", "w=128", "w=steps", "cut", "tall",
                    "unresolved", "merge+exit", "bool+view")


def _padded_table(tree, chunks=None):
    from huffmandecoderongpus_tpu_torch.ops import lanedfa

    tab = lanedfa.pad_table(lanedfa.build_lane_dfa(tree).entry)
    if chunks is not None:
        wide = np.zeros((chunks, tab.shape[1]), dtype=np.int32)
        wide[:tab.shape[0]] = tab
        tab = wide
    return tab


def _view(t, off):
    """A copy of ``t`` ``off`` bytes past an aligned address."""
    import torch

    flat = torch.empty(t.numel() + off, dtype=t.dtype, device=t.device)
    v = flat[off:].view(t.shape)
    v.copy_(t)
    return v


def indexed_scan_case(case, device):
    """(bits, tab, lane_len) of one of INDEXED_SCAN_CASES on ``device``,
    drawn from seed 15: ``lane_scan_indexed``'s inputs."""
    import torch

    from huffmandecoderongpus_tpu_torch.ops import lanedfa_decode as ld

    rng = np.random.default_rng(15)
    if case.startswith("index-"):
        hf = encode_bytes(text_like(rng, 40_000), block_symbols=256)
        st = ld.stage_lanedfa_indexed(hf, hf.index[0], device=device,
                                      tiled=case == "index-tiled")
        return st["bits"], st["tab"], st["lane_len"]
    G, B = {"g1": (1, 300), "g3": (3, 301), "g31": (31, 203),
            "g33": (33, 200), "short-b": (40, 13), "md1": (17, 517),
            "16-chunks": (36, 290)}.get(case, (64, 300))
    if case == "md1":
        tree = encode_bytes(dominant_byte(rng, 20_000, 16)).tree
    elif case == "16-chunks":
        tree = encode_bytes(dominant_byte(rng, 40_000)).tree
    else:
        tree = encode_bytes(text_like(rng, 20_000)).tree
    tab = _padded_table(tree, 16 if case == "16-chunks" else None)
    lens = rng.integers(0, B + 1, G)
    lens[:min(G, 5)] = [0, 1, B, B - 1, 7][:min(G, 5)]
    bits = torch.from_numpy(rng.integers(0, 2, (B, G), dtype=np.uint8))
    out = (bits.to(device), torch.from_numpy(tab).to(device),
           torch.from_numpy(lens.astype(np.int32)).to(device))
    if case.startswith("view+"):
        out = (_view(out[0], int(case[5:])), *out[1:])
    return out


def short_scan_case(case, device):
    """(bits, tab, valid0, kw) of one of SHORT_SCAN_CASES on ``device``,
    drawn from seed 16: ``short_candidate_scan``'s inputs and its keyword
    arguments (B, H, N, W).  valid0 is the plain lane scan's from offset 0
    in lane_dfa_sync's geometry, or set by hand."""
    import torch

    from huffmandecoderongpus_tpu_torch.ops import lane_scan
    from huffmandecoderongpus_tpu_torch.ops import lanedfa_decode as ld

    rng = np.random.default_rng(16)
    if case in ("unresolved", "merge+exit"):
        if case == "unresolved":  # no 0-chain emission, no row near B
            G, B, H, W = 20, 1000, 9, 130
            tree = encode_bytes(text_like(rng, 20_000)).tree
        else:  # a chain emits every row; row B - 1 merges or exits
            G, B, H, W = 40, 24, 2, 26
            tree = encode_bytes((rng.random(1000) < 0.3).astype(
                np.uint8)).tree
        bits = torch.from_numpy(rng.integers(0, 2, (B + H, G),
                                             dtype=np.uint8))
        valid0 = torch.zeros((B + H, G), dtype=torch.uint8)
        if case == "merge+exit":
            valid0[B - 1] = 1
            valid0[B - 1, ::3] = 0  # every third lane exits instead
        return (bits.to(device), torch.from_numpy(_padded_table(tree)).to(
            device), valid0.to(device), dict(B=B, H=H, N=G * B, W=W))
    if case == "tall":
        _raw, hf = comb_stream(141, 3000, seed=16)
        lanes = 8
    elif case == "cut":
        hf = encode_bytes(near_uniform(rng, 20_000, 12))
        lanes = 33
    else:
        hf = encode_bytes(text_like(rng, 20_000))
        lanes = 16
    st = ld.stage_lanedfa(hf, device=device, lanes=lanes, tiled=False)
    bits, tab, B, H = st["bits"], st["tab"], st["B"], st["H"]
    N = st["N"] - (B + B // 3 if case == "cut" else 0)
    steps = bits.shape[0]
    zero = torch.zeros(bits.shape[1], dtype=torch.int32, device=device)
    valid0 = lane_scan.lane_scan_ref(bits, tab, zero, B=B, H=H, N=N)[1]
    W = {"w=h+1": H + 1, "w=steps": steps, "tall": steps}.get(
        case, min(128, steps))
    if case == "bool+view":
        bits, valid0 = _view(bits, 1), _view(valid0 != 0, 1)
    return bits, tab, valid0, dict(B=B, H=H, N=N, W=W)


#: the dense lane decode's edge cases (``dense_case``): G = 1, 3, 20 (one
#: block under 32 lanes: byte flushes), 33 (a block of one lane) and 100
#: (4-lane flushes, a last block of 4); out_rows under the lanes' counts;
#: lanes that finish early (the stream end cut, entries past it); a lane
#: forced WINDOW ranks ahead (its bits the 1-bit code of an md = 1 tree,
#: every row an emission, beside lanes of 9-bit codes); the bit matrix one
#: byte past an aligned address
DENSE_CASES = ("g1", "g3", "g20", "g33", "g100", "short-rows", "early",
               "ahead", "view+1")


def dense_case(case, device):
    """(bits, tab, start, kw) of one of DENSE_CASES on ``device``, drawn
    from seed 18: ``lane_decode_dense``'s inputs and keywords (B, H, N,
    out_rows)."""
    import torch

    rng = np.random.default_rng(18)
    G, B = {"g1": (1, 300), "g3": (3, 301), "g20": (20, 250),
            "g33": (33, 200), "g100": (100, 160), "ahead": (40, 2048),
            "view+1": (64, 130)}.get(case, (64, 300))
    if case == "ahead":
        hf = encode_bytes(dominant_byte(rng, 20_000))
    else:
        hf = encode_bytes(text_like(rng, 20_000))
    tab = _padded_table(hf.tree)
    from huffmandecoderongpus_tpu_torch.ops import lanedfa

    dfa = lanedfa.build_lane_dfa(hf.tree)
    H = max(dfa.height, 1)
    bits = rng.integers(0, 2, (B + H, G), dtype=np.uint8)
    start = rng.integers(0, H, G).astype(np.int32)
    N = G * B
    out_rows = B + H
    if case == "ahead":  # lane 5 emits byte 0's 1-bit code every row
        code, length, _present = tree_codes(hf.tree)
        assert length[0] == 1
        bits[:, 5] = code[0] & 1
        start[5] = 0
    elif case == "short-rows":
        out_rows = B // 20
    elif case == "early":
        N = G * B - 3 * B - 50  # the last lanes end early or have no rows
        start[G - 3] = B + H - 1
    out = (torch.from_numpy(bits).to(device), torch.from_numpy(tab).to(device),
           torch.from_numpy(start).to(device))
    if case == "view+1":
        out = (_view(out[0], 1), *out[1:])
    return (*out, dict(B=B, H=H, N=N, out_rows=out_rows))


#: ``compact``'s edge cases (``compact_case``; the kernel's tiles are 32
#: columns by chunks of 1,024 rows): G not a multiple of the tile (1, 33,
#: 4,095); steps under one chunk and not a multiple of it; out_rows 0,
#: under some columns' counts and over steps; a column that never emits
#: beside one that emits every row; a tile whose columns' ranks lie more
#: than two chunks apart (a run of columns emitting every row beside
#: columns emitting a tenth of them, as at (d)'s blank-run edges); cum one
#: element past an aligned address (no 16-byte loads)
COMPACT_CASES = ("g1", "g33", "g4095", "short", "odd-steps", "rows0",
                 "rows-under", "rows-over", "never+always", "wide",
                 "offset")


def compact_case(case, device):
    """(cum, sym, out_rows) of one of COMPACT_CASES on ``device``, drawn
    from seed 19: ``cum`` (steps, G) int32 the running count of a 0/1
    ``valid`` (rising by 0 or 1 a row, ``compact``'s contract), ``sym``
    (steps, G) uint8."""
    import torch

    rng = np.random.default_rng(19)
    steps, G = {"g1": (200, 1), "g33": (150, 33), "g4095": (70, 4095),
                "short": (5, 256), "odd-steps": (2100, 96),
                "wide": (3500, 96), "offset": (90, 1024)}.get(case,
                                                              (100, 160))
    p = 0.1 if case == "wide" else 0.5
    valid = rng.random((steps, G)) < p
    if case == "never+always":
        valid[:, 3], valid[:, 4] = False, True
    elif case == "wide":  # columns 34-50 emit every row, their tile's
        valid[:, 34:51] = True  # other columns a tenth of them
    cum = np.cumsum(valid, axis=0, dtype=np.int32)
    sym = rng.integers(0, 256, (steps, G), np.uint8)
    out_rows = {"rows0": 0, "rows-under": 50, "rows-over": steps + 37,
                "short": steps, "wide": steps}.get(case, steps // 2 + 2)
    cum_t = torch.from_numpy(cum).to(device)
    if case == "offset":
        cum_t = _view(cum_t, 1)
    return cum_t, torch.from_numpy(sym).to(device), out_rows


#: P4's (``k4_stripped``) edge cases (``p4_case``): cells_p under one
#: window, exactly two, and (a)'s 412; G = 64 (the smallest G, two blocks of
#: 32 lanes); ORP = 128 (no zero columns) and 132 (4-byte stores); nib all
#: 0xFF (every popcount 4: the sums wrap a byte, the high bits masked);
#: negative sym; both inputs one element past an aligned address (a lane a
#: thread)
P4_CASES = ("cells100", "cells256", "cells412", "g64", "orp128", "orp132",
            "nib-ff", "neg-sym", "offset")


def p4_case(case, device, G=None):
    """(sym (cells_p, G) int32, nib (cells_p, G) uint8, ORP) of one of
    P4_CASES on ``device``, drawn from seed 20; ``G`` replaces the case's
    lanes (a multiple of 64; the scripts' kernel takes multiples of
    128)."""
    import torch

    rng = np.random.default_rng(20)
    cells_p = {"cells100": 100, "cells256": 256, "cells412": 412,
               "orp128": 300, "orp132": 140}.get(case, 150)
    G = G or (64 if case == "g64" else 256)
    ORP = {"orp128": 128, "orp132": 132, "cells412": 1024}.get(case, 256)
    sym = rng.integers(0, 2**31, (cells_p, G), dtype=np.int64).astype(
        np.int32)
    nib = rng.integers(0, 256, (cells_p, G)).astype(np.uint8)
    if case == "nib-ff":
        nib[:] = 0xFF
    sym[rng.random(sym.shape) < (1.0 if case == "neg-sym" else 0.3)] *= -1
    sym_t, nib_t = (torch.from_numpy(sym).to(device),
                    torch.from_numpy(nib).to(device))
    if case == "offset":
        sym_t, nib_t = _view(sym_t, 1), _view(nib_t, 1)
    return sym_t, nib_t, ORP


#: the speculative pipeline's edge cases beside its tiny inputs: S2's tile
#: launch on a tile the case gives (None: the plan's own), so that a stream
#: takes several blocks, its bits are no multiple of the tile ("-t<tile>"),
#: or are one ("h1-t16"), or a block before the last has its halo run past
#: the stream's end and the last block is a sliver ("halo-past"); trees 14,
#: 15, 17, 20 and 22 tall (S1's table whole in shared memory up to 14, in
#: two levels above; S4's read from device memory above 16; S2 at those
#: heights); S3's block of 2^BLOCK_LEVELS outputs: text one output under,
#: at and one over it ("text-block-1", "text-block", "text-block+1"), and
#: text of 3 blocks and 5 outputs cut short so that a taken -1 span falls
#: in the last block's prefix ("cut-prefix", the first codeword that does
#: not fit 10 before the end) or only in its levels below the block's
#: ("cut-low", 3 before the end): raw None, found_size -1
SPEC_CASES = ("text-halo-past", "text-t2048", "u12-t2048", "alpha-t8192",
              "h1-t16", "fib14", "fib15", "fib17", "fib20", "fib22",
              "text-block-1", "text-block", "text-block+1", "cut-prefix",
              "cut-low")
#: S3's block (csrc/spec_query.cu B) and the cut cases' size
QUERY_BLOCK = 1 << BLOCK_LEVELS
CUT_SIZE = 3 * QUERY_BLOCK + 5


def cut_stream(raw, first_out):
    """The HuffFile of ``raw`` cut so that codeword ``first_out`` is the
    first that runs past ``bits`` (one bit short of its end), the header's
    size kept."""
    hf = encode_bytes(raw)
    ends = np.cumsum(tree_codes(hf.tree)[1][raw].astype(np.int64))
    bits = int(ends[first_out]) - 1
    return HuffFile(tree=hf.tree, bits=bits,
                    uncompressed_size=hf.uncompressed_size,
                    payload=hf.payload[:(bits + 7) // 8])


#: S1 on tables less some codes (a SPEC_CASES case, the code lengths of
#: the codes taken out): windows that match no code, whole in shared
#: memory (height 10) and in two levels (15, 20)
NO_CODE_CASES = (("text-block+1", (3, 9)), ("fib15", (2, 15)),
                 ("fib20", (1, 17, 20)))


def table_without_codes(tree, lengths):
    """(height, sym, length) numpy of ``tree``'s decode table less the code
    of the first symbol of each length in ``lengths``: length and symbol 0
    at every window of those codes, as an incomplete tree's table has
    them."""
    from huffmandecoderongpus_tpu_torch.ops.lut import build_decode_lut

    table = build_decode_lut(tree)
    code, length, present = tree_codes(tree)
    sym, ln = table.sym.copy(), table.length.copy()
    for L in lengths:
        c = int(np.flatnonzero(present & (length == L))[0])
        at = np.arange(int(code[c]), 1 << table.height, 1 << L)
        sym[at], ln[at] = 0, 0
    return table.height, sym, ln


def spec_case(case):
    """(raw, HuffFile, tile or None) of a SPEC_CASES case, from seed
    SEED + 20; raw is None for the cut cases."""
    rng = np.random.default_rng(SEED + 20)
    if case.startswith("fib"):
        raw, tree = fib_tree_stream(rng, int(case[3:]) + 1, 4000, 40)
        return raw, encode_bytes(raw, tree), None
    if case.startswith("cut"):
        raw = text_like(rng, CUT_SIZE)
        return None, cut_stream(raw, CUT_SIZE - (10 if case == "cut-prefix"
                                                 else 3)), None
    if case.startswith("text-block"):
        raw = text_like(rng, QUERY_BLOCK + int(case[10:] or 0))
        return raw, encode_bytes(raw), None
    if case == "h1-t16":
        raw = np.frombuffer(b"ab" * 40, dtype=np.uint8)
    elif case.startswith("text"):
        raw = text_like(rng, 3000)
    elif case.startswith("u12"):
        raw = near_uniform(rng, 4000, 12)
    else:  # all 256 symbols, skewed
        w = rng.random(256) ** 3 + 1e-4
        raw = rng.choice(np.arange(256, dtype=np.uint8), size=5000,
                         p=w / w.sum()).astype(np.uint8)
    hf = encode_bytes(raw)
    if case == "text-halo-past":  # bits = 3 tiles and 100-123 offsets
        return raw, hf, (hf.bits - 100) // 24 * 8
    return raw, hf, int(case.rsplit("-t", 1)[1])

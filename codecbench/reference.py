"""The plain reference: Huffman trees, an encoder in plain torch and a
serial decoder in numpy.

Frozen here so that the yardstick does not move with the program: the
tree builder and the code table are copies of the port's
``huffio.build_tree`` and ``huffio.tree_codes`` as of this benchmark's
first version (same deterministic ties, so the same tree for the same
histogram), and the container's bit order is the same (bit p of the
stream is bit ``p % 8`` of byte ``p // 8``).  Nothing here imports the
program.
"""

from __future__ import annotations

import heapq

import numpy as np
import torch

LEAF = -1
MAX_CODE_LEN = 31


def build_tree(freqs) -> np.ndarray:
    """Huffman tree over byte frequencies as an (nodes, 3) int32 node array
    [sym, izero, ione], root at 0, the rest breadth-first; leaves have
    izero == ione == -1.  Ties go to the lowest symbol or the earliest-made
    node; a single symbol gets a padding sibling."""
    freqs = np.asarray(freqs, dtype=np.int64)
    syms = [int(s) for s in np.nonzero(freqs)[0]]
    if not syms:
        raise ValueError("cannot build a Huffman tree for empty input")
    if len(syms) == 1:
        syms = sorted([syms[0], 0 if syms[0] != 0 else 1])
    heap = [(int(freqs[s]), i, i) for i, s in enumerate(syms)]
    heapq.heapify(heap)
    children: dict[int, tuple[int, int]] = {}
    next_id = len(syms)
    while len(heap) > 1:
        f0, _, a = heapq.heappop(heap)
        f1, _, b = heapq.heappop(heap)
        children[next_id] = (a, b)
        heapq.heappush(heap, (f0 + f1, next_id, next_id))
        next_id += 1
    order, head = [heap[0][2]], 0
    while head < len(order):
        order += children.get(order[head], ())
        head += 1
    index_of = {t: i for i, t in enumerate(order)}
    tree = np.empty((len(order), 3), dtype=np.int32)
    for t, i in index_of.items():
        if t in children:
            z, o = children[t]
            tree[i] = (0, index_of[z], index_of[o])
        else:
            tree[i] = (syms[t], LEAF, LEAF)
    return tree


def tree_codes(tree: np.ndarray):
    """``(code, length, present)``, each of size 256: bit k of ``code[s]``
    is the k-th edge from the root to symbol s's leaf."""
    code = np.zeros(256, dtype=np.int64)
    length = np.zeros(256, dtype=np.int64)
    present = np.zeros(256, dtype=bool)
    stack = [(0, 0, 0)]
    while stack:
        node, prefix, depth = stack.pop()
        if tree[node, 1] == LEAF:
            sym = int(tree[node, 0]) & 0xFF
            if present[sym]:
                raise ValueError(f"symbol {sym} appears at two leaves")
            if depth > MAX_CODE_LEN:
                raise ValueError(f"code length {depth} exceeds {MAX_CODE_LEN}")
            code[sym], length[sym], present[sym] = prefix, depth, True
        else:
            stack.append((int(tree[node, 1]), prefix, depth + 1))
            stack.append((int(tree[node, 2]), prefix | (1 << depth),
                          depth + 1))
    return code, length, present


def code_stats(tree: np.ndarray, hist) -> dict:
    """What the code asks of a decoder: height, minimum depth, internal
    nodes (the lane DFA's states) and the stream's bits for ``hist``."""
    _code, length, present = tree_codes(tree)
    hist = np.asarray(hist, dtype=np.int64)
    return dict(height=int(length[present].max()),
                min_depth=int(length[present].min()),
                states=int((tree[:, 1] != LEAF).sum()),
                bits=int(hist @ length))


def encode(data: torch.Tensor, tree: np.ndarray | None = None):
    """Encode a uint8 tensor (any device) with ``tree``, or with the tree of
    its own histogram.  Returns ``(tree, bits, payload)``: the payload a
    uint8 tensor of ceil(bits/8) bytes on the data's device.

    Plain torch: every symbol's code length and offset (an int64 cumsum),
    then ``_pack``."""
    if data.dtype != torch.uint8 or data.dim() != 1 or data.numel() == 0:
        raise ValueError("encode takes a non-empty 1-D uint8 tensor")
    dev = data.device
    hist = torch.bincount(data, minlength=256).cpu().numpy()
    if tree is None:
        tree = build_tree(hist)
    code, length, present = tree_codes(tree)
    sym = data.long()
    if np.any((hist > 0) & ~present):
        raise ValueError("tree has no code for a symbol of the data")
    lens = torch.from_numpy(length).to(dev)[sym]
    codes = torch.from_numpy(code).to(dev)[sym]
    del sym
    offs = torch.cumsum(lens, 0) - lens
    bits = int(hist @ length)
    return tree, bits, _pack(lens, codes, offs, bits)


def lane_aligned_encode(data: torch.Tensor, tree: np.ndarray, lanes: int):
    """The control of the encode cell: ``encode`` with the guarantee that
    the payload is one contiguous bitstream broken.  The data is cut into
    ``lanes`` runs of ceil(n / lanes) symbols, and each run's codes start
    at the next 16-bit boundary instead of right after the last run's.
    Returns ``(tree, bits, payload)`` like ``encode``."""
    code, length, _present = tree_codes(tree)
    dev = data.device
    n = data.numel()
    per = -(-n // lanes)
    lens = torch.from_numpy(length).to(dev)[data.long()]
    lane = torch.arange(n, device=dev) // per
    lane_bits = torch.zeros(lanes, dtype=torch.int64, device=dev)
    lane_bits.index_add_(0, lane, lens)
    padded = (lane_bits + 15) // 16 * 16
    lane_start = torch.cumsum(padded, 0) - padded
    offs = torch.cumsum(lens, 0) - lens
    first = torch.cumsum(lane_bits, 0) - lane_bits
    offs = offs - first[lane] + lane_start[lane]
    bits = int(lane_start[-1] + lane_bits[-1])
    codes = torch.from_numpy(code).to(dev)[data.long()]
    return tree, bits, _pack(lens, codes, offs, bits)


def _pack(lens, codes, offs, bits: int) -> torch.Tensor:
    """The payload: code i's ``lens[i]`` bits at stream offset ``offs[i]``,
    one pass a code-bit position into a byte-per-bit array (the codes too
    short for a pass write a 0 to a spare slot), packed LSB-first into
    ceil(bits/8) bytes."""
    dev = lens.device
    nbytes = (bits + 7) // 8
    bitarr = torch.zeros(nbytes * 8 + 1, dtype=torch.uint8, device=dev)
    spare = nbytes * 8
    for k in range(int(lens.max())):
        live = lens > k
        pos = torch.where(live, offs + k, spare)
        bitarr[pos] = (((codes >> k) & 1) * live).to(torch.uint8)
    weights = 1 << torch.arange(8, device=dev, dtype=torch.int32)
    return (bitarr[:spare].view(nbytes, 8).to(torch.int32)
            * weights).sum(1).to(torch.uint8)


def decode(tree: np.ndarray, payload: np.ndarray, bits: int,
           size: int) -> np.ndarray:
    """Serial tree walk over the stream's bits, one bit a step (numpy and a
    Python loop: for small streams only).  Raises ValueError when the bits
    do not end on a symbol boundary or give another count than ``size``."""
    stream = np.unpackbits(np.asarray(payload, dtype=np.uint8),
                           bitorder="little")[:bits]
    child = tree[:, 1:3].tolist()
    leaf_sym = [int(s) if z == LEAF else -1 for s, z, _o in tree.tolist()]
    out = bytearray()
    node = 0
    for b in stream.tolist():
        node = child[node][b]
        if leaf_sym[node] >= 0:
            out.append(leaf_sym[node])
            node = 0
    if node != 0 or len(out) != size:
        raise ValueError(f"stream ends mid-code or decodes {len(out)} of "
                         f"{size} symbols")
    return np.frombuffer(bytes(out), dtype=np.uint8)


def bad_bytes(got, want: np.ndarray) -> int:
    """Bytes of ``got`` that differ from ``want``, counting every byte the
    two lengths differ by as bad."""
    got = np.asarray(got, dtype=np.uint8).ravel()
    want = np.asarray(want, dtype=np.uint8).ravel()
    n = min(got.size, want.size)
    return (int(np.count_nonzero(got[:n] != want[:n]))
            + abs(got.size - want.size))

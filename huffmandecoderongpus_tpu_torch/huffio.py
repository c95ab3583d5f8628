"""The `.huff` container, Huffman trees and the encoder, in numpy.

The port's own copy of the host layer it needs, so that the port and its
smoke run import nothing of the JAX package.  Same format and the same
deterministic tree as ``huffmandecoderongpus_tpu.huffio``, and the tests
hold the two byte for byte against each other.

Container layout: magic ``b"HUFF"``; three big-endian int32 ``nodes``,
``bits``, ``uncompressed_size``; ``nodes`` 9-byte records (``sym`` u8,
``izero`` and ``ione`` big-endian int32, leaves have ``izero == ione ==
-1``, node 0 is the root); then ``ceil(bits/8)`` payload bytes, bit *p* of
the stream being ``(payload[p//8] >> (p%8)) & 1``.  A 0-bit descends
``izero``, a 1-bit ``ione``.
"""

from __future__ import annotations

import dataclasses
import heapq
import struct

import numpy as np

MAGIC = b"HUFF"
_HEADER = struct.Struct(">iii")
LEAF = -1
MAX_CODE_LEN = 31


@dataclasses.dataclass
class HuffFile:
    """One `.huff` stream in memory."""

    tree: np.ndarray  # (nodes, 3) int32: [sym, izero, ione]; row 0 is the root
    bits: int  # exact number of payload bits
    uncompressed_size: int  # decoded byte count
    payload: np.ndarray  # (ceil(bits/8),) uint8, LSB-first bit packing

    def __post_init__(self) -> None:
        self.tree = np.ascontiguousarray(self.tree, dtype=np.int32)
        self.payload = np.ascontiguousarray(self.payload, dtype=np.uint8)
        if self.tree.ndim != 2 or self.tree.shape[1] != 3:
            raise ValueError(f"tree must be (nodes, 3), got {self.tree.shape}")
        if self.payload.shape[0] != self.payload_bytes:
            raise ValueError(
                f"payload has {self.payload.shape[0]} bytes, expected "
                f"{self.payload_bytes} for {self.bits} bits")

    @property
    def payload_bytes(self) -> int:
        return (self.bits + 7) // 8


def read_huff(path) -> HuffFile:
    """Parse a `.huff` file; raises ValueError on a malformed one."""
    with open(path, "rb") as f:
        raw = f.read()
    if raw[:4] != MAGIC:
        raise ValueError(f"{path}: expected magic {MAGIC!r}, got {raw[:4]!r}")
    if len(raw) < 4 + _HEADER.size:
        raise ValueError(f"{path}: truncated header ({len(raw)} bytes)")
    nodes, bits, size = _HEADER.unpack_from(raw, 4)
    if nodes < 1 or bits < 0 or size < 0:
        raise ValueError(
            f"{path}: bad header nodes={nodes} bits={bits} size={size}")
    off, nbytes = 16, (bits + 7) // 8
    if len(raw) < off + 9 * nodes + nbytes:
        raise ValueError(f"{path}: truncated file ({len(raw)} bytes, need "
                         f"{off + 9 * nodes + nbytes})")
    rec = np.frombuffer(raw, dtype=np.uint8, count=9 * nodes,
                        offset=off).reshape(nodes, 9)
    tree = np.empty((nodes, 3), dtype=np.int32)
    tree[:, 0] = rec[:, 0]
    tree[:, 1] = rec[:, 1:5].copy().view(">i4").reshape(nodes)
    tree[:, 2] = rec[:, 5:9].copy().view(">i4").reshape(nodes)
    validate_tree(tree, what=str(path))
    payload = np.frombuffer(raw, dtype=np.uint8, count=nbytes,
                            offset=off + 9 * nodes).copy()
    return HuffFile(tree=tree, bits=bits, uncompressed_size=size,
                    payload=payload)


def validate_tree(tree: np.ndarray, what: str = "tree") -> None:
    """Child indices in range, leaves marked on both sides, and no node
    reachable twice (a cycle would send a tree walk into a loop)."""
    n = tree.shape[0]
    z, o = tree[:, 1], tree[:, 2]
    leaf = z == LEAF
    if np.any(leaf != (o == LEAF)):
        raise ValueError(f"{what}: node with exactly one LEAF child")
    kids = np.concatenate([z[~leaf], o[~leaf]])
    if kids.size and (kids.min() < 0 or kids.max() >= n):
        raise ValueError(f"{what}: child index out of range")
    seen = np.zeros(n, dtype=bool)
    stack = [0]
    while stack:
        v = stack.pop()
        if seen[v]:
            raise ValueError(f"{what}: node {v} reachable twice (cycle/DAG)")
        seen[v] = True
        if tree[v, 1] != LEAF:
            stack += [int(tree[v, 1]), int(tree[v, 2])]


def _leaf_depths(tree: np.ndarray) -> np.ndarray:
    """Depth of every leaf reachable from the root."""
    out, stack = [], [(0, 0)]
    while stack:
        node, d = stack.pop()
        if tree[node, 1] == LEAF:
            out.append(d)
        else:
            stack += [(int(tree[node, 1]), d + 1), (int(tree[node, 2]), d + 1)]
    return np.array(out, dtype=np.int64)


def table_height(tree: np.ndarray) -> int:
    """The longest code length."""
    return int(_leaf_depths(tree).max(initial=0))


def table_min_depth(tree: np.ndarray) -> int:
    """The shortest code length."""
    return int(_leaf_depths(tree).min())  # a tree has at least one leaf


def tree_codes(tree: np.ndarray):
    """``(code, length, present)``, each of size 256: bit k of ``code[s]``
    is the k-th edge from the root to symbol s's leaf (LSB-first, the
    stream's bit order)."""
    code = np.zeros(256, dtype=np.uint32)
    length = np.zeros(256, dtype=np.int32)
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
            stack.append((int(tree[node, 2]), prefix | (1 << depth), depth + 1))
    return code, length, present


def build_tree(freqs: np.ndarray) -> np.ndarray:
    """Huffman tree over byte frequencies as a node array, root at 0 and
    the rest in breadth-first order.  Ties go to the lowest symbol or the
    earliest-made node, so the tree is reproducible; a single symbol gets a
    padding sibling, since every code is at least one bit long."""
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


def encode_bytes(data) -> HuffFile:
    """Compress bytes with a Huffman tree built from their frequencies."""
    data = np.ascontiguousarray(np.frombuffer(bytes(data), dtype=np.uint8)
                                if isinstance(data, (bytes, bytearray))
                                else data, dtype=np.uint8).ravel()
    if data.size == 0:
        raise ValueError("cannot encode empty input")
    tree = build_tree(np.bincount(data, minlength=256))
    code, length, _ = tree_codes(tree)
    lens = length[data].astype(np.int64)
    codes = code[data]
    offsets = np.cumsum(lens) - lens
    bits = int(offsets[-1] + lens[-1])
    if bits > 2**31 - 1:
        raise ValueError(f"{bits} bits overflow the int32 header")
    bitarr = np.zeros(bits, dtype=np.uint8)
    for k in range(int(lens.max())):  # one scatter per code-bit position
        sel = lens > k
        bitarr[offsets[sel] + k] = (codes[sel] >> np.uint32(k)) & np.uint32(1)
    return HuffFile(tree=tree, bits=bits, uncompressed_size=int(data.size),
                    payload=np.packbits(bitarr, bitorder="little"))

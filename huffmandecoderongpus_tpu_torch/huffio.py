"""The `.huff` container, Huffman trees, the encoder and the `.huffidx`
sidecar writer, in numpy.

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

Sidecar layout (``<name>.huffidx``, big-endian like the container): magic
``b"HIDX"``; int32 version (2), block_symbols K, n_blocks and a crc32
binding the index to (bits, uncompressed_size, payload); then n_blocks
int64 bit offsets, of symbols 0, K, 2K, ...  ``read_huff`` loads the
sidecar beside a `.huff` and checks its binding; a missing, corrupt or
stale one leaves ``index`` None.
"""

from __future__ import annotations

import dataclasses
import heapq
import pathlib
import struct
import zlib

import numpy as np

MAGIC = b"HUFF"
_HEADER = struct.Struct(">iii")
LEAF = -1
MAX_CODE_LEN = 31
INDEX_MAGIC = b"HIDX"
INDEX_VERSION = 2
_INDEX_HEADER = struct.Struct(">4siiii")
DEFAULT_BLOCK_SYMBOLS = 4096


@dataclasses.dataclass
class HuffFile:
    """One `.huff` stream in memory."""

    tree: np.ndarray  # (nodes, 3) int32: [sym, izero, ione]; row 0 is the root
    bits: int  # exact number of payload bits
    uncompressed_size: int  # decoded byte count
    payload: np.ndarray  # (ceil(bits/8),) uint8, LSB-first bit packing
    #: block index for the `.huffidx` sidecar: (bit offsets int64 (n,),
    #: block_symbols); not part of the container
    index: tuple | None = None

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

    @property
    def nodes(self) -> int:
        return int(self.tree.shape[0])

    def file_bytes(self) -> int:
        """Size of the serialized container."""
        return 4 + _HEADER.size + 9 * self.nodes + self.payload_bytes

    def payload_padded(self, pad: int = 3) -> np.ndarray:
        """Payload with ``pad`` zero bytes appended, so fixed-width window
        reads past the last bit are safe (reference: huffdata.c:58-64)."""
        out = np.zeros(self.payload_bytes + pad, dtype=np.uint8)
        out[: self.payload_bytes] = self.payload
        return out


def read_huff(path, load_index: bool = True) -> HuffFile:
    """Parse a `.huff` file; raises ValueError on a malformed one.  With
    ``load_index``, a verified ``<path>idx`` sidecar becomes ``index``
    (``find_index``)."""
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
    index = None
    if load_index:
        index = find_index(path, bits=bits, uncompressed_size=size,
                           payload=payload)
    return HuffFile(tree=tree, bits=bits, uncompressed_size=size,
                    payload=payload, index=index)


def write_huff(path, hf: HuffFile) -> None:
    """Serialize a HuffFile in the container format (the inverse of
    ``read_huff``)."""
    n = hf.nodes
    rec = np.empty((n, 9), dtype=np.uint8)
    rec[:, 0] = (hf.tree[:, 0] & 0xFF).astype(np.uint8)
    rec[:, 1:5] = hf.tree[:, 1].astype(">i4").view(np.uint8).reshape(n, 4)
    rec[:, 5:9] = hf.tree[:, 2].astype(">i4").view(np.uint8).reshape(n, 4)
    with open(path, "wb") as f:
        f.write(MAGIC)
        f.write(_HEADER.pack(n, hf.bits, hf.uncompressed_size))
        f.write(rec.tobytes())
        f.write(hf.payload.tobytes())


def index_path(huff_path) -> pathlib.Path:
    """The sidecar beside a `.huff` file: ``foo.huff`` -> ``foo.huffidx``."""
    return pathlib.Path(str(huff_path) + "idx")


def build_block_index(code_lengths_per_symbol,
                      block_symbols: int = DEFAULT_BLOCK_SYMBOLS
                      ) -> np.ndarray:
    """Bit offsets of symbols 0, K, 2K, ... from per-symbol code lengths."""
    lens = np.asarray(code_lengths_per_symbol, dtype=np.int64)
    starts = np.concatenate(([0], np.cumsum(lens)[:-1]))
    return np.ascontiguousarray(starts[::block_symbols])


def payload_binding(bits: int, uncompressed_size: int,
                    payload: np.ndarray) -> int:
    """crc32 binding an index to one (bits, size, payload) triple."""
    head = struct.pack(">ii", int(bits), int(uncompressed_size))
    return zlib.crc32(np.ascontiguousarray(payload, dtype=np.uint8).tobytes(),
                      zlib.crc32(head)) & 0x7FFFFFFF


def write_index(path, offsets: np.ndarray, block_symbols: int, *,
                bits: int, uncompressed_size: int,
                payload: np.ndarray) -> None:
    """Write a `.huffidx` sidecar bound to the given payload."""
    offsets = np.ascontiguousarray(offsets, dtype=">i8")
    crc = payload_binding(bits, uncompressed_size, payload)
    with open(path, "wb") as f:
        f.write(_INDEX_HEADER.pack(INDEX_MAGIC, INDEX_VERSION,
                                   int(block_symbols), offsets.shape[0], crc))
        f.write(offsets.tobytes())


def read_index(path) -> tuple[np.ndarray, int, int]:
    """``(offsets int64 (n_blocks,), block_symbols, binding crc)`` of a
    sidecar; raises ValueError on a malformed one."""
    with open(path, "rb") as f:
        raw = f.read()
    if raw[:4] != INDEX_MAGIC:
        raise ValueError(
            f"{path}: expected magic {INDEX_MAGIC!r}, got {raw[:4]!r}")
    if len(raw) < _INDEX_HEADER.size:
        raise ValueError(f"{path}: truncated index header")
    _magic, version, k, n, crc = _INDEX_HEADER.unpack_from(raw, 0)
    if version != INDEX_VERSION:
        raise ValueError(f"{path}: unsupported index version {version}")
    if k < 1 or n < 0 or len(raw) < _INDEX_HEADER.size + 8 * n:
        raise ValueError(f"{path}: bad index header k={k} n={n}")
    offsets = np.frombuffer(raw, dtype=">i8", count=n,
                            offset=_INDEX_HEADER.size)
    return offsets.astype(np.int64), k, crc


def find_index(huff_path, *, bits: int, uncompressed_size: int,
               payload: np.ndarray) -> tuple[np.ndarray, int] | None:
    """``(offsets, block_symbols)`` of the sidecar beside a `.huff` file, or
    None when there is none, it is unreadable or of another version, or its
    binding crc does not match (bits, uncompressed_size, payload)."""
    p = index_path(huff_path)
    if not p.exists():
        return None
    try:
        offsets, k, crc = read_index(p)
    except (ValueError, struct.error, OSError):
        return None
    if crc != payload_binding(bits, uncompressed_size, payload):
        return None
    return offsets, k


def unpack_bits(payload: np.ndarray, bits: int) -> np.ndarray:
    """Payload bytes -> (bits,) uint8 array of 0/1, LSB-first."""
    payload = np.asarray(payload, dtype=np.uint8)
    return np.unpackbits(payload, bitorder="little")[:bits]


def payload_to_words_u32(payload: np.ndarray, bits: int,
                         extra_words: int = 1) -> np.ndarray:
    """Payload bytes -> little-endian uint32 words for fixed-width window
    extraction on the device.  Bit *p* of the stream is bit ``p % 32`` of
    ``words[p // 32]``.  ``extra_words`` zero words are appended so that
    reading ``words[p // 32 + 1]`` is always in bounds for p < bits."""
    payload = np.asarray(payload, dtype=np.uint8)
    nwords = (bits + 31) // 32 + extra_words
    buf = np.zeros(nwords * 4, dtype=np.uint8)
    buf[: payload.shape[0]] = payload[: min(payload.shape[0], nwords * 4)]
    return buf.view("<u4")


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


def tree_size(tree: np.ndarray, root: int = 0) -> int:
    """Number of nodes in the subtree under ``root`` (huffdata.c:232-238)."""
    count, stack = 0, [root]
    while stack:
        node = stack.pop()
        count += 1
        if tree[node, 1] != LEAF:
            stack += [int(tree[node, 1]), int(tree[node, 2])]
    return count


def table_num_groups(tree: np.ndarray, bits: int, root: int = 0) -> int:
    """Number of ``bits``-bit jump tables a DFA decomposition needs: one
    for the root and one for each internal node at a depth that is a
    multiple of ``bits`` (tableNumGroupsToGo, huffdata.c:242-256)."""
    count, stack = 1, [(root, bits)]
    while stack:
        node, down = stack.pop()
        if tree[node, 1] == LEAF:
            continue
        if down == 0:
            count += 1
            stack.append((node, bits))
        else:
            stack += [(int(tree[node, 1]), down - 1),
                      (int(tree[node, 2]), down - 1)]
    return count


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


def _printable(sym: int) -> str:
    return chr(sym) if 32 <= sym < 127 else f"\\x{sym:02x}"


@dataclasses.dataclass
class HuffTree:
    """A node array with its metrics and its printouts."""

    tree: np.ndarray

    @property
    def nodes(self) -> int:
        return int(self.tree.shape[0])

    @property
    def height(self) -> int:
        return table_height(self.tree)

    @property
    def min_depth(self) -> int:
        return table_min_depth(self.tree)

    @property
    def size(self) -> int:
        return tree_size(self.tree)

    def num_groups(self, bits: int) -> int:
        return table_num_groups(self.tree, bits)

    def format_codes(self) -> str:
        """One line a symbol: its code, first edge first, and the symbol
        (listHuffCodes, huffdata.c:133-146)."""
        code, length, present = tree_codes(self.tree)
        return "\n".join(
            "".join("1" if (int(code[s]) >> k) & 1 else "0"
                    for k in range(int(length[s])))
            + f" '{_printable(s)}'" for s in range(256) if present[s])

    def format_table(self) -> str:
        """The node array, a line a node (showHuffTable,
        huffdata.c:291-300)."""
        lines = []
        for i in range(self.nodes):
            sym, z, o = (int(v) for v in self.tree[i])
            lines.append(f"{i}   '{_printable(sym)}'" if z == LEAF
                         else f"{i}   {z}   {o}")
        return "\n".join(lines)


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


def as_u8(data) -> np.ndarray:
    """Bytes or an array as a flat contiguous uint8 array."""
    if isinstance(data, (bytes, bytearray, memoryview)):
        return np.frombuffer(bytes(data), dtype=np.uint8)
    return np.ascontiguousarray(data, dtype=np.uint8).ravel()


def require_codes(hist: np.ndarray, present: np.ndarray) -> None:
    """Raise ValueError if a symbol of the byte histogram ``hist`` has no
    code in the tree (``present``, from ``tree_codes``)."""
    missing = np.nonzero((hist > 0) & ~present)[0]
    if missing.size:
        raise ValueError(f"tree has no code for symbols {missing.tolist()}")


def encode_bytes(data, tree: np.ndarray | None = None,
                 block_symbols: int | None = None) -> HuffFile:
    """Compress bytes with ``tree``, or with a Huffman tree built from
    their frequencies.  ``block_symbols``: also attach the `.huffidx` block
    index, an offset every ``block_symbols`` symbols (``write_index``
    persists it)."""
    data = as_u8(data)
    if data.size == 0:
        raise ValueError("cannot encode empty input")
    hist = np.bincount(data, minlength=256)
    if tree is None:
        tree = build_tree(hist)
    code, length, present = tree_codes(tree)
    require_codes(hist, present)
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
    index = None
    if block_symbols is not None:
        index = (build_block_index(lens, block_symbols), int(block_symbols))
    return HuffFile(tree=tree, bits=bits, uncompressed_size=int(data.size),
                    payload=np.packbits(bitarr, bitorder="little"),
                    index=index)

"""DFA table decoders: the jump-table and Lin approaches, on the host.

The port's copy of the JAX package's ``models/dfa.py``.  Semantics parity
with the reference's jumptableapproach.c (linked k-bit jump tables, states
deduped by code prefix = tree node, a byte path for jumpbits 8) and
linapproach.c (one flat array, subtree roots every ``jumpbits`` levels
plus "telescoped" partial-depth roots for shallow subtrees, here per-state
chunk widths).

Both decoders take ``jumpbits`` as ``param`` (the reference sweeps 1..14
through its paramdata channel, mainrun.c:442-459; default 8).  The table
builders run in numpy over all 2^k chunks a state; the decode loops are
the port's C++ runtime (``native``).  Each decode finishes its last bits
with ``tail_decode`` from the tree node of the DFA's final state.
"""

from __future__ import annotations

import numpy as np

from huffmandecoderongpus_tpu_torch import native
from huffmandecoderongpus_tpu_torch.models import register

DEFAULT_JUMPBITS = 8


def _walk_chunks(tree: np.ndarray, start_node: int, w: int, maxsym: int):
    """For every w-bit chunk, walk the tree from ``start_node`` consuming all
    w bits (emitting a symbol and restarting at the root on each leaf).
    Returns (syms (2^w, maxsym) u8, count (2^w,) u8, end_node (2^w,) i64)."""
    size = 1 << w
    win = np.arange(size, dtype=np.uint32)
    izero = tree[:, 1].astype(np.int64)
    ione = tree[:, 2].astype(np.int64)
    symarr = tree[:, 0].astype(np.uint8)
    node = np.full(size, start_node, dtype=np.int64)
    syms = np.zeros((size, maxsym), dtype=np.uint8)
    cnt = np.zeros(size, dtype=np.int64)
    for j in range(w):
        bit = (win >> np.uint32(j)) & np.uint32(1)
        node = np.where(bit == 1, ione[node], izero[node])
        isleaf = izero[node] == -1
        rows = np.nonzero(isleaf)[0]
        syms[rows, cnt[rows]] = symarr[node[rows]]
        cnt[isleaf] += 1
        node = np.where(isleaf, 0, node)
    return syms, cnt.astype(np.uint8), node


def _subtree_heights(tree: np.ndarray) -> np.ndarray:
    """Height of the subtree rooted at each node (leaves 0), without
    recursion: nodes in depth-first order from the root, then children
    before parents."""
    h = np.zeros(tree.shape[0], dtype=np.int64)
    order, stack = [], [0]
    while stack:
        v = stack.pop()
        order.append(v)
        if tree[v, 1] != -1:
            stack += [int(tree[v, 1]), int(tree[v, 2])]
    for v in reversed(order):
        if tree[v, 1] != -1:
            h[v] = 1 + max(h[int(tree[v, 1])], h[int(tree[v, 2])])
    return h


def _check_jumpbits(k: int) -> None:
    if not (1 <= k <= 16):
        raise ValueError(f"jumpbits must be in 1..16, got {k}")


def build_jump_dfa(tree: np.ndarray, k: int):
    """Fixed-width k-bit DFA; states are the tree nodes reachable at chunk
    boundaries, deduped (jumptableapproach.c:40-99 semantics).

    Returns (syms, count, next, state_nodes): flat entry arrays indexed by
    ``(state << k) | chunk`` and the tree node behind each state id."""
    _check_jumpbits(k)
    state_of = np.full(tree.shape[0], -1, dtype=np.int64)
    state_nodes = [0]
    state_of[0] = 0
    syms_l, cnt_l, next_l = [], [], []
    i = 0
    while i < len(state_nodes):
        sy, cn, end = _walk_chunks(tree, state_nodes[i], k, maxsym=k)
        for e in np.unique(end):
            if state_of[e] == -1:
                state_of[e] = len(state_nodes)
                state_nodes.append(int(e))
        syms_l.append(sy)
        cnt_l.append(cn)
        next_l.append(state_of[end].astype(np.int32))
        i += 1
    return (
        np.ascontiguousarray(np.concatenate(syms_l)),
        np.ascontiguousarray(np.concatenate(cnt_l)),
        np.ascontiguousarray(np.concatenate(next_l)),
        np.asarray(state_nodes, dtype=np.int64),
    )


def build_lin_dfa(tree: np.ndarray, k: int):
    """Variable-width flat DFA (linapproach.c semantics): a state whose
    subtree is shallower than k gets a "telescoped" table as wide as that
    subtree is tall, consuming fewer bits.

    Returns (syms, count, next, base, width, state_nodes)."""
    _check_jumpbits(k)
    heights = _subtree_heights(tree)
    state_of = np.full(tree.shape[0], -1, dtype=np.int64)
    state_nodes = [0]
    state_of[0] = 0
    syms_l, cnt_l, next_nodes_l = [], [], []
    widths, bases = [], []
    base = 0
    i = 0
    while i < len(state_nodes):
        s = state_nodes[i]
        w = int(min(k, max(heights[s], 1)))
        widths.append(w)
        bases.append(base)
        sy, cn, end = _walk_chunks(tree, s, w, maxsym=k)
        base += 1 << w
        for e in np.unique(end):
            if state_of[e] == -1:
                state_of[e] = len(state_nodes)
                state_nodes.append(int(e))
        syms_l.append(sy)
        cnt_l.append(cn)
        next_nodes_l.append(end)
        i += 1
    nxt = np.concatenate([state_of[e] for e in next_nodes_l]).astype(np.int32)
    return (
        np.ascontiguousarray(np.concatenate(syms_l)),
        np.ascontiguousarray(np.concatenate(cnt_l)),
        np.ascontiguousarray(nxt),
        np.asarray(bases, dtype=np.int32),
        np.asarray(widths, dtype=np.int32),
        np.asarray(state_nodes, dtype=np.int64),
    )


@register("jumptable", backend="host-native", param=DEFAULT_JUMPBITS)
def jumptable(hf, param=DEFAULT_JUMPBITS, *, device) -> np.ndarray:
    """k-bit jump-table DFA decode + serial tail
    (jumptableapproach.c:166-258); k = 8 takes the byte path."""
    k = DEFAULT_JUMPBITS if param is None else int(param)
    syms, cnt, nxt, state_nodes = build_jump_dfa(hf.tree, k)
    data = hf.payload_padded(4)
    head, pos, st = native.dfa_decode_raw(
        syms, cnt, nxt, k, k, data, hf.bits, hf.uncompressed_size
    )
    tail = native.tail_decode(
        hf.tree, int(state_nodes[st]), data, pos, hf.bits,
        hf.uncompressed_size - head.size
    )
    return np.concatenate([head, tail])


@register("lin", backend="host-native", param=DEFAULT_JUMPBITS)
def lin(hf, param=DEFAULT_JUMPBITS, *, device) -> np.ndarray:
    """Flat-array telescoped DFA decode + serial tail
    (linapproach.c:197-276)."""
    k = DEFAULT_JUMPBITS if param is None else int(param)
    syms, cnt, nxt, base, width, state_nodes = build_lin_dfa(hf.tree, k)
    data = hf.payload_padded(4)
    head, pos, st = native.vdfa_decode_raw(
        syms, cnt, nxt, base, width, k, data, hf.bits, hf.uncompressed_size
    )
    tail = native.tail_decode(
        hf.tree, int(state_nodes[st]), data, pos, hf.bits,
        hf.uncompressed_size - head.size
    )
    return np.concatenate([head, tail])

"""Fused bit-transition table over Huffman tree states (numpy).

Port of ``huffmandecoderongpus_tpu.ops.lanedfa`` (``LaneDFA``,
``build_lane_dfa``), whose module imports jax; the table is host data, so it
is built with numpy here and compared byte for byte with the reference.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from huffmandecoderongpus_tpu_torch.huffio import table_height, table_min_depth

EMIT_BIT = 1 << 10
STATE_MASK = (1 << 10) - 1


@dataclasses.dataclass(frozen=True)
class LaneDFA:
    """Fused bit-transition table over tree-node states.

    ``entry[node*2 + bit]`` packs, as one int32:
      bits 0..9   next state (the root-reset on leaves already applied)
      bit  10     emit flag (a codeword just completed)
      bits 16..23 emitted symbol
    """

    entry: np.ndarray  # (2 * nodes,) int32
    nodes: int
    height: int
    min_depth: int


def build_lane_dfa(tree: np.ndarray) -> LaneDFA:
    """Build the fused table from the node-array tree layout
    ([sym, izero, ione], row 0 root, leaf <=> izero == -1).

    Only internal nodes are DFA states (a leaf transition folds into emit +
    root reset), so states are renumbered to the internal nodes."""
    tree64 = np.ascontiguousarray(tree, dtype=np.int64)
    n = tree64.shape[0]
    internal = tree64[:, 1] != -1
    n_states = max(int(internal.sum()), 1)
    if n_states > STATE_MASK:
        raise ValueError(f"{n_states} states exceed the {STATE_MASK}-state encoding")
    state_of = np.cumsum(internal) - 1  # original node -> packed state id
    if internal.any() and state_of[0] != 0:
        raise ValueError("root must be node 0")
    entry = np.zeros(2 * n_states, dtype=np.int32)
    for bit in (0, 1):
        child = tree64[internal, 1 + bit]
        child_safe = np.clip(child, 0, n - 1)
        leaf = tree64[child_safe, 1] == -1
        sym = tree64[child_safe, 0] & 0xFF
        val = np.where(leaf, (sym << 16) | EMIT_BIT, state_of[child_safe])
        entry[bit::2] = val.astype(np.int32)
    t32 = np.ascontiguousarray(tree, dtype=np.int32)
    return LaneDFA(entry=entry, nodes=n, height=table_height(t32),
                   min_depth=table_min_depth(t32))

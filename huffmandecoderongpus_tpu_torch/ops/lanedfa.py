"""The lane-parallel bit DFA's table and host staging (numpy).

Port of ``huffmandecoderongpus_tpu.ops.lanedfa`` (``LaneDFA``,
``build_lane_dfa``, ``bits_matrix``, ``pick_lanes``) and of
``_pad_table`` (``ops/pallas_lanedfa.py``), whose modules import jax.  The
table and the bit matrix are host data, built with numpy and compared byte
for byte with the reference; ``lanedfa_decode`` runs the decode.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from huffmandecoderongpus_tpu_torch.huffio import (
    table_height,
    table_min_depth,
    unpack_bits,
)

EMIT_BIT = 1 << 10
STATE_MASK = (1 << 10) - 1
#: lanes are whole multiples of this on the tiled route (the Pallas
#: kernel's (8, 128) lane tile); kept so staged inputs compare equal
LANE_TILE = 1024
#: table entries per row of the padded table
CHUNK = 128


class EnvelopeError(ValueError):
    """The stream is outside what a decoder takes."""


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


def pad_table(entry: np.ndarray) -> np.ndarray:
    """The fused table padded to (n_chunks, 128) int32."""
    t = entry.shape[0]
    out = np.zeros((max(-(-t // CHUNK), 1), CHUNK), dtype=np.int32)
    out.reshape(-1)[:t] = entry
    return out


def bits_matrix(payload: np.ndarray, bits: int, lanes: int, halo: int,
                round_to: int = 1):
    """(B + halo, G) uint8 bit matrix and B: element [j, g] is stream bit
    ``g*B + j`` (rows >= B repeat the head of the next lane), zero past the
    stream end.  B is rounded up to a multiple of ``round_to``."""
    B = -(-bits // lanes)
    if round_to > 1:
        B = -(-B // round_to) * round_to
    flat = np.zeros(lanes * B + halo, dtype=np.uint8)
    flat[:bits] = unpack_bits(payload, bits)
    # column g is the window flat[g*B : g*B + B + halo]
    mat = np.lib.stride_tricks.as_strided(
        flat, shape=(B + halo, lanes), strides=(1, B))
    return np.ascontiguousarray(mat), B


def pick_lanes(bits: int, target_block_bits: int = 4096,
               max_lanes: int = 1 << 15) -> int:
    """Lane count: a power of two, blocks of at least target_block_bits."""
    g = max(1, bits // max(target_block_bits, 1))
    g = 1 << max(g.bit_length() - 1, 0)
    return int(min(max(g, 1), max_lanes))


#: bytes of one staged bit tile (rows x lanes) of the lane-DFA scans, and
#: the tiles in their ring (``csrc/widescan.cuh`` ``BIT_STAGES``)
TILE_BYTES = 4096
TILE_STAGES = 3
#: most threads a block, and the shared memory a block takes without
#: opting in (``cudaFuncSetAttribute``); the scans stay under the latter
MAX_THREADS = 1024
SHARED_DEFAULT = 48 * 1024
#: bytes of the fused table each scan stages beside its tiles
TABLE_BYTES = 2048 * 4


def tile_plan(G: int, chains: int, ptr: int, *, out_tiles: bool) -> dict:
    """Launch plan of a lane-DFA scan over the (rows, G) bit matrix: a
    block owns ``lanes`` neighbouring lanes (32 where G allows, halved
    while ``chains`` threads a lane would pass ``MAX_THREADS``), stages
    them ``rows`` (a multiple of 16) at a time in a ring of ``stages``
    tiles of ``TILE_BYTES``, and copies ``vec`` bytes at a time: 16 or 4
    (``cp.async``) where that aligns ``ptr`` (the matrix's address, or-ed
    with the outputs' that take the same width) and divides the lanes a
    block and G, or where one block holds every lane (its rows are then
    one run of bytes, copied whole), else 1.  ``out_tiles``: the lane
    scan's plan, one warp a block and two more pairs of tiles for its sym
    and valid outputs.  ``threads`` a block, ``blocks``, and ``shared``:
    the dynamic shared memory the wrapper asks for (the table's
    ``TABLE_BYTES`` are static, beside it)."""
    if G < 1 or not 1 <= chains <= MAX_THREADS:
        raise ValueError(f"tile_plan: G={G}, {chains} chains a lane")
    L = min(32, G)
    while L * chains > MAX_THREADS:
        L //= 2
    R = max(16, TILE_BYTES // L // 16 * 16)
    vec = next(v for v in (16, 4, 1) if ptr % v == 0
               and (L == G or (L % v == 0 and G % v == 0)))
    shared = (TILE_STAGES + (4 if out_tiles else 0)) * R * L
    return dict(lanes=L, rows=R, stages=TILE_STAGES, vec=vec,
                blocks=-(-G // L), threads=32 if out_tiles else L * chains,
                shared=shared)


def lane_limits(N: int, B: int, G: int, device) -> torch.Tensor:
    """(G,) int64: each lane's bit rows below N - g*B are in the stream."""
    return N - torch.arange(G, device=device, dtype=torch.int64) * B

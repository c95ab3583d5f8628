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
#: most dynamic shared memory a scan's plan takes (``csrc/widescan.cuh``
#: ``BIT_SHARED_MAX``): the default less the staged table
BIT_SHARED_MAX = SHARED_DEFAULT - TABLE_BYTES


def tile_plan(G: int, chains: int, ptr: int, *, out_tiles: bool,
              rings: int = 1, extra: int = 0) -> dict:
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
    and valid outputs.  ``rings``: matrices of the same layout staged side
    by side, a ring each (the short candidate scan's bits and 0-chain
    emissions; ``ptr`` then or-s both addresses).  ``extra``: bytes of
    dynamic shared memory beside the tiles (the indexed scan's 2-bit step
    table); the tiles lose rows, 16 at a time, until the whole stays
    within ``BIT_SHARED_MAX``.  ``threads`` a block, ``blocks``, and
    ``shared``: the dynamic shared memory the wrapper asks for (the
    table's ``TABLE_BYTES`` are static, beside it)."""
    if G < 1 or not 1 <= chains <= MAX_THREADS or rings < 1 or extra < 0:
        raise ValueError(f"tile_plan: G={G}, {chains} chains a lane, "
                         f"{rings} rings, {extra} extra bytes")
    L = min(32, G)
    while L * chains > MAX_THREADS:
        L //= 2
    tiles = TILE_STAGES * rings + (4 if out_tiles else 0)
    R = max(16, TILE_BYTES // L // 16 * 16)
    while R > 16 and tiles * R * L + extra > BIT_SHARED_MAX:
        R -= 16
    if tiles * R * L + extra > BIT_SHARED_MAX:
        raise ValueError(f"tile_plan: {extra} extra bytes leave no room "
                         "for the tiles")
    vec = next(v for v in (16, 4, 1) if ptr % v == 0
               and (L == G or (L % v == 0 and G % v == 0)))
    return dict(lanes=L, rows=R, stages=TILE_STAGES, vec=vec,
                blocks=-(-G // L), threads=32 if out_tiles else L * chains,
                shared=tiles * R * L + extra)


def step2_bytes(tab_words: int) -> int:
    """Bytes of the indexed scan's 2-bit step table for a padded table of
    ``tab_words`` int32 entries (two a state): 16 a state
    (``csrc/widescan.cuh`` ``step2_bytes``)."""
    return (tab_words + 1) // 2 * 16


#: threads a block of ``lane_scan_indexed``: a warp that walks the lanes
#: and three that copy its tiles in and out (``csrc/lane_scan_indexed.cu``)
INDEXED_THREADS = 128


def indexed_plan(G: int, ptr: int, tab_words: int) -> dict:
    """Launch plan of ``lane_scan_indexed``: the lane scan's tiles
    (``tile_plan(G, 1, ptr, out_tiles=True)``) with the 2-bit step table
    of a ``tab_words`` table beside them, and ``INDEXED_THREADS`` a
    block."""
    p = tile_plan(G, 1, ptr, out_tiles=True, extra=step2_bytes(tab_words))
    return dict(p, threads=INDEXED_THREADS)


def short_plan(G: int, H: int, ptr: int) -> dict:
    """Launch plan of ``short_candidate_scan``: the candidate scan's
    (H chains a lane) with a second ring for the 0-chain's emissions;
    ``ptr`` or-s the addresses of both matrices."""
    return tile_plan(G, H, ptr, out_tiles=False, rings=2)


def step2_table(tab: np.ndarray) -> np.ndarray:
    """The indexed scan's 2-bit step table (uint32, 4 entries a state) of
    the padded fused table ``tab``, as ``csrc/widescan.cuh``
    ``stage_step_table2`` builds it in shared memory: entry 4 * s + 2 * b0
    + b1 holds the state after bits b0 then b1 from state s, times 16
    (bits 4-13), both bits' emit flags (bits 14 and 15) and both fused
    entries' symbol fields (bits 16-23 and 24-31)."""
    t = np.asarray(tab, dtype=np.int64).reshape(-1)
    n = (t.size + 1) // 2
    full = np.zeros(2 * (STATE_MASK + 1), dtype=np.int64)
    full[:t.size] = t
    s = np.repeat(np.arange(n), 4)
    b0 = np.tile([0, 0, 1, 1], n)
    b1 = np.tile([0, 1, 0, 1], n)
    e0 = full[2 * s + b0]
    e1 = full[2 * (e0 & STATE_MASK) + b1]
    emit0 = (e0 & EMIT_BIT) != 0
    emit1 = (e1 & EMIT_BIT) != 0
    out = (((e1 & STATE_MASK) << 4) | (emit0.astype(np.int64) << 14)
           | (emit1.astype(np.int64) << 15) | (((e0 >> 16) & 0xFF) << 16)
           | (((e1 >> 16) & 0xFF) << 24))
    return out.astype(np.uint32)


def lane_limits(N: int, B: int, G: int, device) -> torch.Tensor:
    """(G,) int64: each lane's bit rows below N - g*B are in the stream."""
    return N - torch.arange(G, device=device, dtype=torch.int64) * B

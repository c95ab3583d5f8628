"""K2: compose per-lane exit maps into each lane's true entry offset.

Replaces ``huffmandecoderongpus_tpu/ops/pallas_widescan.py`` ``k2_compose`` /
``_k2_kernel``.  CUDA source: ``csrc/k2_compose.cu``.

``entry[0] = start`` and ``entry[l + 1] = exmap[entry[l], l]``: a sequential
composition of G small maps, where an entry offset at or past the map rows
(HP) reads 0, as the TPU kernel's 128-wide padding does; the map values are
entry offsets below 128.  Also returns the composite map ``tot`` (128,)
uint8: lane G-1's exit for each entry offset of lane 0.

On the card it is one launch (``k2_plan``): blocks take tiles of
consecutive lanes by an atomic ticket, compose each tile's maps in shared
memory (byte maps over the HP + 1 entry classes, a thread a sub-tile and
class, then a log-depth scan), chain the tiles by a decoupled look-back
over their published maps, and walk each sub-tile from its entry.  The
look-back's state is a buffer held per device and stream
(``lookback.States``), zeroed once when made; its flags carry the epoch of
the call that wrote them, which each call advances on the card, so no call
resets it.  A call captured in a CUDA graph gets a state of its own, which
the graph zeroes at each replay, so a replay may run on any stream beside
eager calls, and a later call's larger state frees nothing it holds.

The plain version keeps the three steps of the JAX kernel over NGp groups
of L lanes: (1) each group's composite map over all 128 entry offsets, (2)
one scan over the group composites, (3) each group applies its first
lane's entry.
"""

from __future__ import annotations

import functools

import torch

from huffmandecoderongpus_tpu_torch.ops import _build, lookback
from huffmandecoderongpus_tpu_torch.utils import trace

#: entry offsets a map is evaluated at (the TPU kernel's lane width)
NE = 128
#: most groups the plain version's scan step walks
MAX_GROUPS = 256
#: the kernel's block, and its tile of lanes (``k2_plan``)
THREADS = 512
TILE = 256
#: predecessors a look-back step reads, and a published map's bytes
#: (``csrc/k2_compose.cu``)
LOOKBACK = 32
MAP_BYTES = 256
#: tiles the first look-back buffer of a stream holds
STATE_TILES = 256


def groups(G: int) -> tuple[int, int]:
    """(L, NGp): lanes per group and the number of groups."""
    L = -(-G // MAX_GROUPS)
    if G % L:
        raise ValueError(f"k2_compose: {G} lanes do not split into groups")
    return L, G // L


def _up16(n: int) -> int:
    return -(-n // 16) * 16


def shared_bytes(HP: int, TL: int, threads: int) -> int:
    """Dynamic shared bytes of a K2 block (``k2_compose.cu`` ``K2Smem``):
    the staged rows (HP x TL bytes), the entries (TL int32), two buffers
    of the sub-tile maps (threads // (HP + 1) maps of HP + 1 bytes), two of
    a look-back window's (LOOKBACK maps) and the look-back's composite,
    each 16-byte aligned."""
    NC = HP + 1
    S = threads // NC
    return (_up16(HP * TL) + 4 * TL + 2 * _up16(S * NC)
            + 2 * _up16(LOOKBACK * NC) + _up16(NC))


@functools.lru_cache(maxsize=256)
def k2_plan(G: int, HP: int, sm_count: int = _build.SM_COUNT) -> dict:
    """Launch plan of K2 on a card of ``sm_count`` SMs: ``tile`` = TILE
    lanes a block, ``tiles`` = ceil(G / tile) blocks of
    ``threads``; ``sub``: the lanes of a sub-tile, the tile over the
    threads // (HP + 1) sub-tiles a block walks at once (the last tile's
    sub-tiles are as long and fewer); ``shared`` (``shared_bytes``),
    ``per_sm`` (the blocks an SM holds by threads and shared memory) and
    ``waves`` (the tiles over what the card holds at once; a block waits
    only on tiles of earlier tickets, so more than one wave is slower, not
    stuck).  Raises ValueError outside the kernel's bounds."""
    if not 1 <= HP <= NE or G < 1:
        raise ValueError("k2_compose: map rows must be 1 to 128, lanes >= 1")
    tile = TILE
    S = THREADS // (HP + 1)
    shared = shared_bytes(HP, tile, THREADS)
    per_sm = min(_build.SM_THREADS // THREADS,
                 _build.SM_SHARED // (shared + _build.BLOCK_RESERVED))
    tiles = -(-G // tile)
    return dict(tile=tile, sub=-(-tile // S), threads=THREADS, tiles=tiles,
                shared=shared, per_sm=per_sm,
                waves=-(-tiles // (sm_count * per_sm)), sm_count=sm_count)


def _state_words(cap: int) -> int:
    """int32 words of K2's look-back state for ``cap`` tiles: the epoch and
    ticket word (two), a flag a tile, and two maps of MAP_BYTES a tile."""
    return 2 + cap + 2 * cap * MAP_BYTES // 4


#: the look-back's state, a device and stream each
_states = lookback.States(_state_words, STATE_TILES)


def k2_compose(exmap, start: int = 0):
    """Entries (G,) int32 of every lane and the composite map (128,) uint8,
    from ``exmap`` (HP, G) int32.  CPU tensors run the plain version; CUDA
    tensors launch the kernel."""
    if exmap.device.type == "cpu":
        return k2_compose_ref(exmap, start)
    _build.require_cuda("k2_compose", exmap)
    HP, G = exmap.shape
    if not 0 <= start < NE or HP > NE:
        raise ValueError("k2_compose: start and map rows must be below 128")
    groups(G)  # the lanes the plain version takes
    dev = exmap.device
    p = k2_plan(G, HP, _build.sm_count(dev))
    stream = _build.stream_ptr(exmap)
    state, cap = _states.get(dev, stream, p["tiles"])
    entry = torch.empty(G, dtype=torch.int32, device=dev)
    tot = torch.empty(NE, dtype=torch.uint8, device=dev)
    rc = _build.get_lib().ws_k2_compose(
        exmap.data_ptr(), entry.data_ptr(), tot.data_ptr(), state.data_ptr(),
        cap, G, HP, start, p["tile"], p["sub"], p["threads"], p["shared"],
        stream)
    trace.count("launch.k2_compose")
    _build.check(rc, "k2_compose")
    return entry, tot


def k2_compose_ref(exmap, start: int = 0):
    """Plain torch K2, in the JAX kernel's three steps."""
    HP, G = exmap.shape
    L, NGp = groups(G)
    dev = exmap.device
    ex = torch.zeros((NE, G), dtype=torch.int64, device=dev)
    ex[:HP] = exmap.to(torch.int64)
    ex = ex.reshape(NE, NGp, L)
    grp = torch.arange(NGp, device=dev)

    def step(state, lane):
        """exmap[state, lane of each group]; 0 at or past the map rows."""
        inside = (state >= 0) & (state < HP)
        v = ex[state.clamp(0, NE - 1), grp[:, None] if state.dim() > 1
               else grp, lane]
        return torch.where(inside, v, 0)

    # (1) each group's composite map at every entry offset
    gmap = torch.arange(NE, device=dev).expand(NGp, NE).clone()
    for lane in range(L):
        gmap = step(gmap, lane)
    # (2) scan over the groups: the first lane's entry of every group for
    # lane 0 entering at each offset (column ``start`` is the one used)
    state = torch.arange(NE, device=dev)
    goff = torch.empty(NGp, dtype=torch.int64, device=dev)
    for g in range(NGp):
        goff[g] = state[start]
        state = gmap[g, state]
    tot = state
    # (3) each group applies its first lane's entry
    entry = torch.empty((NGp, L), dtype=torch.int64, device=dev)
    s = goff
    for lane in range(L):
        entry[:, lane] = s
        s = step(s, lane)
    return (entry.reshape(-1)[:G].to(torch.int32), tot.to(torch.uint8))

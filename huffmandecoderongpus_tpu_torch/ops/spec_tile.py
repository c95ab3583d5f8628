"""S2's launch plan and its low levels: doubling levels 1..m of a tile in
shared memory, one launch writing the kept levels 2, 4, ..., m.

The port of ``double`` and the kept levels in
``huffmandecoderongpus_tpu/ops/speculative.py`` ``speculative_decode_xla``
(:122-140), XLA ops there and no Pallas kernel.  CUDA source:
``csrc/spec_tile.cu``.  A block stages step0 over its tile and a right
halo of (2^m - 1) * height offsets (level j needs level j - 1 up to a span
of 2^(j-1) codewords of at most ``height`` bits past its own range) and
doubles m times in shared memory; the odd levels and the halo never reach
device memory.  ``s2_plan`` picks m and the tile, and which kept levels
above m ``spec_pair`` (two levels a launch) makes; the launcher refuses
any other tile plan (``s2_plan_ok`` mirrors it).
"""

from __future__ import annotations

import ctypes

import torch

from huffmandecoderongpus_tpu_torch.ops import _build
from huffmandecoderongpus_tpu_torch.ops.spec_double import (
    level_dtype,
    spec_double_ref,
)
from huffmandecoderongpus_tpu_torch.ops.spec_pair import BLOCK_OFFSETS
from huffmandecoderongpus_tpu_torch.utils import trace

THREADS = 512
#: blocks an SM (the kernel's launch bounds): each takes half its shared
#: memory
BLOCKS_AN_SM = 2
#: kept levels one launch writes at most: 2, 4, ..., 2 * MAX_OUT
MAX_OUT = 8
#: a block's shared bytes at most, and the offsets it stages at most: two
#: int16 buffers
SHARED_MAX = _build.SM_SHARED // BLOCKS_AN_SM - _build.BLOCK_RESERVED
SPAN_MAX = SHARED_MAX // 4
#: a tile is at least this many halos
HALO_SHARE = 4
#: bytes of three spans of a pair launch's input level past which its
#: blocks a span apart run together (most of the 50 MB L2)
SPAN_ORDER_BYTES = 20 << 20


def top_level(levels: int) -> int:
    """The highest kept level a decode of ``levels`` levels doubles to:
    the largest even k with 2 <= k < levels, else 0 (no doubling)."""
    return (levels - 1) // 2 * 2 if levels >= 3 else 0


def halo(m: int, height: int) -> int:
    """Offsets past a tile that levels 1..m read: the spans of 2^(j-1)
    codewords of at most ``height`` bits, summed over j."""
    return ((1 << m) - 1) * height


def _round8(x: int) -> int:
    return -(-x // 8) * 8


def _span(bits: int, height: int, m: int, tile: int) -> int:
    """Offsets a block's buffers hold: its tile and halo, cut at ``bits``,
    rounded up to 8 (two offsets a thread, 16-byte staging)."""
    return _round8(min(tile + halo(m, height), bits))


def _fits(bits: int, height: int, m: int, tile: int | None) -> bool:
    h = halo(m, height)
    if m > 2 * MAX_OUT or (1 << m) * height > 32767:
        return False
    if tile is None:  # a tile of HALO_SHARE halos and its halo fit
        return (HALO_SHARE + 1) * h + 8 <= SPAN_MAX
    return HALO_SHARE * h <= tile and _span(bits, height, m, tile) <= (
        SPAN_MAX)


def s2_plan(bits: int, height: int, levels: int, *, size: int,
            sms: int = _build.SM_COUNT, tile: int | None = None) -> dict:
    """S2's launches for one decode: ``m`` (even; 0 where ``levels`` < 3,
    no launch) the levels the tile launch doubles in shared memory, the
    largest even m up to the top kept level whose levels fit int16 (2^m *
    height <= 32767) and whose halo is at most a quarter of the tile;
    ``tile`` the offsets a block owns (a multiple of 8: by default the most
    that fit a block's shared memory beside the halo, cut to whole waves
    of BLOCKS_AN_SM blocks on each of ``sms`` SMs, at least HALO_SHARE
    halos);
    ``span`` the offsets a block stages, ``shared`` its bytes, ``threads``
    and ``blocks``; ``pairs`` the kept levels m + 2, ..., top that
    ``spec_pair`` makes from the one below, a launch each, and ``segs``
    their block orders (``spec_pair``'s ``seg``: the blocks in the mean
    span of the input level, 2^(k - 2) codewords of bits / ``size``
    bits, the header's size, where three such spans pass
    SPAN_ORDER_BYTES; else 1); ``launches`` in all.  A ``tile`` given must be a multiple of 8
    that holds 4 halos of some m >= 2, else ValueError."""
    top = top_level(levels)
    if top == 0:
        return dict(top=0, m=0, halo=0, tile=0, span=0, threads=THREADS,
                    shared=0, blocks=0, pairs=(), segs=(), launches=0)
    if tile is not None and (tile < 8 or tile % 8):
        raise ValueError(f"s2_plan: tile {tile} is not a multiple of 8")
    ms = [m for m in range(2, top + 1, 2) if _fits(bits, height, m, tile)]
    if not ms:
        raise ValueError(f"s2_plan: no m >= 2 fits tile {tile} at height "
                         f"{height}")
    m = ms[-1]
    h = halo(m, height)
    if tile is None:
        tile0 = (SPAN_MAX - h) // 8 * 8
        slots = BLOCKS_AN_SM * sms
        waves = -(-(-(-bits // tile0)) // slots)
        tile = min(tile0, max(_round8(-(-bits // (waves * slots))),
                              _round8(HALO_SHARE * h)))
    span = _span(bits, height, m, tile)
    pairs = tuple(range(m + 2, top + 1, 2))
    return dict(top=top, m=m, halo=h, tile=tile, span=span, threads=THREADS,
                shared=4 * span, blocks=-(-bits // tile), pairs=pairs,
                segs=tuple(_seg(bits, height, k, size) for k in pairs),
                launches=1 + len(pairs))


def _seg(bits: int, height: int, k: int, size: int) -> int:
    """The pair launch's block order for kept level ``k``."""
    span = (1 << (k - 2)) * bits / size
    if 3 * span * level_dtype(k - 2, height).itemsize < SPAN_ORDER_BYTES:
        return 1
    return max(1, min(round(span / BLOCK_OFFSETS),
                      -(-bits // BLOCK_OFFSETS)))


def s2_plan_ok(p: dict, bits: int, height: int) -> bool:
    """The tile launcher's check (``csrc/spec_tile.cu``
    ``spec_tile_plan_ok``) mirrored."""
    m, tile = p["m"], p["tile"]
    if (bits < 1 or not 1 <= height <= 22 or m < 2 or m % 2
            or m > 2 * MAX_OUT or (1 << m) * height > 32767 or tile < 8
            or tile % 8 or p["threads"] != THREADS):
        return False
    return (HALO_SHARE * halo(m, height) <= tile
            and p["shared"] == 4 * _span(bits, height, m, tile)
            and p["shared"] <= SHARED_MAX)


def spec_tile(step0, *, bits: int, height: int, m: int, tile: int) -> list:
    """Kept levels 2, 4, ..., m of ``step0`` ((bits,) int16, spans of at
    most ``height`` bits), each (bits,) int16, the tile launch's output for
    the plan (m, tile).  CPU tensors run the plain version; CUDA tensors
    launch the kernel, or raise where the launcher would refuse the
    plan."""
    if step0.dtype != torch.int16 or step0.numel() != bits or bits < 1:
        raise ValueError("spec_tile: step0 is (bits,) int16")
    span = _span(bits, height, m, tile) if m >= 2 else 0
    p = dict(m=m, tile=tile, threads=THREADS, shared=4 * span)
    if not s2_plan_ok(p, bits, height):
        raise ValueError(f"spec_tile: the launcher refuses m={m} "
                         f"tile={tile} at height {height}, {bits} bits")
    if step0.is_cpu:
        return spec_tile_ref(step0, bits=bits, m=m)
    _build.require_cuda("spec_tile", step0)
    outs = [torch.empty(bits, dtype=torch.int16, device=step0.device)
            for _ in range(m // 2)]
    ptrs = (ctypes.c_longlong * len(outs))(*(o.data_ptr() for o in outs))
    rc = _build.get_lib().ws_spec_tile(
        step0.data_ptr(), ctypes.addressof(ptrs), len(outs), bits, height,
        m, tile, THREADS, p["shared"], _build.stream_ptr(step0))
    trace.count("launch.spec_tile")
    _build.check(rc, "spec_tile")
    return outs


def spec_tile_ref(step0, *, bits: int, m: int) -> list:
    """Plain version: ``spec_double_ref`` m times, the even levels kept as
    int16."""
    out, s = [], step0
    for j in range(1, m + 1):
        s = spec_double_ref(s, bits=bits,
                            dtype=torch.int32 if j % 2 else torch.int16)
        if j % 2 == 0:
            out.append(s)
    return out

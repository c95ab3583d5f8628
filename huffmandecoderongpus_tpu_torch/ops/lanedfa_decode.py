"""Lane-DFA decode: the fallback chain of the wide-lane decoder.

Port of ``decode_lanedfa_pallas`` (``huffmandecoderongpus_tpu/ops/
pallas_lanedfa.py``, either discovery) and of ``decode_lanedfa`` and
``_compose`` (``ops/lanedfa.py``, without the sidecar ``entries``), and of
the sidecar decodes ``decode_lanedfa_indexed`` (``ops/lanedfa.py``) and
``decode_lanedfa_indexed_pallas``.  The discovery decode cuts the stream
into G lanes of B bits, each column of the bit matrix
(``lanedfa.bits_matrix``) holding its lane's bits and H more:

  candidate_scan  H chains per lane from every entry offset -> cnt, exit
  compose         exit maps -> each lane's entry offset, base and count
  lane_scan       each lane from its entry offset -> per-bit sym, valid

and the host keeps the valid symbols, lane by lane (``discovery="sync"``
replaces the candidate scan with ``lanedfa_sync``'s discovery against the
lane scan from offset 0).  The JAX package runs
the two scans as Pallas kernels, or, for streams under ``LANE_TILE * H``
bits, as XLA scans that compute the same; the port runs both geometries
through the one pair of kernel wrappers.  With a `.huffidx` block index
each block is a lane that starts at the root and ends at its exact length,
so one scan (``lane_scan_indexed``) decodes it, in either geometry.
"""

from __future__ import annotations

import numpy as np
import torch

from huffmandecoderongpus_tpu_torch.ops.candidate_scan import candidate_scan
from huffmandecoderongpus_tpu_torch.huffio import unpack_bits
from huffmandecoderongpus_tpu_torch.ops.lane_scan import lane_scan
from huffmandecoderongpus_tpu_torch.ops.lane_scan_indexed import (
    lane_scan_indexed,
)
from huffmandecoderongpus_tpu_torch.ops.lanedfa import (
    LANE_TILE,
    bits_matrix,
    build_lane_dfa,
    pad_table,
    pick_lanes,
)
from huffmandecoderongpus_tpu_torch.utils import trace


def prefix_maps(cnt: torch.Tensor, ex: torch.Tensor):
    """(M, C) (H, G) int64: column g the exit offset and the symbols over
    lanes 0..g for a chain entering lane 0 at each offset, from the
    per-lane exit maps ``cnt``/``ex`` (H, G) int32.  An exit offset
    outside [0, H) is read as 0, as the reference's select chain does.

    Plain torch: an inclusive prefix scan of the maps by doubling
    (log2(G) steps of (H, G) gathers), where the JAX package folds
    sqrt(G)-lane groups; the composition is the same."""
    G = cnt.shape[1]
    H = cnt.shape[0]
    C = cnt.to(torch.int64)
    M = ex.to(torch.int64)
    M = torch.where((M >= 0) & (M < H), M, 0)
    # column g of (M, C): exit offset and symbols over lanes (g - d, g]
    # for a chain entering the first of them at each offset
    d = 1
    while d < G:
        nxt = M[:, :-d]
        M = torch.cat([M[:, :d], M[:, d:].gather(0, nxt)], dim=1)
        C = torch.cat([C[:, :d], C[:, :-d] + C[:, d:].gather(0, nxt)], dim=1)
        d *= 2
    return M, C


def shard_map_of(cnt: torch.Tensor, ex: torch.Tensor, maps=None):
    """The composite map of G lanes, (exit, count) (H,) int32: for a chain
    entering the first lane at each offset, its entry offset into the lane
    after the last, and the symbols it decodes on the way (the JAX
    ``_stitch``'s shard map).  ``maps``: ``prefix_maps(cnt, ex)``, when
    the caller has it."""
    M, C = prefix_maps(cnt, ex) if maps is None else maps
    return M[:, -1].to(torch.int32), C[:, -1].to(torch.int32)


def compose(cnt: torch.Tensor, ex: torch.Tensor, start=0, base=0, *,
            maps=None):
    """Chain the per-lane exit maps ``cnt``/``ex`` (H, G) int32: lane 0
    enters at offset ``start`` (an int or a 0-d tensor; one outside [0, H)
    is read as 0) with ``base`` symbols before it, lane g+1 where lane g's
    chain from its own entry exits.  Returns (entry_off, base, n) (G,)
    int32 and total (0-d int32): each lane's entry offset, the symbols
    before it, its own symbols, and the symbols through the last lane.
    ``maps``: ``prefix_maps(cnt, ex)``, when the caller has it."""
    H = cnt.shape[0]
    M, C = prefix_maps(cnt, ex) if maps is None else maps
    dev = cnt.device
    s = torch.as_tensor(start, dtype=torch.int64, device=dev).reshape(1)
    s = torch.where((s >= 0) & (s < H), s, 0)
    b = torch.as_tensor(base, dtype=torch.int64, device=dev).reshape(1)
    zero = torch.zeros(1, dtype=torch.int64, device=dev)
    row_m = M.index_select(0, s)[0]
    row_c = C.index_select(0, s)[0]
    entry = torch.cat([s, row_m[:-1]])
    lane_base = b + torch.cat([zero, row_c[:-1]])
    n = cnt.to(torch.int64).gather(0, entry[None])[0]
    i32 = torch.int32
    return (entry.to(i32), lane_base.to(i32), n.to(i32),
            (b[0] + row_c[-1]).to(i32))


def require_device(device) -> torch.device:
    """``device`` as a torch.device; raises for CUDA where it is not
    available (nothing falls back to the CPU)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device 'cuda' requested but torch.cuda.is_available() is false")
    return device


def stage_lanedfa(hf, *, device, lanes=None, tiled=True) -> dict:
    """The scans' inputs for a HuffFile: the bit matrix ``bits`` (B+H, G)
    uint8 and the padded table ``tab`` (n_chunks, 128) int32 on
    ``device``, with B, H and the stream's bit count N.  ``tiled``: the
    geometry ``decode_lanedfa_tiled`` runs (whole ``LANE_TILE`` multiples
    of lanes, up to 16384, for streams of at least ``LANE_TILE * H`` bits;
    ``decode_lanedfa``'s below); else ``decode_lanedfa``'s (a power of two
    of 4096-bit blocks, at least H bits a lane)."""
    dfa = build_lane_dfa(hf.tree)
    H = max(dfa.height, 1)
    if tiled and hf.bits >= LANE_TILE * H:
        G = (pick_lanes(hf.bits, max_lanes=1 << 14) if lanes is None
             else int(lanes))
        G = max(LANE_TILE, min(G, max(hf.bits // H, 1)))
        G = (G // LANE_TILE) * LANE_TILE
    else:
        G = pick_lanes(hf.bits) if lanes is None else int(lanes)
        G = max(1, min(G, hf.bits // H if hf.bits >= H else 1))
    mat, B = bits_matrix(hf.payload, hf.bits, G, H, round_to=512)
    bits, tab = trace.upload(device, mat, pad_table(dfa.entry))
    return dict(bits=bits, tab=tab, B=B, H=H, N=hf.bits)


def decode_lanedfa(hf, *, device, lanes=None, check_size=True) -> np.ndarray:
    """Lane-DFA decode of a HuffFile on ``device`` to host bytes, in the
    JAX package's XLA geometry (``decode_lanedfa``, without its sidecar
    ``entries``)."""
    device = require_device(device)
    return _decode(hf, stage_lanedfa(hf, device=device, lanes=lanes,
                                     tiled=False), check_size)


def decode_lanedfa_tiled(hf, *, device, lanes=None, check_size=True,
                         discovery="candidates") -> np.ndarray:
    """Lane-DFA decode in the JAX package's Pallas geometry
    (``decode_lanedfa_pallas``): ``discovery="candidates"`` runs the
    candidate scan, ``"sync"`` the lane scan from offset 0 and the
    self-synchronizing discovery (``lanedfa_sync.discover_and_splice``).
    Streams under ``LANE_TILE * H`` bits take ``decode_lanedfa``'s geometry
    and candidate discovery, as there."""
    if discovery not in ("candidates", "sync"):
        raise ValueError(f"unknown discovery {discovery!r}")
    device = require_device(device)
    st = stage_lanedfa(hf, device=device, lanes=lanes)
    if discovery == "sync" and st["N"] >= LANE_TILE * st["H"]:
        from huffmandecoderongpus_tpu_torch.ops.lanedfa_sync import (
            decode_staged_sync,
        )

        return decode_staged_sync(hf, st, check_size)
    return _decode(hf, st, check_size)


def _decode(hf, st: dict, check_size: bool) -> np.ndarray:
    kw = dict(B=st["B"], H=st["H"], N=st["N"])
    cnt, ex = candidate_scan(st["bits"], st["tab"], **kw)
    entry_off, _base, _n, total = compose(cnt, ex)
    sym, valid = lane_scan(st["bits"], st["tab"], entry_off, **kw)
    with trace.span("huff.wait"):
        total = int(total)
    if check_size and total != hf.uncompressed_size:
        raise RuntimeError(
            f"decoded {total} symbols, header says {hf.uncompressed_size}")
    return _emitted(hf, sym, valid, check_size)


def _emitted(hf, sym, valid, check_size: bool) -> np.ndarray:
    """The valid symbols of (sym, valid) (rows, G), lane by lane, on the
    host."""
    with trace.span("huff.trim"):
        out = trace.download(sym.t()[valid.t() > 0])
    if check_size and out.size != hf.uncompressed_size:
        raise RuntimeError(
            f"emitted {out.size} symbols, header says {hf.uncompressed_size}")
    return out


def stage_lanedfa_indexed(hf, offsets, *, device, tiled=True) -> dict:
    """The indexed scan's inputs: the bit matrix ``bits`` (B, G) uint8,
    column g the bits of index block g from its offset on (zero past the
    stream end), the padded table ``tab`` and the block lengths
    ``lane_len`` (G,) int32, on ``device``; B is the longest block.
    ``tiled`` pads the lanes to whole ``LANE_TILE`` multiples with
    zero-length lanes (``decode_lanedfa_indexed_pallas``'s geometry), else
    G is the number of blocks (``decode_lanedfa_indexed``'s).  Raises
    ValueError for offsets not increasing from 0."""
    offsets = np.asarray(offsets, dtype=np.int64)
    G0 = offsets.shape[0]
    lens = np.append(offsets[1:], hf.bits) - offsets
    if np.any(lens < 0) or (G0 and offsets[0] != 0):
        raise ValueError("corrupt block index: offsets not increasing from 0")
    B = int(lens.max(initial=1))
    G = -(-G0 // LANE_TILE) * LANE_TILE if tiled else G0
    offs = np.zeros(G, dtype=np.int64)
    offs[:G0] = offsets
    lane_len = np.zeros(G, dtype=np.int32)
    lane_len[:G0] = lens
    flat = np.zeros(hf.bits + B, dtype=np.uint8)
    flat[:hf.bits] = unpack_bits(hf.payload, hf.bits)
    mat = flat[offs[None, :] + np.arange(B, dtype=np.int64)[:, None]]
    dfa = build_lane_dfa(hf.tree)
    bits, tab, lane_len = trace.upload(device, mat, pad_table(dfa.entry),
                                       lane_len)
    return dict(bits=bits, tab=tab, lane_len=lane_len)


def decode_lanedfa_indexed(hf, offsets, block_symbols: int, *, device,
                           check_size=True) -> np.ndarray:
    """Sidecar decode in the JAX package's XLA geometry (one lane per index
    block): no entry discovery, each block scanned from the root to its
    exact length.  ``block_symbols`` is the index's; the scan needs only
    the offsets."""
    del block_symbols
    return _decode_indexed(hf, offsets, device, False, check_size)


def decode_lanedfa_indexed_tiled(hf, offsets, block_symbols: int, *, device,
                                 check_size=True) -> np.ndarray:
    """Sidecar decode in the JAX package's Pallas geometry
    (``decode_lanedfa_indexed_pallas``): the lanes padded to whole
    ``LANE_TILE`` multiples; under ``LANE_TILE // 4`` blocks,
    ``decode_lanedfa_indexed``'s geometry, as there."""
    if np.asarray(offsets).shape[0] < LANE_TILE // 4:
        return decode_lanedfa_indexed(hf, offsets, block_symbols,
                                      device=device, check_size=check_size)
    return _decode_indexed(hf, offsets, device, True, check_size)


def _decode_indexed(hf, offsets, device, tiled: bool,
                    check_size: bool) -> np.ndarray:
    device = require_device(device)
    st = stage_lanedfa_indexed(hf, offsets, device=device, tiled=tiled)
    sym, valid = lane_scan_indexed(st["bits"], st["tab"], st["lane_len"])
    return _emitted(hf, sym, valid, check_size)

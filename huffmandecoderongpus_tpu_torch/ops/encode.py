"""Lane-parallel device encoder: bytes -> LSB-first Huffman payload.

Port of ``huffmandecoderongpus_tpu/ops/pallas_encode.py``: the host
staging, ``shift_lanes``, ``encode_program`` and ``encode_pallas`` (here
``encode_lanes``).  The input is cut into G lanes of K_real symbols, held
as a (K, G) symbol matrix, and the device program runs

  E1 e1_pack     each lane packs its codes into 16-bit granules, one row
                 per half-code sub-step, with a valid flag
  E2 e2_compact  each lane's valid granules, dense: (G, ORP)
  E3 e3_place    the lanes' exclusive bit offsets P (phase a = P & 15,
                 granule offset W = P >> 4), each lane's granules shifted
                 to its phase, and every occupied granule into the payload,
                 in one launch (its plain version runs ``lane_offsets``,
                 ``shift_lanes`` and ``e3_place.place_ref`` in turn)

then the payload's granules become little-endian bytes, cut to
ceil(bits/8), on the device, and only those bytes come back.  Every shape
is known before the program runs: ``total_bits`` is exact from the byte
histogram.

Two cases leave the first plan, and each counts one ``encode.retry``
(``utils.trace``); both stay on the device.  A lane whose granule count reaches ORP has its
dense row cut, so E2 and E3 run again on E1's rows with ORP lifted past
the largest count.  Codes longer than 26 bits (two 13-bit halves) do not
fit E1's pack tables, so the stream goes to ``encode_ops.encode_device``.
The JAX package encodes both cases on the host with ``encode_bytes``; the
bytes are the same.  It also places payloads over 8 MiB on the host; the
port runs E3 at every size.  Unlike the JAX ``encode_pallas``, a tree
without a code for a symbol of the input raises ValueError, as
``encode_bytes`` does.
"""

from __future__ import annotations

import numpy as np
import torch

from huffmandecoderongpus_tpu_torch.huffio import (
    HuffFile,
    as_u8,
    build_block_index,
    build_tree,
    require_codes,
    tree_codes,
)
from huffmandecoderongpus_tpu_torch.ops.e1_pack import GRAN, HALF, e1_pack
from huffmandecoderongpus_tpu_torch.ops.e2_compact import e2_compact
from huffmandecoderongpus_tpu_torch.ops.e3_place import e3_place, occupancy
from huffmandecoderongpus_tpu_torch.ops.encode_ops import encode_device
from huffmandecoderongpus_tpu_torch.ops.lanedfa_decode import require_device
from huffmandecoderongpus_tpu_torch.utils import trace

#: symbol rows are a multiple of SEG (the TPU kernel's grid step)
SEG = 16


def build_pack_tables(code: np.ndarray, length: np.ndarray):
    """256-entry int32 tables: lo = code_lo13 | lo_len << 13, hi = code_hi
    | hi_len << 13 (hi_len = max(len - 13, 0))."""
    code = code.astype(np.int64)
    length = length.astype(np.int64)
    if length.max(initial=0) > 2 * HALF:
        raise ValueError("code length > 26 unsupported by the pack tables")
    lo_len = np.minimum(length, HALF)
    hi_len = np.maximum(length - HALF, 0)
    lo = (code & ((1 << HALF) - 1)) | (lo_len << HALF)
    hi = (code >> HALF) | (hi_len << HALF)
    return lo.astype(np.int32), hi.astype(np.int32)


def _prepare(data, tree):
    """(symbols, histogram, tree, code, length); raises ValueError for
    empty input and for a tree without a code for a symbol of the input."""
    with trace.span("huff.stage.hist"):
        arr = as_u8(data)
        if arr.size == 0:
            raise ValueError("cannot encode empty input")
        hist = np.bincount(arr, minlength=256)
        if tree is None:
            tree = build_tree(hist)
        code, length, present = tree_codes(tree)
        require_codes(hist, present)
        return arr, hist, tree, code, length


def _plan(N: int, hist: np.ndarray, length: np.ndarray, lanes=None) -> dict:
    """The JAX package's geometry: G lanes (2^floor(log2(N/512)) in
    [128, 8192]), K_real symbols a lane and K >= K_real + 1 rows (a
    multiple of SEG), the dense-row budget ORP (1.6 times the mean granules
    a lane, a multiple of 128) and the payload's NROWS rows of 128
    granules."""
    if lanes is None:
        G = 1 << max((N // 512).bit_length() - 1, 0)
        G = max(128, min(G, 1 << 13))
    else:
        G = int(lanes)
    K_real = -(-N // G)
    K = -(-(K_real + 1) // SEG) * SEG  # >= 1 trailing pad row per lane
    rows = 2 * K
    rows_p = -(-rows // 128) * 128
    total_bits = int(hist @ length.astype(np.int64))
    if total_bits > 2**31 - 1:
        raise ValueError("compressed stream overflows the int32 header")
    avg = float(total_bits) / N
    ORP = -(-min(int(K_real * avg / GRAN * 1.6) + 4, rows_p) // 128) * 128
    n_granules = -(-total_bits // GRAN)
    return dict(N=N, G=G, K=K, K_real=K_real, SEG=SEG, rows=rows,
                rows_p=rows_p, total_bits=total_bits, n_granules=n_granules,
                **_rows(n_granules, ORP))


def _rows(n_granules: int, ORP: int) -> dict:
    """ORP, ORPW (its rows of 128) and the payload's NROWS rows of 128
    granules, with the JAX package's slack of ORPW + 8 rows."""
    ORPW = ORP // 128
    return dict(ORP=ORP, ORPW=ORPW,
                NROWS=(-(-n_granules // 128) + ORPW + 8) // 8 * 8)


def _stage(arr, hist, tree, code, length, lanes, device) -> dict:
    with trace.span("huff.stage.lanes"):
        p = _plan(int(arr.size), hist, length, lanes)
        lo, hi = build_pack_tables(code, length)
        N, G, K, K_real = p["N"], p["G"], p["K"], p["K_real"]
        lanes_mat = np.zeros((G, K), dtype=np.uint8)
        tmp = np.zeros(G * K_real, dtype=np.uint8)
        tmp[:N] = arr
        lanes_mat[:, :K_real] = tmp.reshape(G, K_real)
        data3 = np.ascontiguousarray(lanes_mat.T)
        nval = np.clip(N - np.arange(G, dtype=np.int64) * K_real, 0,
                       K_real).astype(np.int32)
    data3, lo, hi, nval = trace.upload(device, data3, lo, hi, nval)
    return dict(plan=p, tree=tree, data3=data3, lo=lo, hi=hi, nval=nval)


def stage_encode_inputs(data, tree=None, lanes=None, *, device) -> dict:
    """The device program's inputs on ``device``: the symbol matrix
    ``data3`` (K, G) uint8 (lane g's symbols in column g, zero past its
    ``nval[g]`` real symbols), the pack tables ``lo``/``hi`` (256,) int32,
    ``nval`` (G,) int32, the ``tree`` and the ``plan`` (see ``_plan``).
    Raises ValueError for empty input, a symbol without a code and codes
    longer than 26 bits."""
    device = require_device(device)
    with trace.span("huff.stage"):
        return _stage(*_prepare(data, tree), lanes, device)


def shift_lanes(denseT, counts, shift):
    """out[g, i] = (d[g, i] << a_g | d[g, i-1] >> (16 - a_g)) & 0xFFFF,
    with d lane g's dense granules masked to its count."""
    G, ORP = denseT.shape
    i = torch.arange(ORP, device=denseT.device)[None, :]
    d = torch.where(i < counts.reshape(G, 1), denseT, 0)
    a = shift.reshape(G, 1).to(denseT.dtype)
    prev = torch.nn.functional.pad(d[:, :-1], (1, 0))
    lo = (d << a) & 0xFFFF
    hi = torch.where(a > 0, prev >> (GRAN - a), 0)
    return lo | hi


def lane_offsets(bits):
    """Where each lane's bits land, from its bit count ``bits`` (G,): the
    phase ``shift`` = P & 15 and granule offset ``word_off`` = P >> 4 of
    its exclusive bit offset P (summed in int64), and the granules ``occ``
    it occupies there; all (G,) int32."""
    L = bits.to(torch.int64)
    P = torch.cumsum(L, 0) - L
    shift = (P & (GRAN - 1)).to(torch.int32)
    return shift, (P >> 4).to(torch.int32), occupancy(shift, bits)


def place(gran, gval, cnt, bits, *, ORP, NROWS):
    """E1's outputs -> payload granules (NROWS, 128) int32: E2, then E3
    (offsets, shift and placement).  Exact when every count is below
    ORP."""
    return e3_place(e2_compact(gran, gval, ORP=ORP), cnt, bits, NROWS=NROWS)


def encode_program(data3, lo, hi, nval, *, ORP, NROWS):
    """The device encode: E1 -> E2 -> E3.  Returns
    the payload granules (NROWS, 128) int32 and the per-lane granule counts
    (G,) int32, whose maximum the caller checks against ORP."""
    gran, gval, cnt, bits = e1_pack(data3, lo, hi, nval)
    return place(gran, gval, cnt, bits, ORP=ORP, NROWS=NROWS), cnt


def payload_bytes(out, bits: int):
    """The payload's first ceil(bits/8) bytes, from granules (little-endian
    u16, one per int32), on the granules' device."""
    g = out.reshape(-1)[: -(-bits // GRAN)]
    b = torch.stack((g & 0xFF, (g >> 8) & 0xFF), dim=1).reshape(-1)
    return b[: (bits + 7) // 8].to(torch.uint8)


def encode_lanes(data, tree=None, lanes=None, *, device,
                 block_symbols: int | None = None) -> HuffFile:
    """Encode bytes on ``device`` into a HuffFile, byte-equal to
    ``huffio.encode_bytes(data, tree=tree, block_symbols=block_symbols)``.
    ``device="cuda"`` launches the kernels and raises when CUDA is not
    available; ``device="cpu"`` runs their plain versions.  A lane
    overflowing its dense row re-runs E2 and E3 with a larger ORP, and codes
    longer than 26 bits go to ``encode_device``, both on ``device``
    (each counts one ``encode.retry``).  ``block_symbols``: also attach
    the `.huffidx` block index (``huffio.build_block_index``)."""
    device = require_device(device)
    with trace.span("huff.encode"):
        with trace.span("huff.stage"):
            arr, hist, tree, code, length = _prepare(data, tree)
            long_codes = length.max(initial=0) > 2 * HALF
            if not long_codes:
                st = _stage(arr, hist, tree, code, length, lanes, device)
        if long_codes:
            trace.count("encode.retry")
            hf = encode_device(arr, tree=tree, device=device)
        else:
            hf = _encode_staged(st, tree)
        if block_symbols is not None:
            hf.index = (build_block_index(length[arr], block_symbols),
                        int(block_symbols))
        return hf


def _encode_staged(st: dict, tree) -> HuffFile:
    """E1-E3 on a staged input, and its payload's bytes to the host."""
    p = st["plan"]
    with trace.span("huff.launch"):
        gran, gval, cnt, bits = e1_pack(st["data3"], st["lo"], st["hi"],
                                        st["nval"])
        out = place(gran, gval, cnt, bits, ORP=p["ORP"], NROWS=p["NROWS"])
    with trace.span("huff.wait"):
        top = int(cnt.max())
    if top >= p["ORP"]:
        # a lane's row was cut: compact and place again with room for the
        # largest count and its phase-shift carry granule
        trace.count("encode.retry")
        r = _rows(p["n_granules"], -(-(top + 1) // 128) * 128)
        with trace.span("huff.launch"):
            out = place(gran, gval, cnt, bits, ORP=r["ORP"],
                        NROWS=r["NROWS"])
    return HuffFile(tree=tree, bits=p["total_bits"], uncompressed_size=p["N"],
                    payload=trace.download(payload_bytes(out,
                                                         p["total_bits"])))

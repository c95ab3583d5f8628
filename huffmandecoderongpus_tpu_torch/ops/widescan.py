"""Wide-lane decoder: host staging (numpy), the device program (torch), and
the ``decode_widescan`` wrapper.

Port of ``huffmandecoderongpus_tpu/ops/pallas_widescan.py``.  The stream
is cut into G lanes of B bits; the four-kernel device program runs

  words_matrix  (G, B/32) lane words -> halo'd (steps_w, G) word matrix
  K1            main scan + candidate discovery -> cells, per-lane maps:
                k1_scan2 two bits per step (min code length md >= 2),
                k1_scan one bit per step (md = 1)
  K2 k2_compose exit maps -> each lane's true entry offset
  select/cut    per-lane counts and fix rows (plain torch)
  K3            re-decode lanes entered mid-codeword, spliced in place
                (k3_fix2, or k3_fix for md = 1)
  K4 k4_compact cells -> per-lane dense bytes

and the host trims the dense rows by the per-lane counts.  As in the JAX
package, ``decode_widescan`` first routes a stream under
``ONESHOT_MAX_BITS`` that fits the one-shot envelope to the same program in
one launch (``oneshot.py``).  A stream outside the program's envelope
(staging raises :class:`EnvelopeError`) or a lane overflowing its dense row
decodes through the lane-DFA chain (``lanedfa.decode_lanedfa_tiled``) on the
same device; nothing else falls back.

With a `.huffidx` block index, ``decode_widescan_indexed`` runs the indexed
program instead: every block is a lane starting at the DFA root, so the lane
words are aligned on the device (``normalize_lane_words``), K1 runs its main
scan alone (``k1_main``) and K4 compacts; no K2 or K3, and the counts come
from the index.  ``lane_wide`` does not take this route, as in the JAX
package.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from huffmandecoderongpus_tpu_torch.ops.k1_main import k1_main
from huffmandecoderongpus_tpu_torch.ops.k1_scan import k1_scan
from huffmandecoderongpus_tpu_torch.ops.k1_scan2 import k1_scan2
from huffmandecoderongpus_tpu_torch.ops.k2_compose import k2_compose
from huffmandecoderongpus_tpu_torch.ops.k3_fix import k3_fix
from huffmandecoderongpus_tpu_torch.ops.k3_fix2 import k3_fix2
from huffmandecoderongpus_tpu_torch.ops.k4_compact import k4_compact
from huffmandecoderongpus_tpu_torch.ops.lanedfa import (
    EMIT_BIT,
    STATE_MASK,
    EnvelopeError,
    LaneDFA,
    build_lane_dfa,
)
from huffmandecoderongpus_tpu_torch.ops.lanedfa_decode import (
    decode_lanedfa_tiled,
    require_device,
)
from huffmandecoderongpus_tpu_torch.ops.quad import CELL, to_i32, u32
from huffmandecoderongpus_tpu_torch.utils import trace

#: the batched decode's state limit, the JAX package's compact-entry limit
#: (its ``MAX_STATES``); the port's tables hold up to 128 states compact
MAX_STATES = 127
#: states a compact entry holds (its 7-bit state field: states 0-127), so
#: every table of one chunk (NS = 1) is compact and every larger one wide,
#: which is how every reader picks the layout
COMPACT_STATES = 128
MAX_STATES_WIDE = 1023  # LaneDFA STATE_MASK bound; wide entries hold 15 bits
#: the map rows (HP) must fit K2's 128 entry offsets
MAX_HEIGHT = 128
#: streams below this many bits route to the one-shot launch when eligible:
#: the JAX package's threshold, kept so both packages route alike (it was
#: set on a TPU; the H100's is still to be decided)
ONESHOT_MAX_BITS = 1 << 21


# ---------------------------------------------------------------------------
# Host staging (numpy)


def pack_pair_table(dfa: LaneDFA) -> np.ndarray:
    """(NS, 128) int32 pair table for the 1-bit kernels: one word per state,
    entry(bit 0) | entry(bit 1) << 16; row c holds states [c*128,
    c*128+128).  Up to 128 states (NS = 1) the compact entry sym<<8 |
    emit<<7 | next state (an emitting entry's next state is the root, and
    a non-emitting one carries zero sym bits); beyond that the wide entry
    emit<<15 | sym<<1 when emitting, the bare state otherwise.  The JAX
    package packs 128 states wide in one chunk, which its readers take
    for compact (``compact_from_jax``)."""
    n_states = dfa.entry.shape[0] // 2
    if n_states > MAX_STATES_WIDE:
        raise ValueError(
            f"{n_states} states > {MAX_STATES_WIDE} (wide pair table)")
    NS = max(1, -(-n_states // 128))
    out = np.zeros(NS * 128, dtype=np.int64)
    for bit in (0, 1):
        e = dfa.entry[bit::2].astype(np.int64)
        emit = (e & EMIT_BIT) != 0
        state = np.where(emit, 0, e & STATE_MASK)
        sym = np.where(emit, (e >> 16) & 0xFF, 0)
        if n_states > COMPACT_STATES:
            e16 = np.where(emit, 0x8000 | (sym << 1), state)
        else:
            e16 = (sym << 8) | (emit.astype(np.int64) << 7) | state
        out[:n_states] |= e16 << (16 * bit)
    return out.astype(np.uint32).view(np.int32).reshape(NS, 128)


def pack_quad_tables(dfa: LaneDFA):
    """(2 * NS, 128) int32 quad tables + (C0, C1, NS).  Row b0*NS + c holds
    states [c*128, c*128+128), selected by the chunk's first bit; the second
    bit picks the 16-bit half.  Requires md >= 2.

    Two 16-bit entry layouts: up to 128 states (NS = 1) the compact layout
    sym<<8 | emit<<7 | post_state (post state 0 = root if the chunk's second
    bit emitted, else C[b1]; non-emitting entries carry zero sym bits);
    beyond 128 states the wide layout (emit<<15 | sym<<1 | pos when
    emitting, the bare state otherwise)."""
    n_states = dfa.entry.shape[0] // 2
    if n_states > MAX_STATES_WIDE:
        raise ValueError(
            f"{n_states} states > {MAX_STATES_WIDE} (wide quad table)")
    big = n_states > COMPACT_STATES
    NS = max(1, -(-n_states // 128))
    ent = dfa.entry.astype(np.int64)

    C = []
    for b in (0, 1):
        if ent[b] & EMIT_BIT:
            raise ValueError("md < 2: root child is a leaf")
        C.append(int(ent[b] & STATE_MASK))

    def emit16(e, pos, b1):
        sym = int((e >> 16) & 0xFF)
        if big:
            return 0x8000 | (sym << 1) | pos
        post = 0 if pos == 1 else C[b1]
        return (sym << 8) | 0x80 | post

    # int64 accumulation: an entry with the sign bit in the high half-word
    # wraps to the int32 bit pattern only at the final cast
    out = np.zeros((2 * NS, 128), dtype=np.int64)
    for st in range(n_states):
        for b0 in (0, 1):
            e0 = ent[2 * st + b0]
            for b1 in (0, 1):
                if e0 & EMIT_BIT:
                    e16 = emit16(e0, 0, b1)
                else:
                    e1 = ent[2 * int(e0 & STATE_MASK) + b1]
                    if e1 & EMIT_BIT:
                        e16 = emit16(e1, 1, b1)
                    else:
                        e16 = int(e1 & STATE_MASK)
                out[b0 * NS + st // 128, st % 128] |= e16 << (16 * b1)
    return out.astype(np.uint32).view(np.int32), C[0], C[1], NS


def _stream_buffer(payload: np.ndarray, bits: int, nbytes: int,
                   limit: int) -> np.ndarray:
    """(nbytes,) uint8: the first ``limit`` payload bytes, then zeros; bits
    at or past the stream end are zero (the kernels' per-lane limit is the
    pad test)."""
    buf = np.zeros(nbytes, dtype=np.uint8)
    nb = min(int(payload.size), limit)
    buf[:nb] = payload[:nb]
    full, rem = divmod(bits, 8)
    if full < nb:
        if rem:
            buf[full] &= (1 << rem) - 1
            buf[full + 1:nb] = 0
        else:
            buf[full:nb] = 0
    return buf


def payload_lane_words(payload: np.ndarray, bits: int, G: int,
                       B: int) -> np.ndarray:
    """(G, B//32) int32 lane-major payload words: word w of lane g holds
    stream bits [g*B + 32w, g*B + 32w + 32), LSB-first, zero past the
    stream end."""
    if B % 32:
        raise ValueError("lane bits must be whole 32-bit words")
    nbytes = G * B // 8
    buf = _stream_buffer(payload, bits, nbytes, nbytes)
    return buf.view("<u4").view(np.int32).reshape(G, B // 32)


def _plan(bits: int, H: int, md: int, lanes=None, avg_len=None):
    """Launch geometry for a stream: the JAX package's plan, constant for
    constant, so that staged inputs compare equal.  Its constants were tuned
    on a TPU; re-deciding them for the GPU is later work."""
    UNROLL = 8 if md == 1 else 4 * md
    SEG = UNROLL * max(1, 32 // UNROLL)
    if lanes is None:
        # ~500 decoded symbols per lane, rounded to a power of two in log
        # space, floored at 4096 lanes for big streams and 1024 otherwise
        size = bits / avg_len if avg_len else bits / 4.0
        xi = max(int(size / 500), 1)
        p2 = xi.bit_length() - 1
        if xi * xi > 2 << (2 * p2):
            p2 += 1
        G = 1 << p2
        G = max(4096 if bits >= (1 << 22) else 1024, min(G, 1 << 14))
        while G > 1024 and bits // G < max(2 * SEG, 2 * H):
            G //= 2
        G = max(1024, G)
    else:
        G = max(512, 1 << (max(int(lanes), 1) - 1).bit_length())
    B = -(-bits // G)
    B = -(-B // 32) * 32  # whole payload words per lane
    steps = B + H
    steps_p = -(-steps // SEG) * SEG
    NG = 1 << ((G // 128).bit_length() // 2 + 3)
    NG = min(NG, G)
    Rg = G // NG
    hard = min(B // md + 2, steps_p // md)
    if avg_len is not None and avg_len > 0:
        ORP = min(int(B / avg_len * 1.25) + 66, hard)
    else:
        ORP = hard
    ORP = -(-ORP // 128) * 128
    RB = min(G // 128, 32)
    return dict(G=G, B=B, steps=steps, steps_p=steps_p, SEG=SEG,
                UNROLL=UNROLL, NG=NG, Rg=Rg, ORP=ORP, RB=RB)


def stage_widescan_inputs(hf, *, device, lanes=None):
    """Build everything the device program needs: the plan, the table (the
    quad table for md >= 2, ``chunk2``; the pair table for md = 1) and the
    per-lane payload words and bit limits as tensors on ``device``.  Raises
    EnvelopeError for a stream the program does not take."""
    with trace.span("huff.stage"):
        with trace.span("huff.stage.tables"):
            dfa = build_lane_dfa(hf.tree)
            H = max(dfa.height, 1)
            md = max(dfa.min_depth, 1)
            n_states = dfa.entry.shape[0] // 2
            if n_states > MAX_STATES_WIDE:
                raise EnvelopeError(f"{n_states} internal states > "
                                    f"{MAX_STATES_WIDE} (wide tables)")
            if hf.bits < 1024 * max(H, 8):
                raise EnvelopeError(f"{hf.bits} bits < 1024*max(H, 8): too "
                                    "small for the wide lanes")
            if H > MAX_HEIGHT:
                # the JAX program fails in K2's map padding here instead
                raise EnvelopeError(
                    f"tree height {H} > {MAX_HEIGHT}: K2 composes at most "
                    f"{MAX_HEIGHT} entry offsets per lane")
            chunk2 = md >= 2
            if chunk2:
                tab, C0, C1, NS = pack_quad_tables(dfa)
            else:
                tab, C0, C1 = pack_pair_table(dfa), 0, 0
                NS = tab.shape[0]
        avg = hf.bits / max(hf.uncompressed_size, 1)
        p = _plan(hf.bits, H, md, lanes=lanes, avg_len=avg)
        G = p["G"]
        with trace.span("huff.stage.words"):
            w2 = payload_lane_words(hf.payload, hf.bits, G, p["B"])
            lane = np.arange(G, dtype=np.int64)
            lim = np.clip(hf.bits - lane * p["B"], -(1 << 30),
                          1 << 30).astype(np.int32)
        tab, words, lim = trace.upload(device, tab, w2, lim)
        return dict(plan=p, dfa=dfa, H=H, md=md, chunk2=chunk2, C0=C0, C1=C1,
                    NS=NS, tab=tab, words=words, lim=lim)


def compact_from_jax(tab: np.ndarray, NS: int, quad: bool, C0: int,
                     C1: int) -> np.ndarray:
    """A JAX package's pair (``quad`` False) or quad table in the port's
    layout: the JAX packers take the wide layout past 127 states, so a
    tree of exactly 128 states comes packed wide in one chunk, which every
    reader (theirs too) decodes as compact.  Such a table (NS = 1 and
    state 127 present: column 127 is nonzero, since every live state has
    nonzero entries) is rewritten compact, entry for entry; every other
    table is the port's already and comes back as it is."""
    tab = np.asarray(tab, dtype=np.int32)
    if NS != 1 or not tab[:, 127].any():
        return tab
    w = tab.astype(np.int64) & 0xFFFFFFFF
    out = np.zeros_like(w)
    for half in (0, 1):
        e = (w >> (16 * half)) & 0xFFFF
        emit = (e & 0x8000) != 0
        post = 0
        if quad:  # an emission on the chunk's first bit ends at C[b1]
            post = np.where(e & 1, 0, C1 if half else C0)
        comp = np.where(emit, ((e >> 1) & 0xFF) << 8 | 0x80 | post, e)
        out |= comp << (16 * half)
    return out.astype(np.uint32).view(np.int32)


def from_jax_staging(st: dict, device) -> dict:
    """The port's staged tensors from a staging dict of the JAX package,
    its arrays given as numpy beside the plan scalars: that of
    ``stage_widescan_inputs`` (``tabw``, ``words``, ``lim2``), of
    ``stage_widescan_indexed`` (``raw``/``sh`` for ``words``, with the
    index ``counts`` and ``nb``) or of ``stage_batch_inputs`` (``tab_bounds``
    and ``c01``: per-stream tables, see ``batch.from_jax_batch``).  A
    table the JAX package packed wide at 128 states comes converted to
    the port's compact layout (``compact_from_jax``)."""

    def t(a):
        return torch.from_numpy(np.array(a, dtype=np.int32)).to(device)

    if "tab_bounds" in st:
        from huffmandecoderongpus_tpu_torch.ops.batch import from_jax_batch

        return from_jax_batch(st, device)
    tab = compact_from_jax(np.asarray(st["tabw"]), st["NS"],
                           st.get("chunk2", True), st["C0"], st["C1"])
    out = dict(plan=dict(st["plan"]), H=st["H"], md=st["md"], C0=st["C0"],
               C1=st["C1"], NS=st["NS"], tab=t(tab),
               lim=t(st["lim2"]).reshape(-1))
    if "raw" in st:  # indexed
        out.update(raw=t(st["raw"]), sh=t(st["sh"]),
                   counts=np.asarray(st["counts"]), nb=st["nb"])
        return out
    out.update(dfa=st["dfa"], chunk2=st["chunk2"], words=t(st["words"]))
    return out


# ---------------------------------------------------------------------------
# Device program (torch around the K1-K4 wrappers)


def words_matrix(w2: torch.Tensor, steps_w: int) -> torch.Tensor:
    """(G, BW) lane words -> (steps_w, G) halo'd word matrix: row r < BW is
    word r of every lane, and row r >= BW is word r % BW of lane + r // BW
    (zeros past the last lane), so candidate chains can read up to H bits
    past their lane's end."""
    G, BW = w2.shape
    main = w2.t()
    rows = [main]
    need = steps_w - BW
    k = 1
    while need > 0:
        take = min(BW, need)
        rows.append(torch.cat([main[:take, k:], torch.zeros(
            (take, k), dtype=w2.dtype, device=w2.device)], dim=1))
        need -= take
        k += 1
    return torch.cat(rows, dim=0).contiguous()


def select_h(maps: torch.Tensor, idx: torch.Tensor, H: int) -> torch.Tensor:
    """maps (HP, G) picked per lane at idx (G,); an index outside [0, H)
    picks row 0."""
    idx = torch.where((idx >= 0) & (idx < H), idx, 0).to(torch.int64)
    return maps.gather(0, idx[None, :])[0]


def wide_decode_program(words, tab, lim, *, B, H, steps, steps_p, SEG, md,
                        ORP, chunk2, C0, C1, NS):
    """Full decode from lane words ``words`` (G, B//32) int32.  Returns
    (denseT (G, ORP) uint8, n (G,) int32, total int64 scalar tensor), all
    on the input's device.  ``chunk2`` picks the 2-bit kernels (quad
    table, md >= 2) or the 1-bit ones (pair table, md = 1).  The stages
    are ``stage_k1``, K2, ``stage_k3`` and K4, which the stage profiler
    (``harness.profiling``) also runs one by one."""
    kw = dict(H=H, steps_p=steps_p, SEG=SEG, md=md, chunk2=chunk2, C0=C0,
              C1=C1, NS=NS)
    wmat, sym, val, cntmap, exmap, mrowmap = stage_k1(
        words, tab, lim, B=B, steps=steps, **kw)
    entry, _tot = k2_compose(exmap, 0)
    sym, val, n, total = stage_k3(wmat, tab, lim, entry, cntmap, mrowmap,
                                  sym, val, **kw)
    denseT = k4_compact(sym, val, ORP=ORP)
    return denseT, n, total


def _kernel_args(steps_p, SEG, md, chunk2, C0, C1, NS) -> dict:
    kw = dict(steps_p=steps_p, SEG=SEG, md=md, NS=NS)
    if chunk2:
        kw.update(C0=C0, C1=C1)
    return kw


def stage_k1(words, tab, lim, *, B, H, steps, steps_p, SEG, md, chunk2, C0,
             C1, NS):
    """The program's first stage: the halo'd word matrix and K1 (k1_scan2,
    or k1_scan for md = 1).  Returns (wmat, sym, val, cntmap, exmap,
    mrowmap)."""
    wmat = words_matrix(words, -(-steps_p // 32))
    scan = k1_scan2 if chunk2 else k1_scan
    return (wmat, *scan(wmat, tab, lim, B=B, H=H, steps=steps,
                        **_kernel_args(steps_p, SEG, md, chunk2, C0, C1, NS)))


def stage_k3(wmat, tab, lim, entry, cntmap, mrowmap, sym, val, *, H, steps_p,
             SEG, md, chunk2, C0, C1, NS):
    """The stage after K2: the per-lane counts and their total
    (``select_h``), the fix rows and K3 (k3_fix2, or k3_fix for md = 1),
    which splices ``sym``/``val`` in place.  Returns (sym, val, n,
    total)."""
    n = select_h(cntmap, entry, H)
    total = n.sum()
    cut, cut_slot = fix_rows(entry, mrowmap, lim, H, md)
    fix = k3_fix2 if chunk2 else k3_fix
    sym, val = fix(wmat, tab, entry, cut, cut_slot, sym, val,
                   **_kernel_args(steps_p, SEG, md, chunk2, C0, C1, NS))
    return sym, val, n, total


def fix_rows(entry, mrowmap, lim, H: int, md: int):
    """(cut, cut_slot) (G,) int32 for K3.  cut = the first row the 0-chain
    owns: 0 for entry-0 lanes, merge row + 1 for merged candidates, past the
    end for unmerged ones (full replay); lanes past the stream end decode
    nothing and need no fix.  cut_slot = the first md-slot at or past it."""
    cut = torch.where(entry == 0, 0, select_h(mrowmap, entry, H) + 1)
    cut = torch.where(lim > 0, cut, 0)
    cut_slot = torch.where(cut > 0, torch.div(cut - 1, md,
                                              rounding_mode="floor") + 1, 0)
    return cut.to(torch.int32), cut_slot.to(torch.int32)


def program_args(st: dict) -> dict:
    """Keyword arguments of wide_decode_program for a staged stream."""
    p = st["plan"]
    return dict(B=p["B"], H=st["H"], steps=p["steps"], steps_p=p["steps_p"],
                SEG=p["SEG"], md=st["md"], ORP=p["ORP"], chunk2=st["chunk2"],
                C0=st["C0"], C1=st["C1"], NS=st["NS"])


def decode_widescan(hf, *, device, lanes=None, check_size=True,
                    oneshot=None) -> np.ndarray:
    """Wide-lane decode of a HuffFile on ``device`` to host bytes.

    ``device="cuda"`` runs the CUDA kernels and raises when CUDA is not
    available; ``device="cpu"`` runs their plain torch versions.

    ``oneshot``: None routes a stream under ONESHOT_MAX_BITS to the one-shot
    launch (``oneshot.decode_oneshot_staged``) when ``oneshot_eligible``
    holds, on every device; True routes every eligible stream, False none.
    The JAX package skips the route under its interpreter only because the
    interpreted kernel is slow; here the CPU runs the plain version, so no
    device is exempt.  A lane overflowing the one-shot's dense rows
    (EnvelopeError) falls through to the four-kernel program.

    A stream that staging refuses (EnvelopeError), or whose lanes overflow
    the four-kernel program's dense rows, decodes through the lane-DFA
    chain on the same device; a size mismatch with the header raises
    first."""
    # oneshot imports this module, so it is imported here
    from huffmandecoderongpus_tpu_torch.ops import oneshot as ons

    device = require_device(device)
    with trace.span("huff.decode"):
        try:
            st = stage_widescan_inputs(hf, device=device, lanes=lanes)
        except EnvelopeError:
            return decode_lanedfa_tiled(hf, device=device,
                                        check_size=check_size)
        route = oneshot if oneshot is not None else hf.bits < ONESHOT_MAX_BITS
        if route and ons.oneshot_eligible(st):
            try:
                return ons.decode_oneshot_staged(hf, st,
                                                 check_size=check_size)
            except EnvelopeError:
                pass  # a lane overflowed: the four-kernel program takes it
        ORP = st["plan"]["ORP"]
        with trace.span("huff.launch"):
            denseT, n, total = wide_decode_program(
                st["words"], st["tab"], st["lim"], **program_args(st))
        with trace.span("huff.wait"):
            total = int(total)
        if check_size and total != hf.uncompressed_size:
            raise RuntimeError(
                f"decoded {total} symbols, header says {hf.uncompressed_size}")
        with trace.span("huff.wait"):
            top = int(n.max())
        if top > ORP:  # a lane overflowed its dense row
            return decode_lanedfa_tiled(hf, device=device,
                                        check_size=check_size)
        out = trimmed(denseT, n)
        if check_size and out.size != hf.uncompressed_size:
            raise RuntimeError(f"emitted {out.size} symbols, header says "
                               f"{hf.uncompressed_size}")
        return out


def trimmed(denseT: torch.Tensor, n: torch.Tensor):
    """The first n[g] bytes of each dense row g of denseT (G, ORP), row
    after row, as a host numpy array (the trim)."""
    with trace.span("huff.trim"):
        mask = torch.arange(denseT.shape[1], device=denseT.device)[None, :] \
            < n[:, None]
        return trace.download(denseT[mask])


# ---------------------------------------------------------------------------
# Indexed decode: the `.huffidx` sidecar's blocks are the lanes


def indexed_lane_words(payload: np.ndarray, bits: int, offsets: np.ndarray,
                       BW: int):
    """(raw, sh): (len(offsets), BW+1) int32 word rows, row g the payload
    words from word offsets[g] // 32 on, and the in-word shifts offsets[g] %
    32 (G,) int32, which ``normalize_lane_words`` applies on the device."""
    nw = (bits + 31) // 32
    buf = _stream_buffer(payload, bits, (nw + BW + 2) * 4, nw * 4)
    words = buf.view("<u4").view(np.int32)
    base = (offsets >> 5).astype(np.int64)
    raw = words[base[:, None] + np.arange(BW + 1, dtype=np.int64)[None, :]]
    return np.ascontiguousarray(raw), (offsets & 31).astype(np.int32)


def normalize_lane_words(raw: torch.Tensor, sh: torch.Tensor) -> torch.Tensor:
    """(G, BW) int32 words whose bit 0 is each lane's first stream bit,
    from the raw word rows (G, BW+1) int32 and shifts (G,) int32: logical
    shifts of the uint32 bit patterns, on the input's device."""
    u = u32(raw)
    s = sh.to(torch.int64)[:, None]
    lo = u[:, :-1] >> s
    hi = torch.where(s == 0, 0, (u[:, 1:] << (32 - s)) & 0xFFFFFFFF)
    return to_i32(lo | hi)


def stage_widescan_indexed(hf, offsets, block_symbols: int, *, device,
                           lane_multiple: int = 1024) -> dict:
    """Stage the indexed decode: every index block is one lane starting at
    the DFA root, so no discovery, composition or fix scan runs, and the
    per-lane symbol counts (``counts``, host numpy) are exact.  Raises
    EnvelopeError outside the program's envelope (more than 1023 states,
    md = 1, fewer than 128 blocks, blocks over 1024 symbols) and ValueError
    for an index that does not fit the stream.

    ``lane_multiple``: the lane count is padded to a multiple of it (at
    least 1024), as the JAX package's sharded runner asks for."""
    dfa = build_lane_dfa(hf.tree)
    H = max(dfa.height, 1)
    md = max(dfa.min_depth, 1)
    n_states = dfa.entry.shape[0] // 2
    if n_states > MAX_STATES_WIDE:
        raise EnvelopeError("tree exceeds the wide quad-table state limit")
    if md < 2:
        raise EnvelopeError("indexed widescan needs min code length >= 2")
    offsets = np.asarray(offsets, dtype=np.int64)
    nb = offsets.shape[0]
    if nb < 128:
        raise EnvelopeError("too few index blocks for the wide program")
    if block_symbols > 1024:
        raise EnvelopeError("index blocks too long for the wide program")
    lens = np.append(offsets[1:], hf.bits) - offsets
    if np.any(lens < 0) or offsets[0] != 0:
        raise ValueError("corrupt block index: offsets not increasing from 0")
    UNROLL = 4 * md
    SEG = math.lcm(CELL * md, 32)
    steps_p = -(-int(lens.max(initial=1)) // SEG) * SEG
    BW = -(-steps_p // 32)
    lane_multiple = max(int(lane_multiple), 1024)
    G = max(lane_multiple, -(-nb // lane_multiple) * lane_multiple)
    R = G // 128
    # the JAX plan's row-group block (a TPU grid constant, kept so staged
    # plans compare equal)
    RB = 32 if R % 32 == 0 else (16 if R % 16 == 0 else 8)
    if SEG > 96:
        RB = min(RB, 16)
    counts = np.zeros(G, dtype=np.int32)
    counts[:nb] = block_symbols
    counts[nb - 1] = hf.uncompressed_size - (nb - 1) * block_symbols
    if counts[nb - 1] < 0 or counts[:nb].max(initial=0) > block_symbols:
        raise ValueError("block index inconsistent with the header")
    # ORP >= block_symbols: an indexed lane cannot overflow its dense row
    ORP = -(-block_symbols // 128) * 128
    tab, C0, C1, NS = pack_quad_tables(dfa)
    offs_p = np.zeros(G, dtype=np.int64)
    offs_p[:nb] = offsets
    raw, sh = indexed_lane_words(hf.payload, hf.bits, offs_p, BW)
    lim = np.zeros(G, dtype=np.int32)
    lim[:nb] = lens
    tab, raw, sh, lim = trace.upload(device, tab, raw, sh, lim)
    return dict(plan=dict(B=steps_p, steps=steps_p, steps_p=steps_p, SEG=SEG,
                          UNROLL=UNROLL, G=G, RB=RB, ORP=ORP),
                H=H, md=md, C0=C0, C1=C1, NS=NS, tab=tab, raw=raw, sh=sh,
                lim=lim, counts=counts, nb=nb)


def wide_decode_indexed_program(raw, sh, tab, lim, *, steps_p, md, ORP, C0,
                                C1, NS):
    """The indexed decode: align the lane words, transpose them into the
    (BW, G) word matrix (no halo rows: a lane ends where its block ends),
    K1's main scan alone (``k1_main``), K4.  Returns denseT (G, ORP)
    uint8."""
    wmat = normalize_lane_words(raw, sh).t().contiguous()
    sym, val = k1_main(wmat, tab, lim, steps_p=steps_p, md=md, C0=C0, C1=C1,
                       NS=NS)
    return k4_compact(sym, val, ORP=ORP)


def indexed_args(st: dict) -> dict:
    """Keyword arguments of wide_decode_indexed_program for an indexed
    staging."""
    p = st["plan"]
    return dict(steps_p=p["steps_p"], md=st["md"], ORP=p["ORP"], C0=st["C0"],
                C1=st["C1"], NS=st["NS"])


def decode_widescan_indexed(hf, offsets, block_symbols: int, *, device,
                            check_size=True) -> np.ndarray:
    """Decode a HuffFile through its `.huffidx` block index on ``device``
    to host bytes: the blocks are the lanes, the program is K1's main scan
    and K4, and each lane is trimmed to its count from the index.  Raises
    EnvelopeError outside the indexed envelope (callers take another
    route)."""
    device = require_device(device)
    st = stage_widescan_indexed(hf, offsets, block_symbols, device=device)
    with trace.span("huff.launch"):
        denseT = wide_decode_indexed_program(st["raw"], st["sh"], st["tab"],
                                             st["lim"], **indexed_args(st))
    (counts,) = trace.upload(device, st["counts"])
    out = trimmed(denseT, counts)
    if check_size and out.size != hf.uncompressed_size:
        raise RuntimeError(
            f"emitted {out.size} symbols, header says {hf.uncompressed_size}")
    return out

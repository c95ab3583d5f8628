"""Wide-lane decoder: host staging (numpy), the device program (torch), and
the ``decode_widescan`` wrapper.

Port of the chunked (min code length md >= 2) path of
``huffmandecoderongpus_tpu/ops/pallas_widescan.py``.  The stream is cut into
G lanes of B bits; the device program runs

  words_matrix  (G, B/32) lane words -> halo'd (steps_w, G) word matrix
  K1 k1_scan2   main scan + candidate discovery -> cells, per-lane maps
  K2 k2_compose exit maps -> each lane's true entry offset
  select/cut    per-lane counts and fix rows (plain torch)
  K3 k3_fix2    re-decode lanes entered mid-codeword, spliced in place
  K4 k4_compact cells -> per-lane dense bytes

and the host trims the dense rows by the per-lane counts.  Everything
outside this envelope raises :class:`EnvelopeError` naming the ROADMAP item
that will lift it; nothing falls back to another decoder or device.
"""

from __future__ import annotations

import numpy as np
import torch

from huffmandecoderongpus_tpu_torch.ops.k1_scan2 import k1_scan2
from huffmandecoderongpus_tpu_torch.ops.k2_compose import k2_compose
from huffmandecoderongpus_tpu_torch.ops.k3_fix2 import k3_fix2
from huffmandecoderongpus_tpu_torch.ops.k4_compact import k4_compact
from huffmandecoderongpus_tpu_torch.ops.lanedfa import (
    EMIT_BIT,
    STATE_MASK,
    LaneDFA,
    build_lane_dfa,
)
from huffmandecoderongpus_tpu_torch.ops.quad import CELL

MAX_STATES = 127  # compact-entry limit: the state field is 7 bits
MAX_STATES_WIDE = 1023  # LaneDFA STATE_MASK bound; wide entries hold 15 bits
#: the map rows (HP) must fit K2's 128 entry offsets
MAX_HEIGHT = 128


class EnvelopeError(ValueError):
    """The stream or tree is outside what this port decodes yet."""


# ---------------------------------------------------------------------------
# Host staging (numpy)


def pack_quad_tables(dfa: LaneDFA):
    """(2 * NS, 128) int32 quad tables + (C0, C1, NS).  Row b0*NS + c holds
    states [c*128, c*128+128), selected by the chunk's first bit; the second
    bit picks the 16-bit half.  Requires md >= 2.

    Two 16-bit entry layouts: up to 127 states the compact layout
    sym<<8 | emit<<7 | post_state (post state 0 = root if the chunk's second
    bit emitted, else C[b1]; non-emitting entries carry zero sym bits);
    beyond 127 states the wide layout (emit<<15 | sym<<1 | pos when
    emitting, the bare state otherwise)."""
    n_states = dfa.entry.shape[0] // 2
    if n_states > MAX_STATES_WIDE:
        raise ValueError(
            f"{n_states} states > {MAX_STATES_WIDE} (wide quad table)")
    big = n_states > MAX_STATES
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


def payload_lane_words(payload: np.ndarray, bits: int, G: int,
                       B: int) -> np.ndarray:
    """(G, B//32) int32 lane-major payload words: word w of lane g holds
    stream bits [g*B + 32w, g*B + 32w + 32), LSB-first.  Bits at or past the
    stream end are zero (the kernels' per-lane limit is the pad test)."""
    if B % 32:
        raise ValueError("lane bits must be whole 32-bit words")
    nbytes = G * B // 8
    buf = np.zeros(nbytes, dtype=np.uint8)
    nb = min(int(payload.size), nbytes)
    buf[:nb] = payload[:nb]
    full, rem = divmod(bits, 8)
    if full < nb:
        if rem:
            buf[full] &= (1 << rem) - 1
            buf[full + 1:nb] = 0
        else:
            buf[full:nb] = 0
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
    """Build everything the device program needs: the plan, the quad table
    and the per-lane payload words and bit limits as tensors on
    ``device``.  Raises EnvelopeError outside the port's envelope."""
    dfa = build_lane_dfa(hf.tree)
    H = max(dfa.height, 1)
    md = max(dfa.min_depth, 1)
    n_states = dfa.entry.shape[0] // 2
    if n_states > MAX_STATES_WIDE:
        raise EnvelopeError(
            f"{n_states} internal states > {MAX_STATES_WIDE}: needs the "
            "lane-DFA fallback chain (ROADMAP Queue 1 item 6)")
    if hf.bits < 1024 * max(H, 8):
        raise EnvelopeError(
            f"{hf.bits} bits < 1024*max(H, 8): tiny streams need the "
            "lane-DFA fallback chain (ROADMAP Queue 1 item 6)")
    if md < 2:
        raise EnvelopeError(
            "min code length 1: needs the 1-bit kernels k1_scan/k3_fix "
            "(ROADMAP Queue 1 item 4)")
    if H > MAX_HEIGHT:
        raise EnvelopeError(
            f"tree height {H} > {MAX_HEIGHT}: K2 composes at most "
            f"{MAX_HEIGHT} entry offsets per lane")
    avg = hf.bits / max(hf.uncompressed_size, 1)
    p = _plan(hf.bits, H, md, lanes=lanes, avg_len=avg)
    G = p["G"]
    tabq, C0, C1, NS = pack_quad_tables(dfa)
    w2 = payload_lane_words(hf.payload, hf.bits, G, p["B"])
    lane = np.arange(G, dtype=np.int64)
    lim = np.clip(hf.bits - lane * p["B"], -(1 << 30), 1 << 30).astype(np.int32)
    return dict(plan=p, dfa=dfa, H=H, md=md, C0=C0, C1=C1, NS=NS,
                tab=torch.from_numpy(tabq).to(device),
                words=torch.from_numpy(w2).to(device),
                lim=torch.from_numpy(lim).to(device))


def from_jax_staging(st: dict, device) -> dict:
    """The port's staged tensors from the JAX package's
    ``stage_widescan_inputs`` result, its arrays given as numpy
    (``tabw``, ``words``, ``lim2``) beside the plan scalars."""
    if not st["chunk2"]:
        raise EnvelopeError("min code length 1 (ROADMAP Queue 1 item 4)")

    def t(a):
        return torch.from_numpy(np.array(a, dtype=np.int32)).to(device)

    return dict(plan=dict(st["plan"]), dfa=st["dfa"], H=st["H"], md=st["md"],
                C0=st["C0"], C1=st["C1"], NS=st["NS"], tab=t(st["tabw"]),
                words=t(st["words"]), lim=t(st["lim2"]).reshape(-1))


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
                        ORP, C0, C1, NS):
    """Full decode from lane words ``words`` (G, B//32) int32.  Returns
    (denseT (G, ORP) uint8, n (G,) int32, total int64 scalar tensor), all
    on the input's device."""
    wmat = words_matrix(words, -(-steps_p // 32))
    kw = dict(steps_p=steps_p, SEG=SEG, md=md, C0=C0, C1=C1, NS=NS)
    sym, val, cntmap, exmap, mrowmap = k1_scan2(
        wmat, tab, lim, B=B, H=H, steps=steps, **kw)
    entry, _tot = k2_compose(exmap, 0)
    n = select_h(cntmap, entry, H)
    total = n.sum()
    cut, cut_slot = fix_rows(entry, mrowmap, lim, H, md)
    sym, val = k3_fix2(wmat, tab, entry, cut, cut_slot, sym, val, **kw)
    denseT = k4_compact(sym, val, ORP=ORP)
    return denseT, n, total


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
                SEG=p["SEG"], md=st["md"], ORP=p["ORP"], C0=st["C0"],
                C1=st["C1"], NS=st["NS"])


def decode_widescan(hf, *, device, lanes=None, check_size=True) -> np.ndarray:
    """Wide-lane decode of a HuffFile on ``device`` to host bytes.

    ``device="cuda"`` runs the CUDA kernels and raises when CUDA is not
    available; ``device="cpu"`` runs their plain torch versions."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device 'cuda' requested but torch.cuda.is_available() is false")
    st = stage_widescan_inputs(hf, device=device, lanes=lanes)
    ORP = st["plan"]["ORP"]
    denseT, n, total = wide_decode_program(st["words"], st["tab"], st["lim"],
                                           **program_args(st))
    total = int(total)
    if check_size and total != hf.uncompressed_size:
        raise RuntimeError(
            f"decoded {total} symbols, header says {hf.uncompressed_size}")
    if int(n.max()) > ORP:
        raise EnvelopeError(
            f"a lane decoded {int(n.max())} symbols > ORP={ORP}: needs the "
            "lane-DFA fallback chain (ROADMAP Queue 1 item 6)")
    mask = torch.arange(ORP, device=device)[None, :] < n[:, None]
    out = denseT[mask].cpu().numpy()
    if check_size and out.size != hf.uncompressed_size:
        raise RuntimeError(
            f"emitted {out.size} symbols, header says {hf.uncompressed_size}")
    return out

"""The one-shot decode: the whole wide-lane program in one kernel launch.

Port of ``huffmandecoderongpus_tpu/ops/pallas_oneshot.py``:
``oneshot_eligible``, ``oneshot_program`` / ``_oneshot_kernel`` and
``decode_oneshot`` / ``decode_oneshot_staged``.  CUDA source:
``csrc/oneshot.cu``.

``oneshot_program`` computes what the four-kernel
``widescan.wide_decode_program`` computes for a chunked tree (min code
length >= 2): K1's main scan and candidate chains, K2's composition, the
per-lane counts and cut rows, K3's fix and splice and K4's compaction.  On
CUDA tensors that is one cooperative launch, with K2's three steps between
grid barriers: a team of threads a lane runs K1's chains side by side, and
K4's block-wide body compacts each block's lanes (launch plan:
``oneshot_plan``); on CPU tensors it is the plain version, the four
kernels' plain stages in sequence.  The
dense rows are zero past each lane's count.  (K4 alone zeroes only past a
lane's valid slots: a lane that K3 replays to its end keeps the halo's
symbols past its count.  The JAX kernel leaves the bytes past the counts
undefined, so a comparison with it masks by the counts.)

``widescan.decode_widescan`` routes a stream under ``ONESHOT_MAX_BITS``
here when ``oneshot_eligible`` holds, as the JAX package does.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from huffmandecoderongpus_tpu_torch.ops import _build, widescan
from huffmandecoderongpus_tpu_torch.ops._build import (
    BLOCK_RESERVED,
    BLOCK_SHARED_MAX,
    SM_COUNT,
    SM_REGISTERS,
    SM_SHARED,
    SM_THREADS,
)
from huffmandecoderongpus_tpu_torch.ops.k1_scan2 import (
    _shapes,
    k1_scan2_ref,
    seg_bits,
    step_bytes,
    team_chains,
    team_words,
)
from huffmandecoderongpus_tpu_torch.ops.k2_compose import (
    NE,
    groups,
    k2_compose_ref,
)
from huffmandecoderongpus_tpu_torch.ops.k3_fix2 import k3_fix2_ref
from huffmandecoderongpus_tpu_torch.ops.k4_compact import (
    k4_compact_ref,
    k4_plan,
)
from huffmandecoderongpus_tpu_torch.ops.lanedfa import EnvelopeError
from huffmandecoderongpus_tpu_torch.ops.lanedfa_decode import require_device
from huffmandecoderongpus_tpu_torch.ops.quad import CELL
from huffmandecoderongpus_tpu_torch.utils import trace

#: most bytes of the one-shot working set: the lane words, cells, maps and
#: dense rows of the fused launch, counted with the JAX package's word
#: model (``oneshot_eligible``) so that the port routes the same streams.
#: At this size the whole working set stays resident in the H100's 50 MB L2.
ONESHOT_WORKING_SET_BYTES = 10 * 1024 * 1024

#: the kernel's phases, as split by its timer stamps (``phase_ms``)
PHASES = ("K1", "K2 group maps", "K2 scan", "K2 apply", "K3", "K4")

#: the card's facts the plan uses (SM_COUNT, SM_SHARED, SM_THREADS,
#: SM_REGISTERS, BLOCK_SHARED_MAX, BLOCK_RESERVED) are ``_build``'s; the
#: kernel's block, and the blocks an SM must hold by its registers
#: (``__launch_bounds__(THREADS, MIN_BLOCKS)``: at most 128 a thread)
THREADS = 128
MIN_BLOCKS = 4
#: most bytes of K4's staged rows in the one-shot's last phase
K4_STAGE_MAX = 32 * 1024
#: cudaErrorCooperativeLaunchTooLarge: the launcher's refusal of a grid
#: that the card cannot hold at once
COOPERATIVE_LAUNCH_TOO_LARGE = 720
#: the scratch arrays, in the order the launcher cuts them
SCRATCH = ("sym", "val", "cntmap", "exmap", "mrowmap", "gmap", "goff", "tot",
           "entry")


@functools.lru_cache(maxsize=256)
def oneshot_plan(G: int, H: int, md: int, SEG: int, steps_p: int, ORP: int,
                 NS: int, sm_count: int = SM_COUNT) -> dict:
    """Launch plan of the one-shot kernel on a card of ``sm_count`` SMs.
    Each lane has a team of ``T`` threads (a power of two from 4 to 32, so
    teams never straddle a warp): the smallest that gives each of its CH
    candidate chains a thread of its own beside the main chain's, halved
    while the grid of G * T threads would need more blocks of ``THREADS``
    than ``MIN_BLOCKS`` an SM on ``sm_count`` SMs and T / 2 still gives
    each of the NL leaders a thread of its own (T >= NL + 1).
    ``lanes`` a block (THREADS / T), ``blocks``, ``shared``: the dynamic
    shared bytes of a block (it has no static ones), the step table of NS
    table chunks (``step_bytes``), then the largest of the teams' K1 state
    and rings, K2's staged group maps and K4's staged rows (``k4``,
    ``k4_plan`` over the block's lanes) with the lanes' counts; ``per_sm``:
    the blocks an SM holds by threads, shared memory and registers, and
    ``fits`` whether the grid is co-resident on ``sm_count`` SMs (a grid
    that is not cannot launch: ``decode_oneshot_staged`` then raises
    EnvelopeError).  ``offsets``/``scratch_bytes``: the scratch buffer's
    cut (``SCRATCH``, each 256-byte aligned).  Raises ValueError for a
    geometry outside the kernel's bounds."""
    CH, HP, cells_p = _shapes(H, steps_p, md)
    NL = min(md, CH)
    if (SEG != seg_bits(md) or not 2 <= md <= 8
            or HP > NE or steps_p % SEG or G % 128 or ORP % 128
            or not 1 <= NS <= 8):
        raise ValueError("geometry outside the one-shot kernel's bounds "
                         "(see oneshot_eligible)")
    T = 4
    while T < 32 and T < CH + 1:
        T *= 2
    while (T // 2 >= max(4, NL + 1)
           and G * T // THREADS > sm_count * MIN_BLOCKS):
        T //= 2
    lanes = THREADS // T
    L, NGp = groups(G)
    k1 = lanes * team_words(CH, NL, SEG // 2) * 4
    k4 = k4_plan(G, cells_p, ORP, lanes=lanes, threads=THREADS,
                 stage_max=K4_STAGE_MAX, min_lanes=4)
    phases = max(k1, NGp * NE, k4["shared"] + 4 * lanes)
    shared = step_bytes(NS) + -(-phases // 16) * 16
    per_sm = min(MIN_BLOCKS, SM_THREADS // THREADS,
                 SM_SHARED // (shared + BLOCK_RESERVED))
    blocks = G * T // THREADS
    sizes = dict(sym=cells_p * G * 4, val=cells_p * G, cntmap=HP * G * 4,
                 exmap=HP * G * 4, mrowmap=HP * G * 4, gmap=NGp * NE,
                 goff=NGp * 4, tot=NE, entry=G * 4)
    offsets, end = [], 0
    for name in SCRATCH:
        offsets.append(end)
        end = -(-(end + sizes[name]) // 256) * 256
    return dict(T=T, lanes=lanes, blocks=blocks, threads=THREADS,
                shared=shared, per_sm=per_sm, sm_count=sm_count,
                fits=blocks <= sm_count * per_sm,
                registers=SM_REGISTERS // (THREADS * MIN_BLOCKS), k4=k4,
                L=L, NGp=NGp, offsets=tuple(offsets), scratch_bytes=end,
                c_offsets=(ctypes.c_longlong * len(offsets))(*offsets))


def oneshot_eligible(st) -> bool:
    """Whether a staged stream (``widescan.stage_widescan_inputs``) fits
    the one-shot launch: a chunked tree, at most 32 blocks of 128 lanes
    (G <= 4096), a halo no wider than a lane, and a working set of at most
    ``ONESHOT_WORKING_SET_BYTES``."""
    p = st["plan"]
    if not st["chunk2"]:
        return False
    G = p["G"]
    R = G // 128
    if R > 32:
        return False
    CH, HP, cells_p = _shapes(st["H"], p["steps_p"], st["md"])
    steps_w = -(-p["steps_p"] // 32)
    BW = p["B"] // 32
    if steps_w - BW > BW:
        return False
    words = (cells_p * 2 * R * 128          # sym + val
             + steps_w * R * 128            # word matrix
             + G * (-(-BW // 128) * 128)    # (G, BW) input, lane-padded
             + CH * 4 * R * 128             # candidate chains
             + (p["SEG"] // 2) * 2 * R * 128  # per-segment scratch
             + HP * 3 * R * 128             # maps
             + 128 * R * 128                # composition
             + G * p["ORP"] // 4            # dense rows (u8)
             + 8 * R * 128)
    return words * 4 <= ONESHOT_WORKING_SET_BYTES


class CoresidencyError(RuntimeError):
    """The launcher refused a grid that the card cannot hold at once."""


def program_args(st: dict) -> dict:
    """Keyword arguments of oneshot_program for a staged stream."""
    args = widescan.program_args(st)
    del args["chunk2"]
    return args


def oneshot_program(words, tab, lim, *, B, H, steps, steps_p, SEG, md, C0,
                    C1, NS, ORP, stamps=None):
    """Whole decode from lane words ``words`` (G, B//32) int32, the quad
    table ``tab`` (2 * NS, 128) int32 and per-lane bit limits ``lim`` (G,)
    int32.  Returns (denseT (G, ORP) uint8, n (G,) int32, total int64
    scalar tensor) on the input's device.  Raises EnvelopeError for a halo
    wider than a lane.  CPU tensors run the plain version; CUDA tensors
    launch the kernel, which writes its device clock at each phase
    boundary into ``stamps`` (a (len(PHASES) + 1,) int64 CUDA tensor) when
    one is given (see ``phase_ms``).  A grid the card cannot hold at once
    is refused by the launcher, without launching, as CoresidencyError (a
    RuntimeError)."""
    G, BW = words.shape
    if -(-steps_p // 32) - BW > BW:
        raise EnvelopeError("halo wider than a lane (steps_w - BW > BW): "
                            "outside the one-shot envelope")
    kw = dict(B=B, H=H, steps=steps, steps_p=steps_p, SEG=SEG, md=md, C0=C0,
              C1=C1, NS=NS, ORP=ORP)
    if words.device.type == "cpu" and stamps is None:
        return oneshot_program_ref(words, tab, lim, **kw)
    _build.require_cuda("oneshot", words, tab, lim,
                        *(() if stamps is None else (stamps,)))
    if stamps is not None and stamps.shape != (len(PHASES) + 1,):
        raise ValueError("oneshot: stamps must hold len(PHASES) + 1 values")
    if BW * 32 != B or NS > 8:
        raise ValueError("geometry outside the one-shot kernel's bounds "
                         "(see oneshot_eligible)")
    dev = words.device
    p = oneshot_plan(G, H, md, SEG, steps_p, ORP, NS, _build.sm_count(dev))
    k4 = p["k4"]
    denseT = torch.empty((G, ORP), dtype=torch.uint8, device=dev)
    n = torch.empty(G, dtype=torch.int32, device=dev)
    total = torch.empty((), dtype=torch.int64, device=dev)
    scratch = torch.empty(p["scratch_bytes"], dtype=torch.uint8, device=dev)
    rc = _build.get_lib().ws_oneshot(
        words.data_ptr(), tab.data_ptr(), lim.data_ptr(),
        denseT.data_ptr(), n.data_ptr(), total.data_ptr(),
        scratch.data_ptr(), ctypes.addressof(p["c_offsets"]),
        p["scratch_bytes"], None if stamps is None else stamps.data_ptr(),
        G, BW, B, H, steps, steps_p, SEG, md, C0, C1, NS, ORP, p["L"],
        p["NGp"], p["T"], k4["lanes"], k4["vec"], k4["chunks"],
        k4["window"], p["shared"], _build.stream_ptr(words))
    trace.count("launch.oneshot")
    _build.check(rc, "oneshot", CoresidencyError
                 if rc == COOPERATIVE_LAUNCH_TOO_LARGE else RuntimeError)
    return denseT, n, total


def phase_ms(words, tab, lim, **kw) -> dict:
    """Device time (ms) of each of the kernel's PHASES in one launch on
    CUDA tensors, from its timer stamps (%globaltimer): K1 and K2's steps up
    to each grid barrier, then K3 and K4 up to the last warp's end."""
    stamps = torch.zeros(len(PHASES) + 1, dtype=torch.int64,
                         device=words.device)
    oneshot_program(words, tab, lim, stamps=stamps, **kw)
    t = stamps.tolist()
    return {name: (t[i + 1] - t[i]) / 1e6 for i, name in enumerate(PHASES)}


def oneshot_program_ref(words, tab, lim, *, B, H, steps, steps_p, SEG, md,
                        C0, C1, NS, ORP):
    """Plain oneshot_program: the four kernels' plain stages in sequence
    (words_matrix, K1, K2, select_h, fix_rows, K3, K4), then the rows
    zeroed past the counts."""
    wmat = widescan.words_matrix(words, -(-steps_p // 32))
    kw = dict(steps_p=steps_p, SEG=SEG, md=md, C0=C0, C1=C1, NS=NS)
    sym, val, cntmap, exmap, mrowmap = k1_scan2_ref(
        wmat, tab, lim, B=B, H=H, steps=steps, **kw)
    entry, _tot = k2_compose_ref(exmap, 0)
    n = widescan.select_h(cntmap, entry, H)
    cut, cut_slot = widescan.fix_rows(entry, mrowmap, lim, H, md)
    sym, val = k3_fix2_ref(wmat, tab, entry, cut, cut_slot, sym, val, **kw)
    denseT = k4_compact_ref(sym, val, ORP=ORP)
    denseT[torch.arange(ORP, device=n.device)[None, :] >= n[:, None]] = 0
    return denseT, n, n.sum()


def decode_oneshot(hf, *, device, lanes=None, check_size=True) -> np.ndarray:
    """One-shot decode of a HuffFile on ``device`` to host bytes.  Raises
    EnvelopeError for a stream outside the one-shot envelope (callers fall
    back to ``widescan.decode_widescan``)."""
    device = require_device(device)
    st = widescan.stage_widescan_inputs(hf, device=device, lanes=lanes)
    if not oneshot_eligible(st):
        raise EnvelopeError("stream outside the one-shot envelope")
    return decode_oneshot_staged(hf, st, check_size=check_size)


def decode_oneshot_staged(hf, st, *, check_size=True) -> np.ndarray:
    """One-shot decode of an already staged stream (the router in
    ``widescan.decode_widescan`` calls this to avoid staging twice).
    Raises EnvelopeError when the launch's grid is not co-resident on the
    card (by the plan for its SM count, or by the launcher's refusal) or a
    lane overflows its dense row, and RuntimeError when the size disagrees
    with the header."""
    p = st["plan"]
    ORP = p["ORP"]
    sms = _build.sm_count(st["words"].device)
    plan = oneshot_plan(p["G"], st["H"], st["md"], p["SEG"], p["steps_p"],
                        ORP, st["NS"], sms)
    if not plan["fits"]:
        raise EnvelopeError(f"the one-shot grid of {plan['blocks']} blocks "
                            f"is not co-resident on {sms} SMs")
    try:
        with trace.span("huff.launch"):
            denseT, n, _total = oneshot_program(
                st["words"], st["tab"], st["lim"], **program_args(st))
    except CoresidencyError as e:
        raise EnvelopeError(str(e)) from e
    with trace.span("huff.wait"):
        top = int(n.max())
    if top > ORP:
        raise EnvelopeError("a lane overflowed the dense buffer")
    out = widescan.trimmed(denseT, n)
    if check_size and out.size != hf.uncompressed_size:
        raise RuntimeError(
            f"emitted {out.size} symbols, header says {hf.uncompressed_size}")
    return out

"""K1: chunked main scan + self-synchronizing candidate discovery.

Replaces ``huffmandecoderongpus_tpu/ops/pallas_widescan.py`` ``k1_scan2`` /
``_k1_kernel2`` (md >= 2 trees).  CUDA source: ``csrc/k1_scan2.cu``.  The
batched ``c01``/``tab_bounds`` variant is ``k1_scan2_c01.py`` and
``discover=False`` is ``k1_main.py``.  On the card each lane is walked by a
team of threads (``csrc/widescan.cuh`` ``k1_team``, which the one-shot
kernel runs too); ``k1_plan`` plans the launch of both K1 kernels.

Every lane walks its B bits (plus an H-bit halo into the next lane) two bits
per step through the quad table: the main chain (entry offset 0) writes the
cell-packed emissions, and one candidate chain per entry offset 1..H-1 runs
until it state-merges with the main chain or with its residue class's
leader, exits the lane late, or reaches the stream end.  Outputs, in the JAX
package's logical layouts with lanes minor:

  sym     (cells_p, G) int32  4 symbol bytes per cell (slot = bit // md)
  val     (cells_p, G) uint8  valid nibble per cell
  cntmap  (HP, G) int32       symbols the lane emits for each entry offset
  exmap   (HP, G) int32       the next lane's entry offset for each entry
  mrowmap (HP, G) int32       merge row (-1 for entry 0, ``steps`` unmerged)
"""

from __future__ import annotations

import functools

import torch

from huffmandecoderongpus_tpu_torch.ops import _build
from huffmandecoderongpus_tpu_torch.ops.quad import (
    CELL,
    chunk_rows,
    decode_entry,
    quad_entry,
    scatter_slots,
    to_i32,
    u32,
)
from huffmandecoderongpus_tpu_torch.utils import trace

#: the K1 kernels' block (``K1_THREADS``), and the blocks an SM must hold
#: by their registers (``__launch_bounds__(K1_THREADS, MIN_BLOCKS)``: at
#: most 128 a thread)
THREADS = 128
MIN_BLOCKS = 4
#: ``k1_plan``'s two regimes: lanes of at least LONG_LANE_SEGMENTS segments
#: on a grid that, with a thread a chain, would put more than
#: BUSY_WARPS_PER_SM warps on each SM take the smallest team (their main
#: chains' rows dominate, and cost more the more warps an SM issues for);
#: every other launch gives each chain a thread of its own (the chains'
#: rows dominate).  Chosen by measurement on an H100 SXM, 700 W (PERF.md).
LONG_LANE_SEGMENTS = 32
BUSY_WARPS_PER_SM = 16


def _shapes(H, steps_p, md):
    """(CH, HP, cells_p): candidate chains (entry offsets 1..CH), map rows
    (CH + 1 rounded up to 8) and cells per lane."""
    CH = max(H - 1, 1)
    return CH, -(-(CH + 1) // 8) * 8, steps_p // md // CELL


def seg_bits(md: int) -> int:
    """SEG of min code length md, as ``widescan._plan`` makes it (and
    ``csrc/widescan.cuh`` ``seg_bits``)."""
    unroll = 4 * md
    return unroll * max(1, 32 // unroll)


def step_bytes(NS: int) -> int:
    """Shared bytes of the K1 kernels' step table (``widescan.cuh``): a
    4-byte entry a (state, 2-bit chunk), 128 states a table chunk."""
    return NS * 128 * 4 * 4


def team_words(CH: int, NL: int, SEGH: int) -> int:
    """int32 words of one team's shared memory (``widescan.cuh``
    ``team_words``): the CH chains' state (4 words each), the main chain's
    count and exit, three main-chain slots (the bits, a state and a count a
    row) and two leader slots (a state and a count a row and leader),
    rounded up to 4."""
    n = 4 * CH + 2 + 3 * (1 + 2 * SEGH) + 2 * (2 * SEGH * NL)
    return -(-n // 4) * 4


def team_chains(T: int, CH: int) -> list[list[int]]:
    """The candidate chains each thread of a team of ``T`` walks, in turn
    (``widescan.cuh`` ``k1_team``): thread 0 the main chain alone, thread
    j >= 1 chains j - 1, j - 1 + (T - 1), ...; chains below NL are the
    leaders, so with T >= NL + 1 each leader is its thread's first."""
    return [[]] + [list(range(j - 1, CH, T - 1)) for j in range(1, T)]


@functools.lru_cache(maxsize=256)
def k1_plan(G: int, H: int, md: int, SEG: int, steps_p: int, NS: int,
            sm_count: int = _build.SM_COUNT) -> dict:
    """Launch plan of the K1 kernels (``k1_scan2``, and ``k1_scan2_c01``
    with NS = 1) on a card of ``sm_count`` SMs.  Each lane has a team of
    ``T`` threads (a power of two from 4 to 32, so teams never straddle a
    warp), one of two sizes: the smallest that gives each of its CH
    candidate chains a thread of its own beside the main chain's (up to
    32), or, for lanes of at least LONG_LANE_SEGMENTS segments (steps_p /
    SEG) whose grid at that size would put more than BUSY_WARPS_PER_SM
    warps on each SM, the smallest that gives each of the NL leaders one
    (T >= NL + 1, at least 4).  ``lanes`` a block of ``THREADS``,
    ``blocks``; ``shared``: the dynamic shared bytes of a block, the step
    table of NS table chunks (``step_bytes``) then the teams' state and
    rings; ``per_sm``: the blocks an SM holds by threads, shared memory and
    registers, and ``waves``: the grid's blocks over what the card holds
    at once.  Raises ValueError for a geometry outside the kernels'
    bounds, or a G for which G * T threads do not fill whole blocks (the
    team body's warp votes need every thread of a warp)."""
    CH, HP, _cells = _shapes(H, SEG, md)
    NL = min(md, CH)
    if (not 2 <= md <= 8 or SEG != seg_bits(md) or HP > 128
            or not 1 <= NS <= 8 or G < 1 or steps_p % SEG):
        raise ValueError("geometry outside the K1 kernels' bounds "
                         "(see widescan._plan)")

    def shape(T):
        lanes = THREADS // T
        shared = step_bytes(NS) + lanes * team_words(CH, NL, SEG // 2) * 4
        per_sm = min(MIN_BLOCKS, _build.SM_THREADS // THREADS,
                     _build.SM_SHARED // (shared + _build.BLOCK_RESERVED))
        blocks = G * T // THREADS
        return dict(T=T, lanes=lanes, blocks=blocks, threads=THREADS,
                    shared=shared, per_sm=per_sm,
                    waves=-(-blocks // (sm_count * per_sm)),
                    registers=_build.SM_REGISTERS // (THREADS * MIN_BLOCKS),
                    sm_count=sm_count)

    T = 4
    while T < 32 and T < CH + 1:
        T *= 2
    if (steps_p // SEG >= LONG_LANE_SEGMENTS
            and G * T / 32 / sm_count > BUSY_WARPS_PER_SM):
        T = 4
        while T < NL + 1:
            T *= 2
    if G * T % THREADS:
        raise ValueError(f"k1_plan: {G} lanes x {T} threads fill no whole "
                         f"blocks of {THREADS}")
    p = shape(T)
    if p["shared"] > _build.BLOCK_SHARED_MAX:
        raise ValueError(f"k1_plan: {p['shared']} shared bytes a block")
    return p


def k1_scan2(wmat, tab, lim, *, B, H, steps, steps_p, SEG, md, C0, C1, NS):
    """K1 over the halo'd word matrix ``wmat`` (steps_w, G) int32, the quad
    table ``tab`` (2 * NS, 128) int32 and per-lane bit limits ``lim`` (G,)
    int32.  Returns (sym, val, cntmap, exmap, mrowmap).  CPU tensors run
    the plain version; CUDA tensors launch the kernel."""
    kw = dict(B=B, H=H, steps=steps, steps_p=steps_p, SEG=SEG, md=md,
              C0=C0, C1=C1, NS=NS)
    if wmat.device.type == "cpu":
        return k1_scan2_ref(wmat, tab, lim, **kw)
    _build.require_cuda("k1_scan2", wmat, tab, lim)
    steps_w, G = wmat.shape
    CH, HP, cells_p = _shapes(H, steps_p, md)
    if (SEG % (CELL * md) or SEG > 32 or md > 8 or HP > 128 or NS > 8
            or steps_p % SEG or steps_w * 32 < steps_p):
        raise ValueError("geometry outside the K1 kernel's bounds (see _plan)")
    dev = wmat.device
    sym = torch.empty((cells_p, G), dtype=torch.int32, device=dev)
    val = torch.empty((cells_p, G), dtype=torch.uint8, device=dev)
    maps = [torch.empty((HP, G), dtype=torch.int32, device=dev)
            for _ in range(3)]
    p = k1_plan(G, H, md, SEG, steps_p, NS, _build.sm_count(dev))
    lib = _build.get_lib()
    rc = lib.ws_k1_scan2(
        wmat.data_ptr(), tab.data_ptr(), lim.data_ptr(), sym.data_ptr(),
        val.data_ptr(), *(m.data_ptr() for m in maps),
        G, steps_w, B, H, steps, steps_p, SEG, md, C0, C1, NS, p["T"],
        p["shared"], _build.stream_ptr(wmat))
    trace.count("launch.k1_scan2")
    _build.check(rc, "k1_scan2")
    return (sym, val, *maps)


def k1_scan2_ref(wmat, tab, lim, *, B, H, steps, steps_p, SEG, md, C0, C1,
                 NS, tbase=0):
    """Plain torch K1: vectorized over lanes (and chains), a Python loop
    over chunk rows.  ``C0``/``C1`` are ints or per-lane (G,) tensors, and
    ``tbase`` each lane's offset into a stack of tables (the batched
    decode's per-stream tables, ``k1_scan2_c01``).

    Three passes over the whole lane, each finishing before the next starts:
    the main chain (its per-row post-chunk state, -1 once it has exited,
    and running count), then the md leaders (one per entry-offset residue
    mod md; they walk past their own resolution and publish their state
    and count per row), then the followers, which read both.  The TPU
    kernel interleaves the three per segment and skips resolved work per
    row group; neither changes a map row (a resolved follower is frozen,
    and a chain that only stops being walked because its lane ended
    reports the same count, exit 0 and no merge row)."""
    del SEG  # segments only gate work; the results do not depend on them
    G = lim.shape[0]
    dev = lim.device
    CH, HP, cells_p = _shapes(H, steps_p, md)
    NL = min(md, CH)
    nrows = steps_p // 2
    tabf = u32(tab).reshape(-1)
    b0s, b1s = chunk_rows(wmat, nrows)
    lim64 = lim.to(torch.int64)
    i64 = dict(dtype=torch.int64, device=dev)

    def rows(i):
        jbit = 2 * i
        return jbit, b0s[i], b1s[i], lim64 > jbit, torch.where(
            b1s[i] > 0, C1, C0)

    # ---- main chain (entry offset 0) ------------------------------------
    node0 = torch.zeros(G, **i64)
    cnt0 = torch.zeros(G, **i64)
    done0 = torch.zeros(G, **i64)
    exit0 = torch.zeros(G, **i64)
    nscr = torch.empty((nrows, G), **i64)
    cscr = torch.empty((nrows, G), **i64)
    cells = torch.zeros((cells_p, G), **i64)
    nib = torch.zeros((cells_p, G), **i64)
    for i in range(nrows):
        jbit, b0, b1, valid, rc = rows(i)
        e = torch.where(valid, quad_entry(tabf, NS, node0, b0, b1, tbase),
                        0)
        emit, pos, sym, node0 = decode_entry(e, NS, rc)
        emit = emit * (1 - done0)
        exiting = emit * (jbit + pos + 1 >= B)
        exit0 = torch.where(exiting > 0, jbit + pos + 1 - B, exit0)
        done0 = done0 | exiting
        cnt0 = cnt0 + emit
        nscr[i] = torch.where(done0 > 0, -1, node0)
        cscr[i] = cnt0
        scatter_slots(cells, nib, jbit, pos, emit, sym, md)

    # ---- chains ------------------------------------------------------------
    # leaders: entry offsets 1..NL, walk to the end of the lane
    srow = torch.arange(1, NL + 1, **i64)[:, None]
    node = torch.zeros((NL, G), **i64)
    cnt = torch.zeros_like(node)
    rec = torch.zeros_like(node)
    cum = torch.zeros_like(node)
    ldr = torch.empty((nrows, NL, G), **i64)
    lcn = torch.empty((nrows, NL, G), **i64)
    for i in range(nrows):
        jbit, b0, b1, valid, rc = rows(i)
        e = torch.where(valid, quad_entry(tabf, NS, node, b0, b1, tbase), 0)
        emit, pos, _, nst = decode_entry(e, NS, rc)
        alive = 1 - (rec & 1)
        started = (jbit >= srow).to(torch.int64)
        partial = srow == jbit + 1
        node = torch.where(started > 0, nst, node)
        node = torch.where(partial & valid, rc, node)
        em = emit * started
        cnt = cnt + em
        nz = nscr[i]
        lstop = (rec & 1) * (1 - ((rec >> 1) & 1))
        ldr[i] = torch.where((lstop > 0) | (nz == -1), -1, node)
        lcn[i] = cnt
        live = (alive * started) > 0
        rec, cum = resolve(rec, cum, [
            (live & valid & (node == nz), ((jbit + 1) << 3) | 3,
             cscr[i] - cnt),
            ((em * alive > 0) & (jbit + pos + 1 >= B),
             ((jbit + pos) << 3) | 1, cnt),
            (live & ~valid, ((B - 1) << 3) | 1, cnt),
        ])
    L = (cnt, rec, cum)

    # followers: entry offsets NL+1..CH, merge with the 0-chain or their
    # residue leader (offset r - 1 mod md); frozen once resolved
    NF = CH - NL
    frow = torch.arange(NL + 1, CH + 1, **i64)[:, None]
    lp = (frow[:, 0] - 1) % md
    node = torch.zeros((NF, G), **i64)
    cnt = torch.zeros_like(node)
    rec = torch.zeros_like(node)
    cum = torch.zeros_like(node)
    for i in range(nrows if NF else 0):
        jbit, b0, b1, valid, rc = rows(i)
        e = torch.where(valid, quad_entry(tabf, NS, node, b0, b1, tbase), 0)
        emit, pos, _, nst = decode_entry(e, NS, rc)
        alive = 1 - (rec & 1)
        started = (jbit >= frow).to(torch.int64)
        partial = frow == jbit + 1
        node = torch.where(alive * started > 0, nst, node)
        node = torch.where((alive > 0) & partial & valid, rc, node)
        em = emit * alive * started
        cnt = cnt + em
        nl = ldr[i].index_select(0, lp)
        ok = ((alive * started) > 0) & valid
        m0 = ok & (node == nscr[i])
        rec, cum = resolve(rec, cum, [
            (m0, ((jbit + 1) << 3) | 3, cscr[i] - cnt),
            (ok & (node == nl), ((jbit + 1) << 3) | 5,
             lcn[i].index_select(0, lp) - cnt),
            ((em > 0) & (jbit + pos + 1 >= B), ((jbit + pos) << 3) | 1, cnt),
            ((alive * started > 0) & ~valid, ((B - 1) << 3) | 1, cnt),
        ])

    return (to_i32(cells), nib.to(torch.uint8),
            *chain_maps(cnt0, exit0, L, (cnt, rec, cum), lp, HP=HP,
                        steps=steps, B=B))


def resolve(rec, cum, conds):
    """A chain's (rec, cum) after one step: the first (cond, rec value,
    cum value) that holds wins; neither changes where none holds."""
    for cond, r, c in reversed(conds):
        rec = torch.where(cond, r, rec)
        cum = torch.where(cond, c, cum)
    return rec, cum


def chain_maps(cnt0, exit0, L, F, lp, *, HP, steps, B):
    """K1's epilogue (both the chunked and the 1-bit kernel): the
    (cntmap, exmap, mrowmap) (HP, G) int32 maps from the main chain's count
    and exit, the leaders' (cnt, rec, cum) ``L`` (NL, G) and the
    followers' ``F`` (NF, G), follower i composing through leader
    ``lp[i]``.  rec packs row << 3 | kind << 1 | resolved, kind 0 late
    exit or stream end, 1 merged with the main chain, 2 merged with the
    leader.  Leaders come first; followers compose through them."""
    G = cnt0.shape[0]
    i64 = dict(dtype=torch.int64, device=cnt0.device)
    NL, NF = L[0].shape[0], F[0].shape[0]
    cntmap = torch.zeros((HP, G), **i64)
    exmap = torch.zeros((HP, G), **i64)
    mrowmap = torch.full((HP, G), steps, **i64)
    cntmap[0] = cnt0
    exmap[0] = exit0
    mrowmap[0] = -1
    lcnt, lrec, lcum = L
    res = lrec & 1
    mrg = (lrec >> 1) & 1
    mrow = lrec >> 3
    Ltot = torch.where(res > 0, torch.where(mrg > 0, cnt0 - lcum, lcum), lcnt)
    Lex = torch.where(res > 0, torch.where(mrg > 0, exit0, mrow + 1 - B), 0)
    Lmrow = torch.where((res > 0) & (mrg > 0), mrow, steps)
    cntmap[1:NL + 1] = Ltot
    exmap[1:NL + 1] = Lex
    mrowmap[1:NL + 1] = Lmrow
    if NF:
        cnt, rec, cum = F
        res = rec & 1
        kind = (rec >> 1) & 3
        mrow = rec >> 3
        tot = torch.where(kind == 1, cnt0 - cum, cum)
        tot = torch.where(kind == 2, Ltot[lp] - cum, tot)
        ex = torch.where(kind == 1, exit0, mrow + 1 - B)
        ex = torch.where(kind == 2, Lex[lp], ex)
        mro = torch.where(kind == 1, mrow, steps)
        mro = torch.where(kind == 2, torch.maximum(mrow, Lmrow[lp]), mro)
        cntmap[NL + 1:NL + NF + 1] = torch.where(res > 0, tot, cnt)
        exmap[NL + 1:NL + NF + 1] = torch.where(res > 0, ex, 0)
        mrowmap[NL + 1:NL + NF + 1] = torch.where(res > 0, mro, steps)
    return (cntmap.to(torch.int32), exmap.to(torch.int32),
            mrowmap.to(torch.int32))

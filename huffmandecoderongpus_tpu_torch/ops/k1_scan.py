"""K1': 1-bit main scan + self-synchronizing candidate discovery (md = 1).

Replaces ``huffmandecoderongpus_tpu/ops/pallas_widescan.py`` ``k1_scan`` /
``_k1_kernel``, which the JAX package runs for trees with min code length 1.
CUDA source: ``csrc/k1_scan.cu``; ``k1_scan_plan`` plans its launch.

The same scheme as K1 (``k1_scan2``) one bit per step through the pair
table (``widescan.pack_pair_table``): the main chain (entry offset 0) writes
one slot per bit, and one candidate chain per entry offset 1..H-1 runs
until it state-merges with the main chain or with the leader (offset 1),
exits the lane late, or reaches the stream end.  A chain starting at offset
r walks from bit r; it resolves at the bit itself (a merge at bit j records
row j, where the chunked kernel records the chunk's second bit).  On the
card each lane is walked by a team of threads on a 1-bit step table in
shared memory (the team body of ``k1_scan2``).  Outputs, in the JAX
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
from huffmandecoderongpus_tpu_torch.ops.k1_scan2 import (
    BUSY_WARPS_PER_SM,
    LONG_LANE_SEGMENTS,
    MIN_BLOCKS,
    THREADS,
    _shapes,
    chain_maps,
    resolve,
    team_words,
)
from huffmandecoderongpus_tpu_torch.ops.pair import bit_rows, e1_fields, pair_entry
from huffmandecoderongpus_tpu_torch.ops.quad import CELL, to_i32, u32
from huffmandecoderongpus_tpu_torch.utils import trace


#: bits a segment of the kernel's walk: one payload word (``widescan._plan``
#: makes SEG 32 for md = 1)
SEG1 = 32


def step1_bytes(NS: int) -> int:
    """Shared bytes of the 1-bit step table (``widescan.cuh``
    ``stage_step_table1``): a 4-byte entry a (state, bit), 128 states a
    table chunk."""
    return NS * 128 * 2 * 4


def step2_bytes(NS: int) -> int:
    """Shared bytes of the main chain's 2-bit step table
    (``csrc/k1_scan.cu`` ``stage_step_table2``): a 4-byte entry a (state,
    2-bit chunk)."""
    return NS * 128 * 4 * 4


@functools.lru_cache(maxsize=256)
def k1_scan_plan(G: int, H: int, steps_p: int, NS: int,
                 sm_count: int = _build.SM_COUNT) -> dict:
    """Launch plan of ``k1_scan`` on a card of ``sm_count`` SMs, by
    ``k1_scan2.k1_plan``'s rule with one leader: each lane has a team of
    ``T`` threads (a power of two from 4 to 32), the smallest that gives
    each of its CH candidate chains a thread of its own beside the main
    chain's (up to 32), or 4 for lanes of at least LONG_LANE_SEGMENTS
    segments of SEG1 bits whose grid at that size would put more than
    BUSY_WARPS_PER_SM warps on each SM.  ``lanes`` a block of ``THREADS``,
    ``blocks`` (G * T threads rounded up to whole blocks: the threads past
    the last lane walk nothing); ``shared``: a block's dynamic shared
    bytes, the 1-bit and 2-bit step tables of NS chunks (``step1_bytes``,
    ``step2_bytes``) then the teams' state and rings of 32 rows;
    ``per_sm``: the blocks an SM holds by threads, shared memory and
    registers, and ``waves``: the grid's blocks over what the card holds at
    once.  Raises ValueError for a geometry
    outside the kernel's bounds."""
    CH = max(H - 1, 1)
    if (H > 128 or not 1 <= NS <= 8 or G < 1 or steps_p < SEG1
            or steps_p % SEG1):
        raise ValueError("geometry outside the K1' kernel's bounds "
                         "(see widescan._plan)")
    T = 4
    while T < 32 and T < CH + 1:
        T *= 2
    if (steps_p // SEG1 >= LONG_LANE_SEGMENTS
            and G * T / 32 / sm_count > BUSY_WARPS_PER_SM):
        T = 4
    lanes = THREADS // T
    shared = (step1_bytes(NS) + step2_bytes(NS)
              + lanes * team_words(CH, 1, SEG1) * 4)
    if shared > _build.BLOCK_SHARED_MAX:
        raise ValueError(f"k1_scan_plan: {shared} shared bytes a block")
    per_sm = min(MIN_BLOCKS, _build.SM_THREADS // THREADS,
                 _build.SM_SHARED // (shared + _build.BLOCK_RESERVED))
    blocks = -(-G * T // THREADS)
    return dict(T=T, lanes=lanes, blocks=blocks, threads=THREADS,
                shared=shared, per_sm=per_sm,
                waves=-(-blocks // (sm_count * per_sm)), sm_count=sm_count)


def k1_scan(wmat, tab, lim, *, B, H, steps, steps_p, SEG, md, NS):
    """K1' over the halo'd word matrix ``wmat`` (steps_w, G) int32, the pair
    table ``tab`` (NS, 128) int32 and per-lane bit limits ``lim`` (G,)
    int32.  Returns (sym, val, cntmap, exmap, mrowmap).  CPU tensors run
    the plain version; CUDA tensors launch the kernel (md = 1 only, the
    one tree shape the decode path sends here) on ``k1_scan_plan``."""
    kw = dict(B=B, H=H, steps=steps, steps_p=steps_p, SEG=SEG, md=md, NS=NS)
    if wmat.device.type == "cpu":
        return k1_scan_ref(wmat, tab, lim, **kw)
    _build.require_cuda("k1_scan", wmat, tab, lim)
    steps_w, G = wmat.shape
    CH, HP, cells_p = _shapes(H, steps_p, md)
    if (md != 1 or SEG != SEG1 or tab.shape[0] != NS
            or steps_w * 32 < steps_p):
        raise ValueError("geometry outside the K1' kernel's bounds (see _plan)")
    p = k1_scan_plan(G, H, steps_p, NS, _build.sm_count(wmat.device))
    dev = wmat.device
    sym = torch.empty((cells_p, G), dtype=torch.int32, device=dev)
    val = torch.empty((cells_p, G), dtype=torch.uint8, device=dev)
    maps = [torch.empty((HP, G), dtype=torch.int32, device=dev)
            for _ in range(3)]
    rc = _build.get_lib().ws_k1_scan(
        wmat.data_ptr(), tab.data_ptr(), lim.data_ptr(), sym.data_ptr(),
        val.data_ptr(), *(m.data_ptr() for m in maps),
        G, steps_w, B, H, steps, steps_p, NS, p["T"], p["shared"],
        _build.stream_ptr(wmat))
    trace.count("launch.k1_scan")
    _build.check(rc, "k1_scan")
    return (sym, val, *maps)


def k1_scan_ref(wmat, tab, lim, *, B, H, steps, steps_p, SEG, md, NS):
    """Plain torch K1': vectorized over lanes (and chains), a Python loop
    over bits, in three whole-lane passes as ``k1_scan2_ref``: the main
    chain, then the leaders (they walk and count past their own
    resolution and publish state and count per bit), then the followers,
    frozen once resolved."""
    del SEG  # segments only gate work; the results do not depend on them
    G = lim.shape[0]
    dev = lim.device
    CH, HP, cells_p = _shapes(H, steps_p, md)
    NL = min(md, CH)
    tabf = u32(tab).reshape(-1)
    bits = bit_rows(wmat, steps_p)
    lim64 = lim.to(torch.int64)
    i64 = dict(dtype=torch.int64, device=dev)

    # ---- main chain (entry offset 0): one slot per md bits ----------------
    node0 = torch.zeros(G, **i64)
    cnt0 = torch.zeros(G, **i64)
    done0 = torch.zeros(G, **i64)
    exit0 = torch.zeros(G, **i64)
    nscr = torch.empty((steps_p, G), **i64)
    cscr = torch.empty((steps_p, G), **i64)
    cells = torch.zeros((cells_p, G), **i64)
    nib = torch.zeros((cells_p, G), **i64)
    for j in range(steps_p):
        e = torch.where(lim64 > j, pair_entry(tabf, node0, bits[j]), 0)
        emit, sym, node0 = e1_fields(e, NS)
        emit = emit * (1 - done0)
        if j + 1 >= B:
            exiting = emit
            exit0 = torch.where(exiting > 0, j + 1 - B, exit0)
            done0 = done0 | exiting
        cnt0 = cnt0 + emit
        nscr[j] = torch.where(done0 > 0, -1, node0)
        cscr[j] = cnt0
        slot = j // md
        cells[slot // CELL] |= (sym * emit) << (8 * (slot % CELL))
        nib[slot // CELL] |= emit << (slot % CELL)

    # ---- leaders: entry offsets 1..NL, walk to the end of the lane --------
    srow = torch.arange(1, NL + 1, **i64)[:, None]
    node = torch.zeros((NL, G), **i64)
    cnt = torch.zeros_like(node)
    rec = torch.zeros_like(node)
    cum = torch.zeros_like(node)
    ldr = torch.empty((steps_p, NL, G), **i64)
    lcn = torch.empty((steps_p, NL, G), **i64)
    for j in range(steps_p):
        valid = lim64 > j
        e = torch.where(valid, pair_entry(tabf, node, bits[j]), 0)
        emit, _, nst = e1_fields(e, NS)
        alive = 1 - (rec & 1)
        started = (j >= srow).to(torch.int64)
        node = torch.where(started > 0, nst, node)
        em = emit * started
        cnt = cnt + em
        nz = nscr[j]
        # a leader that resolved without merging walks on spuriously, and
        # past the main chain's exit it tracks the halo: publish -1
        lstop = (rec & 1) * (1 - ((rec >> 1) & 1))
        ldr[j] = torch.where((lstop > 0) | (nz == -1), -1, node)
        lcn[j] = cnt
        live = (alive * started) > 0
        rec, cum = resolve(rec, cum, [
            (live & valid & (node == nz), (j << 3) | 3, cscr[j] - cnt),
            ((em * alive > 0) & (j + 1 >= B), (j << 3) | 1, cnt),
            (live & ~valid, ((B - 1) << 3) | 1, cnt),
        ])
    L = (cnt, rec, cum)

    # ---- followers: entry offsets NL+1..CH, merge with the main chain or
    # their residue leader (offset r - 1 mod md) ------------------------------
    NF = CH - NL
    frow = torch.arange(NL + 1, CH + 1, **i64)[:, None]
    lp = (frow[:, 0] - 1) % md
    node = torch.zeros((NF, G), **i64)
    cnt = torch.zeros_like(node)
    rec = torch.zeros_like(node)
    cum = torch.zeros_like(node)
    for j in range(steps_p if NF else 0):
        valid = lim64 > j
        e = torch.where(valid, pair_entry(tabf, node, bits[j]), 0)
        emit, _, nst = e1_fields(e, NS)
        act = ((1 - (rec & 1)) * (j >= frow)) > 0
        node = torch.where(act, nst, node)
        em = emit * act
        cnt = cnt + em
        ok = act & valid
        rec, cum = resolve(rec, cum, [
            (ok & (node == nscr[j]), (j << 3) | 3, cscr[j] - cnt),
            (ok & (node == ldr[j].index_select(0, lp)), (j << 3) | 5,
             lcn[j].index_select(0, lp) - cnt),
            ((em > 0) & (j + 1 >= B), (j << 3) | 1, cnt),
            (act & ~valid, ((B - 1) << 3) | 1, cnt),
        ])

    return (to_i32(cells), nib.to(torch.uint8),
            *chain_maps(cnt0, exit0, L, (cnt, rec, cum), lp, HP=HP,
                        steps=steps, B=B))

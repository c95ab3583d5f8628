"""K1: chunked main scan + self-synchronizing candidate discovery.

Replaces ``huffmandecoderongpus_tpu/ops/pallas_widescan.py`` ``k1_scan2`` /
``_k1_kernel2`` (md >= 2 trees; the batched ``c01``/``tab_bounds`` variants
and ``discover=False`` are not ported).  CUDA source: ``csrc/k1_scan2.cu``.

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

#: kernel launches made by ``k1_scan2`` on CUDA tensors
launches = 0


def _shapes(H, steps_p, md):
    """(CH, HP, cells_p): candidate chains (entry offsets 1..CH), map rows
    (CH + 1 rounded up to 8) and cells per lane."""
    CH = max(H - 1, 1)
    return CH, -(-(CH + 1) // 8) * 8, steps_p // md // CELL


def k1_scan2(wmat, tab, lim, *, B, H, steps, steps_p, SEG, md, C0, C1, NS):
    """K1 over the halo'd word matrix ``wmat`` (steps_w, G) int32, the quad
    table ``tab`` (2 * NS, 128) int32 and per-lane bit limits ``lim`` (G,)
    int32.  Returns (sym, val, cntmap, exmap, mrowmap).  CPU tensors run
    the plain version; CUDA tensors launch the kernel."""
    kw = dict(B=B, H=H, steps=steps, steps_p=steps_p, SEG=SEG, md=md,
              C0=C0, C1=C1, NS=NS)
    if wmat.device.type == "cpu":
        return k1_scan2_ref(wmat, tab, lim, **kw)
    global launches
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
    lib = _build.get_lib()
    rc = lib.ws_k1_scan2(
        _build.ptr(wmat), _build.ptr(tab), _build.ptr(lim), _build.ptr(sym),
        _build.ptr(val), *(_build.ptr(m) for m in maps),
        G, steps_w, B, H, steps, steps_p, SEG, md, C0, C1, NS,
        _build.stream_ptr(wmat))
    launches += 1
    _build.check(rc, "k1_scan2")
    return (sym, val, *maps)


def k1_scan2_ref(wmat, tab, lim, *, B, H, steps, steps_p, SEG, md, C0, C1,
                 NS):
    """Plain torch K1: vectorized over lanes (and chains), a Python loop
    over chunk rows.

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
        e = torch.where(valid, quad_entry(tabf, NS, node0, b0, b1), 0)
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
    def resolve(rec, cum, cnt, conds):
        """First matching (cond, rec value, cum value) wins."""
        for cond, r, c in reversed(conds):
            rec = torch.where(cond, r, rec)
            cum = torch.where(cond, c, cum)
        return rec, cum

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
        e = torch.where(valid, quad_entry(tabf, NS, node, b0, b1), 0)
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
        rec, cum = resolve(rec, cum, cnt, [
            (live & valid & (node == nz), ((jbit + 1) << 3) | 3,
             cscr[i] - cnt),
            ((em * alive > 0) & (jbit + pos + 1 >= B),
             ((jbit + pos) << 3) | 1, cnt),
            (live & ~valid, ((B - 1) << 3) | 1, cnt),
        ])
    L = (node, cnt, rec, cum)

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
        e = torch.where(valid, quad_entry(tabf, NS, node, b0, b1), 0)
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
        rec, cum = resolve(rec, cum, cnt, [
            (m0, ((jbit + 1) << 3) | 3, cscr[i] - cnt),
            (ok & (node == nl), ((jbit + 1) << 3) | 5,
             lcn[i].index_select(0, lp) - cnt),
            ((em > 0) & (jbit + pos + 1 >= B), ((jbit + pos) << 3) | 1, cnt),
            ((alive * started > 0) & ~valid, ((B - 1) << 3) | 1, cnt),
        ])

    # ---- epilogue: leaders first, followers compose through them -----------
    cntmap = torch.zeros((HP, G), **i64)
    exmap = torch.zeros((HP, G), **i64)
    mrowmap = torch.full((HP, G), steps, **i64)
    cntmap[0] = cnt0
    exmap[0] = exit0
    mrowmap[0] = -1
    lnode, lcnt, lrec, lcum = L
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
        res = rec & 1
        kind = (rec >> 1) & 3  # 0 late/ended, 1 merged-0, 2 merged-leader
        mrow = rec >> 3
        tot = torch.where(kind == 1, cnt0 - cum, cum)
        tot = torch.where(kind == 2, Ltot[lp] - cum, tot)
        ex = torch.where(kind == 1, exit0, mrow + 1 - B)
        ex = torch.where(kind == 2, Lex[lp], ex)
        mro = torch.where(kind == 1, mrow, steps)
        mro = torch.where(kind == 2, torch.maximum(mrow, Lmrow[lp]), mro)
        cntmap[NL + 1:CH + 1] = torch.where(res > 0, tot, cnt)
        exmap[NL + 1:CH + 1] = torch.where(res > 0, ex, 0)
        mrowmap[NL + 1:CH + 1] = torch.where(res > 0, mro, steps)
    return (to_i32(cells), nib.to(torch.uint8), cntmap.to(torch.int32),
            exmap.to(torch.int32), mrowmap.to(torch.int32))

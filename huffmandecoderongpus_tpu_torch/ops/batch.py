"""Batched multi-stream decode: N streams, each with its own tree, in one
wide-lane program.

Port of ``huffmandecoderongpus_tpu/ops/pallas_batch.py``.  The streams share
one lane length B (the largest stream's own plan), each gets ceil(bits / B)
live lanes padded to whole ``LANE_BLOCK`` ranges, and the program runs

  K1  k1_scan2_c01   each lane on its stream's table and root children
  (torch)            the exit maps of every stream's last live lane zeroed,
                     so the next stream's first lane composes from entry 0
  K2  k2_compose     one composition over all lanes
  K3  k3_fix2_c01    the fix scan, per-stream tables again
  K4  k4_compact     one compaction into (G, ORP) dense rows

and the host cuts each stream's lanes out of the dense rows and trims them
by their counts.  The tables are compact (NS = 1), so a tree with more than
127 states, or with a 1-bit code, makes the whole batch raise
EnvelopeError, as in the JAX package.  A stream whose lane overflows the
shared dense rows decodes again alone through ``decode_widescan`` on the
same device.

The constants are the JAX package's, kept so that both packages route
alike; they were chosen on a TPU, and their H100 values are still to be
decided from measurements.
"""

from __future__ import annotations

import numpy as np
import torch

from huffmandecoderongpus_tpu_torch.ops import widescan
from huffmandecoderongpus_tpu_torch.ops.k1_scan2_c01 import BLOCK, k1_scan2_c01
from huffmandecoderongpus_tpu_torch.ops.k2_compose import k2_compose
from huffmandecoderongpus_tpu_torch.ops.k3_fix2_c01 import k3_fix2_c01
from huffmandecoderongpus_tpu_torch.ops.k4_compact import k4_compact
from huffmandecoderongpus_tpu_torch.ops.lanedfa import (
    EnvelopeError,
    build_lane_dfa,
)
from huffmandecoderongpus_tpu_torch.ops.lanedfa_decode import require_device
from huffmandecoderongpus_tpu_torch.utils import trace

#: lanes a stream's range is padded to a multiple of
LANE_BLOCK = 1024
#: floor of the shared lane length: entry offsets (< H) and the candidate
#: halo stay well inside a lane
MIN_B = 128
#: with ``auto_split``, members of at least this many bits decode alone
BATCH_SOLO_BITS = 1 << 19


def stage_batch_inputs(hfs, *, device, B=None, lane_block=None) -> dict:
    """Stage N HuffFiles for one batched program: the plan (common B, SEG,
    ORP, ...), the stacked tables ``tabs`` (2N, 128) int32, the stream map
    ``bstream`` (G / 128,) int32 (the stream of every 128-lane block), the
    per-lane root children ``c01``, bit limits ``lim`` and lane words
    ``words``, on ``device``; with each stream's first lane ``g0``, live
    and padded lane counts ``g_live``/``g_pad`` and last live lane
    ``last_live``.  Raises EnvelopeError if any member is outside the batch
    envelope (md = 1, more than 127 states, no bits) or the lane block
    leaves no valid row-group block.

    ``B`` sets the common lane length (floored at MIN_B, rounded up to
    whole words); ``lane_block`` overrides LANE_BLOCK."""
    if not hfs:
        raise ValueError("empty batch")
    with trace.span("huff.stage"):
        return _stage_batch(hfs, device, B, lane_block)


def _stage_batch(hfs, device, B, lane_block) -> dict:
    dfas, Hs, mds, avgs, tabs, c01 = [], [], [], [], [], []
    with trace.span("huff.stage.tables"):
        for hf in hfs:
            dfa = build_lane_dfa(hf.tree)
            n_states = dfa.entry.shape[0] // 2
            if n_states > widescan.MAX_STATES:
                raise EnvelopeError(
                    f"{n_states} states > {widescan.MAX_STATES}: batched "
                    "tables require the compact layout")
            md = max(dfa.min_depth, 1)
            if md < 2:
                raise EnvelopeError("md=1 tree outside the chunked batch path")
            if hf.bits <= 0:
                raise EnvelopeError("empty stream")
            dfas.append(dfa)
            Hs.append(max(dfa.height, 1))
            mds.append(md)
            avgs.append(hf.bits / max(hf.uncompressed_size, 1))
            tab, C0, C1, _NS = widescan.pack_quad_tables(dfa)
            tabs.append(tab)
            c01.append(C0 | (C1 << 16))
    H = max(Hs)
    md = min(mds)
    UNROLL = 4 * md
    SEG = UNROLL * max(1, 32 // UNROLL)
    lane_block = int(lane_block or LANE_BLOCK)
    if B is None:
        # the largest stream's own plan sets the common lane length
        k_big = int(np.argmax([hf.bits for hf in hfs]))
        B = widescan._plan(hfs[k_big].bits, H, md, avg_len=avgs[k_big])["B"]
    B = -(-max(MIN_B, int(B)) // 32) * 32
    steps = B + H
    steps_p = -(-steps // SEG) * SEG
    hard = min(B // md + 2, steps_p // md)

    g0, g_live, g_pad = [], [], []
    c01s, lims, words = [], [], []
    ORP = 0
    G = 0
    with trace.span("huff.stage.words"):
        for k, hf in enumerate(hfs):
            live = max(1, -(-hf.bits // B))
            Gk = -(-live // lane_block) * lane_block
            g0.append(G)
            g_live.append(live)
            g_pad.append(Gk)
            G += Gk
            c01s.append(np.full(Gk, c01[k], np.int32))
            lane = np.arange(Gk, dtype=np.int64)
            lims.append(np.clip(hf.bits - lane * B, -(1 << 30),
                                1 << 30).astype(np.int32))
            words.append(widescan.payload_lane_words(hf.payload, hf.bits, Gk,
                                                     B))
            ORP = max(ORP, min(int(B / avgs[k] * 1.25) + 66, hard))
        tabs, c01s, lims, words = (np.concatenate(a, axis=0)
                                   for a in (tabs, c01s, lims, words))
    ORP = -(-ORP // 128) * 128
    R = G // 128
    # the JAX program's row-group block (a TPU grid constant): every
    # stream's rows must split into it, or the batch is refused as there
    for RB in (32, 16, 8):
        if all((g // 128) % RB == 0 for g in g_pad):
            break
    else:
        raise EnvelopeError(
            f"lane block {lane_block} leaves stream row counts "
            f"{[g // 128 for g in g_pad]} with no valid row-group block")
    bstream = np.repeat(np.arange(len(hfs), dtype=np.int32),
                        [g // BLOCK for g in g_pad])
    last_live = tuple(g0[k] + g_live[k] - 1 for k in range(len(hfs)))
    # K2's split in the JAX plan (the port's K2 splits by its own rule);
    # clamped to 1024 groups, which divide every LANE_BLOCK-multiple G
    NG = min(1 << (R.bit_length() // 2 + 3), G, 1024)
    plan = dict(B=B, steps=steps, steps_p=steps_p, SEG=SEG, UNROLL=UNROLL,
                G=G, RB=RB, ORP=ORP, NG=NG, Rg=G // NG)
    bstream, tabs, c01s, lims, words = trace.upload(
        device, bstream, tabs, c01s, lims, words)
    return dict(plan=plan, H=H, md=md, last_live=last_live, g0=tuple(g0),
                g_live=tuple(g_live), g_pad=tuple(g_pad), bstream=bstream,
                tabs=tabs, c01=c01s, lim=lims, words=words)


def from_jax_batch(st: dict, device) -> dict:
    """The port's batch staging from the JAX package's
    ``stage_batch_inputs`` result (arrays as numpy): the 8-row table blocks
    cut to their two live rows, ``tab_bounds`` (row-group boundaries
    between streams) expanded into the stream map."""

    def t(a):
        return torch.from_numpy(np.array(a, dtype=np.int32)).to(device)

    p = dict(st["plan"])
    N = len(st["g0"])
    tabs = np.asarray(st["tabw"]).reshape(N, 8, 128)[:, :2].reshape(2 * N,
                                                                   128)
    n_rg = p["G"] // 128 // p["RB"]
    rg_stream = [sum(rg >= b for b in st["tab_bounds"]) for rg in range(n_rg)]
    bstream = np.repeat(np.asarray(rg_stream, dtype=np.int32),
                        p["RB"] * 128 // BLOCK)
    return dict(plan=p, H=st["H"], md=st["md"], last_live=st["last_live"],
                g0=st["g0"], g_live=st["g_live"], g_pad=st["g_pad"],
                bstream=t(bstream), tabs=t(tabs),
                c01=t(st["c01"]).reshape(-1), lim=t(st["lim2"]).reshape(-1),
                words=t(st["words"]))


def batch_decode_program(words, tabs, lim, c01, bstream, last_live, *, B, H,
                         steps, steps_p, SEG, md, ORP):
    """The batched program over all N streams' lanes.  Returns (denseT
    (G, ORP) uint8, n (G,) int32, total 0-d), as wide_decode_program."""
    wmat = widescan.words_matrix(words, -(-steps_p // 32))
    sym, val, cntmap, exmap, mrowmap = k1_scan2_c01(
        wmat, tabs, lim, c01, bstream, B=B, H=H, steps=steps,
        steps_p=steps_p, SEG=SEG, md=md)
    # every stream's last live lane exits to entry 0 (in place: K1's
    # output is not used elsewhere)
    exmap[:, list(last_live)] = 0
    entry, _tot = k2_compose(exmap, 0)
    n = widescan.select_h(cntmap, entry, H)
    total = n.sum()
    cut, cut_slot = widescan.fix_rows(entry, mrowmap, lim, H, md)
    sym, val = k3_fix2_c01(wmat, tabs, entry, cut, cut_slot, sym, val, c01,
                           bstream, steps_p=steps_p, SEG=SEG, md=md)
    return k4_compact(sym, val, ORP=ORP), n, total


def batch_args(st: dict) -> dict:
    """Keyword arguments of batch_decode_program for a batch staging."""
    p = st["plan"]
    return dict(B=p["B"], H=st["H"], steps=p["steps"], steps_p=p["steps_p"],
                SEG=p["SEG"], md=st["md"], ORP=p["ORP"])


def batch_inputs(st: dict) -> tuple:
    """Positional arguments of batch_decode_program for a batch staging."""
    return (st["words"], st["tabs"], st["lim"], st["c01"], st["bstream"],
            st["last_live"])


def decode_widescan_batch(hfs, *, device, B=None, check_size=True,
                          auto_split=True) -> list:
    """Decode N HuffFiles on ``device``; a list of host byte arrays in
    input order.

    ``auto_split``: members of BATCH_SOLO_BITS bits or more decode alone
    through ``decode_widescan``, and the batch takes the small members (all
    of them, or none when fewer than two are small); False puts every
    member in one program.  Staging raises EnvelopeError for a batch
    outside the envelope; a member whose lane overflows the dense rows
    decodes again alone through ``decode_widescan``."""
    device = require_device(device)
    with trace.span("huff.batch"):
        small = [k for k, hf in enumerate(hfs) if hf.bits < BATCH_SOLO_BITS]
        if not auto_split or len(small) == len(hfs):
            return _decode_batched(hfs, device, B, check_size)
        outs = [None] * len(hfs)
        if len(small) >= 2:
            batched = _decode_batched([hfs[k] for k in small], device, B,
                                      check_size)
            for k, out in zip(small, batched):
                outs[k] = out
        for k, hf in enumerate(hfs):
            if outs[k] is None:
                outs[k] = widescan.decode_widescan(hf, device=device,
                                                   check_size=check_size)
        return outs


def _decode_batched(hfs, device, B, check_size: bool) -> list:
    """Every member of ``hfs`` in one batched program; a member whose lane
    overflows the shared dense rows decodes again alone."""
    st = stage_batch_inputs(hfs, device=device, B=B)
    with trace.span("huff.launch"):
        denseT, n, _total = batch_decode_program(*batch_inputs(st),
                                                 **batch_args(st))
    with trace.span("huff.wait"):
        counts = n.cpu()
    outs = []
    for k, hf in enumerate(hfs):
        g0, gk = st["g0"][k], st["g_pad"][k]
        # a lane overflowed the shared dense rows
        if int(counts[g0:g0 + gk].max()) > st["plan"]["ORP"]:
            outs.append(widescan.decode_widescan(hf, device=device,
                                                 check_size=check_size))
            continue
        out = widescan.trimmed(denseT[g0:g0 + gk], n[g0:g0 + gk])
        if check_size and out.size != hf.uncompressed_size:
            raise RuntimeError(
                f"stream {k}: emitted {out.size} symbols, header says "
                f"{hf.uncompressed_size}")
        outs.append(out)
    return outs

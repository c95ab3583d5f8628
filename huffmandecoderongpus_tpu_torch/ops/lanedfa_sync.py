"""Self-synchronizing entry discovery for the lane DFA.

Port of ``huffmandecoderongpus_tpu/ops/lanedfa_sync.py``
(``discover_and_splice``, ``decode_lanedfa_sync``).  Where candidate
discovery walks all H entry chains of every lane over the whole lane, this
one leans on Huffman chains synchronizing: two chains that reach a common
codeword boundary agree from there on.

  1. ``lane_scan`` from offset 0 in every lane (the "0-chain"): its
     emissions are the output of every lane whose true entry offset is 0
     and the merge target of the others.
  2. ``short_candidate_scan`` walks every chain W rows, until it emits on
     a row where the 0-chain emitted (merged: from there it is the
     0-chain) or exits its lane; W doubles from 128 until every chain has
     resolved or W covers the lane, one flag read back to the host a
     round (``rounds`` counts them).
  3. The lane that holds the stream end gets the full ``candidate_scan``
     on its one column (its chains end at the stream, without exiting).
  4. ``compose`` picks each lane's entry offset; lanes entering elsewhere
     than 0 have their rows through the merge row (all rows, unmerged)
     decoded again by ``lane_scan`` cut at the longest such cut
     (``rows=``), spliced over the 0-chain's rows (``fix_scans`` counts
     those scans).

All of it runs as torch ops and the three kernels on the device of the bit
matrix; the CPU runs the kernels' plain versions.
"""

from __future__ import annotations

import numpy as np
import torch

from huffmandecoderongpus_tpu_torch.ops.candidate_scan import candidate_scan
from huffmandecoderongpus_tpu_torch.ops.lane_scan import lane_scan
from huffmandecoderongpus_tpu_torch.ops.lanedfa_decode import (
    _emitted,
    compose,
    require_device,
    stage_lanedfa,
)
from huffmandecoderongpus_tpu_torch.ops.short_candidate_scan import (
    short_candidate_scan,
)

#: the first round's walk length (rows), as in the reference
W0 = 128
#: short candidate scans run by ``discover_and_splice`` (its rounds)
rounds = 0
#: fix scans run by ``discover_and_splice`` (calls with a lane to splice)
fix_scans = 0


def discover_and_splice(bits_t, tab, sym0, valid0, *, B, H, N):
    """Entry discovery against the 0-chain, and the splice.

    ``bits_t`` (B+H, G) uint8 and ``tab`` (n_chunks, 128) int32 are the
    scans' inputs; ``sym0``/``valid0`` (B+H, G) uint8 the lane scan from
    offset 0.  Returns (sym, valid) (B+H, G) uint8 of the true chains and
    (base, n) (G,) int32, total (0-d int32), as ``compose``."""
    global rounds, fix_scans
    steps, G = bits_t.shape
    dev = bits_t.device
    i32 = torch.int32
    cnt0 = valid0.sum(0, dtype=i32)  # the 0-chain's emissions
    rows = torch.arange(steps, dtype=i32, device=dev)[:, None]
    # the 0-chain's exit: one past its last emission at a row >= B, less B
    # (0 if none), read off the H halo rows alone
    last = torch.where(valid0[B:] != 0, rows[:H], -1).amax(0)
    exit0 = torch.clamp(last + 1, min=0)
    lane_base = torch.arange(G, dtype=torch.int64, device=dev) * B
    dead = (lane_base[None, :]
            + torch.arange(H, dtype=torch.int64, device=dev)[:, None]) >= N
    tail = min(max((N - 1) // B, 0), G - 1)  # the lane holding the stream end

    W = min(max(W0, H + 1), steps)
    while True:
        merged, exited, mrow, cnt, ex = short_candidate_scan(
            bits_t, tab, valid0, B=B, H=H, N=N, W=W)
        rounds += 1
        unresolved = ~(merged | exited | dead)
        unresolved[:, tail] = False  # its chains get the full scan below
        if W >= steps or not bool(unresolved.any()):
            break
        W = min(W * 2, steps)

    # merged chains continue as the 0-chain strictly after the merge row
    # (their own merge-row emission is already in cnt); merge rows lie
    # below W, so the 0-chain's running count is needed on W rows only
    cum0 = torch.cumsum(valid0[:W], 0, dtype=i32)
    cum_thru = cum0.gather(0, mrow.clamp(0, W - 1).long())
    cnt_total = torch.where(merged, cnt + (cnt0[None, :] - cum_thru), cnt)
    exit_total = torch.where(merged, exit0[None, :], ex)
    tcnt, tex = candidate_scan(bits_t[:, tail:tail + 1].contiguous(), tab,
                               B=B, H=H, N=N - tail * B)
    cnt_total[:, tail] = tcnt[:, 0]
    exit_total[:, tail] = tex[:, 0]
    merged[:, tail] = False  # the tail lane replays all its rows
    entry_off, base, n, total = compose(cnt_total, exit_total)

    # splice: entries at offset 0 keep the 0-chain everywhere; merged
    # chains replay their rows through the merge row, the others all rows
    lanes = torch.arange(G, device=dev)
    pick = entry_off.long()
    cut = torch.where(entry_off == 0, 0,
                      torch.where(merged[pick, lanes], mrow[pick, lanes] + 1,
                                  steps))
    Wfix = min(int(cut.max()), steps)
    if Wfix <= 0:
        return sym0, valid0, base, n, total
    fix_scans += 1
    fsym, fvalid = lane_scan(bits_t[:Wfix], tab, entry_off, B=B, H=H, N=N,
                             rows=Wfix)
    use_fix = rows[:Wfix] < cut[None, :]
    sym, valid = sym0.clone(), valid0.clone()
    sym[:Wfix] = torch.where(use_fix, fsym, sym0[:Wfix])
    valid[:Wfix] = torch.where(use_fix, fvalid, valid0[:Wfix])
    return sym, valid, base, n, total


def decode_lanedfa_sync(hf, *, device, lanes=None,
                        check_size=True) -> np.ndarray:
    """Lane-DFA decode of a HuffFile on ``device`` with self-synchronizing
    discovery, in the JAX package's XLA geometry (``decode_lanedfa_sync``).
    Raises RuntimeError where the symbols decoded or emitted are not the
    header's count."""
    device = require_device(device)
    st = stage_lanedfa(hf, device=device, lanes=lanes, tiled=False)
    return decode_staged_sync(hf, st, check_size)


def decode_staged_sync(hf, st: dict, check_size: bool) -> np.ndarray:
    """The sync decode of staged inputs (``stage_lanedfa``'s dict): the
    0-chain, discovery and splice, then the valid symbols on the host."""
    kw = dict(B=st["B"], H=st["H"], N=st["N"])
    zero = torch.zeros(st["bits"].shape[1], dtype=torch.int32,
                       device=st["bits"].device)
    sym0, valid0 = lane_scan(st["bits"], st["tab"], zero, **kw)
    sym, valid, _base, _n, total = discover_and_splice(
        st["bits"], st["tab"], sym0, valid0, **kw)
    total = int(total)
    if check_size and total != hf.uncompressed_size:
        raise RuntimeError(
            f"decoded {total} symbols, header says {hf.uncompressed_size}")
    return _emitted(hf, sym, valid, check_size)

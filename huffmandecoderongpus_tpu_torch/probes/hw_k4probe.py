"""Where K4's time goes: its transpose alone, with the window prefix, and
in full.

Port of ``scripts/hw_k4probe.py``.  On stream (a), kjv-sized text (the
script's default corpus, absent here, at its size), the time a launch
(CUDA events) of ``k4_stripped`` in its ``transpose`` and ``prefix``
stages and of the port's full ``k4_compact``, all three on (a)'s real K3
output, the cells the main path hands K4: (a)'s G, ``cells_p`` and ORP.
The script fed random nibbles instead; the port's K4 drops ranks at or past
ORP (``ops/k4_compact.py``), so either input times the same work.  Both
stripped stages are held against their plain version on the host.
"""

from __future__ import annotations

import torch

from huffmandecoderongpus_tpu_torch.ops import widescan as ws
from huffmandecoderongpus_tpu_torch.ops.k2_compose import k2_compose
from huffmandecoderongpus_tpu_torch.ops.k4_compact import k4_compact
from huffmandecoderongpus_tpu_torch.ops.k4_stripped import (
    STAGES,
    k4_stripped,
    k4_stripped_ref,
)
from huffmandecoderongpus_tpu_torch.ops.lanedfa_decode import require_device
from huffmandecoderongpus_tpu_torch.probes import streams as st_
from huffmandecoderongpus_tpu_torch.probes._timing import (
    card,
    raise_if_wrong,
    time_ms,
    verdict,
)


def k3_output(hf, device):
    """(sym, val, ORP): the spliced cells K4 takes in ``hf``'s decode, from
    K1, K2 and K3 on ``device``."""
    st = ws.stage_widescan_inputs(hf, device=device)
    kw = ws.program_args(st)
    ORP = kw.pop("ORP")
    B, steps = kw.pop("B"), kw.pop("steps")
    wmat, sym, val, cntmap, exmap, mrowmap = ws.stage_k1(
        st["words"], st["tab"], st["lim"], B=B, steps=steps, **kw)
    entry, _tot = k2_compose(exmap, 0)
    sym, val, _n, _total = ws.stage_k3(wmat, st["tab"], st["lim"], entry,
                                       cntmap, mrowmap, sym, val, **kw)
    return sym, val, ORP


def run(device="cuda", *, streams=None, nbytes=None, **_):
    """Print the probe's lines; returns {stage: ms a launch}.  ``streams``
    maps "a" to (name, raw, HuffFile); by default it is drawn (``nbytes``
    long if given).  Raises if a stripped stage differs from its plain
    version."""
    dev = require_device(device)
    name, _raw, hf = streams["a"] if streams else st_.stream("a", nbytes)
    sym, val, ORP = k3_output(hf, dev)
    cells_p, G = sym.shape
    print(f"{name} G={G} cells_p={cells_p} CW={-(-cells_p // 128)} "
          f"ORP={ORP}", flush=True)
    wrong, ms = [], {}
    for stage in STAGES:
        ms[stage] = time_ms(lambda s=stage: k4_stripped(sym, val, ORP=ORP,
                                                        stage=s), dev)
        print(f"K4[{stage:9s}]: {ms[stage]:.4f} ms", flush=True)
    ms["full"] = time_ms(lambda: k4_compact(sym, val, ORP=ORP), dev)
    print(f"K4[full     ]: {ms['full']:.4f} ms", flush=True)
    host = (sym.cpu(), val.cpu())
    for stage in STAGES:
        print(verdict(f"K4[{stage}] against the plain version on the host",
                      torch.equal(k4_stripped(sym, val, ORP=ORP,
                                              stage=stage).cpu(),
                                  k4_stripped_ref(*host, ORP=ORP,
                                                  stage=stage)), wrong),
              flush=True)
    print(f"card: {card(dev)}", flush=True)
    raise_if_wrong(wrong)
    return dict(ms=ms, G=G, cells_p=cells_p, ORP=ORP)

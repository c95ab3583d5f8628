"""The launch floor: a trivial and a medium kernel beside torch's ``x + 1``.

Port of ``scripts/hw_dispatch.py``.  Three times over, at K = 10 and 50
launches back to back between two CUDA events, the time a launch of

  torch x+1  torch's ``x + 1`` on an (8,) int32 tensor (one library kernel)
  triv       ``probe_inc`` on an (8, 128) int32 tile
  med        ``probe_arith`` body ``mul3``: 64 steps of a = a * 3 + i on a
             (32, 128) int32 tile

The script's relay floor and its subtraction have no counterpart: a time
here is the span between the events around K launches, over K, which is
the host's rate of launching wherever that is slower than the card; a line
after gives each kernel's own time on the card (``torch.profiler``).  The outputs of ``triv`` and ``med`` are then held
against their plain versions on the host.
"""

from __future__ import annotations

import torch

from huffmandecoderongpus_tpu_torch.ops.lanedfa_decode import require_device
from huffmandecoderongpus_tpu_torch.ops.probe_arith import (
    probe_arith,
    probe_arith_ref,
)
from huffmandecoderongpus_tpu_torch.ops.probe_inc import probe_inc, probe_inc_ref
from huffmandecoderongpus_tpu_torch.probes._timing import (
    card,
    device_ms,
    raise_if_wrong,
    time_ms,
    us,
    verdict,
)

REPS = 3
BATCHES = (10, 50)
#: steps of the medium kernel
MED_STEPS = 64


def run(device="cuda", **_):
    """Print the probe's lines; returns {(rep, K): (torch, triv, med) ms a
    launch}.  Raises if an output differs from its plain version."""
    dev = require_device(device)
    x = torch.zeros(8, dtype=torch.int32, device=dev)
    xp = torch.zeros((8, 128), dtype=torch.int32, device=dev)
    xm = torch.zeros((32, 128), dtype=torch.int32, device=dev)
    fns = (lambda: x + 1, lambda: probe_inc(xp),
           lambda: probe_arith(xm, body="mul3", S=MED_STEPS))
    out = {}
    for rep in range(REPS):
        for K in BATCHES:
            a, b, c = out[rep, K] = tuple(time_ms(f, dev, K) for f in fns)
            print(f"rep{rep} K={K:3d}: torch x+1 {a * 1e3:8.3f} us  "
                  f"triv {b * 1e3:8.3f} us  med {c * 1e3:8.3f} us",
                  flush=True)
    on_card = tuple(device_ms(f, dev) for f in fns)
    print("on the card (profiler), a launch: torch x+1 {}  triv {}  med {}"
          .format(*(us(t) for t in on_card)), flush=True)
    wrong = []
    print(verdict("triv against the plain version on the host", torch.equal(
        probe_inc(xp).cpu(), probe_inc_ref(xp.cpu())), wrong), flush=True)
    print(verdict("med against the plain version on the host", torch.equal(
        probe_arith(xm, body="mul3", S=MED_STEPS).cpu(),
        probe_arith_ref(xm.cpu(), body="mul3", S=MED_STEPS)), wrong),
          flush=True)
    print(f"card: {card(dev)}", flush=True)
    raise_if_wrong(wrong)
    return dict(ms=out, device_ms=on_card)

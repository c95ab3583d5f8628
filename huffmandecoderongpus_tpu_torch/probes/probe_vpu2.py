"""Integer and gather latency against independent chains, on (128, 128)
int32 tiles.

Port of ``scripts/probe_vpu2.py``.  One thread an element runs P
independent chains (P = 1, 4, 8) of S = 4000 steps: ``probe_arith`` body
``xor3`` (c = c + (c ^ 3), two dependent integer ops a step) and
``probe_gather_chain`` (c = x[r, c & 127], one dependent shared-memory load
a step, the element's row staged).  A line gives the time a launch; the
script's ns an op (the time over the 2·P·S, or P·S, whole-tile ops of a
launch); and the ns a chain step, with its cycles at the SM clock read
right after the runs, per dependent op: at P = 1 that is the op's latency,
and where P = 4 or 8 takes no longer a step, the chains hide it.  The
per-op figures come from the kernel's own time on the card
(``torch.profiler``) where it was measured, since back-to-back launches
can be timed by the host's launch rate instead.

The script's input, arange % 128 in every row, makes each gather chain a
fixed point (c = x[r, c] = c): every step of a warp reads 32 distinct
banks, the conflict-free case.  The ``gather permuted`` lines run the same
chains on ``permuted`` (the same values, seeded and shuffled over the
tile), where a chain's columns, and so its banks, depend on the data, as
K1's table lookups do.  Every output, arith and gather, is held against
its plain version on the host on ``permuted``.
"""

from __future__ import annotations

import numpy as np
import torch

from huffmandecoderongpus_tpu_torch.ops.lanedfa_decode import require_device
from huffmandecoderongpus_tpu_torch.ops.probe_arith import (
    probe_arith,
    probe_arith_ref,
)
from huffmandecoderongpus_tpu_torch.ops.probe_gather import (
    probe_gather_chain,
    probe_gather_chain_ref,
)
from huffmandecoderongpus_tpu_torch.probes._timing import (
    card,
    cycles,
    device_ms,
    floor_line,
    floor_ms,
    raise_if_wrong,
    sm_clock_mhz,
    time_ms,
    us,
    verdict,
)

R = C = 128
CHAINS = (1, 4, 8)
STEPS = 4000
SEED = 0


def script_input(device):
    """The script's (R, C) int32 input: arange % C, every row 0..C-1."""
    return (torch.arange(R * C, dtype=torch.int32).reshape(R, C) % C).to(
        device)


def permuted(device, seed: int = SEED):
    """The script's values shuffled over the tile by a seeded permutation:
    rows differ, and a chain through a row walks data-dependent columns."""
    rng = np.random.default_rng(seed)
    x = rng.permutation(R * C).reshape(R, C).astype(np.int32) % C
    return torch.from_numpy(x).to(device)


def _probes(steps):
    """[(name, P, kernel call, plain call, dependent ops a step, input)],
    each call taking an (R, C) input; the input is "script" or
    "permuted"."""
    arith = [("arith", P,
              lambda x, P=P: probe_arith(x, body="xor3", S=steps, P=P),
              lambda x, P=P: probe_arith_ref(x, body="xor3", S=steps, P=P),
              2, "script") for P in CHAINS]
    gather = [(name, P,
               lambda x, P=P: probe_gather_chain(x, x, P=P, S=steps),
               lambda x, P=P: probe_gather_chain_ref(x, x, P=P, S=steps),
               1, inp)
              for name, inp in (("gather", "script"),
                                ("gather permuted", "permuted"))
              for P in CHAINS]
    return arith + gather


def run(device="cuda", *, steps: int = STEPS, **_):
    """Print the probe's lines; returns {(name, P): ms a launch} and the
    floor.  Raises if an output differs from its plain version."""
    dev = require_device(device)
    xs = {"script": script_input(dev), "permuted": permuted(dev)}
    fl = floor_ms(dev)
    print(floor_line(fl), flush=True)
    probes = _probes(steps)
    ms = {(name, P): time_ms(lambda k=kern, x=xs[inp]: k(x), dev)
          for name, P, kern, _plain, _ops, inp in probes}
    clock = sm_clock_mhz(dev)
    on_card = {(name, P): device_ms(lambda k=kern, x=xs[inp]: k(x), dev)
               for name, P, kern, _plain, _ops, inp in probes}
    wrong = []
    xv = xs["permuted"]
    for name, P, kern, plain, ops, _inp in probes:
        on = on_card[name, P]
        t = ms[name, P] if on is None else on
        ns_step = t * 1e6 / max(steps, 1)
        ns_op = t * 1e6 / max(ops * P * steps, 1)
        print(f"{name} P={P}: {ms[name, P]:.4f} ms a launch, kernel "
              f"{us(on)} on the card (profiler); "
              f"{ns_op:8.3f} ns/op  {ns_step:8.3f} ns/step  "
              f"({cycles(ns_step / ops, clock)} a dependent op)", flush=True)
        print(verdict(f"{name} P={P} on the permuted input against the plain "
                      "version on the host",
                      torch.equal(kern(xv).cpu(), plain(xv.cpu())), wrong),
              flush=True)
    print(f"card: {card(dev)}", flush=True)
    raise_if_wrong(wrong)
    return dict(floor_ms=fl, ms=ms, device_ms=on_card, clock=clock,
                steps=steps)

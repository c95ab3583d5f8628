"""16-bit gathers, rolls, and the throughput of integer and gather chains.

Port of ``scripts/probe_vpu.py``.  In order, as the script runs them:

  i16 gather   ``probe_gather`` axis 1 on (16, 128) int16 and uint16 tables,
               every index 3: EXACT or WRONG against numpy
  roll         ``probe_roll`` (the one-shot gather with the index
               (j - s) mod W) of ((8, 640), 3, axis 1), ((128, 640), 100,
               axis 1) and ((64, 128), 5, axis 0) int32: EXACT or WRONG
               against ``np.roll``
  arith        ``probe_arith`` body ``addxor`` on (128, 128) int32 and
               int16, S = 2000 steps of 4 x {a = a + b; b = b ^ a}: the time
               a launch and the ns an op (8 dependent ops a step)
  gather chain ``probe_gather_chain`` from a (128, 128) index of ones through
               row 0 of an (8, 128) table broadcast to every row, S = 2000
               dependent shared-memory loads: the time and the ns a load

Where the script counted TPU vector registers, a line here gives ns a
dependent op of one thread (every element is one thread) and its cycles at
the SM clock read right after the runs, from the kernel's own time on the
card (``torch.profiler``) where it was measured.  The timed inputs are the
script's: the chain's row 0 is arange % 128, so every chain stays at 1 and
a warp's loads all read one word.  The outputs are held against their
plain versions on the host on seeded inputs instead (``arith_check_case``,
``chain_check_case``), where a wrong step count, width or row shows.
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
    probe_gather,
    probe_gather_chain,
    probe_gather_chain_ref,
    probe_roll,
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
STEPS = 2000
SEED = 0
#: dependent integer ops a step of the addxor body
ADDXOR_OPS = 8
I16_CASES = (torch.int16, torch.uint16)
#: (shape, shift, axis) of the script's rolls
ROLLS = (((8, 640), 3, 1), ((128, 640), 100, 1), ((64, 128), 5, 0))


def i16_case(dt, device):
    """(tab, idx) of the 16-bit gather: arange(16 * 128) as ``dt`` and every
    index 3, as the script makes them."""
    tab = torch.arange(16 * 128, dtype=torch.int32).to(dt).reshape(16, 128)
    idx = torch.full((16, 128), 3, dtype=dt)
    return tab.to(device), idx.to(device)


def roll_case(shape, device):
    return torch.arange(shape[0] * shape[1], dtype=torch.int32).reshape(
        shape).to(device)


def chain_case(device):
    """(tab, idx) of the gather chain: arange(8 * 128) % 128 as (8, 128)
    and a (128, 128) index of ones."""
    tab = (torch.arange(8 * C, dtype=torch.int32) % C).reshape(8, C)
    return tab.to(device), torch.ones((R, C), dtype=torch.int32).to(device)


def arith_check_case(dt, device, seed: int = SEED):
    """A seeded (R, C) input of type ``dt`` over its whole range."""
    info = torch.iinfo(dt)
    x = np.random.default_rng(seed).integers(info.min, info.max, (R, C),
                                             endpoint=True)
    return torch.from_numpy(x).to(dt).to(device)


def chain_check_case(device, seed: int = SEED):
    """A seeded (tab, idx) for the broadcast chain: an (8, 128) table of
    columns whose row 0 is a permutation, and a (128, 128) index over them,
    so each chain walks its own cycle of row 0."""
    rng = np.random.default_rng(seed)
    tab = rng.integers(0, C, (8, C)).astype(np.int32)
    tab[0] = rng.permutation(C)
    idx = rng.integers(0, C, (R, C)).astype(np.int32)
    return torch.from_numpy(tab).to(device), torch.from_numpy(idx).to(device)


def _np(t):
    """A tensor as numpy (uint16 by way of its int16 bits)."""
    if t.dtype == torch.uint16:
        return t.cpu().view(torch.int16).numpy().view(np.uint16)
    return t.cpu().numpy()


def run(device="cuda", *, steps: int = STEPS, **_):
    """Print the probe's lines; returns its times.  Raises if an output
    differs from numpy or from its plain version."""
    dev = require_device(device)
    wrong = []
    for dt in I16_CASES:
        tab, idx = i16_case(dt, dev)
        got = _np(probe_gather(tab, idx, axis=1))
        want = _np(tab)[np.arange(16)[:, None], np.full((16, 128), 3)]
        print(verdict(f"i16 gather {str(dt).split('.')[-1]}",
                      np.array_equal(got, want), wrong), flush=True)
    for shape, shift, ax in ROLLS:
        x = roll_case(shape, dev)
        print(verdict(f"roll {shape} s={shift} ax={ax}", np.array_equal(
            _np(probe_roll(x, shift, axis=ax)), np.roll(_np(x), shift,
                                                          axis=ax)), wrong),
              flush=True)
    fl = floor_ms(dev)
    print(floor_line(fl), flush=True)
    ms = {}
    for dt in (torch.int32, torch.int16):
        x = torch.ones((R, C), dtype=dt, device=dev)
        name = str(dt).split(".")[-1]
        def arith(x=x):
            return probe_arith(x, body="addxor", S=steps)

        t = ms[f"arith {name}"] = time_ms(arith, dev)
        clock = sm_clock_mhz(dev)
        on = device_ms(arith, dev)
        ns_op = (t if on is None else on) * 1e6 / max(steps * ADDXOR_OPS, 1)
        print(f"arith {name} ({R},{C}) x{ADDXOR_OPS}/step: {t:.4f} ms a "
              f"launch, kernel {us(on)} on the card; {ns_op:.3f} ns a "
              f"dependent op ({cycles(ns_op, clock)})", flush=True)
        xv = arith_check_case(dt, dev)
        print(verdict(f"arith {name} on a seeded input against the plain "
                      "version on the host",
                      torch.equal(probe_arith(xv, body="addxor",
                                              S=steps).cpu(),
                                  probe_arith_ref(xv.cpu(), body="addxor",
                                                  S=steps)), wrong),
              flush=True)
    tab, idx = chain_case(dev)

    def chain(tab=tab, idx=idx):
        return probe_gather_chain(tab, idx, P=1, S=steps, broadcast=True)

    t = ms["gather chain"] = time_ms(chain, dev)
    clock = sm_clock_mhz(dev)
    on = device_ms(chain, dev)
    ns = (t if on is None else on) * 1e6 / max(steps, 1)
    print(f"gather chain i32 ({R},{C}): {t:.4f} ms a launch, kernel {us(on)} "
          f"on the card; {ns:.3f} ns a dependent shared-memory load "
          f"({cycles(ns, clock)})", flush=True)
    tab, idx = chain_check_case(dev)
    print(verdict("gather chain on a seeded input against the plain version "
                  "on the host",
                  torch.equal(chain(tab, idx).cpu(), probe_gather_chain_ref(
                      tab.cpu(), idx.cpu(), P=1, S=steps, broadcast=True)),
                  wrong), flush=True)
    print(f"card: {card(dev)}", flush=True)
    raise_if_wrong(wrong)
    return dict(floor_ms=fl, ms=ms, steps=steps)

"""One-shot gathers along either axis, at the widths the dense compaction
needs.

Port of ``scripts/probe_gather.py``: ``probe_gather`` along axis 1 at (S, W)
in ``AXIS1`` int32, then along axis 0 at (16, 128) int32 and (8, 128) uint8,
on seeded tables and indices (numpy, seed 0, drawn in the script's order).
Each line says EXACT or WRONG against ``np.take_along_axis`` and gives the
kernel's time a launch beside that of ``torch.gather``, the same function
as one library call.
"""

from __future__ import annotations

import numpy as np
import torch

from huffmandecoderongpus_tpu_torch.ops.lanedfa_decode import require_device
from huffmandecoderongpus_tpu_torch.ops.probe_gather import probe_gather
from huffmandecoderongpus_tpu_torch.probes._timing import (
    card,
    raise_if_wrong,
    time_ms,
    verdict,
)

AXIS1 = ((8, 128), (8, 256), (8, 1536), (128, 1536), (256, 1536))
AXIS0 = ((16, 128, np.int32), (8, 128, np.uint8))


def cases(seed: int = 0):
    """[(label, axis, tab, idx)] as numpy, drawn as the script draws them."""
    rng = np.random.default_rng(seed)
    out = []
    for S, W in AXIS1:
        tab = rng.integers(0, 1 << 20, (S, W)).astype(np.int32)
        idx = rng.integers(0, W, (S, W)).astype(np.int32)
        out.append((f"axis1 ({S},{W})", 1, tab, idx))
    for S, W, dt in AXIS0:
        tab = rng.integers(0, 100, (S, W)).astype(dt)
        idx = rng.integers(0, S, (S, W)).astype(np.int32)
        out.append((f"axis0 ({S},{W},{np.dtype(dt).name})", 0, tab, idx))
    return out


def run(device="cuda", **_):
    """Print the probe's lines; returns {label: (kernel ms, torch.gather
    ms)}.  Raises if a gather differs from numpy."""
    dev = require_device(device)
    wrong, ms = [], {}
    for label, axis, tab_np, idx_np in cases():
        tab = torch.from_numpy(tab_np).to(dev)
        idx = torch.from_numpy(idx_np).to(dev)
        got = probe_gather(tab, idx, axis=axis).cpu().numpy()
        ok = np.array_equal(got, np.take_along_axis(tab_np, idx_np, axis))
        k64 = idx.to(torch.int64)
        ms[label] = (time_ms(lambda: probe_gather(tab, idx, axis=axis), dev),
                     time_ms(lambda: tab.gather(axis, k64), dev))
        print(verdict(label, ok, wrong) + f"  kernel {ms[label][0]:.4f} ms  "
              f"torch.gather {ms[label][1]:.4f} ms", flush=True)
    print(f"card: {card(dev)}", flush=True)
    raise_if_wrong(wrong)
    return dict(ms=ms)

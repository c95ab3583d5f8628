"""Env-gated debug dumps of intermediate buffers.

The port's copy of the JAX package's ``utils/debug.py``.  Role parity with
the reference's DEBUG / FGPUDEBUG builds, which print the bitdecode,
bitsteps and bitsindex intermediates (pes.c:141-196, fastgpu.cu:226-273,
openclapproach.c:431-606): the speculative pipeline
(``ops.speculative.speculative_stages``) dumps its S1 symbols, its kept S2
levels and its S3 result here.  Set ``HUFF_DEBUG=1`` (or call
:func:`set_debug`) to activate; dumps go to stderr, truncated to ``limit``
leading elements like the reference's fixed-count loops.  A tensor on the
card is copied to the host for the dump.
"""

from __future__ import annotations

import os
import sys

import numpy as np

_forced: bool | None = None


def set_debug(on: bool | None) -> None:
    """Force debug dumps on/off (None = defer to the HUFF_DEBUG env var)."""
    global _forced
    _forced = on


def debug_enabled() -> bool:
    if _forced is not None:
        return _forced
    return os.environ.get("HUFF_DEBUG", "") not in ("", "0")


def dump(name: str, arr, limit: int = 32, out=None) -> None:
    """Print a truncated view of an intermediate array when debugging."""
    if not debug_enabled():
        return
    if out is None:
        out = sys.stderr
    if hasattr(arr, "detach"):  # a torch tensor, on any device
        arr = arr.detach().cpu().numpy()
    a = np.asarray(arr).reshape(-1)
    head = np.array2string(a[:limit], max_line_width=120)
    suffix = f" ... ({a.size} total)" if a.size > limit else ""
    print(f"[huff-debug] {name}: {head}{suffix}", file=out)

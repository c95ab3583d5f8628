"""The card's peak and the bytes a request must move.

A request's work is counted from the request, not from the kernels that
do it: each input byte read once and each output byte written once, so
the share reads the same whatever kernels a program runs.  The rate and
the rule are ``chip_smoke.py``'s bytes bound (its ``HBM_BYTES_PER_S`` and
``nbytes``), frozen here.
"""

from __future__ import annotations

#: NVIDIA H100 SXM's memory rate, bytes a second (NVIDIA's data sheet)
HBM_BYTES_PER_S = 3.35e12


def decode_bytes(compressed: int, decoded: int) -> int:
    """A decode reads the payload once and writes the decoded bytes once."""
    return int(compressed) + int(decoded)


def encode_bytes(raw: int, payload: int) -> int:
    """An encode reads the input once and writes the payload once."""
    return int(raw) + int(payload)


def bound_s(nbytes: int) -> float:
    """The least time the card's memory allows for ``nbytes``."""
    return nbytes / HBM_BYTES_PER_S


def share_pct(nbytes: int, kernel_s: float) -> float | None:
    """The bound's share of the kernels' time, in %; None without kernel
    time."""
    if kernel_s <= 0:
        return None
    return 100.0 * bound_s(nbytes) / kernel_s

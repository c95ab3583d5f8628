"""Timers: the host's monotonic clock, and CUDA events for the card.

``Timer``, ``report_resolution`` and ``gb_per_s`` are those of the JAX
package's ``harness/timing.py``.  ``event_ms`` and ``launch_ms`` are the
port's one device timer: launches of a function between two CUDA events on
a CUDA device, after warm-ups; on the CPU, where torch runs each call to its
end, the same loop timed by the host clock.
"""

from __future__ import annotations

import statistics
import time

import torch


class Timer:
    """start/stop nanosecond timer (timing.h:20-30 semantics)."""

    __slots__ = ("_t0", "_t1")

    def __init__(self) -> None:
        self._t0 = 0
        self._t1 = 0

    def start(self) -> None:
        self._t0 = time.perf_counter_ns()

    def stop(self) -> None:
        self._t1 = time.perf_counter_ns()

    @property
    def ns(self) -> int:
        return self._t1 - self._t0

    @property
    def ms(self) -> float:
        return self.ns / 1e6

    @property
    def seconds(self) -> float:
        return self.ns / 1e9


def report_resolution() -> str:
    """Clock resolution report (reportresolution, timing.c:46-50)."""
    info = time.get_clock_info("perf_counter")
    return f"timer resolution: {info.resolution:.3e} s (monotonic={info.monotonic})"


def gb_per_s(nbytes: int, seconds: float) -> float:
    """Decode throughput in GB/s (decimal GB, the unit BASELINE.md uses)."""
    if seconds <= 0:
        return float("inf")
    return nbytes / seconds / 1e9


def event_ms(fn, trials: int, *, device="cuda", launches: int = 1,
             warmup: int = 0) -> list[float]:
    """Per trial, the ms one call of ``fn`` takes: ``launches`` calls back
    to back between two CUDA events, then a synchronize, the elapsed time
    over ``launches``.  ``warmup`` untimed calls first.  On a CPU device
    the host clock times the same loop."""
    cuda = torch.device(device).type == "cuda"
    for _ in range(warmup):
        fn()
    out = []
    for _ in range(trials):
        if cuda:
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            for _ in range(launches):
                fn()
            b.record()
            torch.cuda.synchronize()
            out.append(a.elapsed_time(b) / launches)
        else:
            t0 = time.perf_counter()
            for _ in range(launches):
                fn()
            out.append((time.perf_counter() - t0) * 1e3 / launches)
    return out


def launch_ms(fn, *, device="cuda", launches: int = 20, trials: int = 5,
              warmup: int = 3) -> float:
    """The median over ``trials`` of ``event_ms``'s ms a call."""
    return statistics.median(event_ms(fn, trials, device=device,
                                      launches=launches, warmup=warmup))

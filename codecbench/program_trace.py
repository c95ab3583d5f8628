"""The program's own spans and counters, read from a traced run.

The port opens ``huff.*`` spans round its host work while a profiler
records (``huffmandecoderongpus_tpu_torch/utils/trace.py``), so they come
in the run's trace as ``user_annotation`` events on the profiler's clock,
beside the card's kernels and copies; each also comes a second time as a
``gpu_user_annotation`` (the profiler's projection of it onto the card),
which is not read.  Its counters taken while the profiler recorded are
``trace.traced_counts()``: the window's alone, since set-up and warm-up
run before the profiler starts.  A program without them (a checkout from
before they were added) reads None, as does a run without a trace.
"""

from __future__ import annotations

from codecbench import devtrace

#: the trace's category of host spans that the program opens
SPAN = "user_annotation"


def span_ms(run, name: str) -> float | None:
    """Host ms a completed request in the program's span ``name``: its
    events clipped to the window, a nested call counted once, summed, over
    the completed requests."""
    if run.trace is None or not run.completed:
        return None
    win = run.trace.window()
    if win is None:
        return None
    lo, hi = win
    found = []
    for _c, n, s, e in run.trace.of(SPAN):
        s, e = max(s, lo), min(e, hi)
        if n == name and e > s:
            found.append((s, e))
    if not found:
        return None
    held = sum(e - s for s, e in devtrace.merged(found))
    return held / 1e3 / len(run.completed)


def traced_counts(run) -> dict | None:
    """The program's counters taken under the run's profiler, or None
    without a trace or where the program keeps none."""
    if run.trace is None:
        return None
    try:
        from huffmandecoderongpus_tpu_torch.utils import trace
    except ImportError:
        return None
    return trace.traced_counts()


def copy_s(run) -> float:
    """Device seconds of the window's host-to-device and device-to-host
    copies."""
    return sum(e - s for _c, name, s, e in run.trace.device(devtrace.COPY)
               if "HtoD" in name or "DtoH" in name) / 1e6

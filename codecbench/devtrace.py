"""The profiler's trace, read: device activity, host spans, idle gaps.

A traced run records the window with ``torch.profiler`` (host and CUDA
activity), writes its Chrome trace to a temporary file, reads it back and
deletes it.  Times in the trace are microseconds on one clock for host and
device events.  Device activity is every kernel, copy and memset; host
spans are the profiler's ``cpu_op`` events and the ``user_annotation``
spans that the harness opens (``codecbench.request`` around each request,
``codecbench.<span>`` around the functions an entry names).
"""

from __future__ import annotations

import dataclasses
import json
import os
import tempfile

#: the trace's categories of device activity
KERNEL, COPY, MEMSET = "kernel", "gpu_memcpy", "gpu_memset"
DEVICE_CATS = (KERNEL, COPY, MEMSET)
HOST_CATS = ("user_annotation", "cpu_op")
REQUEST_SPAN = "codecbench.request"
#: entries a breakdown list keeps
TOP = 10


@dataclasses.dataclass
class Trace:
    """Complete ("X") events of a trace, each (cat, name, start, end) in
    microseconds."""

    events: list

    def of(self, *cats) -> list:
        return [e for e in self.events if e[0] in cats]

    def window(self) -> tuple[float, float] | None:
        """First request span's start to the last one's end."""
        req = [e for e in self.of("user_annotation") if e[1] == REQUEST_SPAN]
        if not req:
            return None
        return min(e[2] for e in req), max(e[3] for e in req)

    def device(self, *cats) -> list:
        """Device events of ``cats`` (all device activity by default),
        clipped to the window."""
        win = self.window()
        if win is None:
            return []
        lo, hi = win
        out = []
        for cat, name, s, e in self.of(*(cats or DEVICE_CATS)):
            s, e = max(s, lo), min(e, hi)
            if e > s:
                out.append((cat, name, s, e))
        return out


def from_chrome(doc: dict) -> Trace:
    """A Trace from a Chrome trace document (``traceEvents``)."""
    events = []
    for ev in doc.get("traceEvents", ()):
        if ev.get("ph") != "X" or "dur" not in ev:
            continue
        s = float(ev["ts"])
        events.append((ev.get("cat", ""), ev.get("name", ""), s,
                       s + float(ev["dur"])))
    return Trace(events)


def from_profiler(prof) -> Trace:
    """Export a finished ``torch.profiler.profile`` to a temporary file
    (under ``TMPDIR``), read it, delete it."""
    fd, path = tempfile.mkstemp(suffix=".json", prefix="codecbench-")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            return from_chrome(json.load(f))
    finally:
        os.unlink(path)


def merged(intervals) -> list[tuple[float, float]]:
    """Sorted (start, end) intervals with overlaps merged."""
    out: list[list[float]] = []
    for s, e in sorted((s, e) for *_x, s, e in intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def busy_s(trace: Trace) -> float:
    """Seconds in which some device activity ran, inside the window."""
    return sum(e - s for s, e in merged(trace.device())) / 1e6


def window_s(trace: Trace) -> float:
    win = trace.window()
    return 0.0 if win is None else (win[1] - win[0]) / 1e6


def summed_s(trace: Trace, *cats) -> float:
    """Summed durations of the device events of ``cats`` in the window."""
    return sum(e - s for _c, _n, s, e in trace.device(*cats)) / 1e6


def top_ops(trace: Trace, k: int = TOP) -> list:
    """[[name, seconds]] of the device operations that took most time."""
    tot: dict[str, float] = {}
    for _c, name, s, e in trace.device():
        tot[name] = tot.get(name, 0.0) + (e - s) / 1e6
    return [[n, v] for n, v in sorted(tot.items(), key=lambda kv: -kv[1])[:k]]


def idle_gaps(trace: Trace, k: int = TOP) -> list:
    """[[what the host was doing, seconds]] of the longest stretches of the
    window with no device activity.  A gap is named by the spans open on
    the host at its midpoint, outermost first."""
    win = trace.window()
    if win is None:
        return []
    edges = [win[0]]
    for s, e in merged(trace.device()):
        edges += [s, e]
    edges.append(win[1])
    gaps = sorted(((edges[i + 1] - edges[i], edges[i], edges[i + 1])
                   for i in range(0, len(edges), 2)
                   if edges[i + 1] > edges[i]), reverse=True)[:k]
    host = trace.of(*HOST_CATS)
    out = []
    for length, s, e in gaps:
        mid = (s + e) / 2
        open_ = sorted((hs, -he, name) for _c, name, hs, he in host
                       if hs <= mid < he)
        out.append([" > ".join(n for _s, _e, n in open_) or "(no host span)",
                    length / 1e6])
    return out

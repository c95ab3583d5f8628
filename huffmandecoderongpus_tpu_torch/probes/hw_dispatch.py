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
after gives each kernel's own time on the card (``torch.profiler``), and
the next where a ``probe_inc`` launch spends the host's time
(``host_split``).  The outputs of ``triv`` and ``med`` are then held
against their plain versions on the host.
"""

from __future__ import annotations

import ctypes
import threading
import time

import torch

from huffmandecoderongpus_tpu_torch.ops import _build
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
#: calls each part of a launch is timed over, and the parts, in the order
#: a wrapper runs them
SPLIT_CALLS = 1000
SPLIT_PARTS = ("checks", "empty", "library", "stream", "pointers", "ctypes",
               "launch", "check")


def _us_a_call(fn, calls: int) -> float:
    """Host us a call of ``fn``, over ``calls`` calls after ten untimed."""
    for _ in range(10):
        fn()
    t0 = time.perf_counter_ns()
    for _ in range(calls):
        fn()
    return (time.perf_counter_ns() - t0) / calls / 1e3


def host_split(device, calls: int = SPLIT_CALLS):
    """Where the host's time goes in a ``probe_inc`` launch on an (8, 128)
    int32 tile: {part: (objects us, lean us)} a call, each part timed on
    its own with ``time.perf_counter_ns`` over ``calls`` calls (the cost of
    calling an empty function taken off), plus "sum" and "whole" (one whole
    call of each path).  None off the card.

    The parts, in a wrapper's order: the argument checks, the output's
    ``torch.empty_like``, the library lookup, the stream lookup, the
    pointers, the ``ctypes`` call with nothing to launch (n = 0: argument
    conversion and the C call), the launch (the same call with n = 1,024,
    less that), and ``check`` of the return code.  "lean" is the wrappers'
    path (``ops/_build.py``); "objects" makes a Python object at each step
    instead: a ``torch.device`` per tensor checked, a locked library
    lookup, a ``torch.cuda.Stream`` and a ``ctypes.c_void_p`` per
    pointer."""
    if torch.device(device).type != "cuda":
        return None
    from huffmandecoderongpus_tpu_torch.ops.probe_inc import probe_inc

    x = torch.zeros((8, 128), dtype=torch.int32, device=device)
    out = torch.empty_like(x)
    n = x.numel()
    lib = _build.get_lib()
    fn = lib.ws_probe_inc
    lock = threading.Lock()

    def checks_objects():
        if x.device.type == "cpu":
            raise AssertionError("unreachable")
        dev = x.device
        if x.device != dev or x.device.type != "cuda":
            raise AssertionError("unreachable")
        if not x.is_contiguous() or x.dtype != torch.int32:
            raise AssertionError("unreachable")

    def checks_lean():
        if x.is_cpu:
            raise AssertionError("unreachable")
        _build.require_cuda("probe_inc", x)
        if x.dtype != torch.int32:
            raise AssertionError("unreachable")

    def library_objects():
        with lock:
            return _build.get_lib()

    def stream_objects():
        return ctypes.c_void_p(torch.cuda.current_stream(x.device).cuda_stream)

    def pointers_objects():
        return ctypes.c_void_p(x.data_ptr()), ctypes.c_void_p(out.data_ptr())

    px, po = pointers_objects()
    s_obj, s_lean = stream_objects(), _build.stream_ptr(x)
    ix, io = x.data_ptr(), out.data_ptr()

    def whole_objects():
        checks_objects()
        o = torch.empty_like(x)
        rc = library_objects().ws_probe_inc(
            ctypes.c_void_p(x.data_ptr()), ctypes.c_void_p(o.data_ptr()), n,
            stream_objects())
        _build.check(rc, "probe_inc")
        return o

    parts = {
        "checks": (checks_objects, checks_lean),
        "empty": (lambda: torch.empty_like(x),) * 2,
        "library": (library_objects, _build.get_lib),
        "stream": (stream_objects, lambda: _build.stream_ptr(x)),
        "pointers": (pointers_objects, lambda: (x.data_ptr(), out.data_ptr())),
        "ctypes": (lambda: fn(px, po, 0, s_obj), lambda: fn(ix, io, 0, s_lean)),
        "launch": (lambda: fn(px, po, n, s_obj), lambda: fn(ix, io, n, s_lean)),
        "check": (lambda: _build.check(0, "probe_inc"),) * 2,
        "whole": (whole_objects, lambda: probe_inc(x)),
    }
    empty = _us_a_call(lambda: None, calls)
    split = {}
    for part, fns in parts.items():
        split[part] = tuple(max(_us_a_call(f, calls) - empty, 0.0)
                            for f in fns)
        torch.cuda.synchronize(device)
    split["launch"] = tuple(max(a - b, 0.0) for a, b in zip(
        split["launch"], split["ctypes"]))
    split["sum"] = tuple(sum(split[p][i] for p in SPLIT_PARTS)
                         for i in range(2))
    split["whole"] = split.pop("whole")
    return split


def host_calls(device, calls: int = SPLIT_CALLS):
    """Host us a whole call (``calls`` calls back to back, the cost of
    calling an empty function taken off) of the P1 and P3 wrappers beside
    the PyTorch call for the same function: ``probe_inc`` and ``x + 1`` on
    (8, 128) int32, ``probe_gather`` and ``torch.gather`` along axis 1 on
    (256, 1536) int32 (the index cast to int64 for torch beforehand), and
    ``probe_roll`` and ``torch.roll`` of (128, 640) int32 by 100 on axis 1.
    None off the card."""
    if torch.device(device).type != "cuda":
        return None
    from huffmandecoderongpus_tpu_torch.ops.probe_gather import (
        probe_gather,
        probe_roll,
    )
    from huffmandecoderongpus_tpu_torch.ops.probe_inc import probe_inc

    i32 = dict(dtype=torch.int32, device=device)
    x = torch.zeros((8, 128), **i32)
    tab = torch.zeros((256, 1536), **i32)
    idx = torch.zeros((256, 1536), **i32)
    k64 = idx.long()
    xr = torch.zeros((128, 640), **i32)
    fns = {"probe_inc": lambda: probe_inc(x), "x + 1": lambda: x + 1,
           "probe_gather": lambda: probe_gather(tab, idx, axis=1),
           "torch.gather": lambda: tab.gather(1, k64),
           "probe_roll": lambda: probe_roll(xr, 100, axis=1),
           "torch.roll": lambda: torch.roll(xr, 100, 1)}
    empty = _us_a_call(lambda: None, calls)
    out = {}
    for name, fn in fns.items():
        out[name] = max(_us_a_call(fn, calls) - empty, 0.0)
        torch.cuda.synchronize(device)
    return out


def split_line(split, calls=None) -> str:
    """The host split as one line, objects -> lean a part, then the whole
    calls of ``host_calls``."""
    if split is None:
        return ("host split of a probe_inc launch: not measured off the "
                "card")
    src = ("torch._C._cuda_getCurrentRawStream"
           if hasattr(torch._C, "_cuda_getCurrentRawStream")
           else "torch.cuda.current_stream")
    return (f"host split of a probe_inc launch, us a call over {SPLIT_CALLS} "
            "calls (objects -> lean): " + "  ".join(
                f"{p} {a:.3f} -> {b:.3f}" for p, (a, b) in split.items())
            + f"; lean stream from {src}"
            + ("" if calls is None else "; whole calls, host us: " + "  ".join(
                f"{n} {v:.3f}" for n, v in calls.items())))


def run(device="cuda", **_):
    """Print the probe's lines; returns ms={(rep, K): (torch, triv, med) ms
    a launch}, their device_ms and the host_split.  Raises if an output
    differs from its plain version."""
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
    split = host_split(dev)
    print(split_line(split, host_calls(dev)), flush=True)
    wrong = []
    print(verdict("triv against the plain version on the host", torch.equal(
        probe_inc(xp).cpu(), probe_inc_ref(xp.cpu())), wrong), flush=True)
    print(verdict("med against the plain version on the host", torch.equal(
        probe_arith(xm, body="mul3", S=MED_STEPS).cpu(),
        probe_arith_ref(xm.cpu(), body="mul3", S=MED_STEPS)), wrong),
          flush=True)
    print(f"card: {card(dev)}", flush=True)
    raise_if_wrong(wrong)
    return dict(ms=out, device_ms=on_card, host_split=split)

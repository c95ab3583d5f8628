"""One run of one cell: set-up, a closed loop for the window, the check,
the metrics and the result line.

Set-up (``setup_s``, from the start of the process) makes the
configuration's data from the seed on the device, hands it to the
entry's ``Cell`` (which builds the program's inputs with the plain
reference), and warms up the entry's own shapes.  The window then sends
one request after another from one client until ``seconds`` have passed
and the last request has returned; the window runs from the first
request's start to the last one's end.  With ``trace`` the window runs
under ``torch.profiler``, with a span round each request and round each
program function that the entry names (its ``SPANS``).  Every answer is
glanced at as it comes (a cheap check of part of it), and a sample of
the answers, drawn from the seed, is kept and checked whole against the
reference once the window has closed and the memory peak has been read.

An entry module (``entries/<name>.py``) has ``SPANS``, a tuple of
(module, attribute, span name), and a class ``Cell(data, cfg, traffic,
device, seed)`` with ``warmup()``; ``prepare(i)``, which makes request
i's input outside its timed call (a new input each request) and returns
a dict, its note; ``request(i)``, the timed call; ``glance(note,
answer)``, which notes a cheap check of the answer; ``work(i)`` (its
``in_bytes``, ``out_bytes`` and ``moved_bytes``); and ``check(samples,
notes)``, which takes the sampled [(i, answer)] and the notes of every
completed request by i, and returns ({name: (number, limit)}, the set of
requests found wrong).
"""

from __future__ import annotations

import contextlib
import dataclasses
import importlib
import json
import random
import subprocess
import sys
import time
import traceback

import torch

from codecbench import datagen, devtrace

#: top-level modules no run may load: JAX and the JAX package (the port's
#: own name starts with the latter's, so names are compared whole)
FORBIDDEN = ("jax", "jaxlib", "flax", "huffmandecoderongpus_tpu")
#: answers a run keeps for the check
SAMPLE = 16
#: where the sample's draw is taken from, beside the seed
SAMPLE_SALT = 0xC0DEC
#: where the entry's draws (each request's input, the glances) are taken
#: from, beside the seed
INPUT_SALT = 0x1A9E7


@dataclasses.dataclass
class Run:
    """What a run's metric readers read."""

    setup_s: float
    window_s: float
    #: a dict a request: t0, t1 (host clock), ok, in_bytes, out_bytes,
    #: moved_bytes
    requests: list
    #: host seconds of each call of a span, by span name (traced runs)
    spans: dict
    trace: devtrace.Trace | None

    @property
    def completed(self) -> list:
        return [r for r in self.requests if r["ok"]]


def forbidden_modules() -> list[str]:
    """FORBIDDEN top-level names present in ``sys.modules``."""
    tops = {name.split(".")[0] for name in list(sys.modules)}
    return sorted(tops.intersection(FORBIDDEN))


def emit(result: dict, lines, *, out=None, err=None) -> int:
    """Print a run's check lines (the last lines of ``err``) and its result
    line (the last line of ``out``), and return 0; or, where a forbidden
    module has been loaded by then (by the program, a metric reader or
    anything else the run called), name it on ``err``, print no result
    and return 3.  The look is the last step before the result."""
    out = out or sys.stdout
    err = err or sys.stderr
    found = forbidden_modules()
    if found:
        print("forbidden modules loaded: " + ", ".join(found), file=err,
              flush=True)
        return 3
    for line in lines:
        print(line, file=err)
    err.flush()
    print(json.dumps(result), file=out, flush=True)
    return 0


def card_limits() -> str:
    """The card's name and power limit as ``nvidia-smi`` reads them."""
    try:
        res = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60)
    except (OSError, subprocess.TimeoutExpired) as exc:
        return f"not read ({exc})"
    return (res.stdout or res.stderr).strip()


def synchronize(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


@contextlib.contextmanager
def spans_installed(entry_spans, sink: dict):
    """Wrap each (module, attribute) of ``entry_spans`` in a span: host
    seconds a call into ``sink[name]`` and a profiler annotation
    ``codecbench.<name>``.  The originals come back on exit."""
    saved = []
    try:
        for mod_name, attr, name in entry_spans:
            mod = importlib.import_module(mod_name)
            fn = getattr(mod, attr)
            saved.append((mod, attr, fn))
            setattr(mod, attr, _timed(fn, name, sink.setdefault(name, [])))
        yield
    finally:
        for mod, attr, fn in reversed(saved):
            setattr(mod, attr, fn)


def _timed(fn, name, out: list):
    label = f"codecbench.{name}"

    def wrapper(*args, **kwargs):
        t0 = time.perf_counter()
        try:
            with torch.profiler.record_function(label):
                return fn(*args, **kwargs)
        finally:
            out.append(time.perf_counter() - t0)

    return wrapper


def profiler(device):
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return torch.profiler.profile(activities=acts)


def run_cell(spec, cell: str, seed: int, seconds: float, trace: bool, *,
             device, t_start: float, log=None, request=None,
             min_requests: int = 1):
    """Run ``cell`` once.  Returns (result dict, check lines); ``emit``
    prints them.  ``request(state, i)``, where given, answers in the window
    in place of the entry's own call: the controls and the tests'
    faults.  The window sends at least ``min_requests``."""
    log = log or (lambda msg: print(msg, file=sys.stderr, flush=True))
    wl = spec.workload(cell)
    cfg = spec.config(wl["config"])
    traffic = spec.traffic(wl["traffic"])
    if traffic.get("clients", 1) != 1:
        raise ValueError("the harness drives one client")
    marks = [("imports", time.perf_counter())]
    entry = spec.entry(traffic["entry"])
    cuda = torch.device(device).type == "cuda"
    importlib.import_module("huffmandecoderongpus_tpu_torch")
    if cuda:  # the context, which the data's first call would make
        torch.empty(1, device=device)
        synchronize(device)
    marks.append(("program import, context", time.perf_counter()))
    data = datagen.generate(cfg, seed, device)
    synchronize(device)
    marks.append(("data", time.perf_counter()))
    state = entry.Cell(data, cfg, traffic, device, int(seed) ^ INPUT_SALT)
    del data
    synchronize(device)
    marks.append(("inputs", time.perf_counter()))
    if cuda:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    state.warmup()
    synchronize(device)
    marks.append(("warm-up", time.perf_counter()))
    setup_s = marks[-1][1] - t_start
    prev, parts = t_start, []
    for name, t in marks:
        parts.append(f"{name} {t - prev:.3f}")
        prev = t
    log(f"[setup] {setup_s:.3f} s: " + ", ".join(parts))

    rng = random.Random(int(seed) ^ SAMPLE_SALT)
    samples: list = []
    notes: dict = {}
    requests: list = []
    spans: dict = {}
    raised = 0
    prof = profiler(device) if trace else contextlib.nullcontext()
    installed = (spans_installed(entry.SPANS, spans) if trace
                 else contextlib.nullcontext())
    annotate = (lambda: torch.profiler.record_function(
        devtrace.REQUEST_SPAN)) if trace else contextlib.nullcontext
    with prof, installed:
        t_open = time.perf_counter()
        i = 0
        while (len(requests) < min_requests
               or time.perf_counter() - t_open < seconds):
            note = state.prepare(i)
            t0 = time.perf_counter()
            try:
                with annotate():
                    answer = (state.request(i) if request is None
                              else request(state, i))
                ok = True
            except Exception:  # a failed request is counted, not fatal
                if not raised:
                    log(traceback.format_exc())
                raised += 1
                answer, ok = None, False
            t1 = time.perf_counter()
            requests.append(dict(t0=t0, t1=t1, ok=ok, **state.work(i)))
            if ok:
                state.glance(note, answer)
                notes[i] = note
                # reservoir sample of the answers
                if len(samples) < SAMPLE:
                    samples.append((i, answer))
                else:
                    j = rng.randrange(i + 1)
                    if j < SAMPLE:
                        samples[j] = (i, answer)
            del answer
            i += 1
    window_s = requests[-1]["t1"] - requests[0]["t0"]
    lat = [(r["t1"] - r["t0"]) * 1e3 for r in requests]
    first = ", ".join(f"{v:.2f}" for v in lat[:3])
    fifths = [[] for _ in range(5)]
    for r, v in zip(requests, lat):
        at = (r["t0"] - requests[0]["t0"]) / max(window_s, 1e-9)
        fifths[min(4, int(at * 5))].append(v)
    by_fifth = ", ".join(f"{sorted(f)[len(f) // 2]:.2f}" if f else "-"
                         for f in fifths)
    lat.sort()
    log(f"[window] {len(requests)} requests in {window_s:.3f} s; latency ms "
        f"min {lat[0]:.2f} median {lat[len(lat) // 2]:.2f} max {lat[-1]:.2f}"
        f"; first {first}; median by fifth of the window {by_fifth}")
    memory_peak = torch.cuda.max_memory_allocated() if cuda else 0
    dtrace = None
    if trace:
        t0 = time.perf_counter()
        dtrace = devtrace.from_profiler(prof)
        log(f"[trace] {len(dtrace.events)} events read in "
            f"{time.perf_counter() - t0:.1f} s")
    del prof

    t0 = time.perf_counter()
    numbers, wrong = state.check(samples, notes)
    log(f"[check] {len(notes)} answers glanced, {len(samples)} compared "
        f"whole in {time.perf_counter() - t0:.2f} s")
    del samples, notes, state

    run = Run(setup_s=setup_s, window_s=window_s, requests=requests,
              spans=spans, trace=dtrace)
    kind = "per_layer" if trace else "end_to_end"
    metrics = {}
    for m in spec.metrics(cell, kind):
        value = spec.reader(m["name"])(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if cuda else torch.device(device).type,
           "kind": torch.cuda.get_device_name() if cuda else "cpu",
           "count": int(wl["chips"]), "memory_peak_bytes": int(memory_peak)}
    if trace:
        dev["busy_s"] = devtrace.busy_s(dtrace)
        dev["window_s"] = devtrace.window_s(dtrace)
    failed = raised + len(wrong)
    numbers["failed_requests"] = (failed, 0)
    correct = bool(run.completed) and all(
        v <= lim for v, lim in numbers.values())
    result = {"correct": correct, "attempted": len(requests),
              "failed": failed, "metrics": metrics, "device": dev}
    if trace:
        result["breakdown"] = {"device_ops": devtrace.top_ops(dtrace),
                               "idle_gaps": devtrace.idle_gaps(dtrace)}
    result["checks"] = {name: {"value": v, "limit": lim}
                        for name, (v, lim) in numbers.items()}
    lines = [f"check {name} {v} limit {lim}"
             for name, (v, lim) in numbers.items()]
    return result, lines

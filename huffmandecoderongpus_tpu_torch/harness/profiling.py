"""Per-stage timing of the device decode programs.

Port of ``huffmandecoderongpus_tpu/harness/profiling.py``.  A report maps
each stage to seconds, as there, so ``format_report`` is the same.  A
device stage is timed by CUDA events around it on a CUDA device, and by the
host clock on the CPU (where torch runs each call to its end): the median
over ``reps`` runs after one untimed run, whose outputs feed the next
stage.  Host stages (the lane-DFA's bit matrix and compaction) are host
clock everywhere.  ``trace`` writes a ``torch.profiler`` Chrome trace.

The speculative pipeline's breakdown (``profile_speculative``) waits for
that pipeline's port.
"""

from __future__ import annotations

import contextlib
import pathlib
import statistics
import time

import torch

from huffmandecoderongpus_tpu_torch.harness.timing import event_ms
from huffmandecoderongpus_tpu_torch.ops import widescan as ws
from huffmandecoderongpus_tpu_torch.ops.candidate_scan import candidate_scan
from huffmandecoderongpus_tpu_torch.ops.k2_compose import k2_compose
from huffmandecoderongpus_tpu_torch.ops.k4_compact import k4_compact
from huffmandecoderongpus_tpu_torch.ops.lane_scan import lane_scan
from huffmandecoderongpus_tpu_torch.ops.lanedfa_decode import (
    compose,
    require_device,
    stage_lanedfa,
)

REPS = 5


def _time_stage(fn, device, reps: int = REPS):
    """(seconds, output) of ``fn``: one untimed run gives the output, then
    the median of ``reps`` runs, each between two CUDA events on a CUDA
    device or under the host clock on the CPU."""
    out = fn()
    return statistics.median(event_ms(fn, reps, device=device)) / 1e3, out


def _host_s(fn, device):
    """(seconds, output) of one run of host work ``fn``, host clock, the
    device synchronized at its end."""
    t0 = time.perf_counter()
    out = fn()
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
    return time.perf_counter() - t0, out


def profile_lanedfa(hf, lanes: int | None = None, reps: int = REPS, *,
                    device="cuda") -> dict[str, float]:
    """Stage breakdown of the lane-DFA decoder in ``decode_lanedfa``'s
    geometry: the host bit matrix (with the table, onto the device), the
    candidate scan, compose, the main (lane) scan and the host compaction;
    ``total`` is their sum, as in the JAX report."""
    device = require_device(device)
    report = {}
    report["host_bit_matrix"], st = _host_s(
        lambda: stage_lanedfa(hf, device=device, lanes=lanes, tiled=False),
        device)
    kw = dict(B=st["B"], H=st["H"], N=st["N"])
    bits, tab = st["bits"], st["tab"]
    report["candidate_scan"], (cnt, ex) = _time_stage(
        lambda: candidate_scan(bits, tab, **kw), device, reps)
    report["compose"], (entry, *_rest) = _time_stage(
        lambda: compose(cnt, ex), device, reps)
    report["main_scan"], (sym, valid) = _time_stage(
        lambda: lane_scan(bits, tab, entry, **kw), device, reps)

    def compaction():
        sym_t = sym.cpu().numpy().T
        valid_t = valid.cpu().numpy().T
        return sym_t[valid_t > 0]

    report["host_compaction"], _ = _host_s(compaction, device)
    report["total"] = sum(report.values())
    return report


def profile_widescan(hf, lanes: int | None = None, reps: int = REPS, *,
                     device="cuda") -> dict[str, float]:
    """Stage breakdown of the wide-lane decoder: K1 with discovery (and the
    word matrix), K2, K3 with the counts and fix rows before it, K4; and
    ``total``, ``wide_decode_program`` timed alone.

    The JAX version times nested jitted prefixes of the program and takes
    their differences; torch has no ``jit`` to fuse a prefix, so each stage
    is timed directly on the previous stage's outputs (the stage helpers
    ``wide_decode_program`` itself runs).  The stages need not sum to
    ``total``: the gaps between launches are in neither.  Raises
    EnvelopeError for a stream outside the program's envelope."""
    device = require_device(device)
    st = ws.stage_widescan_inputs(hf, device=device, lanes=lanes)
    args = ws.program_args(st)
    kw = dict(args)
    ORP, B, steps = kw.pop("ORP"), kw.pop("B"), kw.pop("steps")
    words, tab, lim = st["words"], st["tab"], st["lim"]
    report = {}
    report["k1_scan_discovery"], (wmat, sym, val, cntmap, exmap, mrowmap) = (
        _time_stage(lambda: ws.stage_k1(words, tab, lim, B=B, steps=steps,
                                        **kw), device, reps))
    report["k2_compose"], (entry, _tot) = _time_stage(
        lambda: k2_compose(exmap, 0), device, reps)
    # K3 splices in place and is idempotent on its own output, so every
    # timed run does the same work on one copy
    report["k3_fix_splice"], (msym, mval, _n, _total) = _time_stage(
        lambda: ws.stage_k3(wmat, tab, lim, entry, cntmap, mrowmap, sym,
                            val, **kw), device, reps)
    report["k4_compact"], _ = _time_stage(
        lambda: k4_compact(msym, mval, ORP=ORP), device, reps)
    report["total"], _ = _time_stage(
        lambda: ws.wide_decode_program(words, tab, lim, **args), device, reps)
    return report


@contextlib.contextmanager
def trace(log_dir: str):
    """``torch.profiler`` context over the host and, where there is one, the
    card; on exit writes ``trace.json`` (a Chrome trace) into ``log_dir``."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        yield prof
    path = pathlib.Path(log_dir)
    path.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(path / "trace.json"))


def format_report(report: dict[str, float]) -> str:
    width = max(len(k) for k in report)
    lines = [f"{k:>{width}}  {v * 1e3:10.3f} ms" for k, v in report.items()]
    return "\n".join(lines)

"""Spans and counters of the codec's host work, on the profiler's clock.

``span(name)`` marks a stretch of host work.  While a ``torch.profiler``
session records, it is a ``torch.profiler.record_function`` annotation,
so the span lands in the same trace as the card's kernels, copies and
memsets, on the profiler's one clock; otherwise it is a shared no-op
context, after one read of the autograd profiler's enabled flag.
``count(name, n)`` adds to process totals (``counts()``) and, while a
profiler records, to a second table (``traced_counts()``) that holds only
what was counted under a profiler.  Nothing here turns tracing on: any
``torch.profiler`` trace of a program that calls the codec shows its
spans.

Spans (nesting as the codec opens them):

  huff.decode        one stream's decode (``decode_widescan``), whole
  huff.batch         one ``decode_widescan_batch`` call
  huff.encode        one ``encode_lanes`` call
  huff.stage         host staging of a decode, a batch or an encode
  huff.stage.tables  the lane DFA and its packed tables
  huff.stage.words   the lane words and per-lane bit limits
  huff.stage.hist    the encode's histogram and code
  huff.stage.lanes   the encode's symbol matrix
  huff.upload        host-to-device copies of staged inputs
  huff.launch        the host enqueueing a device program
  huff.wait          the host blocked on a device scalar or count
  huff.trim          the dense rows masked and gathered, and downloaded
  huff.download      device-to-host copies of an answer

Counters: ``launch.<kernel>`` (a CUDA kernel launched), ``encode.retry``
(an encode finished off its first plan), ``bytes.upload`` and
``bytes.download`` (bytes of the copies in ``huff.upload`` and
``huff.download`` that cross to or from a CUDA device).
"""

from __future__ import annotations

import contextlib

import torch
from torch.autograd import profiler as _autograd_profiler

_NOOP = contextlib.nullcontext()
_totals: dict[str, int] = {}
_traced: dict[str, int] = {}


def span(name: str):
    """A context over host work: a profiler annotation ``name`` while a
    profiler records, else a no-op."""
    if _autograd_profiler._is_profiler_enabled:
        return torch.profiler.record_function(name)
    return _NOOP


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to counter ``name``; to the traced table too while a
    profiler records."""
    _totals[name] = _totals.get(name, 0) + n
    if _autograd_profiler._is_profiler_enabled:
        _traced[name] = _traced.get(name, 0) + n


def counts() -> dict[str, int]:
    """Every counter's total in this process."""
    return dict(_totals)


def traced_counts() -> dict[str, int]:
    """Every counter's total of what was counted while a profiler
    recorded."""
    return dict(_traced)


def upload(device, *arrays) -> list[torch.Tensor]:
    """Numpy arrays as tensors on ``device``, copied in a ``huff.upload``
    span; ``bytes.upload`` counts them when ``device`` is a CUDA device."""
    with span("huff.upload"):
        out = [torch.from_numpy(a).to(device) for a in arrays]
    if torch.device(device).type == "cuda":
        count("bytes.upload", sum(a.nbytes for a in arrays))
    return out


def download(t: torch.Tensor):
    """``t`` as a host numpy array, copied in a ``huff.download`` span;
    ``bytes.download`` counts it when ``t`` is on a CUDA device."""
    with span("huff.download"):
        out = t.cpu().numpy()
    if t.device.type == "cuda":
        count("bytes.download", out.nbytes)
    return out

"""The port's spans and counters (``utils.trace``) on the CPU.

Under ``torch.profiler`` the decode, batch and encode entries open the
``huff.*`` spans with the nesting ``utils/trace.py`` lists; without a
profiler they open none and add nothing to ``traced_counts()``; ``count``
adds to the process totals either way; the byte counters count only
copies to or from a CUDA device, so they stay at 0 here.  Small streams
through the plain torch versions; no JAX.
"""

import contextlib

import numpy as np
import pytest
import torch

from huffmandecoderongpus_tpu_torch.huffio import encode_bytes
from huffmandecoderongpus_tpu_torch.ops import batch, encode, widescan
from huffmandecoderongpus_tpu_torch.probes.streams import text_like
from huffmandecoderongpus_tpu_torch.utils import trace

#: (span, the innermost span around it) of a decode through the program
DECODE = {("huff.decode", None), ("huff.stage", "huff.decode"),
          ("huff.stage.tables", "huff.stage"),
          ("huff.stage.words", "huff.stage"), ("huff.upload", "huff.stage"),
          ("huff.launch", "huff.decode"), ("huff.wait", "huff.decode"),
          ("huff.trim", "huff.decode"), ("huff.download", "huff.trim")}
#: the same of a batch of small members in one program
BATCH = {("huff.batch", None), ("huff.stage", "huff.batch"),
         ("huff.stage.tables", "huff.stage"),
         ("huff.stage.words", "huff.stage"), ("huff.upload", "huff.stage"),
         ("huff.launch", "huff.batch"), ("huff.wait", "huff.batch"),
         ("huff.trim", "huff.batch"), ("huff.download", "huff.trim")}
#: the same of an encode
ENCODE = {("huff.encode", None), ("huff.stage", "huff.encode"),
          ("huff.stage.hist", "huff.stage"),
          ("huff.stage.lanes", "huff.stage"), ("huff.upload", "huff.stage"),
          ("huff.launch", "huff.encode"), ("huff.wait", "huff.encode"),
          ("huff.download", "huff.encode")}


@pytest.fixture(scope="module")
def streams():
    rng = np.random.default_rng(26)
    raws = [text_like(rng, n) for n in (20000, 9000, 7000)]
    return raws, [encode_bytes(r) for r in raws]


def profiled():
    return torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU])


def nesting(prof) -> set:
    """{(span, innermost huff span around it)} of a finished profile."""
    def parent(e):
        p = e.cpu_parent
        while p is not None and not p.name.startswith("huff."):
            p = p.cpu_parent
        return None if p is None else p.name

    return {(e.name, parent(e)) for e in prof.events()
            if e.name.startswith("huff.")}


def decode_program(raws, hfs):
    out = widescan.decode_widescan(hfs[0], device="cpu", oneshot=False)
    np.testing.assert_array_equal(out, raws[0])


def decode_oneshot(raws, hfs):
    out = widescan.decode_widescan(hfs[0], device="cpu", oneshot=True)
    np.testing.assert_array_equal(out, raws[0])


def batch_one_program(raws, hfs):
    outs = batch.decode_widescan_batch(hfs[1:], device="cpu")
    for out, raw in zip(outs, raws[1:]):
        np.testing.assert_array_equal(out, raw)


def batch_with_a_solo_member(raws, hfs):
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(batch, "BATCH_SOLO_BITS", hfs[0].bits)
        outs = batch.decode_widescan_batch(hfs, device="cpu")
    for out, raw in zip(outs, raws):
        np.testing.assert_array_equal(out, raw)


def encode_lanes(raws, _hfs):
    got = encode.encode_lanes(raws[0], device="cpu")
    np.testing.assert_array_equal(got.payload, encode_bytes(raws[0]).payload)


CALLS = {
    "decode_program": (decode_program, DECODE),
    "decode_oneshot": (decode_oneshot, DECODE),
    "batch_one_program": (batch_one_program, BATCH),
    "batch_with_a_solo_member": (batch_with_a_solo_member,
                                 BATCH | DECODE - {("huff.decode", None)}
                                 | {("huff.decode", "huff.batch")}),
    "encode_lanes": (encode_lanes, ENCODE),
}


def test_a_span_is_an_annotation_only_while_a_profiler_records():
    # the flag ``span`` reads is the one ``torch.profiler.profile`` flips
    off = trace.span("huff.decode")
    assert off is trace.span("huff.stage")
    assert not isinstance(off, torch.profiler.record_function)
    with profiled():
        assert isinstance(trace.span("huff.decode"),
                          torch.profiler.record_function)
    assert trace.span("huff.decode") is off


@pytest.mark.parametrize("name", sorted(CALLS))
def test_entries_open_their_spans_under_a_profiler(streams, name):
    fn, want = CALLS[name]
    with profiled() as prof:
        fn(*streams)
    assert nesting(prof) == want


@pytest.mark.parametrize("name", sorted(CALLS))
def test_no_spans_and_no_traced_counts_without_a_profiler(streams, name,
                                                          monkeypatch):
    opened = []

    def spy(span_name, *args, **kwargs):
        opened.append(span_name)
        return contextlib.nullcontext()

    monkeypatch.setattr(torch.profiler, "record_function", spy)
    before = trace.traced_counts()
    CALLS[name][0](*streams)
    trace.count("test.untraced")
    assert opened == []
    assert trace.traced_counts() == before


def test_count_adds_to_the_totals_with_and_without_a_profiler():
    total = trace.counts().get("test.count", 0)
    traced = trace.traced_counts().get("test.count", 0)
    trace.count("test.count")
    with profiled():
        trace.count("test.count", 5)
    trace.count("test.count", 2)
    assert trace.counts()["test.count"] == total + 8
    assert trace.traced_counts()["test.count"] == traced + 5


def test_byte_counters_stay_zero_for_cpu_copies(streams):
    names = ("bytes.upload", "bytes.download")
    before = [{k: table.get(k, 0) for k in names}
              for table in (trace.counts(), trace.traced_counts())]
    with profiled():
        decode_program(*streams)
        encode_lanes(*streams)
        up = trace.upload("cpu", np.arange(10, dtype=np.int32))
        down = trace.download(torch.arange(10, dtype=torch.int32))
    assert up[0].tolist() == down.tolist() == list(range(10))
    assert [{k: table.get(k, 0) for k in names} for table in (
        trace.counts(), trace.traced_counts())] == before

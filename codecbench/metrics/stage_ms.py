"""stage_ms.<family>: host ms a request in the program's host staging,
from the spans the harness wraps round the functions the entry names
(``SPANS``: ``stage_widescan_inputs`` and ``stage_batch_inputs`` for the
decodes, ``encode._prepare`` and ``encode._stage`` for the encode)."""


def read(run):
    calls = run.spans.get("stage")
    if not calls or not run.completed:
        return None
    return sum(calls) / len(run.completed) * 1e3

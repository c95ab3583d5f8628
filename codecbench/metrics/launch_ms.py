"""launch_ms.<family>: host ms a request in the program's ``huff.launch``
spans: the host enqueueing the device program (its launches and the torch
ops between them); from the traced run's profiler annotations
(``program_trace``)."""

from codecbench import program_trace


def read(run):
    return program_trace.span_ms(run, "huff.launch")

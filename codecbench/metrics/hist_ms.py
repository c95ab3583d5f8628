"""hist_ms.<family>: host ms a request in the program's ``huff.stage.hist``
spans: the encode's byte histogram, tree and code, in its host staging; from
the traced run's profiler annotations (``program_trace``)."""

from codecbench import program_trace


def read(run):
    return program_trace.span_ms(run, "huff.stage.hist")

"""lanes_ms.<family>: host ms a request in the program's ``huff.stage.lanes``
spans: the encode's plan, pack tables and (K, G) symbol matrix, in its host
staging; from the traced run's profiler annotations (``program_trace``)."""

from codecbench import program_trace


def read(run):
    return program_trace.span_ms(run, "huff.stage.lanes")

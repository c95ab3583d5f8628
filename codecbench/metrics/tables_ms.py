"""tables_ms.<family>: host ms a request in the program's ``huff.stage.tables``
spans: the lane DFA and its packed tables, in the decodes' host staging;
from the traced run's profiler annotations (``program_trace``)."""

from codecbench import program_trace


def read(run):
    return program_trace.span_ms(run, "huff.stage.tables")

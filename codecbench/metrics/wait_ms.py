"""wait_ms.<family>: host ms a request in the program's ``huff.wait`` spans:
the host blocked on a device scalar or count (the decoded total, the largest
lane count); from the traced run's profiler annotations (``program_trace``)."""

from codecbench import program_trace


def read(run):
    return program_trace.span_ms(run, "huff.wait")

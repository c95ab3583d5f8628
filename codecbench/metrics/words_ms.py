"""words_ms.<family>: host ms a request in the program's ``huff.stage.words``
spans: the lane-word buffers and per-lane bit limits, in the decodes' host
staging; from the traced run's profiler annotations (``program_trace``)."""

from codecbench import program_trace


def read(run):
    return program_trace.span_ms(run, "huff.stage.words")

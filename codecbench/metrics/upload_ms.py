"""upload_ms.<family>: host ms a request in the program's ``huff.upload``
spans: the pageable host-to-device copies of the staged inputs, host side;
from the traced run's profiler annotations (``program_trace``)."""

from codecbench import program_trace


def read(run):
    return program_trace.span_ms(run, "huff.upload")

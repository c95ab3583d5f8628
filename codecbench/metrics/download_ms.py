"""download_ms.<family>: host ms a request in the program's ``huff.download``
spans: the pageable device-to-host copies of the answer, host side; from the
traced run's profiler annotations (``program_trace``)."""

from codecbench import program_trace


def read(run):
    return program_trace.span_ms(run, "huff.download")

"""copy_ms.<family>: device ms a request in host-device copies (the
staging's uploads, the trim's download): the profiler's memcpy records in
the window, summed, over the requests."""

from codecbench import devtrace


def read(run):
    if run.trace is None or not run.completed:
        return None
    if not run.trace.device(devtrace.COPY):
        return None
    return devtrace.summed_s(run.trace, devtrace.COPY) / len(
        run.completed) * 1e3

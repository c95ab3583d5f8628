"""device_idle_pct.<family>: the share of the traced window in which no
kernel, copy or memset ran on the card, %."""

from codecbench import devtrace


def read(run):
    if run.trace is None:
        return None
    window = devtrace.window_s(run.trace)
    busy = devtrace.busy_s(run.trace)
    if window <= 0 or busy <= 0:
        return None
    return 100.0 * (1.0 - busy / window)

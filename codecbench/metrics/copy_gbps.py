"""copy_gbps.<family>: the bytes the program copied between host and card
(its ``bytes.upload`` and ``bytes.download`` counters under the traced
run's profiler) over the device seconds of the window's host-to-device and
device-to-host copies, 1e9 bytes a GB (``program_trace``)."""

from codecbench import program_trace


def read(run):
    counts = program_trace.traced_counts(run)
    if not counts:
        return None
    moved = counts.get("bytes.upload", 0) + counts.get("bytes.download", 0)
    seconds = program_trace.copy_s(run)
    if moved <= 0 or seconds <= 0:
        return None
    return moved / seconds / 1e9

"""kernels_roofline.<family>: the least time the card's memory allows for
the requests' work (``roofline``: input bytes read once, output bytes
written once, at 3.35 TB/s) as a share of the time the profiler saw
kernels run in the window, %."""

from codecbench import devtrace, roofline


def read(run):
    if run.trace is None or not run.completed:
        return None
    kernel_s = devtrace.summed_s(run.trace, devtrace.KERNEL)
    moved = sum(r["moved_bytes"] for r in run.completed)
    return roofline.share_pct(moved, kernel_s)

"""paged_decode_gbps: decoded bytes of every completed request of a paged
cell over the window's seconds, 1e9 bytes a GB (host clock); kept apart
from decode_gbps so that its per-call host noise does not set the
whole-file bound."""


def read(run):
    return sum(r["out_bytes"] for r in run.completed) / run.window_s / 1e9

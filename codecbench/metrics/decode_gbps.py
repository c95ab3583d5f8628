"""decode_gbps: decoded bytes of every completed request over the window's
seconds, 1e9 bytes a GB (host clock)."""


def read(run):
    return sum(r["out_bytes"] for r in run.completed) / run.window_s / 1e9

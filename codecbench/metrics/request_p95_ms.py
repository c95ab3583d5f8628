"""request_p95_ms.<family>: the 95th percentile of the completed requests'
latencies, ms (host clock round each request, in the traced run)."""

import statistics


def read(run):
    lat = [r["t1"] - r["t0"] for r in run.completed]
    if len(lat) < 2:
        return None
    return statistics.quantiles(lat, n=20, method="inclusive")[18] * 1e3

"""The 90th percentile of the latency of every call the window completed,
from sending its batch to reading its verdict on the host, in ms."""

import statistics


def read(run):
    lat = [c["latency_s"] for c in run["calls"]]
    if len(lat) < 2:
        return None
    return statistics.quantiles(lat, n=10, method="inclusive")[8] * 1e3

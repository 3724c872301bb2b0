"""Lanes a call's second hash round runs: the program's counter
h2g.round2_lanes (ops/hash_to_g1.py::ROUND2_LANES, utils/profiling.py::
count; cap x counters a chunk, padding included), which the registry sums
as a stage's seconds. Each batch of the cycle has its own (a set's messages
fix how many of them reach round 2); the metric is their mean over the
cycle."""

NAME = "h2g.round2_lanes"


def read(run):
    by_batch = {}
    for c in run["calls"]:
        if NAME in c["spans"]:
            by_batch.setdefault(c["batch"], []).append(c["spans"][NAME])
    if not by_batch:
        return None
    return sum(sum(v) / len(v) for v in by_batch.values()) / len(by_batch)

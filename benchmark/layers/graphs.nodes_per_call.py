"""Kernel nodes a call's graph replays run (utils/aotcache.py): for each
replay in the call, its graph's kernel nodes as the driver API counted
them at capture. An exact count; each batch of the cycle has its own
(a set's messages fix how many second-round chunks its hashing takes), and
the metric is their mean over the cycle."""


def read(run):
    by_batch = {}
    for c in run["calls"]:
        if c["nodes"] is None:
            return None
        by_batch.setdefault(c["batch"], []).append(c["nodes"])
    if not by_batch:
        return None
    return sum(min(v) for v in by_batch.values()) / len(by_batch)

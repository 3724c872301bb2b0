"""The card's busy share inside the program's graphs over the window's
calls, in %, without the profiler: the device time of every graph replay
(the program's span gpu.graph, a pair of CUDA events that each captured
graph records at its start and end, utils/aotcache.py) summed over the
calls, over the calls' summed latencies."""


def read(run):
    calls = run["calls"]
    if not any("gpu.graph" in c["spans"] for c in calls):
        return None
    busy = sum(c["spans"].get("gpu.graph", 0.0) for c in calls)
    return 100.0 * busy / sum(c["latency_s"] for c in calls)

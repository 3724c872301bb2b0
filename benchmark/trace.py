"""torch.profiler over a few calls of the timed path, reduced to plain
records: every device operation and every host event, on one clock."""

import json
from pathlib import Path

TRACE_FILE = Path(__file__).resolve().parent / ".cache" / "trace" / "profile.json"
DEVICE_CATS = {"kernel", "gpu_memcpy", "gpu_memset"}
HOST_CATS = {"cpu_op", "user_annotation", "cuda_runtime", "cuda_driver"}


def profile_calls(call, ks, device):
    """Run call(k) for each k under the profiler; returns the verdicts and
    the events as dicts: name, start and end (seconds), on_device, and for a
    kernel its grid and block. The
    events come from the profiler's Chrome trace (written to TRACE_FILE,
    then read back), which gives each kernel's launch shape."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
        torch.cuda.synchronize(device)
    verdicts = []
    with profile(activities=acts) as prof:
        for k in ks:
            with record_function("bench.call"):
                verdicts.append(call(k))
    TRACE_FILE.parent.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(TRACE_FILE))
    return verdicts, events(json.loads(TRACE_FILE.read_text()))


def events(chrome):
    """The complete events of a Chrome trace on the card and on the host."""
    out = []
    for e in chrome.get("traceEvents", []):
        cat = e.get("cat")
        if e.get("ph") != "X" or (cat not in DEVICE_CATS and cat not in HOST_CATS):
            continue
        start = float(e["ts"]) * 1e-6
        rec = {"name": e.get("name", ""), "start": start,
               "end": start + float(e.get("dur", 0.0)) * 1e-6, "on_device": cat in DEVICE_CATS}
        args = e.get("args") or {}
        if cat == "kernel" and "grid" in args and "block" in args:
            rec["grid"], rec["block"] = args["grid"], args["block"]
        out.append(rec)
    return out


def window(evs):
    """(start, end) of the profiled calls, from their bench.call spans."""
    calls = [e for e in evs if not e["on_device"] and e["name"] == "bench.call"]
    return min(e["start"] for e in calls), max(e["end"] for e in calls)


def busy(evs, lo, hi):
    """The union of device operations inside [lo, hi], as sorted disjoint
    intervals."""
    spans = sorted((max(e["start"], lo), min(e["end"], hi)) for e in evs
                   if e["on_device"] and e["end"] > lo and e["start"] < hi)
    merged = []
    for a, b in spans:
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return merged


def busy_s(profile):
    lo, hi = window(profile["events"])
    return sum(b - a for a, b in busy(profile["events"], lo, hi))


def _short(name, width=80):
    name = name[5:] if name.startswith("void ") else name
    return name.replace("(anonymous namespace)::", "")[:width]


def _host_activity(cpu, starts, t):
    """The innermost host event under way at time t: of those begun by t
    and not ended, the one begun last."""
    import bisect

    i = bisect.bisect_right(starts, t) - 1
    while i >= 0:
        if cpu[i]["end"] >= t and cpu[i]["name"] != "bench.call":
            return _short(cpu[i]["name"], 60)
        i -= 1
    return "host code outside any torch call"


def breakdown(profile, top=10, named_gaps=2000):
    """The device operations that took the most time, and the device's idle
    time by what the host was doing (the `named_gaps` longest gaps, each
    named by the innermost host event under way at its middle)."""
    evs = profile["events"]
    lo, hi = window(evs)
    ops = {}
    for e in evs:
        if e["on_device"]:
            k = _short(e["name"])
            ops[k] = ops.get(k, 0.0) + e["end"] - e["start"]
    merged = busy(evs, lo, hi)
    edges = [lo] + [x for ab in merged for x in ab] + [hi]
    gaps = sorted(((edges[i + 1] - edges[i], (edges[i] + edges[i + 1]) / 2)
                   for i in range(0, len(edges), 2) if edges[i + 1] > edges[i]), reverse=True)
    cpu = sorted((e for e in evs if not e["on_device"]), key=lambda e: e["start"])
    starts = [e["start"] for e in cpu]
    idle = {}
    for length, mid in gaps[:named_gaps]:
        k = _host_activity(cpu, starts, mid)
        idle[k] = idle.get(k, 0.0) + length
    rest = sum(length for length, _ in gaps[named_gaps:])
    if rest:
        idle["shorter gaps"] = idle.get("shorter gaps", 0.0) + rest
    order = lambda d: sorted(([k, v] for k, v in d.items()), key=lambda kv: -kv[1])[:top]  # noqa: E731
    return {"device_ops": order(ops), "idle_gaps": order(idle)}

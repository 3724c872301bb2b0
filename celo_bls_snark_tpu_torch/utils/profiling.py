"""Stage timing registry (the counterpart of the JAX package's
utils/profiling.py), on the host's clock and on the card's.

`stage(name)` is a host-clock scope; a stage that dispatched device work
calls `device_sync` on its output before the scope ends, so the work is
charged to the stage that issued it. While a torch profiler runs, a stage
is also a named range of its trace, on the clock of the card's kernels.

`device_span(name, like)` times its body on the card: a pair of timing CUDA
events on the current stream around it. Outside a capture the pair is
recorded once; inside a CUDA graph capture it becomes two event-record
nodes of the graph, recorded again by every replay (utils/aotcache.py
collects a capture's pairs and arms them after each replay). A pair is
never read where it is recorded: armed, it waits for report(), which reads
every armed pair whose end has completed into the registry under its name,
as a stage's time, and drops one not yet complete, counting it under
`gpu.dropped` (`calls` = pairs dropped), so reading never waits. The names
of the card's clock start with `gpu.`. On CPU tensors device_span does
nothing.

Times accumulate in a process-global registry; `report()` snapshots it.
`count(name, n)` adds a counter to it (its sum under total_s).
`device_trace()` runs torch.profiler over the card and yields the profile;
with Config.profile_trace_dir set it traces the host too and writes a
Chrome trace there. `time_ms` times one call on the card between CUDA
events, eagerly or from a replayed CUDA graph.
"""

import os
import time
from contextlib import contextmanager

import torch

from .config import get_config
from .tree import tree_leaves

_METRICS: dict = {}
_TRACES = [0]  # traces written by this process
_ARMED: dict = {}  # id -> a recorded Pair that report() has not read yet
_CAPTURES: list = []  # per capture underway, the pairs its body recorded
MAX_ARMED = 4096  # eager pairs past this are read (or dropped) at once
DROPPED = "gpu.dropped"


def _add(name: str, seconds: float) -> None:
    ent = _METRICS.setdefault(name, {"calls": 0, "total_s": 0.0})
    ent["calls"] += 1
    ent["total_s"] += seconds


def count(name: str, n: int) -> None:
    """Add n to the counter `name`, a registry entry like a stage's whose
    total_s holds the count (calls: the times it was added to), so that a
    reader of the stages' sums a call reads it alike."""
    _add(name, float(n))


@contextmanager
def stage(name: str, label: "str | None" = None):
    """Time a named stage (host clock). While a torch profiler runs it is
    also a range of the trace, named `label` (default `name`)."""
    rng = None
    if torch.autograd._profiler_enabled():
        rng = torch.profiler.record_function(label or name)
        rng.__enter__()
    t0 = time.perf_counter()
    try:
        yield
    finally:
        dt = time.perf_counter() - t0
        if rng is not None:
            rng.__exit__(None, None, None)
        _add(name, dt)
        if get_config().profile:
            print(f"# stage {name}: {dt:.3f}s", flush=True)


class Pair:
    """The two timing events of one device span. external=True makes them
    event-record nodes when recorded inside a capture; outside one PyTorch
    records them as plain events."""

    __slots__ = ("name", "start", "end")

    def __init__(self, name: str):
        self.name = name
        self.start = torch.cuda.Event(enable_timing=True, external=True)
        self.end = torch.cuda.Event(enable_timing=True, external=True)


@contextmanager
def device_span(name: str, like):
    """Time the body on the card under `name` (a `gpu.` name): on the
    current stream of the device of `like`, a tensor or a tree of them;
    nothing when its first tensor is not on a CUDA card."""
    leaf = next((x for x in tree_leaves(like) if isinstance(x, torch.Tensor)), None)
    if leaf is None or not leaf.is_cuda:
        yield
        return
    stream = torch.cuda.current_stream(leaf.device)
    pair = Pair(name)
    pair.start.record(stream)
    yield
    pair.end.record(stream)
    if torch.cuda.is_current_stream_capturing():
        if _CAPTURES:
            _CAPTURES[-1].append(pair)
    else:
        if len(_ARMED) >= MAX_ARMED:
            _read_armed()
        arm([pair])


@contextmanager
def collect_spans():
    """Yields the list into which the device spans recorded in the body
    inside a capture are put (a graph's own pairs, utils/aotcache.py)."""
    pairs = []
    _CAPTURES.append(pairs)
    try:
        yield pairs
    finally:
        _CAPTURES.pop()


def arm(pairs) -> None:
    """Queue recorded pairs for report()."""
    for p in pairs:
        _ARMED[id(p)] = p


def settle(pairs) -> None:
    """Read those of `pairs` still armed into the registry, or drop them
    where their end has not completed; never waits. A graph's pairs are
    settled before its next replay records them again."""
    for p in pairs:
        if _ARMED.pop(id(p), None) is None:
            continue
        if p.end.query():
            _add(p.name, p.start.elapsed_time(p.end) * 1e-3)
        else:
            _add(DROPPED, 0.0)


def _read_armed() -> None:
    settle(list(_ARMED.values()))


def device_sync(tree) -> None:
    """Wait for the device work that produced `tree`: PyTorch returns
    before the card finishes. A tree of CPU tensors needs no wait."""
    leaf = tree_leaves(tree)[0]
    if leaf.is_cuda:
        torch.cuda.synchronize(leaf.device)


def time_ms(fn, iters, graph=False):
    """Mean milliseconds per call of fn between CUDA events. Eager, a call
    costs what the host spends issuing it whenever that exceeds the card's
    time; with graph=True the calls are captured once into a CUDA graph and
    replayed, so the events time the card's work alone."""
    fn()
    torch.cuda.synchronize()
    t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    if graph:
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            for _ in range(iters):
                fn()
        g.replay()
        torch.cuda.synchronize()
        t0.record()
        g.replay()
        t1.record()
    else:
        t0.record()
        for _ in range(iters):
            fn()
        t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / iters


@contextmanager
def device_trace():
    """torch.profiler over the card's kernels, yielding the profile (its
    key_averages() give each kernel's device time). With
    Config.profile_trace_dir set (env CELO_BLS_TPU_PROFILE_TRACE_DIR, the
    JAX package's field) the host is traced too, every stage() a named
    range, and the trace is written in that directory as the Chrome trace
    `trace-<pid>-<k>.json`. Without a card only the host is traced."""
    from torch.profiler import ProfilerActivity, profile

    out_dir = get_config().profile_trace_dir
    acts = [ProfilerActivity.CUDA] if torch.cuda.is_available() else []
    if out_dir is not None or not acts:
        acts.append(ProfilerActivity.CPU)
    with profile(activities=acts) as prof:
        yield prof
    if out_dir is not None:
        os.makedirs(out_dir, exist_ok=True)
        _TRACES[0] += 1
        prof.export_chrome_trace(
            os.path.join(out_dir, f"trace-{os.getpid()}-{_TRACES[0]}.json"))


def report() -> dict:
    """The registry, every armed device span read first (or dropped)."""
    _read_armed()
    return {k: dict(v) for k, v in _METRICS.items()}


def reset() -> None:
    """Empty the registry and forget the armed pairs unread."""
    _METRICS.clear()
    _ARMED.clear()

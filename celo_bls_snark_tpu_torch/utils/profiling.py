"""Stage timing registry (the counterpart of the JAX package's
utils/profiling.py).

`stage(name)` is a wall-clock scope; a stage that dispatched device work
calls `device_sync` on its output before the scope ends, so the work is
charged to the stage that issued it. Times accumulate in a process-global
registry; `report()` snapshots it. `device_trace()` runs torch.profiler
over the card and yields the profile; with Config.profile_trace_dir set it
traces the host too, every stage a named range, and writes a Chrome trace
there. `time_ms` times one call on the card between CUDA events, eagerly or
from a replayed CUDA graph.
"""

import os
import time
from contextlib import contextmanager

import torch

from .config import get_config
from .tree import tree_leaves

_METRICS: dict = {}
_TRACES = [0]  # traces written by this process


@contextmanager
def stage(name: str):
    """Time a named stage (host clock); a named range in device_trace()'s
    trace when Config.profile_trace_dir is set."""
    cfg = get_config()
    rng = None
    if cfg.profile_trace_dir is not None:
        rng = torch.profiler.record_function(name)
        rng.__enter__()
    t0 = time.perf_counter()
    try:
        yield
    finally:
        dt = time.perf_counter() - t0
        if rng is not None:
            rng.__exit__(None, None, None)
        ent = _METRICS.setdefault(name, {"calls": 0, "total_s": 0.0})
        ent["calls"] += 1
        ent["total_s"] += dt
        if cfg.profile:
            print(f"# stage {name}: {dt:.3f}s", flush=True)


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
    return {k: dict(v) for k, v in _METRICS.items()}


def reset() -> None:
    _METRICS.clear()

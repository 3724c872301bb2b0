"""Stage timing registry (the counterpart of the JAX package's
utils/profiling.py).

`stage(name)` is a wall-clock scope; a stage that dispatched device work
calls `device_sync` on its output before the scope ends, so the work is
charged to the stage that issued it. Times accumulate in a process-global
registry; `report()` snapshots it. `time_ms` times one call on the card
between CUDA events, eagerly or from a replayed CUDA graph.
"""

import time
from contextlib import contextmanager

import torch

from .config import get_config
from .tree import tree_leaves

_METRICS: dict = {}


@contextmanager
def stage(name: str):
    """Time a named stage (host clock)."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        dt = time.perf_counter() - t0
        ent = _METRICS.setdefault(name, {"calls": 0, "total_s": 0.0})
        ent["calls"] += 1
        ent["total_s"] += dt
        if get_config().profile:
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


def report() -> dict:
    return {k: dict(v) for k, v in _METRICS.items()}


def reset() -> None:
    _METRICS.clear()

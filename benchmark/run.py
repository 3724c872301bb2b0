"""The benchmark of the PyTorch/CUDA port: one cell of BENCHMARK.json on
the CUDA card of this machine.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout. Everything is found by name: the cell's
entry in BENCHMARK.json, its file cells/<cell>.json (driver, parameters,
control), its configuration's file, the driver drivers/<driver>.py, and a
reader for every metric, e2e/<metric>.py for the end-to-end ones and
layers/<metric>.py for the per-layer ones. A new cell, configuration or
metric is a new file and a new entry; no file here changes.

A run: the set-up (worker processes make the keys and signatures from the
seed while the card warms up every program on inputs of the timed shapes;
the reference's hashes of messages the checkout has not cached yet are
made first, and their seconds are not counted in setup_s),
then a closed loop with one caller for --seconds: each call sends the
next batch of the cycle (reference/inputs.py) and reads its verdict to the
host before the next is sent. With --trace 1 a few more calls run under
torch.profiler. Then the reference judges every verdict, and the last line
of standard output is the result. It fails without a CUDA card.
"""

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import statistics  # noqa: E402
import sys  # noqa: E402
from contextlib import contextmanager  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
PROFILED_CALLS = 2  # calls under the profiler in a --trace 1 run
FORBIDDEN = ("jax", "jaxlib", "flax", "celo_bls_snark_tpu")


def log(msg: str) -> None:
    print(f"[bench] {msg}", file=sys.stderr, flush=True)


def load_module(kind: str, name: str):
    """benchmark/<kind>/<name>.py, which may have dots in its name."""
    path = HERE / kind / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"benchmark_{kind}_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cell_spec(workload: str, overrides=None):
    """(BENCHMARK.json, its workload entry, the cell file, the configuration)
    of `workload`; `overrides` {"params": {...}, "config": {...}} shrink a
    cell for the CPU tests."""
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    entry = next((w for w in spec["workloads"] if w["name"] == workload), None)
    if entry is None:
        raise SystemExit(f"unknown workload {workload!r}")
    cell = json.loads((HERE / "cells" / f"{workload}.json").read_text())
    conf = next(c for c in spec["configs"] if c["name"] == entry["config"])
    config = json.loads((ROOT / conf["file"]).read_text())
    if cell["config"] != entry["config"] or cell["traffic"] != entry["traffic"]:
        raise SystemExit(f"cells/{workload}.json disagrees with BENCHMARK.json")
    overrides = overrides or {}
    cell = {**cell, "params": {**cell["params"], **overrides.get("params", {})}}
    config = {**config, **overrides.get("config", {})}
    return spec, entry, cell, config


def metrics_of(spec, workload: str, section: str):
    return [m for m in spec[section] if workload in m.get("workloads", [workload])]


class Spans:
    """Host-clock spans of one call: the benchmark's own (`span`) and the
    program's stages (utils/profiling.py), in seconds by name."""

    def __init__(self):
        self.seconds = {}

    @contextmanager
    def span(self, name):
        from torch.profiler import record_function

        t0 = time.perf_counter()
        with record_function(name):
            yield
        self.seconds[name] = self.seconds.get(name, 0.0) + time.perf_counter() - t0


def graph_replays():
    """{entry: replays} of the program's captured graphs."""
    from celo_bls_snark_tpu_torch.utils import aotcache

    return {e: e.replays for e in aotcache.entries()}


def graph_nodes(before, after):
    """Kernel nodes the replays between two snapshots ran; None where a
    graph's count is unknown."""
    total = 0
    for e, n in after.items():
        done = n - before.get(e, 0)
        if done:
            if e.info.get("kernels") is None:
                return None
            total += done * e.info["kernels"]
    return total


def timed_call(drv, k):
    """One call with its spans, graph nodes and latency."""
    from celo_bls_snark_tpu_torch.utils import profiling

    spans = Spans()
    profiling.reset()
    before = graph_replays()
    t0 = time.perf_counter()
    verdict = drv.call(k, spans.span)
    latency = time.perf_counter() - t0
    for name, ent in profiling.report().items():
        spans.seconds[name] = spans.seconds.get(name, 0.0) + ent["total_s"]
    return {"batch": k % len(drv.batches), "verdict": verdict, "latency_s": latency,
            "spans": spans.seconds, "nodes": graph_nodes(before, graph_replays())}


def power_limit():
    import subprocess

    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=20)
        return out.stdout.strip().splitlines()[0] if out.stdout.strip() else "not read"
    except (OSError, subprocess.SubprocessError):
        return "not read"


def run(workload, seed, seconds, trace, device="cuda", workers=None, overrides=None,
        driver_wrap=None):
    """One run of `workload`; returns the result dict. `driver_wrap(drv)`
    lets a test break the timed path underneath."""
    import torch

    from benchmark.reference import work

    spec, entry, cell, config = cell_spec(workload, overrides)
    device = torch.device(device)
    parts = {}
    t = time.perf_counter()
    ex = work.pool(workers or work.default_workers())
    try:
        drv = load_module("drivers", cell["driver"]).Driver(config, cell["params"], seed,
                                                            device, ex)
        parts["inputs_started_s"] = time.perf_counter() - t
        t = time.perf_counter()
        drv.load()
        # warm-up: the driver's calls after which every program's key has
        # had its eager call and its capture (the CPU has no graphs)
        for k in drv.warm_up if device.type == "cuda" else ():
            drv.call(k, Spans().span)
        parts["warm_up_s"] = time.perf_counter() - t
        t = time.perf_counter()
        drv.finish()
        parts["inputs_wait_s"] = time.perf_counter() - t
    finally:
        ex.shutdown()
    if driver_wrap is not None:
        drv = driver_wrap(drv)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    # the set-up's objects (the inputs' host points) out of the collector's
    # reach, so that its full collections in the window do not scan them
    gc.collect()
    gc.freeze()
    gc_before = gc.get_stats()[2]["collections"]
    t_first = time.perf_counter()
    setup_s = t_first - T_PROCESS - work.MISS_SECONDS[0]

    calls, failed = [], 0
    k = 0
    while time.perf_counter() - t_first < seconds or k < len(drv.batches):
        try:
            calls.append(timed_call(drv, k))
        except Exception as e:  # a call that raises is a call with no answer
            log(f"call {k} raised {type(e).__name__}: {e}")
            failed += 1
            break
        k += 1
    window_s = time.perf_counter() - t_first
    gc_full = gc.get_stats()[2]["collections"] - gc_before

    profile = None
    if trace and not failed:
        from benchmark import trace as tr

        verdicts, evs = tr.profile_calls(lambda j: drv.call(j, Spans().span),
                                               range(k, k + PROFILED_CALLS), device)
        calls += [{"batch": j % len(drv.batches), "verdict": v, "profiled": True}
                  for j, v in zip(range(k, k + PROFILED_CALLS), verdicts)]
        profile = {"events": evs}

    gc.unfreeze()
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    sigs_per_call, batches = drv.sigs_per_call, drv.batches
    drv.release()
    if device.type == "cuda":
        from celo_bls_snark_tpu_torch.utils import aotcache

        aotcache.clear()
        torch.cuda.empty_cache()

    t = time.perf_counter()
    ex = work.pool(workers or work.default_workers())
    try:
        expected = drv.judge(ex)
    finally:
        ex.shutdown()
    judge_s = time.perf_counter() - t

    found = sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))
    if found:
        raise ForbiddenModules(found)

    record = {"calls": [c for c in calls if not c.get("profiled")], "window_s": window_s,
              "setup_s": setup_s, "sigs_per_call": sigs_per_call, "profile": profile}
    section = "per_layer" if trace else "end_to_end"
    metrics = {}
    for m in metrics_of(spec, workload, section):
        value = load_module("layers" if trace else "e2e", m["name"]).read(record)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    wrong = sum(c["verdict"] != expected[c["batch"]] for c in calls)
    checks = {"wrong_verdicts": {"value": wrong, "limit": 0}}
    correct = failed == 0 and all(c["value"] <= c["limit"] for c in checks.values())
    result = {
        "correct": correct, "attempted": len(calls) + failed, "failed": failed,
        "metrics": metrics,
        "device": {"platform": "gpu" if device.type == "cuda" else "cpu",
                   "kind": torch.cuda.get_device_name(device) if device.type == "cuda"
                   else "cpu",
                   "count": 1, "memory_peak_bytes": peak},
    }
    if profile is not None:
        lo, hi = tr.window(profile["events"])
        result["device"]["busy_s"] = tr.busy_s(profile)
        result["device"]["window_s"] = hi - lo
        result["breakdown"] = tr.breakdown(profile)
    lat = {}
    for c in record["calls"]:
        lat.setdefault(batches[c["batch"]], []).append(c["latency_s"] * 1e3)
    result["notes"] = {
        "setup_parts_s": parts, "reference_hashing_s": work.MISS_SECONDS[0],
        "judge_s": judge_s, "window_calls": len(record["calls"]),
        "latency_ms": {b: [min(v), statistics.median(v), max(v)] for b, v in lat.items()},
        "full_collections_in_window": gc_full,
        "expected": dict(zip(batches, expected)),
        "power_limit": power_limit() if device.type == "cuda" else "cpu",
    }
    result["checks"] = checks
    return result


class ForbiddenModules(RuntimeError):
    pass


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = ap.parse_args(argv)

    import torch

    _spec, entry, _cell, _config = cell_spec(a.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < entry["chips"]:
        log(f"needs {entry['chips']} CUDA card(s); found "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 3
    try:
        result = run(a.workload, a.seed, a.seconds, a.trace)
    except ForbiddenModules as e:
        log(f"modules of JAX or the JAX package were loaded: {', '.join(e.args[0])}")
        return 4
    for name, c in result["checks"].items():
        log(f"check {name} {c['value']} limit {c['limit']}")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

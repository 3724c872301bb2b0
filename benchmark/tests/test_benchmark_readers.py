"""The metric readers on recorded spans and a small synthetic profile."""

import pytest

from benchmark import peaks, trace
from benchmark.run import load_module


def read(folder, name, run):
    return load_module(folder, name).read(run)


def calls(latencies, spans=None, nodes=None):
    return [{"batch": i % 4, "verdict": True, "latency_s": lat,
             "spans": (spans or {}), "nodes": nodes[i % 4] if nodes else 0}
            for i, lat in enumerate(latencies)]


def test_end_to_end_readers():
    run = {"calls": calls([0.1 * (i + 1) for i in range(10)]), "window_s": 2.0,
           "sigs_per_call": 6000, "setup_s": 12.5}
    assert read("e2e", "sigs_per_s", run) == pytest.approx(10 * 6000 / 2.0)
    # inclusive quantiles of 0.1 .. 1.0: the 90th percentile is 0.91 s
    assert read("e2e", "call_p90_ms", run) == pytest.approx(910.0)
    assert read("e2e", "setup_s", run) == 12.5


def test_span_readers():
    run = {"calls": calls([0.5] * 4, {"h2g.crh": 0.2, "h2g.round1": 0.03,
                                      "h2g.round2": 0.02, "verify.check": 0.1})}
    assert read("layers", "h2g.crh_ms", run) == pytest.approx(200.0)
    assert read("layers", "h2g.rounds_ms", run) == pytest.approx(50.0)
    assert read("layers", "verify.check_ms", run) == pytest.approx(100.0)
    bare = {"calls": calls([0.1] * 4, {"verify.check": 0.09})}
    assert read("layers", "h2g.crh_ms", bare) is None
    assert read("layers", "verify.check_ms", bare) == pytest.approx(90.0)


def test_nodes_per_call_is_the_cycle_mean():
    run = {"calls": calls([0.1] * 8, nodes=[100, 120, 100, 120])}
    assert read("layers", "graphs.nodes_per_call", run) == 110
    run["calls"][3]["nodes"] = None
    assert read("layers", "graphs.nodes_per_call", run) is None


def profile():
    """Two calls in [0, 10] ms; device work [1, 3] + [2, 4] + [6, 7] ms;
    one mont_mul<25> launch of 4,096 x 128 lanes taking 1 ms."""
    ms = 1e-3
    evs = [
        {"name": "bench.call", "start": 0.0, "end": 5 * ms, "on_device": False},
        {"name": "bench.call", "start": 5 * ms, "end": 10 * ms, "on_device": False},
        {"name": "aten::copy_", "start": 4.5 * ms, "end": 5.5 * ms, "on_device": False},
        {"name": "void (anonymous namespace)::mont_mul_kernel<25, 128, 4>(int const*)",
         "start": 1 * ms, "end": 2 * ms, "on_device": True, "grid": [4096, 1, 1],
         "block": [128, 1, 1]},
        {"name": "elementwise", "start": 2 * ms, "end": 4 * ms, "on_device": True},
        {"name": "elementwise", "start": 2 * ms, "end": 3 * ms, "on_device": True},
        {"name": "Memcpy DtoD", "start": 6 * ms, "end": 7 * ms, "on_device": True},
    ]
    return {"events": evs, "wall_s": 0.01, "calls": 2}


def test_trace_readers():
    run = {"profile": profile()}
    assert trace.busy_s(run["profile"]) == pytest.approx(4e-3)
    lo, hi = trace.window(run["profile"]["events"])
    assert (lo, hi) == (0.0, pytest.approx(1e-2))
    bound = peaks.mont_mul_bound_s(25, 4096 * 128)
    assert bound == pytest.approx(12 * 25 * 4096 * 128 / 3.35e12)
    assert read("layers", "mont_mul_roofline", run) == pytest.approx(100 * bound / 1e-3)
    assert read("layers", "mont_mul_roofline", {"profile": None}) is None
    out = trace.breakdown(run["profile"])
    assert out["device_ops"][0] == ["elementwise", pytest.approx(3e-3)]
    # idle: [0, 1] and [7, 10] ms between program calls, [4, 6] ms under copy_
    gaps = dict(out["idle_gaps"])
    assert gaps["aten::copy_"] == pytest.approx(2e-3)
    assert gaps["host code outside any torch call"] == pytest.approx(4e-3)


def test_chrome_events_keep_launch_shapes():
    chrome = {"traceEvents": [
        {"ph": "X", "cat": "kernel", "name": "k", "ts": 10.0, "dur": 2.0,
         "args": {"grid": [2, 1, 1], "block": [32, 1, 1]}},
        {"ph": "X", "cat": "gpu_user_annotation", "name": "bench.call", "ts": 9.0, "dur": 5.0},
        {"ph": "X", "cat": "user_annotation", "name": "bench.call", "ts": 9.0, "dur": 5.0},
        {"ph": "i", "cat": "kernel", "name": "marker", "ts": 1.0},
    ]}
    evs = trace.events(chrome)
    assert [(e["name"], e["on_device"]) for e in evs] == [("k", True), ("bench.call", False)]
    assert evs[0]["grid"] == [2, 1, 1] and evs[0]["end"] == pytest.approx(12e-6)

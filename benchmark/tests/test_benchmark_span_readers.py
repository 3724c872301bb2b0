"""The readers of the program's own spans (utils/profiling.py's stages and
device spans, utils/aotcache.py's launch stage and graph spans) on
synthetic records: each gives the value of its definition, and None on a
record that lacks its names, as on the CPU or on a program without them."""

import pytest

from benchmark.run import load_module

MEANS = [
    ("graphs.launch_ms", {"aot.launch": 0.004}, 4.0),
    ("verify.legs_ms", {"gpu.verify.legs": 0.12}, 120.0),
    ("verify.miller_ms", {"gpu.pairing.miller": 0.03}, 30.0),
    ("verify.final_exp_ms", {"gpu.pairing.final_exp": 0.02}, 20.0),
    ("h2g.rounds_gpu_ms", {"gpu.h2g.round": 0.025}, 25.0),
    ("h2g.crh_host_ms", {"h2g.crh.plan": 0.001, "h2g.crh.digest": 0.002}, 3.0),
]


def read(name, run):
    return load_module("layers", name).read(run)


def calls(latencies, spans):
    return [{"batch": i % 2, "verdict": True, "latency_s": lat, "spans": dict(s),
             "nodes": 0} for i, (lat, s) in enumerate(zip(latencies, spans))]


@pytest.mark.parametrize("name,spans,ms", MEANS, ids=[m[0] for m in MEANS])
def test_span_mean_readers(name, spans, ms):
    # two calls with the spans, two with twice them: the mean is 1.5 times
    doubled = {k: 2 * v for k, v in spans.items()}
    run = {"calls": calls([0.2] * 4, [spans, doubled, spans, doubled])}
    assert read(name, run) == pytest.approx(1.5 * ms)


@pytest.mark.parametrize("name", [m[0] for m in MEANS] + ["device.graph_busy_pct"])
def test_span_readers_none_without_their_names(name):
    run = {"calls": calls([0.2] * 3, [{"verify.check": 0.1, "h2g.crh": 0.01}] * 3)}
    assert read(name, run) is None


def test_graph_busy_share_is_device_time_over_latency():
    run = {"calls": calls([0.1, 0.3], [{"gpu.graph": 0.09, "aot.launch": 0.001},
                                       {"gpu.graph": 0.15}])}
    assert read("device.graph_busy_pct", run) == pytest.approx(100 * 0.24 / 0.4)


def test_a_call_without_a_span_counts_zero():
    run = {"calls": calls([0.1, 0.1], [{"h2g.crh.plan": 0.004}, {}])}
    assert read("h2g.crh_host_ms", run) == pytest.approx(2.0)
    run = {"calls": calls([0.1, 0.1], [{"gpu.graph": 0.1}, {}])}
    assert read("device.graph_busy_pct", run) == pytest.approx(50.0)

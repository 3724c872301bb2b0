"""The port's spans (celo_bls_snark_tpu_torch/utils/profiling.py): host
stages, device spans and their reading, and the spans that
utils/aotcache.py and the verification paths open.

On the CPU a device span records nothing; its reading is held to stand-in
events, and the graph's re-arming to a stand-in graph. The `gpu` test
captures a span on the card and reads it from four replays."""

import json
import sys
import time
from contextlib import contextmanager

import pytest
import torch

from celo_bls_snark_tpu_torch.hostmath.params import G1_GENERATOR, G2_GENERATOR
from celo_bls_snark_tpu_torch.ops import field as F
from celo_bls_snark_tpu_torch.utils import aotcache, profiling
from celo_bls_snark_tpu_torch.utils.config import get_config

torch.set_num_threads(1)

# the benchmark's own spans around calls into the port: a program name
# equal to one would be added to it
BENCHMARK_SPANS = {"h2g.crh", "verify.check"}


@pytest.fixture(autouse=True)
def clean_registry():
    profiling.reset()
    yield
    profiling.reset()


def needs_card():
    if not torch.cuda.is_available():
        pytest.skip("captures CUDA graphs: needs a CUDA card")


@pytest.mark.parametrize("like", ["tensor", "tree"])
def test_device_span_on_cpu_records_nothing(like):
    a = torch.arange(12, dtype=torch.int64).reshape(3, 4)
    want = a * 3 + 1
    with profiling.device_span("gpu.t.cpu", a if like == "tensor" else (3, (a, a))):
        got = a * 3 + 1
    assert torch.equal(got, want)
    assert profiling.report() == {} and profiling._ARMED == {}


def test_stage_is_a_range_under_a_running_profiler(tmp_path):
    from torch.profiler import ProfilerActivity, profile

    assert get_config().profile_trace_dir is None
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with profiling.stage("t.ranged"):
            torch.ones(4).sum()
        with profiling.stage("t.labelled", "t.labelled:tag"):
            pass
    prof.export_chrome_trace(str(tmp_path / "trace.json"))
    names = {e.get("name") for e in json.loads((tmp_path / "trace.json").read_text())
             ["traceEvents"]}
    assert {"t.ranged", "t.labelled:tag"} <= names
    rep = profiling.report()
    assert rep["t.ranged"]["calls"] == 1 and rep["t.labelled"]["calls"] == 1


def test_stage_opens_no_range_without_a_profiler(monkeypatch):
    def refuse(name):
        raise AssertionError(f"a range {name!r} opened with no profiler running")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    with profiling.stage("t.plain"):
        pass
    assert profiling.report()["t.plain"]["calls"] == 1


class StandInEvent:
    """A timing event whose time and completion a test sets; reading it
    before it completes, or waiting on it, fails the test."""

    def __init__(self, enable_timing=False, external=False):
        assert enable_timing and external
        self.ms, self.done = 0.0, False

    def query(self):
        return self.done

    def elapsed_time(self, end):
        assert self.done and end.done, "an incomplete pair was read"
        return end.ms - self.ms

    def synchronize(self):
        raise AssertionError("reading a span waited for the card")


def pair(monkeypatch, name, start_ms, end_ms, done=True):
    monkeypatch.setattr(torch.cuda, "Event", StandInEvent)
    p = profiling.Pair(name)
    p.start.ms, p.end.ms = start_ms, end_ms
    p.start.done = p.end.done = done
    return p


def test_report_reads_armed_pairs_and_drops_incomplete_ones(monkeypatch):
    a1, a2 = pair(monkeypatch, "gpu.a", 1.0, 4.0), pair(monkeypatch, "gpu.a", 10.0, 12.0)
    late = pair(monkeypatch, "gpu.b", 0.0, 5.0, done=False)
    profiling.arm([a1, a2, late])
    rep = profiling.report()
    assert rep["gpu.a"]["calls"] == 2
    assert rep["gpu.a"]["total_s"] == pytest.approx(5e-3)
    assert "gpu.b" not in rep and rep[profiling.DROPPED]["calls"] == 1
    assert profiling.report() == rep  # each pair is read once
    profiling.arm([a1])
    profiling.reset()
    assert profiling.report() == {}  # reset forgets armed pairs unread


class StandInGraph:
    """Replays by recording its pairs again: complete, or still running."""

    def __init__(self, pairs):
        self.pairs, self.complete, self.replays = pairs, True, 0

    def replay(self):
        self.replays += 1
        for p in self.pairs:
            p.start.ms, p.end.ms = 100.0 * self.replays, 100.0 * self.replays + self.replays
            p.start.done = p.end.done = self.complete


def test_a_replay_reads_its_graphs_previous_spans_first(monkeypatch):
    p = pair(monkeypatch, "gpu.t.body", 0.0, 0.0, done=False)
    graph = StandInGraph([p])
    jit = aotcache.AotJit("t_standin", lambda x: x)
    x = torch.ones(3)
    entry = aotcache.Entry(jit, ("k",), x.device, graph, (x.clone(),), x.clone(),
                           {"port_kernels": {}, "spans": [p.name]}, [p])
    for _ in range(2):  # the second replay reads the first's pair first
        jit._replay(entry, (x,))
    assert profiling._METRICS["gpu.t.body"]["calls"] == 1
    rep = profiling.report()
    assert rep["gpu.t.body"]["calls"] == 2
    assert rep["gpu.t.body"]["total_s"] == pytest.approx(3e-3)  # 1 ms, then 2 ms
    assert rep["aot.launch"]["calls"] == 2 and profiling.DROPPED not in rep
    graph.complete = False  # replays the card has not finished
    for _ in range(2):
        jit._replay(entry, (x,))
    rep = profiling.report()
    assert rep[profiling.DROPPED]["calls"] == 2 and rep["gpu.t.body"]["calls"] == 2


def test_span_names_on_the_benchmark_paths_leave_its_own_spans_alone(monkeypatch):
    """Every stage and device span that the strategy path (composite CRH,
    the hash rounds, the strict and individual programs) and the grouped
    check open, recorded by name on the CPU: none is one of the benchmark's
    own spans, and the phases are all there."""
    from celo_bls_snark_tpu_torch import entry
    from celo_bls_snark_tpu_torch.ops import bls as dbls
    from celo_bls_snark_tpu_torch.ops import curve as dc
    from celo_bls_snark_tpu_torch.ops import msm as dmsm
    from celo_bls_snark_tpu_torch.scripts import bench_strategies as S

    names = set()

    def recording(fn):
        @contextmanager
        def scope(name, *args):
            names.add(name)
            with fn(name, *args):
                yield
        return scope

    scopes = {"stage": profiling.stage, "device_span": profiling.device_span}
    for mod in [m for k, m in sys.modules.items() if k.startswith("celo_bls_snark_tpu_torch")]:
        for attr, fn in scopes.items():
            if getattr(mod, attr, None) is fn:
                monkeypatch.setattr(mod, attr, recording(fn))

    msgs, extras = S.messages(1)
    hash_blocks, to_aff, rep = S.make_hasher({"msgs": msgs, "extras": extras, "V": 1,
                                              "device": torch.device("cpu")})
    jac = hash_blocks()
    sig, pk = dc.g1_pack([G1_GENERATOR], "cpu"), dc.g2_pack([G2_GENERATOR], "cpu")
    digits = torch.from_numpy(dmsm.window_digits([5], 8, S.C))
    progs = S.strategy_programs(1, 1)
    progs["per-epoch batch verification"](digits, sig, pk, to_aff(jac))
    progs["per-epoch individual verification"](sig, pk, rep(jac))
    sigs, hashes, apks = entry.example_inputs(2, 1, device="cpu")
    apk = tuple(tuple(x[:, :1] for x in c) for c in apks)
    assert bool(dbls.batch_verify_grouped_aot(sigs, dc.g1.from_affine(hashes), apk, 1)[0])

    assert {"h2g.message_crh", "h2g.crh.plan", "h2g.crh.digest", "h2g.pack", "h2g.round1",
            "gpu.h2g.round", "gpu.h2g.lane_hash",
            "gpu.verify.legs", "gpu.pairing.miller", "gpu.pairing.final_exp"} <= names
    # aotcache's own names are recorded on the card only
    assert not (names | {"aot.launch", "gpu.graph"}) & BENCHMARK_SPANS


def _pre_cip22_call(device, names=None):
    """One pre-CIP22 hash of 4 messages (round 1 over counter 0, round 2
    over counters 1 and 2) on `device`; returns the registry's report."""
    from celo_bls_snark_tpu_torch.keys import SIG_DOMAIN
    from celo_bls_snark_tpu_torch.ops import hash_to_g1 as th

    msgs = [b"direct msg %03d" % i for i in range(6, 10)]  # first counters 2 0 0 0
    profiling.reset()
    th.hash_to_g1_device(SIG_DOMAIN, msgs, b"", num_counters=3, device=device, cip22=False)
    return profiling.report()


def test_pre_cip22_call_records_its_pack_stage_and_round2_lanes(monkeypatch):
    """A pre-CIP22 hash opens the host stage h2g.pack and the device span
    gpu.h2g.lane_hash inside gpu.h2g.round (which records nothing on the
    CPU), and counts its round-2 lanes: one message, 2 counters."""
    from celo_bls_snark_tpu_torch.ops import hash_to_g1 as th

    names = []
    real = th.device_span

    @contextmanager
    def recording(name, like):
        names.append(name)
        with real(name, like):
            yield

    monkeypatch.setattr(th, "device_span", recording)
    monkeypatch.setattr(th, "ROUND1_COUNTERS", 1)
    rep = _pre_cip22_call("cpu")
    assert names == ["gpu.h2g.round", "gpu.h2g.lane_hash"] * 2
    assert {"h2g.pack", "h2g.round1", "h2g.round2"} <= set(rep)
    assert rep[th.ROUND2_LANES] == {"calls": 1, "total_s": 2.0}
    assert not {n for n in rep if n.startswith("gpu.")}


# --- on the card --------------------------------------------------------------

@pytest.mark.gpu
def test_pre_cip22_lane_hash_span_on_the_card(monkeypatch):
    """On the card each pre-CIP22 round's replay records gpu.h2g.lane_hash
    inside its gpu.h2g.round; the call records h2g.pack and its round-2
    lanes."""
    needs_card()
    from celo_bls_snark_tpu_torch.ops import hash_to_g1 as th

    monkeypatch.setattr(th, "ROUND1_COUNTERS", 1)
    for _ in range(2):  # eager, then the captures
        _pre_cip22_call("cuda")
    rep = _pre_cip22_call("cuda")
    assert rep["gpu.h2g.lane_hash"]["calls"] == 2 and rep["gpu.h2g.round"]["calls"] == 2
    assert 0 < rep["gpu.h2g.lane_hash"]["total_s"] < rep["gpu.h2g.round"]["total_s"]
    assert rep["h2g.pack"]["calls"] == 1 and profiling.DROPPED not in rep
    assert rep[th.ROUND2_LANES] == {"calls": 1, "total_s": 2.0}

def _spanned(a):
    with profiling.device_span("gpu.t.body", a):
        for _ in range(8):
            a = F.fq.mul(a, a)
    return a


def _plain(a):
    for _ in range(8):
        a = F.fq.mul(a, a)
    return a


@pytest.mark.gpu
def test_device_span_inside_a_graph_times_each_replay():
    """A captured span is read from every replay: from report() after a
    replay, and at the next replay after a host read; each sample is
    positive and under its replay's wall time, no pair drops, and the
    event nodes are not kernel nodes."""
    needs_card()
    x = torch.randint(0, 1 << 16, (F.FQ.n, 1 << 16), dtype=torch.int32, device="cuda")
    jit, plain = aotcache.AotJit("t_spanned", _spanned), aotcache.AotJit("t_plain", _plain)
    for j in (jit, plain):
        j(x)  # eager
        j.prepare(x)
    (entry,), (plain_entry,) = jit.entries.values(), plain.entries.values()
    assert entry.info["spans"] == ["gpu.t.body", "gpu.graph"]
    assert entry.info["kernels"] == plain_entry.info["kernels"]
    torch.cuda.synchronize()
    profiling.reset()

    def total():
        return profiling._METRICS.get("gpu.t.body", {}).get("total_s", 0.0)

    samples, walls = [], []
    for k in range(4):
        before = total()
        t0 = time.perf_counter()
        out = jit(x)
        int(out[0, 0])  # the host read
        walls.append(time.perf_counter() - t0)
        if k < 2:
            profiling.report()
        samples.append(total() - before)
    # the third replay's pair stays armed until the fourth replay starts
    assert samples[2] == 0.0
    samples[2] = samples[3]
    before = total()
    rep = profiling.report()
    samples[3] = total() - before
    assert rep["gpu.t.body"]["calls"] == 4 and rep["gpu.graph"]["calls"] == 4
    assert rep["aot.launch"]["calls"] == 4 and profiling.DROPPED not in rep
    for s, w in zip(samples, walls):
        assert 0 < s < w
    assert rep["gpu.t.body"]["total_s"] <= rep["gpu.graph"]["total_s"] < sum(walls)

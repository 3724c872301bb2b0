"""The port's per-shape CUDA-graph cache (celo_bls_snark_tpu_torch/utils/
aotcache.py) and the profiling functions its timing lines use.

On the CPU an AotJit calls its function, so these tests hold what a capture
needs without a card: every graphed program's body, after one warm-up call,
runs clean under tests/torch_capture_guard.py's guard (no host data becomes
a tensor, no tensor is read on the host) and gives the value the host
oracles give. The `gpu` tests capture and replay on the card."""

import random

import numpy as np
import pytest
import torch

from celo_bls_snark_tpu_torch.hostmath import curves as hc
from celo_bls_snark_tpu_torch.hostmath.params import G1_GENERATOR, R
from celo_bls_snark_tpu_torch.keys import SIG_DOMAIN
from celo_bls_snark_tpu_torch.ops import curve as dc
from celo_bls_snark_tpu_torch.ops import field as F
from celo_bls_snark_tpu_torch.ops import hash_to_g1 as th
from celo_bls_snark_tpu_torch.ops import msm as dmsm
from celo_bls_snark_tpu_torch.ops import pedersen as ped
from celo_bls_snark_tpu_torch.snark.accel import DeviceAccel
from celo_bls_snark_tpu_torch.utils import aotcache, profiling
from celo_bls_snark_tpu_torch.utils.config import Config, get_config, set_config

from torch_capture_guard import CaptureUnsafe, capture_guard, rehearse_captures

torch.set_num_threads(1)



def needs_card():
    if not torch.cuda.is_available():
        pytest.skip("captures CUDA graphs: needs a CUDA card")


def test_aotjit_on_cpu_tensors_calls_the_function():
    calls = []

    def fn(x, pair):
        calls.append(x.shape)
        return x + pair[0], pair[1] * 2

    jit = aotcache.AotJit("t_cpu", fn)
    x = torch.arange(6).reshape(2, 3)
    out = jit(x, (x, torch.ones(3)))
    assert torch.equal(out[0], 2 * x) and torch.equal(out[1], 2 * torch.ones(3))
    assert calls == [(2, 3)] and jit.entries == {}
    with pytest.raises(ValueError, match="all on the CPU or all on CUDA"):
        jit(x, (x.to("meta"), x))


def test_arg_key_folds_equal_leaves_and_names_the_multiply():
    a = torch.zeros((25, 8), dtype=torch.int32)
    key = aotcache._arg_key(((a, a), a[:, :1], 3))
    assert aotcache.key_str(key) == "int32[25,8]x2 int32[25,1] 3 cpu mont_mul"
    with F.mul_kernel("tc"):
        assert aotcache._arg_key(((a, a), a[:, :1], 3))[2] == "mont_mul_tc"
    assert aotcache._arg_key((a,)) != aotcache._arg_key(([a],))


@pytest.mark.parametrize("unsafe", ["tensor", "item", "bool", "from_numpy", "as_tensor",
                                    "numpy", "tolist"])
def test_capture_guard_catches_host_data_and_host_reads(unsafe):
    x = torch.arange(4)
    body = {
        "tensor": lambda: torch.tensor([1]),
        "item": lambda: x.sum().item(),
        "bool": lambda: bool(x[0] == 0),
        "from_numpy": lambda: torch.from_numpy(np.zeros(2)),
        "as_tensor": lambda: torch.as_tensor([1, 2]),
        "numpy": lambda: x.numpy(),
        "tolist": lambda: x.tolist(),
    }[unsafe]
    with pytest.raises(CaptureUnsafe):
        with capture_guard():
            body()
    body()  # fine again outside the guard
    with capture_guard():  # device arithmetic passes
        assert torch.equal(torch.as_tensor(x) * 2 + torch.arange(4), 3 * x)


def _pippenger(device="cpu"):
    rng = random.Random(5)
    pts = [hc.G1.mul(rng.randrange(1, R), G1_GENERATOR) for _ in range(7)] + [None]
    sc = [rng.randrange(1 << 16) for _ in pts]
    pv = dc.PointVec(dc.make_affine_raw(
        dc.g1, F.fq, lambda t: (pow(t[0], -1, hc.P),), (0, 0), "t_aot")(
            dc.g1_pack(pts, device)).leaves, F.FQ, (0, 0))
    got = dmsm.msm_pippenger(pv, sc, nbits=16, c=4, L=4, device=device)
    return got, hc.G1.msum([hc.G1.mul(s, p) for s, p in zip(sc, pts) if p])


def _fixed_base():
    c, nbits = 4, 12
    ks = [0, 1, 4095, 1234]
    tbl = dmsm.fixed_base_table(hc.G1, G1_GENERATOR, nbits, c)
    out = dmsm.fixed_base_batch_mul(dc.g1, dc.pack_affine(F.FQ, tbl, "cpu"),
                                    dmsm.fixed_base_plan(ks, nbits, c))
    got = dc.affine_raw_fn(dc.g1, F.fq, lambda t: (pow(t[0], -1, hc.P),), (0, 0),
                           "t_aot_fb")(out)
    return list(got), [hc.G1.mul(k, G1_GENERATOR) if k else None for k in ks]


def _h_poly():
    accel = DeviceAccel("bls12_377", "cpu")
    rng = random.Random(9)
    d = 16
    ev = [[rng.randrange(R) for _ in range(d)] for _ in range(3)]
    got = accel.compute_h_evals(*ev, d, accel.engine.fr_generator)
    with capture_guard():  # the constants are cached, not rebuilt
        assert accel._h_consts(d, accel.engine.fr_generator)[0] is \
            accel._h_tables(d, accel.engine.fr_generator)[0]
    return got.to_ints(), [int(v) for v in got]


def _hash(monkeypatch):
    # first valid counters under the DirectHasher: 0 and 1, both in round 1
    msgs = [b"aot msg 5", b"aot msg 0"]
    jac, has = th.hash_to_g1_device(SIG_DOMAIN, msgs, b"", num_counters=5, device="cpu")
    from celo_bls_snark_tpu_torch.hashers.direct import DirectHasher
    from celo_bls_snark_tpu_torch.hash_to_curve.try_and_increment_cip22 import (
        TryAndIncrementCIP22)

    want = [TryAndIncrementCIP22(DirectHasher(), "g1", True).hash(SIG_DOMAIN, m, b"")
            for m in msgs]
    return (dc.g1_unpack(jac), has.tolist()), (want, [True] * 2)


def _hash_direct(monkeypatch):
    # first valid counters before CIP22: 2 and 0; round 1 over counter 0,
    # round 2 over counters 1 and 2
    monkeypatch.setattr(th, "ROUND1_COUNTERS", 1)
    msgs = [b"direct msg 006", b"direct msg 007"]
    jac, has = th.hash_to_g1_device(SIG_DOMAIN, msgs, b"", num_counters=3, device="cpu",
                                    cip22=False)
    from celo_bls_snark_tpu_torch.hash_to_curve.try_and_increment import TryAndIncrement
    from celo_bls_snark_tpu_torch.hashers.direct import DirectHasher

    want = [TryAndIncrement(DirectHasher(), "g1", True).hash(SIG_DOMAIN, m, b"")
            for m in msgs]
    return (dc.g1_unpack(jac), has.tolist()), (want, [True] * 2)


def _merge(monkeypatch):
    """Round 2's merge: lanes idx take `part` where ok (the padding repeats
    a lane), the rest keep `full`."""
    idx, ok = torch.tensor([4, 1, 4, 4]), torch.tensor([True, False, True, True])
    full = tuple(torch.arange(12, dtype=torch.int32).reshape(2, 6) + 100 * k
                 for k in range(3))
    # the copies of a padded lane carry one value, as a round's do
    part = tuple(-(10 * idx + torch.arange(2)[:, None] + k).to(torch.int32)
                 for k in range(3))
    merge = aotcache.jit("h2g_merge_4", th._merge)
    got = [t.tolist() for t in merge(full, part, idx, ok)]
    want = []
    for f, p in zip(full, part):
        w = f.clone()
        w[:, 4] = p[:, 0]
        want.append(w.tolist())
    return got, want


def _crh():
    msgs = [b"\x01\x02\x03\x04\x05", b"\xff" * 5]
    from celo_bls_snark_tpu_torch.hashers.composite import bh_pedersen_crh

    got = ped.bh_crh_digests(msgs, "cpu", Lc=4)
    return got, [int(hc.ed_to_affine(bh_pedersen_crh(m))[0]).to_bytes(48, "little")
                 for m in msgs]


PROGRAMS = {
    "pippenger": (lambda mp: _pippenger(), {"aff1_t_aot", "aff2_t_aot",
                                            "pv_fromraw_fq377", "pip_g1_c4_L4"}),
    "fixed_base": (lambda mp: _fixed_base(), {"fb_g1", "aff1_t_aot_fb", "aff2_t_aot_fb"}),
    "h_poly": (lambda mp: _h_poly(), {"hp_bls12_377"}),
    "hash_to_g1": (_hash, {"h2g_crh_9_" + SIG_DOMAIN.hex(),
                           "h2g_round_cip22_33_" + SIG_DOMAIN.hex() + "_1_0_5_2"}),
    "hash_to_g1_direct": (_hash_direct, {"h2g_round_direct_15_" + SIG_DOMAIN.hex() + "_1_0_1_2",
                                         "h2g_round_direct_15_" + SIG_DOMAIN.hex() + "_1_1_2_1",
                                         "h2g_merge_1"}),
    "h2g_merge": (_merge, {"h2g_merge_4"}),
    "pedersen": (lambda mp: _crh(), {"bh_crh_14_4"}),
}


@pytest.mark.parametrize("program", list(PROGRAMS))
def test_program_bodies_run_clean_under_the_capture_guard(program, monkeypatch):
    """Each graphed program, at toy size: warm-up, then the body again under
    the guard (rehearse_captures), and the guarded results equal the host
    oracle's. The grouped verification's body is held under the guard in
    tests/test_torch_slice.py."""
    run, tags = PROGRAMS[program]
    with rehearse_captures() as seen:
        got, want = run(monkeypatch)
    assert got == want
    assert set(seen) == tags


def test_jit_is_one_program_per_tag_and_owners():
    """jit() keys its registry by the tag and the identity of the objects fn
    closes over: two curves under one tag are two programs, and the same
    (tag, owners) is the same AotJit. An AotJit nothing refers to leaves
    the process's list."""
    j1 = aotcache.jit("t_owned", lambda x: x + 1, dc.g1)
    j2 = aotcache.jit("t_owned", lambda x: x + 2, dc.g2)
    assert j1 is not j2 and aotcache.jit("t_owned", None, dc.g1) is j1
    x = torch.zeros(3)
    assert torch.equal(j2(x), x + 2) and torch.equal(j1(x), x + 1)
    import gc
    import weakref
    tmp = weakref.ref(aotcache.AotJit("t_tmp", lambda x: x))
    gc.collect()
    assert tmp() is None and all(j.tag != "t_tmp" for j in aotcache._jits())


@pytest.mark.parametrize("function", ["stage", "device_trace", "device_trace_dir"])
def test_profiling_functions(function, tmp_path, monkeypatch):
    """utils/profiling.py's stage(name), and device_trace: without
    Config.profile_trace_dir it yields the profile and writes nothing; with
    it (set from the JAX package's environment variable) it writes a Chrome
    trace in which every stage is a named range."""
    profiling.reset()
    if function == "stage":
        with profiling.stage("t.stage"):
            pass
        with profiling.stage("t.stage"):
            pass
        assert profiling.report()["t.stage"]["calls"] == 2
    elif function == "device_trace":
        assert Config().profile_trace_dir is None
        monkeypatch.chdir(tmp_path)
        with profiling.device_trace() as prof:
            (torch.ones(4) * 3).sum()
        assert any("mul" in e.key for e in prof.key_averages())
        assert list(tmp_path.iterdir()) == []
    else:
        monkeypatch.setenv("CELO_BLS_TPU_PROFILE_TRACE_DIR", str(tmp_path / "tr"))
        prev = get_config()
        set_config(None)
        try:
            assert get_config().profile_trace_dir == str(tmp_path / "tr")
            with profiling.device_trace():
                with profiling.stage("t.traced"):
                    (torch.ones(4) * 3).sum()
        finally:
            set_config(prev)
        (trace,) = (tmp_path / "tr").iterdir()
        assert "t.traced" in trace.read_text()
    profiling.reset()


# --- on the card --------------------------------------------------------------

def _fq_body(a, b):
    return F.fq.add(F.fq.mul(a, b), F.fq.sq(a))


@pytest.mark.gpu
def test_replay_equals_eager_and_follows_new_data():
    needs_card()
    g = torch.Generator(device="cuda").manual_seed(3)
    a, b = (torch.randint(0, 1 << 16, (F.FQ.n, 256), generator=g, device="cuda",
                          dtype=torch.int32) for _ in range(2))
    a2 = a.flip(-1)
    want, want2 = _fq_body(a, b), _fq_body(a2, b)
    jit = aotcache.AotJit("t_fq", _fq_body)
    F.reset_launches()
    aotcache.reset_replays()
    assert torch.equal(jit(a, b), want)  # the first call: eager
    assert jit.entries == {} and F.mont_mul.launches == 2
    assert torch.equal(jit(a2, b), want2)  # captured, replayed
    assert torch.equal(jit(a, b), want)
    (entry,) = jit.entries.values()
    assert entry.replays == 2 and entry.info["port_kernels"] == {"mont_mul": 2}
    assert entry.info["kernels"] >= 2
    # the capture counts no launch; each replay ran 2
    assert F.mont_mul.launches == 2 and aotcache.graph_launches() == {"mont_mul": 4}
    for _ in range(2):
        jit(a[:, :128], b[:, :128])  # a second shape, a second graph
    assert len(jit.entries) == 2


@pytest.mark.gpu
def test_tampered_batch_is_false_through_the_same_graph():
    needs_card()
    from celo_bls_snark_tpu_torch import entry
    from celo_bls_snark_tpu_torch.ops import bls as dbls
    from celo_bls_snark_tpu_torch.utils.tree import tree_map

    sigs, hashes_aff, apks = entry.example_inputs(device="cuda")
    hashes = dc.g1.from_affine(hashes_aff)
    apk = tree_map(lambda t: t[:, :1].contiguous(), apks)
    bad = tree_map(lambda d, x: torch.cat([d, x[:, 1:]], dim=-1),
                   dc.g1.double(tree_map(lambda x: x[:, :1], sigs)), sigs)
    aotcache.clear()
    for _ in range(2):  # eager, then captured
        assert bool(dbls.batch_verify_grouped_aot(sigs, hashes, apk, 1)[0])
    assert not bool(dbls.batch_verify_grouped_aot(bad, hashes, apk, 1)[0])
    assert bool(dbls.batch_verify_grouped_aot(sigs, hashes, apk, 1)[0])
    (entry_,) = aotcache.entries()
    assert entry_.replays == 3


@pytest.mark.gpu
def test_a_host_read_in_the_body_raises_at_capture():
    needs_card()
    jit = aotcache.AotJit("t_item", lambda x: x * int(x.sum().item()))
    jit(torch.ones(4, device="cuda"))  # the first call runs eagerly
    with pytest.raises(RuntimeError, match=r"\[aot\] capture of t_item failed"):
        jit(torch.ones(4, device="cuda"))
    assert jit.entries == {}


@pytest.mark.gpu
def test_a_pool_past_its_limit_drops_its_graphs(monkeypatch):
    needs_card()
    aotcache.clear()
    x = torch.ones((F.FQ.n, 4096), dtype=torch.int32, device="cuda")
    small = aotcache.AotJit("t_small", lambda a: F.fq.mul(a, a))
    for _ in range(2):
        small(x)
    (pool,) = aotcache._POOLS.values()
    monkeypatch.setattr(pool, "limit", -1)  # the next capture finds it full
    other = aotcache.AotJit("t_other", lambda a: F.fq.add(a, a))
    for _ in range(2):
        assert torch.equal(other(x), F.fq.add(x, x))
    assert small.entries == {} and len(other.entries) == 1
    assert aotcache._POOLS[x.device] is not pool
    assert torch.equal(small(x), F.fq.mul(x, x))  # captured again
    assert len(small.entries) == 1

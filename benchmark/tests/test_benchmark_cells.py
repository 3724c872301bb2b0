"""Each cell end to end on the CPU's plain path at a tiny size: the
program's verdicts agree with the reference's on honest and forged batches,
and a run with the timed path broken underneath comes out not correct (half
of each batch left out; every verdict altered where the program makes it).
The control (benchmark/control.py) fails at the same size. The CPU has no
graphs: the warm-up is skipped and each call runs the plain path."""

import pytest
import torch

from benchmark import control, run
from benchmark.reference import pack
from benchmark.reference.params import R
from benchmark.tests.conftest import TINY

CELLS = sorted(TINY)
SEED = 3141592653


def tiny_run(cell, **kw):
    return run.run(cell, SEED, 0, 0, device="cpu", workers=2, overrides=TINY[cell], **kw)


@pytest.mark.parametrize("cell", CELLS)
def test_cell_is_correct_on_the_plain_path(cell):
    r = tiny_run(cell)
    assert r["correct"], r["checks"]
    n = len(r["notes"]["expected"]) // 2
    assert list(r["notes"]["expected"].values()) == [True] * n + [False] * n
    assert r["attempted"] == 2 * n and r["failed"] == 0
    assert set(r["metrics"]) >= {"sigs_per_s", "setup_s"}
    assert list(r)[-1] == "checks"


def _points(x, y, z):
    """Limb columns of Montgomery values back to affine points."""
    from benchmark.reference.params import P

    inv = pow(pack.MONT_R, -1, P)

    def ints(t):
        return [sum(int(v) << (16 * i) for i, v in enumerate(col)) * inv % P
                for col in t.T.tolist()]

    assert set(ints(z)) == {1}
    return list(zip(ints(x), ints(y)))


def test_prehashed_lanes_are_distinct_multiples():
    """Each lane of a set holds endo^e(+-k H_j) and the seal endo^e(+-k sk
    H_j) of one of its committee's messages, and no lane repeats within a
    call or across the six sets."""
    from benchmark.reference import group, work

    _spec, _entry, cell, config = run.cell_spec("sync100.prehashed",
                                                {"params": {**TINY["sync100.prehashed"]["params"],
                                                            "sets": 6}})
    ex = work.pool(2)
    try:
        drv = run.load_module("drivers", "grouped").Driver(config, cell["params"], SEED,
                                                           torch.device("cpu"), ex)
        drv.load()
        drv.finish()
    finally:
        ex.shutdown()
    inp, seen = drv.inp, set()
    lanes_g = inp.M // inp.G
    for s in range(inp.S):
        hs, sg = _points(*drv.hashes[s]), _points(*drv.sigs[s])
        for lane, (h, sig) in enumerate(zip(hs, sg)):
            j, k = divmod(int(inp.src[s][lane]), inp.K)
            e, odd = divmod(int(inp.variant[s][lane]), 2)
            k = -(k + 1) if odd else k + 1
            assert j // inp.per == lane // lanes_g
            assert h == group.endo(group.G1.mul(k % R, inp.hashes[j]), e)
            assert sig == group.endo(group.G1.mul(k * inp.sks[j // inp.per] % R, inp.hashes[j]),
                                     e)
        seen.update(hs)
    assert len(seen) == inp.S * inp.M
    forged = _points(*drv.sigs[inp.S + 1])
    assert sum(a != b for a, b in zip(forged, _points(*drv.sigs[1]))) == 1


def _half_grouped(monkeypatch):
    from celo_bls_snark_tpu_torch.ops import bls as dbls

    real = dbls.batch_verify_grouped_aot

    def half(sigs, hashes, apks, groups):
        n = sigs[0].shape[-1] // 2
        cut = lambda t: tuple(x[..., :n] for x in t)  # noqa: E731
        return real(cut(sigs), cut(hashes), apks, groups)

    monkeypatch.setattr(dbls, "batch_verify_grouped_aot", half)


def _half_strategy(drv):
    S, name, B, V = drv.S, drv.name, drv.inp.B, drv.inp.V
    h = B // 2

    def cut(x, lanes):
        if isinstance(x, tuple):
            return tuple(cut(t, lanes) for t in x)
        return x[..., :lanes]

    def program(*args):
        names = S.ARGS[name]
        a = {n: cut(v, h if n == "h_aff" else h * V) for n, v in zip(names, args)}
        if name == "per-epoch batch verification":
            return S.per_epoch_batch(h, a["expdigits"], a["sig_jac"], a["pk_jac"], a["h_aff"])
        return S.per_epoch_individual(a["sig_jac"], a["pk_jac"], a["h_per_val"])

    drv.progs = {**drv.progs, name: program}
    return drv


def _flip_grouped(monkeypatch):
    from celo_bls_snark_tpu_torch.ops import bls as dbls

    real = dbls.batch_verify_grouped_aot
    monkeypatch.setattr(dbls, "batch_verify_grouped_aot",
                        lambda *a: torch.logical_not(real(*a)))


def _flip_strategy(drv):
    real = drv.progs[drv.name]
    drv.progs = {**drv.progs, drv.name: lambda *a: torch.logical_not(real(*a))}
    return drv


@pytest.mark.parametrize("fault", ["half_batch", "answer_altered"])
@pytest.mark.parametrize("cell", CELLS)
def test_broken_timed_path_is_not_correct(cell, fault, monkeypatch):
    wrap = None
    if cell.startswith("sync100"):
        (_half_grouped if fault == "half_batch" else _flip_grouped)(monkeypatch)
    else:
        wrap = _half_strategy if fault == "half_batch" else _flip_strategy
    r = tiny_run(cell, driver_wrap=wrap)
    assert not r["correct"]
    assert r["checks"]["wrong_verdicts"]["value"] > 0


@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(cell):
    out = control.control_run(cell, SEED, 8, workers=2, overrides=TINY[cell])
    assert not out["correct"] and out["wrong_verdicts"] > 0
    n = len(out["expected"]) // 2
    assert out["expected"] == [True] * n + [False] * n


@pytest.mark.gpu
def test_cell_on_the_card():
    """One short run of the cheapest cell through the command, on a card."""
    import json
    import subprocess
    import sys

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    out = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload",
                          "sync100.prehashed", "--seed", str(SEED), "--seconds", "2",
                          "--trace", "0"], capture_output=True, text=True, timeout=600,
                         cwd=run.ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    assert json.loads(out.stdout.strip().splitlines()[-1])["correct"]

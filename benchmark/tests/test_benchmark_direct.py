"""The cell sync100.direct on the CPU's plain path at a tiny size: the
program hashes each batch's messages before CIP22 and its verdicts agree
with the reference's on honest and forged batches; a run in which the
program hashes by CIP22 in its place, or one lane's message is swapped,
comes out not correct, as does the control; and a program whose entry
takes no `cip22` makes the driver fail before any reference work."""

import pytest
import torch

from benchmark import control, run

CELL = "sync100.direct"
# its own size: 8 blocks an epoch, the two sets of the cell
TINY = {"params": {"messages_per_call": 8, "sets": 2}}
SEED = 2718281828459


def tiny_run(**kw):
    return run.run(CELL, SEED, 0, 0, device="cpu", workers=2, overrides=TINY, **kw)


def test_plain_path_is_correct_on_honest_and_forged_batches():
    r = tiny_run()
    assert r["correct"], r["checks"]
    assert r["notes"]["expected"] == {"honest.0": True, "honest.1": True,
                                      "forged.0": False, "forged.1": False}
    assert r["attempted"] == 4 and r["failed"] == 0
    assert set(r["metrics"]) >= {"sigs_per_s", "call_p90_ms", "setup_s"}


def _hashed_by_cip22(monkeypatch):
    from celo_bls_snark_tpu_torch.ops import hash_to_g1 as th

    real = th.hash_to_g1_device

    def cip22(*args, **kw):
        return real(*args, **{**kw, "cip22": True})

    monkeypatch.setattr(th, "hash_to_g1_device", cip22)


def _message_swapped(drv):
    # one lane of each set hashes the message of the next block
    for msgs in drv.inp.messages:
        msgs[1] = msgs[2]
    return drv


@pytest.mark.parametrize("fault", ["hashed_by_cip22", "message_swapped"])
def test_planted_fault_is_not_correct(fault, monkeypatch):
    wrap = None
    if fault == "hashed_by_cip22":
        _hashed_by_cip22(monkeypatch)
    else:
        wrap = _message_swapped
    r = tiny_run(driver_wrap=wrap)
    assert not r["correct"]
    assert r["checks"]["wrong_verdicts"]["value"] > 0


def test_control_is_not_correct():
    out = control.control_run(CELL, SEED, 8, workers=2, overrides=TINY)
    assert not out["correct"] and out["wrong_verdicts"] > 0
    assert out["expected"] == [True, True, False, False]


def test_entry_without_cip22_fails_before_reference_work(monkeypatch):
    """The parent's entry, which hashes by CIP22 only: the driver raises at
    once, before it asks for a single reference hash."""
    from benchmark.reference import work
    from celo_bls_snark_tpu_torch.ops import bls as dbls

    def no_cip22(sigs_jac, apks_aff, domain, messages, extra_data=b"", groups=1,
                 composite=False, num_counters=24, compat=True):
        raise AssertionError("called")

    asked = []
    monkeypatch.setattr(dbls, "batch_verify_messages_device", no_cip22)
    monkeypatch.setattr(work, "message_hashes", lambda *a: asked.append(a))
    with pytest.raises(RuntimeError, match="takes no cip22"):
        run.run(CELL, SEED, 0, 0, device="cpu", workers=1, overrides=TINY)
    assert asked == []


@pytest.mark.gpu
def test_cell_on_the_card():
    """One short run through the command, on a card."""
    import json
    import subprocess
    import sys

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    out = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload", CELL,
                          "--seed", str(SEED), "--seconds", "2", "--trace", "0"],
                         capture_output=True, text=True, timeout=900, cwd=run.ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    assert json.loads(out.stdout.strip().splitlines()[-1])["correct"]

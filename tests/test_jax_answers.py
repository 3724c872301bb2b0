"""tests/jax_answers.py: a recording round-trips, and inputs that are not
the ones it was recorded from are refused, naming the file and the
command that re-derives it. Outside the Tier-1 gate (`slow`), every
recording under tests/jax_recordings/ is re-derived from the JAX package."""

import importlib

import numpy as np
import pytest

import jax_answers


@pytest.mark.slow
@pytest.mark.parametrize("name", jax_answers.recorded())
def test_a_recording_is_the_jax_packages_answer(name):
    module, case = name.split(".")
    importlib.import_module(module).REC.rederive(case)


def _inputs(seed):
    return np.arange(6, dtype=np.uint32).reshape(2, 3) + seed, [b"msg", (1, None)], 5


def _answers(inputs):
    words, _, k = inputs
    return {"limbs": [words * k, words > 7], "one": [np.full(1, k, np.int32)]}


def _verdicts(inputs):
    return {"ok": [np.array([True, False])]}


@pytest.fixture
def rec(tmp_path, monkeypatch):
    monkeypatch.setattr(jax_answers, "DATA", str(tmp_path))
    return jax_answers.Recordings("test_mod", {
        "limbs": (lambda: _inputs(0), _answers),
        "verdicts": (lambda: _inputs(0), _verdicts)})


def test_a_recording_round_trips(rec):
    assert rec.write("limbs").endswith("test_mod.limbs.npz")
    assert rec.write("verdicts").endswith("test_mod.verdicts.npz")
    for case, jax_fn in (("limbs", _answers), ("verdicts", _verdicts)):
        got = rec.load(case, _inputs(0))
        want = jax_fn(_inputs(0))
        assert sorted(got) == sorted(want)
        for key in want:
            assert len(got[key]) == len(want[key])
            for x, y in zip(got[key], want[key]):
                assert x.dtype == y.dtype
                np.testing.assert_array_equal(x, y)
    rec.rederive("limbs")
    rec.rederive("verdicts")


@pytest.mark.parametrize("case", ["limbs", "verdicts"])
def test_a_stale_recording_raises(rec, case):
    rec.write(case)
    path = rec.path(case)
    with pytest.raises(jax_answers.StaleRecording) as e:
        rec.load(case, _inputs(1))
    assert path in str(e.value)
    assert f"`python tests/jax_answers.py test_mod.{case}`" in str(e.value)


def test_answers_are_recorded_for_recorded_cases_and_live_for_the_others(rec):
    rec.write("limbs")
    calls = []

    def live(inputs):
        calls.append(inputs)
        return {"ok": [np.array([False])]}

    np.testing.assert_array_equal(rec.answers("limbs", _inputs(0), live)["one"][0], [5])
    with pytest.raises(jax_answers.StaleRecording):
        rec.answers("limbs", _inputs(1), live)
    assert calls == []
    assert rec.answers("other", _inputs(1), live)["ok"][0].tolist() == [False]
    assert len(calls) == 1


def test_a_missing_recording_raises(rec):
    with pytest.raises(jax_answers.StaleRecording, match="jax_answers.py test_mod.limbs"):
        rec.load("limbs", _inputs(0))


def test_a_committed_recording_refuses_other_inputs():
    import test_torch_hash_to_g1 as t

    words, compat = t.sqrt_inputs()
    t.REC.load("sqrt_stages", (words, compat))
    with pytest.raises(jax_answers.StaleRecording, match="test_torch_hash_to_g1.sqrt_stages"):
        t.REC.load("sqrt_stages", (words, not compat))


def test_the_digest_tells_apart_what_it_should():
    d = jax_answers.digest
    assert d((1, 2)) == d([1, 2]) != d((12,))
    assert d(b"ab") != d("ab") != d((b"a", b"b"))
    assert d(np.zeros(2, np.int32)) != d(np.zeros(2, np.int64)) != d(np.zeros((1, 2), np.int64))
    assert d(None) != d(0) != d(False)
    assert d(True) == d(np.bool_(True)) and d(3) == d(np.int64(3))

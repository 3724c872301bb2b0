"""ms a call on the card building the pairing legs, the work before the
Miller loop in the check program: the program's device span
gpu.verify.legs (ops/bls.py: the grouped fold and its affine form; the
strict program's Straus MSMs and affine forms;
scripts/bench_strategies.py::per_epoch_individual's affine forms)."""

from benchmark.layers import _spans


def read(run):
    return _spans.mean_ms(run, ["gpu.verify.legs"])

"""ms a call on the card in the Miller loop: the program's device span
gpu.pairing.miller (ops/pairing.py::miller_loop_batch)."""

from benchmark.layers import _spans


def read(run):
    return _spans.mean_ms(run, ["gpu.pairing.miller"])

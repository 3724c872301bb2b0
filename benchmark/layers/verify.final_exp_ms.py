"""ms a call on the card in the final exponentiation: the program's device
span gpu.pairing.final_exp (ops/pairing.py::final_exponentiation)."""

from benchmark.layers import _spans


def read(run):
    return _spans.mean_ms(run, ["gpu.pairing.final_exp"])

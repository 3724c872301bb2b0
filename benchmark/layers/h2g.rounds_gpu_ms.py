"""ms a call on the card in the hash-to-G1 rounds: the program's device
span gpu.h2g.round (ops/hash_to_g1.py::_round_body), one a round's
replay, summed over a call's rounds."""

from benchmark.layers import _spans


def read(run):
    return _spans.mean_ms(run, ["gpu.h2g.round"])

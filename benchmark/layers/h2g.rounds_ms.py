"""ms a call in the hash-to-G1 layer (ops/hash_to_g1.py::hash_to_g1_device):
the program's stages h2g.round1 and h2g.round2, each of which ends on a
host read."""

from benchmark.layers import _spans


def read(run):
    return _spans.mean_ms(run, ["h2g.round1", "h2g.round2"])

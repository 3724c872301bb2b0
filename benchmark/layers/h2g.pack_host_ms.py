"""ms a call on the host packing the messages for the rounds before CIP22
and copying them to the card: the program's host stage h2g.pack
(ops/hash_to_g1.py::hash_to_g1_device with cip22 false)."""

from benchmark.layers import _spans


def read(run):
    return _spans.mean_ms(run, ["h2g.pack"])

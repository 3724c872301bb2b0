"""ms a call on the card hashing the lanes of the rounds before CIP22: the
program's device span gpu.h2g.lane_hash (ops/hash_to_g1.py::
_direct_round_body, the CRH and the XOF of every (counter, message) lane),
one a round's replay, summed over a call's rounds."""

from benchmark.layers import _spans


def read(run):
    return _spans.mean_ms(run, ["gpu.h2g.lane_hash"])

"""ms a call on the host in the CRH: the program's host stages
h2g.crh.plan (ops/pedersen.py::bh_plan and the copy of its index and sign
tensors to the card) and h2g.crh.digest (the points read to the host made
into 48-byte digests, pedersen.py::bh_crh_digests)."""

from benchmark.layers import _spans


def read(run):
    return _spans.mean_ms(run, ["h2g.crh.plan", "h2g.crh.digest"])

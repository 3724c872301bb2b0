"""ms a call in the CRH layer (ops/pedersen.py, ops/blake2s.py,
ops/hash_to_g1.py::composite_crh_bytes): the benchmark's span h2g.crh
around composite_crh_bytes, which returns host bytes."""

from benchmark.layers import _spans


def read(run):
    return _spans.mean_ms(run, ["h2g.crh"])

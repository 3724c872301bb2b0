"""ms a call in the BLS pipeline (ops/bls.py's grouped check; the strategy
programs over strict_batch_verify_device and verify_pairs_device): the
benchmark's span verify.check around the check and its verdict's read."""

from benchmark.layers import _spans


def read(run):
    return _spans.mean_ms(run, ["verify.check"])

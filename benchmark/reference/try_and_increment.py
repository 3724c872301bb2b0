"""Try-and-increment hash-to-curve, the variant before CIP22: the whole
hasher runs once a counter, over the counter, the extra data and the
message.

Bit-exact with crates/bls-crypto/src/hash_to_curve/try_and_increment.rs:
for counter c = 0..254, candidate = hasher.hash(domain, c || extra || msg,
hash_length); decompress; multiply by the cofactor; retry on failure.
`compat` takes the y-sign from bit 377, as the deployed Celo build does
(try_and_increment.rs:106-120).
"""

from . import curves
from .h2c_common import (
    G1_BYTES,
    HashToCurveError,
    apply_compat_sign,
    g1_from_random_bytes,
    hash_length,
)

NUM_TRIES = 255


class TryAndIncrement:
    """Hash to G1."""

    def __init__(self, hasher, compat=True):
        self.hasher = hasher
        self.compat = compat

    def hash(self, domain: bytes, message: bytes, extra_data: bytes):
        hash_bytes = hash_length(G1_BYTES)
        for c in range(NUM_TRIES):
            candidate = self.hasher.hash(domain, bytes([c]) + extra_data + message,
                                         hash_bytes)[:G1_BYTES]
            if self.compat:
                candidate = apply_compat_sign(candidate, G1_BYTES)
            pt = g1_from_random_bytes(candidate)
            if pt is None or pt == "infinity":
                continue
            scaled = curves.G1.scale_by_cofactor(pt)
            if scaled is None:
                continue
            return scaled
        raise HashToCurveError("could not hash to curve in 255 tries")

"""Try-and-increment hash-to-curve (pre-CIP22 variant).

Bit-exact with crates/bls-crypto/src/hash_to_curve/try_and_increment.rs:
for counter c = 0..255, candidate = hasher.hash(domain, c || extra || msg,
hash_length); decompress; multiply by the cofactor; retry on failure.

`compat=True` (the reference's default feature) replicates the deployed Celo
bit extraction: the y-sign is taken from bit 377 instead of bit 383
(try_and_increment.rs:106-120).
"""

from ..hostmath import curves
from ..hashers import DirectHasher
from ..hashers.composite import composite_hasher
from .common import hash_length, HashToCurveError
from .common import (
    G1_BYTES,
    G2_BYTES,
    apply_compat_sign,
    g1_from_random_bytes,
    g2_from_random_bytes,
)

NUM_TRIES = 255


class TryAndIncrement:
    def __init__(self, hasher, group="g1", compat=True):
        self.hasher = hasher
        self.group = group
        self.compat = compat
        if group == "g1":
            self._num_bytes = G1_BYTES
            self._from_bytes = g1_from_random_bytes
            self._curve = curves.G1
        else:
            self._num_bytes = G2_BYTES
            self._from_bytes = g2_from_random_bytes
            self._curve = curves.G2

    def hash(self, domain: bytes, message: bytes, extra_data: bytes):
        return self.hash_with_attempt(domain, message, extra_data)[0]

    def hash_with_attempt(self, domain: bytes, message: bytes, extra_data: bytes):
        num_bytes = self._num_bytes
        hash_bytes = hash_length(num_bytes)
        for c in range(NUM_TRIES):
            candidate = self.hasher.hash(
                domain, bytes([c]) + extra_data + message, hash_bytes
            )
            candidate = candidate[:num_bytes]
            if self.compat:
                candidate = apply_compat_sign(candidate, num_bytes)
            pt = self._from_bytes(candidate)
            if pt is None:
                continue
            if pt == "infinity":
                continue
            scaled = self._curve.scale_by_cofactor(pt)
            if scaled is None:
                continue
            return scaled, c
        raise HashToCurveError("could not hash to curve in 255 tries")


def composite_hash_to_g1(compat=True) -> TryAndIncrement:
    return TryAndIncrement(composite_hasher(), "g1", compat)


def direct_hash_to_g1(compat=True) -> TryAndIncrement:
    return TryAndIncrement(DirectHasher(), "g1", compat)

"""CIP-22 try-and-increment: the CRH runs once outside the counter loop, and
only the XOF is re-run per counter — what makes in-circuit hashing affordable.

Bit-exact with crates/bls-crypto/src/hash_to_curve/try_and_increment_cip22.rs:
inner = crh(domain, message); per counter c: candidate = xof(domain,
c || extra || inner, hash_length).
"""

from . import curves
from .composite import composite_hasher
from .h2c_common import hash_length, HashToCurveError
from .h2c_common import (
    G1_BYTES,
    G2_BYTES,
    apply_compat_sign,
    g1_from_random_bytes,
    g2_from_random_bytes,
)

NUM_TRIES = 255


class TryAndIncrementCIP22:
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
        return self.hash_with_attempt_cip22(domain, message, extra_data)[0]

    def hash_with_attempt_cip22(self, domain: bytes, message: bytes, extra_data: bytes):
        num_bytes = self._num_bytes
        hash_bytes = hash_length(num_bytes)
        inner_hash = self.hasher.crh(domain, message, hash_bytes)
        for c in range(NUM_TRIES):
            msg = bytes([c]) + extra_data + inner_hash
            candidate = self.hasher.xof(domain, msg, hash_bytes)[:num_bytes]
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


def composite_hash_to_g1_cip22(compat=True) -> TryAndIncrementCIP22:
    return TryAndIncrementCIP22(composite_hasher(), "g1", compat)

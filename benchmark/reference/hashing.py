"""Hash to G1 on the host, over the composite or the direct hasher, by
CIP22 try-and-increment (crates/bls-crypto/src/hash_to_curve/
try_and_increment_cip22.rs) or by the variant before it
(try_and_increment.rs)."""

from .cip22 import TryAndIncrementCIP22
from .composite import composite_hasher
from .direct import DirectHasher
from .try_and_increment import TryAndIncrement

HASHERS = {"composite": composite_hasher, "direct": DirectHasher}


def hash_to_g1(hasher: str, domain: bytes, message: bytes, extra: bytes,
               compat: bool = True, cip22: bool = True):
    """The affine G1 point of `message` (the cofactor cleared)."""
    if cip22:
        return TryAndIncrementCIP22(HASHERS[hasher](), "g1", compat).hash(domain, message, extra)
    return TryAndIncrement(HASHERS[hasher](), compat).hash(domain, message, extra)

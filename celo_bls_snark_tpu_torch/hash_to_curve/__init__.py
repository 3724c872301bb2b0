"""Hash-to-curve via try-and-increment (reference:
crates/bls-crypto/src/hash_to_curve/)."""

from .common import hash_length, HashToCurveError
from .try_and_increment import TryAndIncrement, composite_hash_to_g1, direct_hash_to_g1
from .try_and_increment_cip22 import TryAndIncrementCIP22, composite_hash_to_g1_cip22

__all__ = [
    "TryAndIncrement",
    "TryAndIncrementCIP22",
    "composite_hash_to_g1",
    "direct_hash_to_g1",
    "composite_hash_to_g1_cip22",
    "hash_length",
    "HashToCurveError",
]

"""CIP22 try-and-increment hash-to-G1 (reference:
crates/bls-crypto/src/hash_to_curve/try_and_increment_cip22.rs)."""

from .common import hash_length, HashToCurveError
from .try_and_increment_cip22 import TryAndIncrementCIP22, composite_hash_to_g1_cip22

__all__ = [
    "TryAndIncrementCIP22",
    "composite_hash_to_g1_cip22",
    "hash_length",
    "HashToCurveError",
]

"""Hasher layer: CRH + XOF pairs (reference: crates/bls-crypto/src/hashers/)."""

from .direct import DirectHasher
from .composite import CompositeHasher, composite_hasher

__all__ = ["DirectHasher", "CompositeHasher", "composite_hasher"]

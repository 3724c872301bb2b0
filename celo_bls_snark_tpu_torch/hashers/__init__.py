"""Hasher layer: CRH + XOF pairs (reference: crates/bls-crypto/src/hashers/).

`Hasher` protocol: crh(domain, message, xof_digest_length) -> bytes,
xof(domain, hashed_message, xof_digest_length) -> bytes,
hash = xof(crh(...)) (crates/bls-crypto/src/hashers/mod.rs:9-42).
"""

from .direct import DirectHasher
from .composite import CompositeHasher, composite_hasher

__all__ = ["DirectHasher", "CompositeHasher", "composite_hasher", "Hasher"]


class Hasher:
    """Base protocol (duck-typed); see DirectHasher / CompositeHasher."""

    def crh(self, domain: bytes, message: bytes, xof_digest_length: int) -> bytes:
        raise NotImplementedError

    def xof(self, domain: bytes, hashed_message: bytes, xof_digest_length: int) -> bytes:
        raise NotImplementedError

    def hash(self, domain: bytes, message: bytes, output_size_in_bytes: int) -> bytes:
        prepared = self.crh(domain, message, output_size_in_bytes)
        return self.xof(domain, prepared, output_size_in_bytes)

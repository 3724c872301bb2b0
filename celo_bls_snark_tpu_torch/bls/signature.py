"""Signatures: aggregation and (n+1)-pairing batch verification.

Reference parity: crates/bls-crypto/src/bls/signature.rs
(aggregate = G1 sum :61-67, batch = G1 MSM :70-89, batch_verify :101-117,
batch_verify_hashes = (n+1)-pairing product, BDN18 pg.11 :125-155).
"""

from ..hostmath.params import R, G2_GENERATOR
from ..hostmath import curves, pairing
from ..utils import serialization as ser


class Signature:
    """A G1 point (signature.rs:17)."""

    __slots__ = ("pt",)

    def __init__(self, pt):
        self.pt = pt

    def __eq__(self, other):
        return isinstance(other, Signature) and self.pt == other.pt

    @staticmethod
    def aggregate(signatures) -> "Signature":
        return Signature(curves.G1.msum([s.pt for s in signatures]))

    @staticmethod
    def batch(exponents, signatures):
        """MSM of signatures with exponents; None on length mismatch."""
        sigs = list(signatures)
        if len(sigs) != len(exponents):
            return None
        acc = None
        for e, s in zip(exponents, sigs):
            term = curves.G1.mul(e % R, s.pt) if e % R != 0 else None
            acc = curves.G1.add(acc, term)
        return Signature(acc)

    def batch_verify(self, pubkeys, domain, messages, hash_to_g1):
        """messages: list of (message, extra_data) pairs."""
        from . import UnevenNumKeysMessages

        if len(pubkeys) != len(messages):
            raise UnevenNumKeysMessages()
        hashes = [hash_to_g1.hash(domain, m, e) for (m, e) in messages]
        return self.batch_verify_hashes(pubkeys, hashes)

    def batch_verify_hashes(self, pubkeys, message_hashes):
        """e(sigma, -g2) * prod e(H(m_i), pk_i) == 1 (signature.rs:125-155)."""
        from . import UnevenNumKeysMessages, VerificationFailed

        if len(pubkeys) != len(message_hashes):
            raise UnevenNumKeysMessages()
        pairs = [(self.pt, curves.G2.neg(G2_GENERATOR))]
        pairs += [(h, pk.pt) for h, pk in zip(message_hashes, pubkeys)]
        if not pairing.pairing_check(pairs):
            raise VerificationFailed()

    # --- serialization ----------------------------------------------------
    def to_bytes(self, compressed=True) -> bytes:
        return ser.g1_to_bytes(self.pt, compressed)

    @classmethod
    def from_bytes(cls, data: bytes, compressed=True, validate=True) -> "Signature":
        return cls(ser.g1_from_bytes(data, compressed, validate))

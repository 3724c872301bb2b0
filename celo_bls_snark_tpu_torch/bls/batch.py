"""Strict batch verifier: random-linear-combination defense against rogue
aggregation. Reference parity: crates/bls-crypto/src/bls/batch.rs.
"""

import math
import secrets

from ..hostmath.params import R


SECURITY_BOUND = 128


def byte_count_from_target_batch_size(size: int, target_security: int) -> int:
    """min(ceil((security + log2 n)/8), |Fr|/8) (batch.rs:20-28)."""
    log2_size = 0 if size <= 1 else math.ceil(math.log2(size))
    target_byte_count = (target_security + log2_size + 7) // 8
    field_byte_count = 253 // 8  # Fr::size_in_bits() / 8
    return min(target_byte_count, field_byte_count)


class Batch:
    """Accumulates (pk, sig) pairs over ONE message (batch.rs:13-41)."""

    def __init__(self, message: bytes, extra_data: bytes):
        self.entries = []
        self.message = bytes(message)
        self.extra_data = bytes(extra_data)

    def add(self, public_key, signature):
        self.entries.append((public_key, signature))

    def verify(self, hash_to_g1, rng=None):
        """Draw per-entry small random exponents, MSM-combine pks and sigs,
        then one pairing check (batch.rs:44-84)."""
        from .keys import PublicKey
        from .signature import Signature

        exp_size = byte_count_from_target_batch_size(len(self.entries), SECURITY_BOUND)
        exponents = []
        pks, sigs = [], []
        for pk, sig in self.entries:
            pks.append(pk)
            sigs.append(sig)
            if rng is None:
                raw = secrets.token_bytes(exp_size)
            else:
                raw = rng.fill_bytes(exp_size)
            # Fr::from_random_bytes: LE integer, always < r for <32 bytes
            exponents.append(int.from_bytes(raw, "little") % R)

        batch_pubkey = PublicKey.batch(exponents, pks)
        batch_sig = Signature.batch(exponents, sigs)
        return batch_pubkey.verify(self.message, self.extra_data, batch_sig, hash_to_g1)

    def verify_each(self, hash_to_g1):
        """Fallback loop of individual verifications (batch.rs:87-96)."""
        for pk, sig in self.entries:
            pk.verify(self.message, self.extra_data, sig, hash_to_g1)

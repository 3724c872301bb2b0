"""Exponent sizing of the strict batch verifier (the counterpart of the
JAX package's bls/batch.py, reduced to what ops/bls.py's
strict_batch_verify_device needs; reference:
crates/bls-crypto/src/bls/batch.rs:11-28)."""

import math

SECURITY_BOUND = 128


def byte_count_from_target_batch_size(size: int, target_security: int) -> int:
    """min(ceil((security + log2 n)/8), |Fr|/8) (batch.rs:20-28)."""
    log2_size = 0 if size <= 1 else math.ceil(math.log2(size))
    target_byte_count = (target_security + log2_size + 7) // 8
    field_byte_count = 253 // 8  # Fr::size_in_bits() / 8
    return min(target_byte_count, field_byte_count)

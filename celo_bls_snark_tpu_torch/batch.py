"""Re-export of bls/batch.py's exponent sizing (reference:
crates/bls-crypto/src/bls/batch.rs:11-28), kept so that the strict batch
verifier's callers keep their imports."""

from .bls.batch import SECURITY_BOUND, Batch, byte_count_from_target_batch_size

__all__ = ["SECURITY_BOUND", "Batch", "byte_count_from_target_batch_size"]

"""BLS crypto core (layer 1). Reference: crates/bls-crypto/src/.

Domain separators and error types mirror crates/bls-crypto/src/lib.rs:75-113.
"""

from .keys import PrivateKey, PublicKey
from .signature import Signature
from .batch import Batch, byte_count_from_target_batch_size
from .cache import PublicKeyCache

SIG_DOMAIN = b"ULforxof"
POP_DOMAIN = b"ULforpop"
OUT_DOMAIN = b"ULforout"


class BLSError(Exception):
    pass


class VerificationFailed(BLSError):
    pass


class UnevenNumKeysMessages(BLSError):
    pass


__all__ = [
    "PrivateKey",
    "PublicKey",
    "Signature",
    "Batch",
    "PublicKeyCache",
    "byte_count_from_target_batch_size",
    "SIG_DOMAIN",
    "POP_DOMAIN",
    "OUT_DOMAIN",
    "BLSError",
    "VerificationFailed",
    "UnevenNumKeysMessages",
]

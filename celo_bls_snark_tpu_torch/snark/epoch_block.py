"""Epoch block model + canonical encodings.

Bit-exact parity with crates/epoch-snark/src/epoch_block.rs (golden hex
encodings pinned in tests/test_epoch_block.py):
  - EpochBlock / EpochTransition data model
  - inner / first-epoch / last-epoch bit encodings (CIP22), pre-Donut
    encoding, generator-pubkey padding up to maximum_validators
  - hash_to_g1_cip22, blake2 first/last hashing with OUT_DOMAIN,
    hash_first_last_epoch_block
"""

import hashlib
from dataclasses import dataclass, field
from typing import Optional

from ..bls import PublicKey, Signature, OUT_DOMAIN, SIG_DOMAIN
from ..bls.keys import PublicKey as _PK
from ..hostmath.params import G2_GENERATOR
from ..hash_to_curve import composite_hash_to_g1_cip22
from ..utils.bits import bits_be_to_bytes_le, bytes_le_to_bits_le
from .encoding import EncodingError, encode_public_key, encode_u8, encode_u16, encode_u32

ENTROPY_BYTES = 16


@dataclass
class EpochBlock:
    index: int                     # u16
    round: int                     # u8
    epoch_entropy: Optional[bytes]
    parent_entropy: Optional[bytes]
    maximum_non_signers: int       # u32
    maximum_validators: int
    new_public_keys: list          # list[PublicKey]

    # --- hashing ----------------------------------------------------------
    def hash_to_g1_cip22(self):
        inner, extra = self.encode_inner_to_bytes_cip22()
        return composite_hash_to_g1_cip22().hash(SIG_DOMAIN, inner, extra)

    def blake2_first_epoch_cip22(self):
        return hash_to_bits(self.encode_first_epoch_to_bytes_cip22())

    def blake2_last_epoch_with_aggregated_pk_cip22(self):
        return hash_to_bits(self.encode_last_epoch_to_bytes_with_aggregated_pk_cip22())

    @staticmethod
    def padding_pk() -> PublicKey:
        return PublicKey(G2_GENERATOR)

    # --- encodings ----------------------------------------------------------
    def encode_to_bits(self):
        """Pre-Donut encoding (epoch_block.rs:106-114)."""
        bits = []
        bits += encode_u16(self.index)
        bits += encode_u32(self.maximum_non_signers)
        for pk in self.new_public_keys:
            bits += encode_public_key(pk)
        return bits

    @staticmethod
    def encode_entropy_cip22(entropy: Optional[bytes]):
        data = entropy if entropy is not None else bytes(ENTROPY_BYTES * 8)
        return bytes_le_to_bits_le(data, ENTROPY_BYTES * 8)

    def _padded_pubkey_bits(self):
        bits = []
        for pk in self.new_public_keys:
            bits += encode_public_key(pk)
        if self.maximum_validators > len(self.new_public_keys):
            pad = encode_public_key(self.padding_pk())
            for _ in range(self.maximum_validators - len(self.new_public_keys)):
                bits += pad
        return bits

    def encode_to_bits_cip22(self, epoch_type: str):
        """epoch_type: 'first' | 'last' (epoch_block.rs:117-140)."""
        bits = []
        bits += encode_u16(self.index)
        if epoch_type == "first":
            bits += self.encode_entropy_cip22(self.parent_entropy)
        else:
            bits += self.encode_entropy_cip22(self.epoch_entropy)
        bits += encode_u32(self.maximum_non_signers)
        bits += self._padded_pubkey_bits()
        return bits

    def encode_inner_to_bits_cip22(self):
        """(epoch_bits, extra_data_bits) (epoch_block.rs:152-171)."""
        extra = []
        extra += encode_u16(self.index)
        extra += encode_u8(self.round)
        extra += encode_u32(self.maximum_non_signers)
        bits = []
        bits += self.encode_entropy_cip22(self.epoch_entropy)
        bits += self.encode_entropy_cip22(self.parent_entropy)
        bits += self._padded_pubkey_bits()
        return bits, extra

    def encode_last_epoch_to_bits_with_aggregated_pk_cip22(self):
        bits = self.encode_to_bits_cip22("last")
        apk = PublicKey.aggregate(self.new_public_keys)
        bits += encode_public_key(apk)
        return bits

    # --- byte encodings -----------------------------------------------------
    def encode_first_epoch_to_bytes_cip22(self) -> bytes:
        return bits_be_to_bytes_le(self.encode_to_bits_cip22("first"))

    def encode_to_bytes(self) -> bytes:
        return bits_be_to_bytes_le(self.encode_to_bits())

    def encode_last_epoch_to_bytes_with_aggregated_pk_cip22(self) -> bytes:
        return bits_be_to_bytes_le(
            self.encode_last_epoch_to_bits_with_aggregated_pk_cip22()
        )

    def encode_inner_to_bytes_cip22(self):
        inner, extra = self.encode_inner_to_bits_cip22()
        return bits_be_to_bytes_le(inner), bits_be_to_bytes_le(extra)


@dataclass
class EpochTransition:
    block: EpochBlock
    aggregate_signature: Signature
    bitmap: list  # list[bool]


def hash_to_bits(data: bytes):
    """Blake2s(OUT_DOMAIN) -> 256 LE bits (epoch_block.rs:226-236)."""
    h = hashlib.blake2s(data, digest_size=32, person=OUT_DOMAIN).digest()
    return bytes_le_to_bits_le(h, 256)


def hash_first_last_epoch_block(first: EpochBlock, last: EpochBlock):
    """512 bits: Blake2(first-encoding) || Blake2(last-encoding)
    (epoch_block.rs:216-223)."""
    return first.blake2_first_epoch_cip22() + last.blake2_last_epoch_with_aggregated_pk_cip22()

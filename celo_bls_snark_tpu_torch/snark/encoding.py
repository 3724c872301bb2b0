"""Scalar/pubkey bit encodings for the epoch SNARK.

Bit-exact parity with crates/epoch-snark/src/encoding.rs:
  - encode_public_key: 377 BE bits of x.c0 || 377 BE bits of x.c1 || the
    lexicographic y-sign bit (c1 > half or (c1 == 0 and c0 > half))
  - encode_u8/u16/u32: LE bit encodings
"""

from ..hostmath.params import P, FQ_BYTES
from ..utils.bits import bytes_le_to_bits_be


class EncodingError(Exception):
    pass


MODULUS_BITS = 377


def encode_public_key(public_key) -> list:
    """public_key: bls.PublicKey (must not be infinity)."""
    pt = public_key.pt
    if pt is None:
        raise EncodingError("cannot encode the point at infinity")
    (x0, x1), (y0, y1) = pt
    half = (P - 1) // 2
    is_over_half = y1 > half or (y1 == 0 and y0 > half)
    bits = []
    bits += bytes_le_to_bits_be(int(x0).to_bytes(FQ_BYTES, "little"), MODULUS_BITS)
    bits += bytes_le_to_bits_be(int(x1).to_bytes(FQ_BYTES, "little"), MODULUS_BITS)
    bits.append(is_over_half)
    return bits


def encode_u8(num: int) -> list:
    return [(num >> i) & 1 == 1 for i in range(8)]


def encode_u16(num: int) -> list:
    return [(num >> i) & 1 == 1 for i in range(16)]


def encode_u32(num: int) -> list:
    return [(num >> i) & 1 == 1 for i in range(32)]

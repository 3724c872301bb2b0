"""Shared candidate-bytes -> curve-point logic for try-and-increment.

Bit-exact with:
  - from_random_bytes: crates/bls-crypto/src/hash_to_curve/mod.rs:146-156
    (field-from-bytes with 2 flag bits + point decompression)
  - the `compat` feature's deployed-Celo bit extraction: sign taken from bit
    377 (0x02 of the final byte) instead of bit 383
    (crates/bls-crypto/src/hash_to_curve/try_and_increment.rs:106-120).

The Celo default build enables `compat`
(crates/bls-crypto/Cargo.toml:52-55); we default the same way.
"""

from .params import P, FQ_BYTES
from . import curves


class HashToCurveError(Exception):
    pass


def hash_length(n: int) -> int:
    """Round n bytes up to a multiple of 256 bits, in bytes
    (crates/bls-crypto/src/hash_to_curve/mod.rs:70-74)."""
    bits = n * 8
    rounded = ((bits + 255) // 256) * 256
    return rounded // 8


FLAG_POSITIVE_Y = 1 << 7
FLAG_INFINITY = 1 << 6

# serialized byte sizes per curve group
G1_BYTES = FQ_BYTES
G2_BYTES = 2 * FQ_BYTES


def apply_compat_sign(candidate: bytes, num_bytes: int) -> bytes:
    """Move the deployed-Celo sign bit (bit 0x02 of the last byte = bit 377)
    into the standard flag position (bit 7)."""
    buf = bytearray(candidate[:num_bytes])
    positive_flag = (buf[num_bytes - 1] & 2) != 0
    if positive_flag:
        buf[num_bytes - 1] |= FLAG_POSITIVE_Y
    else:
        buf[num_bytes - 1] &= (~FLAG_POSITIVE_Y) & 0xFF
    return bytes(buf)


def _fq_from_random_bytes_with_flags(b48: bytes):
    """ark-ff Fp::from_random_bytes_with_flags: flags = top 2 bits of the last
    byte; the value keeps only MODULUS_BITS (377) bits; None if >= p."""
    last = b48[-1]
    greatest = bool(last & FLAG_POSITIVE_Y)
    infinity = bool(last & FLAG_INFINITY)
    v = int.from_bytes(b48, "little")
    v &= (1 << 377) - 1  # REPR_SHAVE_BITS mask
    if v >= P:
        return None
    return v, greatest, infinity


def g1_from_random_bytes(b: bytes):
    """Candidate bytes -> G1 affine point (None if invalid)."""
    res = _fq_from_random_bytes_with_flags(b[:G1_BYTES])
    if res is None:
        return None
    x, greatest, infinity = res
    if x == 0 and infinity:
        return "infinity"
    return curves.G1.get_point_from_x(x, greatest)


def g2_from_random_bytes(b: bytes):
    """Candidate bytes -> G2 affine point (None if invalid).

    ark-ff QuadExtField::from_random_bytes_with_flags: c0 from the first half
    (no flags, but same 377-bit mask), c1 + flags from the second half.
    """
    # c0 has no flag bits in arkworks (EmptyFlags); only the 377-bit mask applies.
    v0 = int.from_bytes(b[:FQ_BYTES], "little") & ((1 << 377) - 1)
    if v0 >= P:
        return None
    res = _fq_from_random_bytes_with_flags(b[FQ_BYTES : 2 * FQ_BYTES])
    if res is None:
        return None
    v1, greatest, infinity = res
    x = (v0, v1)
    if x == (0, 0) and infinity:
        return "infinity"
    return curves.G2.get_point_from_x(x, greatest)

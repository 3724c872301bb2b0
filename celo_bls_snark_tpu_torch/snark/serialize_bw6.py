"""arkworks-compatible serialization for BW6-761 points and Groth16 objects.

Formats (ark-serialize 0.3 semantics, as consumed by
crates/bls-snark-sys/src/snark/mod.rs):
  - Fq761: 96 LE bytes
  - G1/G2 compressed: x with flag bits in the final byte
    (bit 7 = y lexicographically greatest, bit 6 = infinity)
  - Proof<BW6_761>: a (G1) || b (G2) || c (G1), compressed
  - VerifyingKey<BW6_761>: alpha_g1 || beta_g2 || gamma_g2 || delta_g2 ||
    u64-LE count || gamma_abc entries, compressed
"""

from ..hostmath.params import BW6_P as Q, P as R_BW6
from ..hostmath import bw6
from .groth16 import Proof, VerifyingKey

FQ_BYTES = 96
FLAG_GREATEST = 1 << 7
FLAG_INFINITY = 1 << 6


class SerializationError(Exception):
    pass


def _fq_to_bytes(v):
    return int(v % Q).to_bytes(FQ_BYTES, "little")


def point_to_bytes(pt) -> bytes:
    if pt is None:
        buf = bytearray(FQ_BYTES)
        buf[-1] |= FLAG_INFINITY
        return bytes(buf)
    x, y = pt
    buf = bytearray(_fq_to_bytes(x))
    if y > (Q - 1) // 2:
        buf[-1] |= FLAG_GREATEST
    return bytes(buf)


def point_from_bytes(data: bytes, curve, validate=True):
    if len(data) != FQ_BYTES:
        raise SerializationError(f"expected {FQ_BYTES} bytes, got {len(data)}")
    buf = bytearray(data)
    greatest = bool(buf[-1] & FLAG_GREATEST)
    infinity = bool(buf[-1] & FLAG_INFINITY)
    buf[-1] &= ~(FLAG_GREATEST | FLAG_INFINITY) & 0xFF
    x = int.from_bytes(bytes(buf), "little")
    if x >= Q:
        raise SerializationError("x out of range")
    if infinity:
        if x != 0:
            raise SerializationError("infinity with nonzero x")
        return None
    pt = curve.get_point_from_x(x, greatest)
    if pt is None:
        raise SerializationError("x not on curve")
    if validate:
        if curve.mul(R_BW6, pt) is not None:
            raise SerializationError("point not in the prime-order subgroup")
    return pt


def point_to_bytes_uncompressed(pt) -> bytes:
    """ark-serialize 0.3 uncompressed SW affine: x || y LE, flags in the
    final byte of y (infinity only)."""
    if pt is None:
        buf = bytearray(2 * FQ_BYTES)
        buf[-1] |= FLAG_INFINITY
        return bytes(buf)
    x, y = pt
    return _fq_to_bytes(x) + _fq_to_bytes(y)


def point_from_bytes_uncompressed(data: bytes, curve, validate=True):
    if len(data) != 2 * FQ_BYTES:
        raise SerializationError("bad uncompressed point length")
    buf = bytearray(data)
    infinity = bool(buf[-1] & FLAG_INFINITY)
    buf[-1] &= ~(FLAG_GREATEST | FLAG_INFINITY) & 0xFF
    x = int.from_bytes(bytes(buf[:FQ_BYTES]), "little")
    y = int.from_bytes(bytes(buf[FQ_BYTES:]), "little")
    if infinity:
        if x or y:
            raise SerializationError("infinity with nonzero coords")
        return None
    if x >= Q or y >= Q:
        raise SerializationError("coordinate out of range")
    if validate:
        if (y * y - (x * x % Q * x + curve.b)) % Q:
            raise SerializationError("point not on curve")
    return (x, y)


def proof_from_bytes(data: bytes, validate=True) -> Proof:
    if len(data) != 3 * FQ_BYTES:
        raise SerializationError("bad proof length")
    a = point_from_bytes(data[:FQ_BYTES], bw6.G1, validate)
    b = point_from_bytes(data[FQ_BYTES : 2 * FQ_BYTES], bw6.G2, validate)
    c = point_from_bytes(data[2 * FQ_BYTES :], bw6.G1, validate)
    return Proof(a=a, b=b, c=c)


def proof_to_bytes(proof: Proof) -> bytes:
    return (
        point_to_bytes(proof.a) + point_to_bytes(proof.b) + point_to_bytes(proof.c)
    )


def vk_from_bytes(data: bytes, validate=True) -> VerifyingKey:
    off = 0

    def take(n):
        nonlocal off
        chunk = data[off : off + n]
        if len(chunk) != n:
            raise SerializationError("truncated verifying key")
        off += n
        return chunk

    alpha_g1 = point_from_bytes(take(FQ_BYTES), bw6.G1, validate)
    beta_g2 = point_from_bytes(take(FQ_BYTES), bw6.G2, validate)
    gamma_g2 = point_from_bytes(take(FQ_BYTES), bw6.G2, validate)
    delta_g2 = point_from_bytes(take(FQ_BYTES), bw6.G2, validate)
    n = int.from_bytes(take(8), "little")
    gamma_abc = [point_from_bytes(take(FQ_BYTES), bw6.G1, validate) for _ in range(n)]
    if off != len(data):
        raise SerializationError("trailing bytes in verifying key")
    return VerifyingKey(
        alpha_g1=alpha_g1,
        beta_g2=beta_g2,
        gamma_g2=gamma_g2,
        delta_g2=delta_g2,
        gamma_abc_g1=gamma_abc,
    )


def vk_to_bytes(vk: VerifyingKey) -> bytes:
    out = (
        point_to_bytes(vk.alpha_g1)
        + point_to_bytes(vk.beta_g2)
        + point_to_bytes(vk.gamma_g2)
        + point_to_bytes(vk.delta_g2)
        + len(vk.gamma_abc_g1).to_bytes(8, "little")
    )
    for p in vk.gamma_abc_g1:
        out += point_to_bytes(p)
    return out

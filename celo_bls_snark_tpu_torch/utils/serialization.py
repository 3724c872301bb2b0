"""arkworks-compatible (de)serialization for BLS12-377 field/group elements.

Bit-exact with ark-serialize as used by the reference:
  - LE byte order for field elements.
  - Compressed points: x with 2 flag bits in the top of the final byte:
    bit 7 = y is lexicographically "greatest" (PositiveY), bit 6 = infinity.
    (reference mirrors this in its own YSignFlags:
     crates/bls-crypto/src/hash_to_curve/mod.rs:118-144)
  - Uncompressed: x || y, with the infinity flag on y's final byte.
  - G2/Fq2: c0 || c1, flags on c1's final byte.
  - Deserialize performs on-curve + prime-subgroup checks like arkworks.
"""

from ..hostmath.params import P, R, FQ_BYTES, FR_BYTES
from ..hostmath import fp, fp2, curves


class SerializationError(Exception):
    pass


# --- field elements -------------------------------------------------------

def fq_to_bytes(a: int) -> bytes:
    return int(a % P).to_bytes(FQ_BYTES, "little")


def fq_from_bytes(b: bytes) -> int:
    if len(b) != FQ_BYTES:
        raise SerializationError(f"Fq needs {FQ_BYTES} bytes, got {len(b)}")
    v = int.from_bytes(b, "little")
    if v >= P:
        raise SerializationError("Fq value out of range")
    return v


def fr_to_bytes(a: int) -> bytes:
    return int(a % R).to_bytes(FR_BYTES, "little")


def fr_from_bytes(b: bytes) -> int:
    if len(b) != FR_BYTES:
        raise SerializationError(f"Fr needs {FR_BYTES} bytes, got {len(b)}")
    v = int.from_bytes(b, "little")
    if v >= R:
        raise SerializationError("Fr value out of range")
    return v


def fq2_to_bytes(a) -> bytes:
    return fq_to_bytes(a[0]) + fq_to_bytes(a[1])


# --- flags ----------------------------------------------------------------

FLAG_POSITIVE_Y = 1 << 7
FLAG_INFINITY = 1 << 6


def _apply_flags(buf: bytearray, greatest: bool, infinity: bool):
    if greatest:
        buf[-1] |= FLAG_POSITIVE_Y
    if infinity:
        buf[-1] |= FLAG_INFINITY


def _split_flags(last_byte: int):
    return bool(last_byte & FLAG_POSITIVE_Y), bool(last_byte & FLAG_INFINITY)


# --- G1 -------------------------------------------------------------------

def g1_to_bytes(pt, compressed=True) -> bytes:
    if pt is None:
        if compressed:
            buf = bytearray(fq_to_bytes(0))
            _apply_flags(buf, False, True)
            return bytes(buf)
        buf = bytearray(fq_to_bytes(0) + fq_to_bytes(0))
        _apply_flags(buf, False, True)
        return bytes(buf)
    x, y = pt
    if compressed:
        buf = bytearray(fq_to_bytes(x))
        _apply_flags(buf, fp.is_greatest(y, P), False)
        return bytes(buf)
    return fq_to_bytes(x) + fq_to_bytes(y)


def g1_from_bytes(b: bytes, compressed=True, validate=True):
    if compressed:
        if len(b) != FQ_BYTES:
            raise SerializationError("bad G1 compressed length")
        buf = bytearray(b)
        greatest, infinity = _split_flags(buf[-1])
        buf[-1] &= ~(FLAG_POSITIVE_Y | FLAG_INFINITY) & 0xFF
        x = fq_from_bytes(bytes(buf))
        if infinity:
            if x != 0:
                raise SerializationError("infinity with nonzero x")
            return None
        pt = curves.G1.get_point_from_x(x, greatest)
        if pt is None:
            raise SerializationError("x not on curve")
    else:
        if len(b) != 2 * FQ_BYTES:
            raise SerializationError("bad G1 uncompressed length")
        ybuf = bytearray(b[FQ_BYTES:])
        _, infinity = _split_flags(ybuf[-1])
        ybuf[-1] &= ~(FLAG_POSITIVE_Y | FLAG_INFINITY) & 0xFF
        if infinity:
            return None
        x = fq_from_bytes(b[:FQ_BYTES])
        y = fq_from_bytes(bytes(ybuf))
        pt = (x, y)
    if validate:
        if not curves.G1.is_on_curve(pt):
            raise SerializationError("point not on curve")
        if curves.G1.mul(R, pt) is not None:
            raise SerializationError("point not in prime subgroup")
    return pt


# --- G2 -------------------------------------------------------------------

def g2_to_bytes(pt, compressed=True) -> bytes:
    if pt is None:
        if compressed:
            buf = bytearray(fq2_to_bytes(fp2.ZERO))
            _apply_flags(buf, False, True)
            return bytes(buf)
        buf = bytearray(fq2_to_bytes(fp2.ZERO) * 2)
        _apply_flags(buf, False, True)
        return bytes(buf)
    x, y = pt
    if compressed:
        buf = bytearray(fq2_to_bytes(x))
        _apply_flags(buf, fp2.is_greatest(y), False)
        return bytes(buf)
    return fq2_to_bytes(x) + fq2_to_bytes(y)


def g2_from_bytes(b: bytes, compressed=True, validate=True):
    if compressed:
        if len(b) != 2 * FQ_BYTES:
            raise SerializationError("bad G2 compressed length")
        buf = bytearray(b)
        greatest, infinity = _split_flags(buf[-1])
        buf[-1] &= ~(FLAG_POSITIVE_Y | FLAG_INFINITY) & 0xFF
        x = (fq_from_bytes(bytes(buf[:FQ_BYTES])), fq_from_bytes(bytes(buf[FQ_BYTES:])))
        if infinity:
            if not fp2.is_zero(x):
                raise SerializationError("infinity with nonzero x")
            return None
        pt = curves.G2.get_point_from_x(x, greatest)
        if pt is None:
            raise SerializationError("x not on curve")
    else:
        if len(b) != 4 * FQ_BYTES:
            raise SerializationError("bad G2 uncompressed length")
        ybuf = bytearray(b[2 * FQ_BYTES:])
        _, infinity = _split_flags(ybuf[-1])
        ybuf[-1] &= ~(FLAG_POSITIVE_Y | FLAG_INFINITY) & 0xFF
        if infinity:
            return None
        x = (fq_from_bytes(b[:FQ_BYTES]), fq_from_bytes(b[FQ_BYTES : 2 * FQ_BYTES]))
        y = (fq_from_bytes(bytes(ybuf[:FQ_BYTES])), fq_from_bytes(bytes(ybuf[FQ_BYTES:])))
        pt = (x, y)
    if validate:
        if not curves.G2.is_on_curve(pt):
            raise SerializationError("point not on curve")
        if curves.G2.mul(R, pt) is not None:
            raise SerializationError("point not in prime subgroup")
    return pt

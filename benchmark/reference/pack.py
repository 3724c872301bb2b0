"""Points into the card's data layout, with numpy alone.

The program takes a field element of BLS12-377's base field as 25 limbs
of 16 bits in Montgomery form (x 2^400 mod p), canonical, as int32, one
column a lane: [25, B]. A G1 point in projective coordinates is (X, Y, Z);
a G2 point's coordinates are pairs (c0, c1) over Fq2. Affine points here
pack with Z = 1; no input is the point at infinity.
"""

import numpy as np

from .params import P

N_LIMBS = 25
MONT_R = (1 << (16 * N_LIMBS)) % P


def fq(values) -> np.ndarray:
    """Ints in [0, p) -> [25, B] int32 Montgomery limbs."""
    buf = b"".join((int(v) * MONT_R % P).to_bytes(2 * N_LIMBS, "little") for v in values)
    return np.frombuffer(buf, dtype="<u2").reshape(-1, N_LIMBS).T.astype(np.int32)


def g1_affine(points):
    """[(x, y)] -> (x, y) limb arrays."""
    return (fq(p[0] for p in points), fq(p[1] for p in points))


def g1_projective(points):
    """[(x, y)] -> (X, Y, Z) limb arrays, Z = 1."""
    return (*g1_affine(points), fq(1 for _ in points))


def g2_affine(points):
    """[((x0, x1), (y0, y1))] -> ((x0, x1), (y0, y1)) limb arrays."""
    return ((fq(p[0][0] for p in points), fq(p[0][1] for p in points)),
            (fq(p[1][0] for p in points), fq(p[1][1] for p in points)))


def g2_projective(points):
    """[((x0, x1), (y0, y1))] -> (X, Y, Z) pairs of limb arrays, Z = (1, 0)."""
    return (*g2_affine(points), (fq(1 for _ in points), fq(0 for _ in points)))


def window_digits(scalars, nbits: int, c: int) -> np.ndarray:
    """[ceil(nbits / c), B] int32 base-2^c digits, most significant first."""
    nw = (nbits + c - 1) // c
    mask = (1 << c) - 1
    return np.array([[(int(s) >> (c * w)) & mask for s in scalars]
                     for w in reversed(range(nw))], dtype=np.int32)

"""Sums and multi-scalar multiplications on the copied curves, in Jacobian
coordinates (one affine conversion a result)."""

from . import curves
from .params import P

G1 = curves.G1
G2 = curves.G2
# a primitive cube root of unity in Fp: (x, y) -> (OMEGA x, y) maps G1 onto
# itself, an automorphism of order 3 that commutes with every scalar multiple
OMEGA = next(w for w in (pow(g, (P - 1) // 3, P) for g in range(2, 64)) if w != 1)


def endo(point, e: int):
    """The automorphism applied e times to an affine G1 point (None is
    infinity)."""
    if point is None:
        return None
    return pow(OMEGA, e, P) * point[0] % P, point[1]


def msum(curve, points):
    """Sum of affine points (None is infinity)."""
    acc = curve.to_jac(None)
    for p in points:
        acc = curve.jac_add(acc, curve.to_jac(p))
    return curve.from_jac(acc)


def weighted_sum(curve, points, counts):
    """sum_i counts[i] * points[i], counts of either sign: the points of one
    count summed first, then one scalar multiplication a distinct count."""
    by_count = {}
    for p, c in zip(points, counts):
        c = int(c)
        if c < 0:
            p, c = curve.neg(p), -c
        if c:
            by_count.setdefault(c, []).append(p)
    acc = None
    for c, pts in by_count.items():
        acc = curve.add(acc, curve.mul(c, msum(curve, pts)))
    return acc


def msm(curve, scalars, points, c: int = 4):
    """sum_i scalars[i] * points[i] by Straus: one table of 2^c - 1
    multiples a point, one shared run of doublings."""
    tables = []
    for p in points:
        row = [None, curve.to_jac(p)]
        for _ in range(2, 1 << c):
            row.append(curve.jac_add(row[-1], row[1]))
        tables.append(row)
    nbits = max((int(s).bit_length() for s in scalars), default=0)
    mask = (1 << c) - 1
    acc = curve.to_jac(None)
    for w in reversed(range((nbits + c - 1) // c)):
        for _ in range(c):
            acc = curve.jac_double(acc)
        for s, row in zip(scalars, tables):
            d = (int(s) >> (w * c)) & mask
            if d:
                acc = curve.jac_add(acc, row[d])
    return curve.from_jac(acc)


def multiples(points, n):
    """rows[k - 1][j] = k * points[j] for k = 1 .. n, affine G1 points, by
    adding points[j] to the row before (a doubling for k = 2), with one
    field inversion a row for all j. No point may have order under n + 1."""
    rows = [list(points)]
    for k in range(2, n + 1):
        cur = rows[-1]
        dens = [2 * y % P if k == 2 else (x - bx) % P
                for (x, y), (bx, _by) in zip(cur, points)]
        prefix = [1]
        for d in dens:
            prefix.append(prefix[-1] * d % P)
        inv = pow(prefix[-1], P - 2, P)
        invs = [0] * len(dens)
        for i in reversed(range(len(dens))):
            invs[i] = inv * prefix[i] % P
            inv = inv * dens[i] % P
        nxt = []
        for (x, y), (bx, by), iv in zip(cur, points, invs):
            lam = (3 * x * x if k == 2 else y - by) * iv % P
            x3 = (lam * lam - x - bx) % P
            nxt.append((x3, (lam * (x - x3) - y) % P))
        rows.append(nxt)
    return rows

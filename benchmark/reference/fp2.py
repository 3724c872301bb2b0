"""Fq2 = Fq[u]/(u^2 + 5) arithmetic for BLS12-377 (tuples of ints).

Nonresidue is -5 (u^2 = -5). Ord/lexicographic comparisons mirror arkworks'
QuadExtField Ord (c1 first, then c0), which defines the G2 compressed-point
sign bit (reference: crates/bls-gadgets/src/y_to_bit.rs:44-87 semantics).
"""

from .params import P
from . import fp

ZERO = (0, 0)
ONE = (1, 0)


def add(a, b):
    return ((a[0] + b[0]) % P, (a[1] + b[1]) % P)


def sub(a, b):
    return ((a[0] - b[0]) % P, (a[1] - b[1]) % P)


def neg(a):
    return ((-a[0]) % P, (-a[1]) % P)


def mul(a, b):
    a0, a1 = a
    b0, b1 = b
    return ((a0 * b0 - 5 * a1 * b1) % P, (a0 * b1 + a1 * b0) % P)


def smul(k, a):
    return (k * a[0] % P, k * a[1] % P)


def fmul(c, a):
    """Multiply by an Fq scalar c."""
    return (c * a[0] % P, c * a[1] % P)


def sq(a):
    a0, a1 = a
    # (a0 + a1 u)^2 = a0^2 - 5 a1^2 + 2 a0 a1 u
    return ((a0 * a0 - 5 * a1 * a1) % P, (2 * a0 * a1) % P)


def inv(a):
    a0, a1 = a
    # norm = a0^2 + 5 a1^2
    n = (a0 * a0 + 5 * a1 * a1) % P
    ninv = pow(n, -1, P)
    return (a0 * ninv % P, (-a1) * ninv % P)


def conj(a):
    return (a[0], (-a[1]) % P)


def pow_(a, e: int):
    result = ONE
    base = a
    while e > 0:
        if e & 1:
            result = mul(result, base)
        base = sq(base)
        e >>= 1
    return result


def is_zero(a):
    return a[0] == 0 and a[1] == 0


def sqrt(a):
    """Square root in Fq2 via the complex method; None if non-residue.

    For u^2 = -5: given a = a0 + a1*u, find x = x0 + x1*u with x^2 = a.
    Uses the standard norm trick: |a| = a0^2 + 5*a1^2 must be a QR in Fq,
    alpha = sqrt(|a|); then x0^2 = (a0 + alpha)/2 (or with -alpha).
    """
    a0, a1 = a
    if a1 == 0:
        # sqrt of base-field element: either sqrt(a0) in Fq, or sqrt(-a0/5)*u
        s = fp.sqrt(a0, P)
        if s is not None:
            return (s, 0)
        s = fp.sqrt(a0 * pow(-5 % P, -1, P) % P, P)
        if s is None:
            return None
        return (0, s)
    n = (a0 * a0 + 5 * a1 * a1) % P
    alpha = fp.sqrt(n, P)
    if alpha is None:
        return None
    inv2 = pow(2, -1, P)
    delta = (a0 + alpha) * inv2 % P
    x0 = fp.sqrt(delta, P)
    if x0 is None:
        delta = (a0 - alpha) * inv2 % P
        x0 = fp.sqrt(delta, P)
        if x0 is None:
            return None
    x1 = a1 * pow(2 * x0 % P, -1, P) % P
    res = (x0, x1)
    assert sq(res) == (a0 % P, a1 % P)
    return res


def is_greatest(a) -> bool:
    """Lexicographic a > -a: compare c1 first, then c0 (arkworks Fq2 Ord)."""
    c0, c1 = a
    if c1 != 0:
        return fp.is_greatest(c1, P)
    if c0 == 0:
        return False
    return fp.is_greatest(c0, P)


def cmp(a, b) -> int:
    """arkworks QuadExtField Ord: (c1, c0) lexicographic."""
    if a[1] != b[1]:
        return -1 if a[1] < b[1] else 1
    if a[0] != b[0]:
        return -1 if a[0] < b[0] else 1
    return 0

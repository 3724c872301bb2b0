"""Prime-field arithmetic on plain Python integers.

This is the host-side "native" oracle: the slow, obviously-correct model that
the batched device kernels (ops/) are cross-validated against,
mirroring the role arkworks' ark-ff plays for the Rust reference
(SURVEY.md section 4, "gadget <-> native cross-validation").
"""

from functools import lru_cache


def inv(a: int, p: int) -> int:
    return pow(a, -1, p)


def legendre(a: int, p: int) -> int:
    """1 if QR, p-1 if QNR, 0 if zero (as a field exponentiation result)."""
    return pow(a, (p - 1) // 2, p)


@lru_cache(maxsize=None)
def _sqrt_precomp(p: int):
    """Tonelli-Shanks precomputation: (s, t, z^t) with p-1 = 2^s * t, z a QNR."""
    t = p - 1
    s = 0
    while t % 2 == 0:
        t //= 2
        s += 1
    z = 2
    while legendre(z, p) != p - 1:
        z += 1
    return s, t, pow(z, t, p)


def sqrt(a: int, p: int):
    """Tonelli-Shanks square root; returns None if `a` is a non-residue.

    Which of the two roots is returned is unspecified: all call sites
    normalize via the lexicographic "greatest" rule, matching arkworks'
    get_point_from_x (reference: hash_to_curve/mod.rs:146-156 usage).
    """
    a %= p
    if a == 0:
        return 0
    if legendre(a, p) != 1:
        return None
    s, t, c0 = _sqrt_precomp(p)
    c = c0
    x = pow(a, (t + 1) // 2, p)
    b = pow(a, t, p)
    m = s
    while b != 1:
        # find least i with b^(2^i) == 1
        i = 0
        t2 = b
        while t2 != 1:
            t2 = t2 * t2 % p
            i += 1
        e = pow(c, 1 << (m - i - 1), p)
        x = x * e % p
        c = e * e % p
        b = b * c % p
        m = i
    return x


def is_greatest(a: int, p: int) -> bool:
    """arkworks lexicographic sign: a > -a, i.e. a > (p-1)/2 (a != 0)."""
    return a > (p - 1) // 2

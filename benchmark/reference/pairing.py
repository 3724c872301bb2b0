"""Optimal-ate pairing for BLS12-377, host oracle.

e(P in G1, Q in G2) with the D-type sextic twist: E': y^2 = x^3 + 1/u over Fq2,
untwist (x', y') -> (w^2 x', w^3 y') into Fq12 (w^2 = v, v^3 = u).

Semantics mirror arkworks' `Bls12_377::product_of_pairings` as used by the
reference's verification paths (crates/bls-crypto/src/bls/public.rs:102-115,
signature.rs:125-155): a shared Miller loop product followed by one final
exponentiation.
"""

from .params import P, R, X
from . import fp2, fq12

_X_BITS = bin(X)[2:]  # MSB first

# exponent of the "hard part": (p^4 - p^2 + 1) / r
_HARD_EXP = (P**4 - P**2 + 1) // R
assert (P**4 - P**2 + 1) % R == 0


def _line_dbl(t, p_aff):
    """Double T (affine on twist, Fq2) and return (2T, line eval at P).

    Line evaluated at the untwisted points gives the sparse Fq12 element
      (a, b) with a = (yP, 0, 0), b = (-lambda * xP, lambda * xT' - yT', 0)
    where lambda is the tangent slope on the twist and (xT', yT') = 2T... the
    line is through T so we use T's coordinates.
    """
    (xt, yt) = t
    xp, yp = p_aff
    # lambda = 3 xt^2 / (2 yt)
    lam = fp2.mul(fp2.smul(3, fp2.sq(xt)), fp2.inv(fp2.smul(2, yt)))
    x3 = fp2.sub(fp2.sq(lam), fp2.smul(2, xt))
    y3 = fp2.sub(fp2.mul(lam, fp2.sub(xt, x3)), yt)
    # line: l(P) = yP - lam*w*(xP) + (lam*xt - yt) * w^3
    a = ((yp % P, 0), fp2.ZERO, fp2.ZERO)
    b = (fp2.fmul((-xp) % P, lam), fp2.sub(fp2.mul(lam, xt), yt), fp2.ZERO)
    return (x3, y3), (a, b)


def _line_add(t, q, p_aff):
    """Add Q to T (both affine on twist) and return (T+Q, line eval at P)."""
    (xt, yt) = t
    (xq, yq) = q
    xp, yp = p_aff
    lam = fp2.mul(fp2.sub(yq, yt), fp2.inv(fp2.sub(xq, xt)))
    x3 = fp2.sub(fp2.sub(fp2.sq(lam), xt), xq)
    y3 = fp2.sub(fp2.mul(lam, fp2.sub(xt, x3)), yt)
    a = ((yp % P, 0), fp2.ZERO, fp2.ZERO)
    b = (fp2.fmul((-xp) % P, lam), fp2.sub(fp2.mul(lam, xt), yt), fp2.ZERO)
    return (x3, y3), (a, b)


def miller_loop(pairs):
    """Product of Miller loops over [(P_g1_affine, Q_g2_affine), ...].

    Points at infinity (None) are skipped, matching arkworks which filters
    zero elements before pairing.
    """
    pairs = [(p, q) for (p, q) in pairs if p is not None and q is not None]
    if not pairs:
        return fq12.F12_ONE
    ts = [q for (_, q) in pairs]
    f = fq12.F12_ONE
    first = True
    for bit in _X_BITS[1:]:
        if not first:
            f = fq12.sq(f)
        first = False
        for i, (p_aff, q) in enumerate(pairs):
            ts[i], line = _line_dbl(ts[i], p_aff)
            f = fq12.mul(f, line)
        if bit == "1":
            for i, (p_aff, q) in enumerate(pairs):
                ts[i], line = _line_add(ts[i], q, p_aff)
                f = fq12.mul(f, line)
    return f


def final_exponentiation(f):
    """f^((p^12-1)/r): easy part explicitly, hard part by plain exponentiation
    (host oracle favors obviousness; the device code uses the cyclotomic
    addition chain)."""
    # easy: f^(p^6 - 1)
    f = fq12.mul(fq12.conj(f), fq12.inv(f))
    # easy: f^(p^2 + 1)
    f = fq12.mul(fq12.frob_n(f, 2), f)
    # hard: f^((p^4 - p^2 + 1)/r)
    return fq12.pow_(f, _HARD_EXP)


def final_exponentiation_3d(f):
    """f^(3*(p^12-1)/r) via the addition chain the device kernels use:
    hard exponent 3*(p^4-p^2+1)/r = (x-1)^2 (x+p) (x^2+p^2-1) + 3.
    The cofactor 3 (coprime to r) does not affect ==1 checks; this is the
    oracle for ops/pairing.py::final_exponentiation."""
    f = fq12.mul(fq12.conj(f), fq12.inv(f))
    f = fq12.mul(fq12.frob_n(f, 2), f)
    m = f
    t0 = fq12.pow_(fq12.pow_(m, X - 1), X - 1)
    t1 = fq12.mul(fq12.pow_(t0, X), fq12.frob(t0))
    t2 = fq12.mul(
        fq12.mul(fq12.pow_(fq12.pow_(t1, X), X), fq12.frob_n(t1, 2)),
        fq12.conj(t1),
    )
    return fq12.mul(t2, fq12.mul(fq12.sq(m), m))


def pairing(p_aff, q_aff):
    return final_exponentiation(miller_loop([(p_aff, q_aff)]))


def product_of_pairings(pairs):
    """One shared final exponentiation over the product of Miller loops."""
    return final_exponentiation(miller_loop(pairs))


def pairing_check(pairs) -> bool:
    """product_of_pairings(pairs) == 1."""
    return fq12.is_one(product_of_pairings(pairs))

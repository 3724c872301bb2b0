"""Fq6 = Fq2[v]/(v^3 - u) and Fq12 = Fq6[w]/(w^2 - v) tower for BLS12-377.

Fq6 elements: 3-tuples of Fq2 elements (c0, c1, c2) = c0 + c1 v + c2 v^2.
Fq12 elements: 2-tuples of Fq6 elements (c0, c1) = c0 + c1 w.
Host oracle for the batched device pairing code (ops/pairing.py).
"""

from .params import P
from . import fp2

F6_ZERO = (fp2.ZERO, fp2.ZERO, fp2.ZERO)
F6_ONE = (fp2.ONE, fp2.ZERO, fp2.ZERO)
F12_ONE = (F6_ONE, F6_ZERO)
F12_ZERO = (F6_ZERO, F6_ZERO)

# v^3 = u  -> multiplying an Fq2 coefficient by the nonresidue means *u
def _mul_by_nonresidue(a):
    """Multiply Fq2 element by u (the Fq6 nonresidue): (a0+a1 u)*u = -5 a1 + a0 u."""
    a0, a1 = a
    return ((-5 * a1) % P, a0)


def f6_add(a, b):
    return tuple(fp2.add(x, y) for x, y in zip(a, b))


def f6_sub(a, b):
    return tuple(fp2.sub(x, y) for x, y in zip(a, b))


def f6_neg(a):
    return tuple(fp2.neg(x) for x in a)


def f6_mul(a, b):
    a0, a1, a2 = a
    b0, b1, b2 = b
    v0 = fp2.mul(a0, b0)
    v1 = fp2.mul(a1, b1)
    v2 = fp2.mul(a2, b2)
    # Karatsuba (Toom-ish) interpolation
    c0 = fp2.add(v0, _mul_by_nonresidue(fp2.sub(fp2.mul(fp2.add(a1, a2), fp2.add(b1, b2)), fp2.add(v1, v2))))
    c1 = fp2.add(fp2.sub(fp2.mul(fp2.add(a0, a1), fp2.add(b0, b1)), fp2.add(v0, v1)), _mul_by_nonresidue(v2))
    c2 = fp2.add(fp2.sub(fp2.mul(fp2.add(a0, a2), fp2.add(b0, b2)), fp2.add(v0, v2)), v1)
    return (c0, c1, c2)


def f6_sq(a):
    return f6_mul(a, a)


def f6_smul(a, s):
    """Multiply Fq6 element by an Fq2 scalar s."""
    return tuple(fp2.mul(x, s) for x in a)


def f6_mul_by_v(a):
    """(c0 + c1 v + c2 v^2) * v = c2 u + c0 v + c1 v^2."""
    a0, a1, a2 = a
    return (_mul_by_nonresidue(a2), a0, a1)


def f6_inv(a):
    a0, a1, a2 = a
    t0 = fp2.sq(a0)
    t1 = fp2.sq(a1)
    t2 = fp2.sq(a2)
    t3 = fp2.mul(a0, a1)
    t4 = fp2.mul(a0, a2)
    t5 = fp2.mul(a1, a2)
    c0 = fp2.sub(t0, _mul_by_nonresidue(t5))
    c1 = fp2.sub(_mul_by_nonresidue(t2), t3)
    c2 = fp2.sub(t1, t4)
    t6 = fp2.add(fp2.mul(a0, c0), _mul_by_nonresidue(fp2.add(fp2.mul(a2, c1), fp2.mul(a1, c2))))
    t6i = fp2.inv(t6)
    return (fp2.mul(c0, t6i), fp2.mul(c1, t6i), fp2.mul(c2, t6i))


# ---------------------------------------------------------------------------
# Fq12
# ---------------------------------------------------------------------------

def add(a, b):
    return (f6_add(a[0], b[0]), f6_add(a[1], b[1]))


def sub(a, b):
    return (f6_sub(a[0], b[0]), f6_sub(a[1], b[1]))


def mul(a, b):
    a0, a1 = a
    b0, b1 = b
    v0 = f6_mul(a0, b0)
    v1 = f6_mul(a1, b1)
    c0 = f6_add(v0, f6_mul_by_v(v1))
    c1 = f6_sub(f6_sub(f6_mul(f6_add(a0, a1), f6_add(b0, b1)), v0), v1)
    return (c0, c1)


def sq(a):
    return mul(a, a)


def inv(a):
    a0, a1 = a
    t = f6_sub(f6_sq(a0), f6_mul_by_v(f6_sq(a1)))
    ti = f6_inv(t)
    return (f6_mul(a0, ti), f6_neg(f6_mul(a1, ti)))


def conj(a):
    """a^(p^6): conjugation in w."""
    return (a[0], f6_neg(a[1]))


def pow_(a, e: int):
    result = F12_ONE
    base = a
    while e > 0:
        if e & 1:
            result = mul(result, base)
        base = sq(base)
        e >>= 1
    return result


def eq(a, b):
    return a == b


def is_one(a):
    return a == F12_ONE


# ---------------------------------------------------------------------------
# Frobenius: gamma constants computed once at import (Fq2 exponentiations)
# ---------------------------------------------------------------------------
# v^p   = v * u^((p-1)/3)        (p ≡ 1 mod 3)
# v^2p  = v^2 * u^(2(p-1)/3)
# w^p   = w * u^((p-1)/6)        (p ≡ 1 mod 6)
_U = (0, 1)
_GAMMA_V = fp2.pow_(_U, (P - 1) // 3)       # u^((p-1)/3)
_GAMMA_V2 = fp2.sq(_GAMMA_V)                # u^(2(p-1)/3)
_GAMMA_W = fp2.pow_(_U, (P - 1) // 6)       # u^((p-1)/6)


def _f6_frob(a):
    a0, a1, a2 = a
    return (
        fp2.conj(a0),
        fp2.mul(fp2.conj(a1), _GAMMA_V),
        fp2.mul(fp2.conj(a2), _GAMMA_V2),
    )


def frob(a):
    """a^p."""
    a0, a1 = a
    b1 = _f6_frob(a1)
    # multiply each Fq2 coefficient of b1 by gamma_w (an Fq2 scalar)
    b1 = f6_smul(b1, _GAMMA_W)
    return (_f6_frob(a0), b1)


def frob_n(a, n: int):
    for _ in range(n):
        a = frob(a)
    return a


# ---------------------------------------------------------------------------
# Cyclotomic structure helpers for the final exponentiation
# ---------------------------------------------------------------------------

def unitary_inv(a):
    """For elements in the cyclotomic subgroup (after the easy part),
    inverse == conjugate."""
    return conj(a)


def _fp4_sq(za, zb):
    """(za + zb y)^2 in Fq4 = Fq2[y]/(y^2 - u): returns (ta, tb) with
    ta = za^2 + u zb^2, tb = 2 za zb — 2 Fq2 muls (Karatsuba-with-nr)."""
    tmp = fp2.mul(za, zb)
    ta = fp2.sub(
        fp2.sub(
            fp2.mul(fp2.add(za, zb), fp2.add(za, _mul_by_nonresidue(zb))),
            tmp,
        ),
        _mul_by_nonresidue(tmp),
    )
    return ta, fp2.add(tmp, tmp)


def cyclotomic_sq(a):
    """Granger-Scott squaring for unitary elements (the cyclotomic subgroup
    G_{Phi12(p)}, where every post-easy-part final-exp value lives): 3 Fq4
    squarings = 6 Fq2 muls, vs 18 for the generic sq(). Oracle for the
    device kernel (ops/tower.py::f12_cyclo_sq) and the R1CS gadget
    (gadgets/ext_vars.py::Fp12Var.cyclotomic_square)."""
    (z0, z4, z3), (z2, z1, z5) = a
    t0, t1 = _fp4_sq(z0, z1)
    t2, t3 = _fp4_sq(z2, z3)
    t4, t5 = _fp4_sq(z4, z5)
    # z_i' = 3 t - (+/-) 2 z_i, signs per Granger-Scott
    r0 = fp2.add(fp2.add(fp2.sub(t0, z0), fp2.sub(t0, z0)), t0)
    r1 = fp2.add(fp2.add(fp2.add(t1, z1), fp2.add(t1, z1)), t1)
    nt5 = _mul_by_nonresidue(t5)
    r2 = fp2.add(fp2.add(fp2.add(nt5, z2), fp2.add(nt5, z2)), nt5)
    r3 = fp2.add(fp2.add(fp2.sub(t4, z3), fp2.sub(t4, z3)), t4)
    r4 = fp2.add(fp2.add(fp2.sub(t2, z4), fp2.sub(t2, z4)), t2)
    r5 = fp2.add(fp2.add(fp2.add(t3, z5), fp2.add(t3, z5)), t3)
    return ((r0, r4, r3), (r2, r1, r5))

"""In-circuit BLS12-377 pairing (the ark-r1cs-std PairingVar equivalent).

Affine Miller loop over the static X bits with witnessed divisions (an
in-circuit inversion is one constraint, so affine formulas minimize
constraint count), followed by the (x-1)^2 (x+p) (x^2+p^2-1) + 3 final-
exponentiation chain (the same cofactor-3-scaled map as ops/pairing.py —
only ==1 checks are consumed, so the cofactor is harmless).

Constraint-count parity with ark's 18,702-per-verify figure requires the
cyclotomic-squaring + sparse-line-mul optimizations (ROADMAP.md); the
current version is ~2x that but functionally equivalent.
"""

from ..hostmath.params import P, X
from ..hostmath import fp2 as hf2
from .vars import FpVar
from .ext_vars import Fp2Var, Fp6Var, Fp12Var
from .curve_vars import G1Var, G2Var

_X_BITS = bin(X)[3:]


def _line_to_fp12(cs, c_a: FpVar, c_w: Fp2Var, c_w3: Fp2Var):
    """Line value (c_a, 0, 0) + (c_w, c_w3, 0) * w as an Fp12Var."""
    z2 = Fp2Var.zero(cs)
    a = Fp6Var(Fp2Var(c_a, FpVar.const(cs, 0)), z2, z2)
    b = Fp6Var(c_w, c_w3, Fp2Var.zero(cs))
    return Fp12Var(a, b)


def miller_loop_gadget(cs, pairs):
    """Product of Miller loops over [(G1Var, G2Var), ...] (points must not
    be at infinity — the reference gadget has the same precondition)."""
    with cs.ns("miller_loop"):
        f = None
        ts = [(q.x, q.y) for (_, q) in pairs]
        for bit in _X_BITS:
            if f is not None:
                f = f.square()
            for i, (p_var, q_var) in enumerate(pairs):
                xt, yt = ts[i]
                # tangent: lam = 3 xt^2 / (2 yt)
                num = xt.mul(xt).mul_const_fp(3)
                lam = num.mul_by_inverse(yt.add(yt))
                x3 = lam.mul(lam).sub(xt).sub(xt)
                y3 = lam.mul(xt.sub(x3)).sub(yt)
                # line: yP - lam xP w + (lam xt - yt) w^3
                c_a = p_var.y
                c_w = lam.mul_fp(p_var.x.neg())
                c_w3 = lam.mul(xt).sub(yt)
                if f is None:
                    f = _line_to_fp12(cs, c_a, c_w, c_w3)
                else:
                    f = f.mul_by_sparse_line(c_a, c_w, c_w3)
                ts[i] = (x3, y3)
            if bit == "1":
                for i, (p_var, q_var) in enumerate(pairs):
                    xt, yt = ts[i]
                    lam = q_var.y.sub(yt).mul_by_inverse(q_var.x.sub(xt))
                    x3 = lam.mul(lam).sub(xt).sub(q_var.x)
                    y3 = lam.mul(xt.sub(x3)).sub(yt)
                    c_a = p_var.y
                    c_w = lam.mul_fp(p_var.x.neg())
                    c_w3 = lam.mul(xt).sub(yt)
                    f = f.mul_by_sparse_line(c_a, c_w, c_w3)
                    ts[i] = (x3, y3)
        return f


def final_exponentiation_gadget(cs, f: Fp12Var):
    """f^(3*(p^12-1)/r) via the chain (matches ops/pairing.py)."""
    with cs.ns("final_exponentiation"):
        finv = f.inverse()
        m = f.conj().mul(finv)            # ^(p^6-1)
        m = m.frobenius_n(2).mul(m)       # ^(p^2+1)
        # m is unitary from here on: cyclotomic squarings throughout
        t0 = m.cyclotomic_pow_const(X - 1).cyclotomic_pow_const(X - 1)
        t1 = t0.cyclotomic_pow_const(X).mul(t0.frobenius())
        t2 = (
            t1.cyclotomic_pow_const(X)
            .cyclotomic_pow_const(X)
            .mul(t1.frobenius_n(2))
            .mul(t1.conj())
        )
        return t2.mul(m.cyclotomic_square().mul(m))


def enforce_pairing_product_is_one(cs, pairs):
    """enforce_bls_equation core (bls.rs:222-231): product of pairings == 1."""
    f = miller_loop_gadget(cs, pairs)
    e = final_exponentiation_gadget(cs, f)
    e.enforce_equal(Fp12Var.one(cs))

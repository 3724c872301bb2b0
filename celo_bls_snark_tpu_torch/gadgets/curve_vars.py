"""In-circuit curve-point variables: G1Var (over Fp) and G2Var (over Fp2).

The ark-r1cs-std G1Var/G2Var equivalents for BLS12-377 embedded natively in
BW6-761's scalar field — consumed by the BLS verify / hash-to-group gadgets
(crates/bls-gadgets/src/{bls,hash_to_group}.rs).

Affine representation with division-based group law: in-circuit an
inversion is one witnessed constraint, so affine add/double cost ~3 base
constraints each (per coordinate field). Incomplete additions carry the
same caveat as ark's AffineVar arithmetic: adding equal-x points is
unsatisfiable — callers gate doubling paths explicitly (as the reference
gadgets do via conditional selects).
"""

from ..hostmath import curves as hc, fp2 as hf2
from ..hostmath.params import P
from ..relations.r1cs import LinearCombination
from .vars import Boolean, FpVar
from .ext_vars import Fp2Var


class _AffineCurveVar:
    """Shared affine group-law machinery. Subclasses bind the coordinate
    field variable class + host curve for witness computation."""

    FVar = None  # coordinate var class
    host = None  # host curve (witness math)

    def __init__(self, x, y, infinity: Boolean):
        self.x = x
        self.y = y
        self.infinity = infinity
        self.cs = infinity.cs

    # --- allocation -------------------------------------------------------
    @classmethod
    def new_witness(cls, cs, pt):
        """pt: host affine point or None (infinity); setup mode: pass
        `unset` sentinel via pt=... cs decides."""
        if cs.is_in_setup_mode():
            x = cls._new_coord(cs, None)
            y = cls._new_coord(cs, None)
            inf = Boolean.new_witness(cs, False)
            return cls(x, y, inf)
        if pt is None:
            x = cls._new_coord(cs, cls._zero_val())
            y = cls._new_coord(cs, cls._one_val())
            inf = Boolean.new_witness(cs, True)
        else:
            x = cls._new_coord(cs, pt[0])
            y = cls._new_coord(cs, pt[1])
            inf = Boolean.new_witness(cs, False)
        return cls(x, y, inf)

    @classmethod
    def new_witness_checked(cls, cs, pt):
        """Witness allocation WITH the on-curve check, ark's
        new_variable_omit_prime_order_check shape (r1cs-std SW AffineVar:
        infinity flag + (y^2 - x^3 - b) * (1 - infinity) == 0). Costs 5
        constraints for G1, 12 for G2 — the allocation component of the
        reference's pinned counts (y_to_bit.rs:211,251; bls.rs:401)."""
        out = cls.new_witness(cs, pt)
        not_inf = out.infinity.not_()
        x2 = out.x.square()
        x3 = x2.mul(out.x)
        y2 = out.y.square()
        d = y2.sub(x3.add(cls._b_coeff(cs)))
        cls._cond_enforce_zero(d, not_inf)
        return out

    @classmethod
    def constant(cls, cs, pt):
        assert pt is not None
        return cls(
            cls._const_coord(cs, pt[0]),
            cls._const_coord(cs, pt[1]),
            Boolean.false(cs),
        )

    def value(self):
        if self.infinity.value:
            return None
        xv = self._coord_value(self.x)
        yv = self._coord_value(self.y)
        if xv is None:
            return None
        return (xv, yv)

    # --- group law (incomplete; distinct non-infinity points) --------------
    def add_unchecked(self, o):
        """Affine chord addition: requires x != o.x (callers guarantee)."""
        num = o.y.sub(self.y)
        den = o.x.sub(self.x)
        lam = num.mul_by_inverse(den)
        x3 = lam.mul(lam).sub(self.x).sub(o.x)
        y3 = lam.mul(self.x.sub(x3)).sub(self.y)
        return type(self)(x3, y3, Boolean.false(self.cs))

    def double(self):
        """Affine tangent doubling (y != 0 in odd-order subgroups)."""
        num = self.x.mul(self.x).mul_const_scalar(3)
        den = self.y.add(self.y)
        lam = num.mul_by_inverse(den)
        x3 = lam.mul(lam).sub(self.x).sub(self.x)
        y3 = lam.mul(self.x.sub(x3)).sub(self.y)
        return type(self)(x3, y3, self.infinity)

    def neg(self):
        return type(self)(self.x, self.y.neg(), self.infinity)

    def select(self, cond: Boolean, other):
        """cond ? self : other."""
        return type(self)(
            self._cond_select(cond, self.x, other.x),
            self._cond_select(cond, self.y, other.y),
            cond.select(self.infinity, other.infinity),
        )

    def enforce_equal(self, o):
        self.x.enforce_equal(o.x)
        self.y.enforce_equal(o.y)

    def is_eq(self, o) -> Boolean:
        """Point-equality boolean (AND of coordinate equalities)."""
        eqs = self._coord_eq_bits(self.x, o.x) + self._coord_eq_bits(self.y, o.y)
        out = eqs[0]
        for e in eqs[1:]:
            out = out.and_(e)
        return out

    def conditional_enforce_not_equal(self, o, cond: Boolean):
        """cond => self != o (ark EqGadget semantics: is_eq AND cond == 0)."""
        eq_bit = self.is_eq(o)
        self.cs.enforce_constraint(eq_bit.lc(), cond.lc(), LinearCombination())


class G1Var(_AffineCurveVar):
    host = hc.G1

    @staticmethod
    def _coord_eq_bits(a, b):
        return [a.sub(b).is_eq_zero()]

    @staticmethod
    def _new_coord(cs, v):
        return FpVar.new_witness(cs, v if v is not None else 0)

    @staticmethod
    def _const_coord(cs, v):
        return FpVar.const(cs, v)

    @staticmethod
    def _zero_val():
        return 0

    @staticmethod
    def _one_val():
        return 1

    @staticmethod
    def _coord_value(c):
        return c.value

    @staticmethod
    def _cond_select(cond, t, f):
        return FpVar.conditionally_select(cond, t, f)

    @staticmethod
    def _b_coeff(cs):
        return FpVar.const(cs, hc.G1.b)

    @staticmethod
    def _cond_enforce_zero(d, cond):
        d.cs.enforce_constraint(d.lc, cond.lc(), LinearCombination())


class G2Var(_AffineCurveVar):
    host = hc.G2

    @staticmethod
    def _coord_eq_bits(a, b):
        return [a.c0.sub(b.c0).is_eq_zero(), a.c1.sub(b.c1).is_eq_zero()]

    @staticmethod
    def _new_coord(cs, v):
        return Fp2Var.new_witness(cs, v)

    @staticmethod
    def _const_coord(cs, v):
        return Fp2Var.const(cs, v)

    @staticmethod
    def _zero_val():
        return (0, 0)

    @staticmethod
    def _one_val():
        return (1, 0)

    @staticmethod
    def _coord_value(c):
        return c.value()

    @staticmethod
    def _cond_select(cond, t, f):
        return Fp2Var.conditionally_select(cond, t, f)

    @staticmethod
    def _b_coeff(cs):
        return Fp2Var.const(cs, hc.G2.b)

    @staticmethod
    def _cond_enforce_zero(d, cond):
        cs = d.cs
        cs.enforce_constraint(d.c0.lc, cond.lc(), LinearCombination())
        cs.enforce_constraint(d.c1.lc, cond.lc(), LinearCombination())


# mul_const_scalar shims (FpVar has mul_const; Fp2Var has mul_const_fp)
def _fp_mul_const_scalar(self, k):
    return self.mul_const(k)


def _fp2_mul_const_scalar(self, k):
    return self.mul_const_fp(k)


FpVar.mul_const_scalar = _fp_mul_const_scalar
Fp2Var.mul_const_scalar = _fp2_mul_const_scalar

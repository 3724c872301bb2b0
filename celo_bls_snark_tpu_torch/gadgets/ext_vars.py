"""In-circuit extension-tower variables over the native field.

Fp2Var / Fp6Var / Fp12Var for BLS12-377's tower embedded natively in
BW6-761's scalar field — the ark-r1cs-std Fp2Var/Fp12Var equivalents that
the reference's pairing/BLS gadgets consume (crates/bls-gadgets/src/bls.rs
via ark_r1cs_std PairingVar).

Structures mirror hostmath/{fp2,fq12}.py exactly; each var op costs the
ark-style constraint count (karatsuba mul = 3 base muls for Fp2, etc.).
"""

from ..hostmath import fp2 as hf2, fq12 as hf12
from ..hostmath.params import P
from .vars import Boolean, FpVar


class Fp2Var:
    """c0 + c1*u with u^2 = -5."""

    def __init__(self, c0: FpVar, c1: FpVar):
        self.c0 = c0
        self.c1 = c1
        self.cs = c0.cs

    # --- allocation -------------------------------------------------------
    @classmethod
    def new_witness(cls, cs, value):
        v0, v1 = (None, None) if value is None else value
        return cls(FpVar.new_witness(cs, v0), FpVar.new_witness(cs, v1))

    @classmethod
    def const(cls, cs, value):
        return cls(FpVar.const(cs, value[0]), FpVar.const(cs, value[1]))

    @classmethod
    def zero(cls, cs):
        return cls.const(cs, (0, 0))

    @classmethod
    def one(cls, cs):
        return cls.const(cs, (1, 0))

    def value(self):
        if self.c0.value is None:
            return None
        return (self.c0.value, self.c1.value)

    # --- linear -----------------------------------------------------------
    def add(self, o):
        return Fp2Var(self.c0.add(o.c0), self.c1.add(o.c1))

    def sub(self, o):
        return Fp2Var(self.c0.sub(o.c0), self.c1.sub(o.c1))

    def neg(self):
        return Fp2Var(self.c0.neg(), self.c1.neg())

    def conj(self):
        return Fp2Var(self.c0, self.c1.neg())

    def mul_const_fp(self, k: int):
        return Fp2Var(self.c0.mul_const(k), self.c1.mul_const(k))

    def mul_const_fp2(self, kv):
        """Multiply by a constant Fq2 element (k0, k1): linear, free."""
        k0, k1 = kv
        c0 = self.c0.mul_const(k0).sub(self.c1.mul_const(5 * k1))
        c1 = self.c0.mul_const(k1).add(self.c1.mul_const(k0))
        return Fp2Var(c0, c1)

    def mul_by_nonresidue(self):
        """* u: (-5 c1, c0)."""
        return Fp2Var(self.c1.mul_const(-5), self.c0)

    # --- multiplicative (3 constraints, karatsuba) -------------------------
    def mul(self, o):
        v0 = self.c0.mul(o.c0)
        v1 = self.c1.mul(o.c1)
        t = self.c0.add(self.c1).mul(o.c0.add(o.c1))
        return Fp2Var(v0.sub(v1.mul_const(5)), t.sub(v0.add(v1)))

    def square(self):
        v0 = self.c0.mul(self.c0)
        v1 = self.c1.mul(self.c1)
        a01 = self.c0.mul(self.c1)
        return Fp2Var(v0.sub(v1.mul_const(5)), a01.add(a01))

    def mul_fp(self, k: FpVar):
        return Fp2Var(self.c0.mul(k), self.c1.mul(k))

    def inverse(self):
        """Witness the inverse, enforce self * inv == 1 (3 constraints)."""
        cs = self.cs
        val = self.value()
        inv_val = None if val is None else hf2.inv(val)
        inv = Fp2Var.new_witness(cs, inv_val)
        prod = self.mul(inv)
        prod.enforce_equal(Fp2Var.one(cs))
        return inv

    def mul_by_inverse(self, den: "Fp2Var"):
        """self / den: witness q, enforce q*den == self (3 constraints)."""
        cs = self.cs
        sval, dval = self.value(), den.value()
        qval = None
        if sval is not None and dval is not None:
            qval = hf2.mul(sval, hf2.inv(dval)) if dval != (0, 0) else (0, 0)
        q = Fp2Var.new_witness(cs, qval)
        q.mul(den).enforce_equal(self)
        return q

    # --- relations ---------------------------------------------------------
    def enforce_equal(self, o):
        self.c0.enforce_equal(o.c0)
        self.c1.enforce_equal(o.c1)

    def conditional_enforce_not_equal(self, o, cond: Boolean):
        """cond => self != o: ((c0-o0) + r*(c1-o1)) * m = cond with a random
        -ish combiner is not sound in-circuit; use the reference approach of
        two coordinates: at least one coordinate differs. We witness which."""
        cs = self.cs
        d0 = self.c0.sub(o.c0)
        d1 = self.c1.sub(o.c1)
        # witness selector: which coordinate differs (prove-mode choice)
        sval = None
        if d0.value is not None:
            sval = d0.value != 0
        sel = Boolean.new_witness(cs, bool(sval) if sval is not None else False)
        picked = FpVar.conditionally_select(sel, d0, d1)
        picked.conditional_enforce_not_equal(FpVar.const(cs, 0), cond)

    @staticmethod
    def conditionally_select(cond: Boolean, t: "Fp2Var", f: "Fp2Var"):
        return Fp2Var(
            FpVar.conditionally_select(cond, t.c0, f.c0),
            FpVar.conditionally_select(cond, t.c1, f.c1),
        )


class Fp6Var:
    """(a0, a1, a2) over Fp2, v^3 = u."""

    def __init__(self, a0, a1, a2):
        self.a = (a0, a1, a2)
        self.cs = a0.cs

    @classmethod
    def zero(cls, cs):
        return cls(Fp2Var.zero(cs), Fp2Var.zero(cs), Fp2Var.zero(cs))

    @classmethod
    def one(cls, cs):
        return cls(Fp2Var.one(cs), Fp2Var.zero(cs), Fp2Var.zero(cs))

    @classmethod
    def const(cls, cs, value):
        return cls(*[Fp2Var.const(cs, v) for v in value])

    @classmethod
    def new_witness(cls, cs, value):
        vals = (None, None, None) if value is None else value
        return cls(*[Fp2Var.new_witness(cs, v) for v in vals])

    def value(self):
        vs = [x.value() for x in self.a]
        return None if any(v is None for v in vs) else tuple(vs)

    def add(self, o):
        return Fp6Var(*[x.add(y) for x, y in zip(self.a, o.a)])

    def sub(self, o):
        return Fp6Var(*[x.sub(y) for x, y in zip(self.a, o.a)])

    def neg(self):
        return Fp6Var(*[x.neg() for x in self.a])

    def mul(self, o):
        a0, a1, a2 = self.a
        b0, b1, b2 = o.a
        v0 = a0.mul(b0)
        v1 = a1.mul(b1)
        v2 = a2.mul(b2)
        c0 = v0.add(
            a1.add(a2).mul(b1.add(b2)).sub(v1.add(v2)).mul_by_nonresidue()
        )
        c1 = a0.add(a1).mul(b0.add(b1)).sub(v0.add(v1)).add(v2.mul_by_nonresidue())
        c2 = a0.add(a2).mul(b0.add(b2)).sub(v0.add(v2)).add(v1)
        return Fp6Var(c0, c1, c2)

    def square(self):
        return self.mul(self)

    def mul_by_v(self):
        a0, a1, a2 = self.a
        return Fp6Var(a2.mul_by_nonresidue(), a0, a1)

    def mul_fp2(self, s: Fp2Var):
        return Fp6Var(*[x.mul(s) for x in self.a])

    def enforce_equal(self, o):
        for x, y in zip(self.a, o.a):
            x.enforce_equal(y)

    @staticmethod
    def conditionally_select(cond, t, f):
        return Fp6Var(
            *[Fp2Var.conditionally_select(cond, x, y) for x, y in zip(t.a, f.a)]
        )


class Fp12Var:
    """(c0, c1) over Fp6, w^2 = v."""

    def __init__(self, c0: Fp6Var, c1: Fp6Var):
        self.c0 = c0
        self.c1 = c1
        self.cs = c0.cs

    @classmethod
    def one(cls, cs):
        return cls(Fp6Var.one(cs), Fp6Var.zero(cs))

    @classmethod
    def const(cls, cs, value):
        return cls(Fp6Var.const(cs, value[0]), Fp6Var.const(cs, value[1]))

    @classmethod
    def new_witness(cls, cs, value):
        vals = (None, None) if value is None else value
        return cls(Fp6Var.new_witness(cs, vals[0]), Fp6Var.new_witness(cs, vals[1]))

    def value(self):
        v0, v1 = self.c0.value(), self.c1.value()
        return None if v0 is None or v1 is None else (v0, v1)

    def mul(self, o):
        v0 = self.c0.mul(o.c0)
        v1 = self.c1.mul(o.c1)
        c0 = v0.add(v1.mul_by_v())
        c1 = self.c0.add(self.c1).mul(o.c0.add(o.c1)).sub(v0).sub(v1)
        return Fp12Var(c0, c1)

    def square(self):
        """Complex squaring: 2 Fp6 muls (36 constraints) vs 3 for mul."""
        v0 = self.c0.mul(self.c1)
        c0 = (
            self.c0.add(self.c1)
            .mul(self.c0.add(self.c1.mul_by_v()))
            .sub(v0)
            .sub(v0.mul_by_v())
        )
        return Fp12Var(c0, v0.add(v0))

    def cyclotomic_square(self):
        """Granger-Scott squaring for unitary elements (post-easy-part
        final-exp values): 3 Fp4 squarings = 6 Fp2 muls (18 constraints).
        Mirrors hostmath/fq12.py::cyclotomic_sq; matches ark-r1cs-std's
        Fp12Var::cyclotomic_square used by the reference's pairing gadget
        final exp."""

        def fp4_sq(za, zb):
            tmp = za.mul(zb)
            ta = (
                za.add(zb)
                .mul(za.add(zb.mul_by_nonresidue()))
                .sub(tmp)
                .sub(tmp.mul_by_nonresidue())
            )
            return ta, tmp.add(tmp)

        z0, z4, z3 = self.c0.a
        z2, z1, z5 = self.c1.a
        t0, t1 = fp4_sq(z0, z1)
        t2, t3 = fp4_sq(z2, z3)
        t4, t5 = fp4_sq(z4, z5)
        d0, d1 = t0.sub(z0), t1.add(z1)
        r0 = d0.add(d0).add(t0)
        r1 = d1.add(d1).add(t1)
        nt5 = t5.mul_by_nonresidue()
        d2, d3 = nt5.add(z2), t4.sub(z3)
        r2 = d2.add(d2).add(nt5)
        r3 = d3.add(d3).add(t4)
        d4, d5 = t2.sub(z4), t3.add(z5)
        r4 = d4.add(d4).add(t2)
        r5 = d5.add(d5).add(t3)
        return Fp12Var(Fp6Var(r0, r4, r3), Fp6Var(r2, r1, r5))

    def cyclotomic_pow_const(self, e: int):
        """pow_const for unitary elements: cyclotomic squarings (18) instead
        of generic ones (36+)."""
        out = None
        nb = e.bit_length()
        for i in range(nb):
            bit = (e >> (nb - 1 - i)) & 1
            if out is not None:
                out = out.cyclotomic_square()
            if bit:
                out = self if out is None else out.mul(self)
        return out

    def mul_by_sparse_line(self, c_a, c_w, c_w3):
        """Multiply by a Miller-loop line value
            (c_a, 0, 0) + (c_w, c_w3, 0) * w
        with c_a an Fp scalar (FpVar) and c_w, c_w3 Fp2Vars — 11 Fp2-shaped
        muls instead of a generic Fp12 mul."""

        def mul_by_01(x: Fp6Var, b0: Fp2Var, b1: Fp2Var):
            a0, a1, a2 = x.a
            v0 = a0.mul(b0)
            v1 = a1.mul(b1)
            c0 = v0.add(a1.add(a2).mul(b1).sub(v1).mul_by_nonresidue())
            c1 = a0.add(a1).mul(b0.add(b1)).sub(v0).sub(v1)
            c2 = a0.add(a2).mul(b0).sub(v0).add(v1)
            return Fp6Var(c0, c1, c2)

        # v0 = c0 * (c_a, 0, 0): three Fp2-by-Fp muls
        v0 = Fp6Var(*[x.mul_fp(c_a) for x in self.c0.a])
        v1 = mul_by_01(self.c1, c_w, c_w3)
        # (l0 + l1) has first coeff (c_a + c_w) as a full Fp2
        ca2 = Fp2Var(c_a, FpVar.const(self.cs, 0))
        s = mul_by_01(self.c0.add(self.c1), ca2.add(c_w), c_w3)
        return Fp12Var(v0.add(v1.mul_by_v()), s.sub(v0).sub(v1))

    def conj(self):
        return Fp12Var(self.c0, self.c1.neg())

    def inverse(self):
        cs = self.cs
        val = self.value()
        inv_val = None if val is None else hf12.inv(val)
        inv = Fp12Var.new_witness(cs, inv_val)
        self.mul(inv).enforce_equal(Fp12Var.one(cs))
        return inv

    def frobenius(self):
        """a^p via coefficient conjugation + constant gamma muls (free)."""
        gv, gv2, gw = hf12._GAMMA_V, hf12._GAMMA_V2, hf12._GAMMA_W
        gvw = hf2.mul(gv, gw)
        gv2w = hf2.mul(gv2, gw)
        a0, a1 = self.c0, self.c1
        b0 = Fp6Var(
            a0.a[0].conj(),
            a0.a[1].conj().mul_const_fp2(gv),
            a0.a[2].conj().mul_const_fp2(gv2),
        )
        b1 = Fp6Var(
            a1.a[0].conj().mul_const_fp2(gw),
            a1.a[1].conj().mul_const_fp2(gvw),
            a1.a[2].conj().mul_const_fp2(gv2w),
        )
        return Fp12Var(b0, b1)

    def frobenius_n(self, n: int):
        out = self
        for _ in range(n):
            out = out.frobenius()
        return out

    def pow_const(self, e: int):
        """Fixed-exponent square-and-multiply (unrolled; e is compile-time)."""
        out = None
        nb = e.bit_length()
        for i in range(nb):
            bit = (e >> (nb - 1 - i)) & 1
            if out is not None:
                out = out.square()
            if bit:
                out = self if out is None else out.mul(self)
        return out

    def enforce_equal(self, o):
        self.c0.enforce_equal(o.c0)
        self.c1.enforce_equal(o.c1)

    @staticmethod
    def conditionally_select(cond, t, f):
        return Fp12Var(
            Fp6Var.conditionally_select(cond, t.c0, f.c0),
            Fp6Var.conditionally_select(cond, t.c1, f.c1),
        )

"""Short-Weierstrass (G1/G2 of BLS12-377) and twisted-Edwards group law,
host-side, on plain integers / tuples.

G1 points: (x, y) affine over Fq, or None for infinity.
G2 points: ((x0,x1), (y0,y1)) affine over Fq2, or None for infinity.
Internally Jacobian coordinates are used for scalar multiplication.

Reference parity: group-law semantics of arkworks ark-ec
(consumed at crates/bls-crypto/src/bls/*.rs).
"""

from .params import P, R, G1_COFACTOR, G2_COFACTOR, G2_B_C0, G2_B_C1, ED_A, ED_D
from . import fp, fp2


# ---------------------------------------------------------------------------
# Generic Jacobian arithmetic over a field given by ops table
# ---------------------------------------------------------------------------

class _FqOps:
    zero = 0
    one = 1

    @staticmethod
    def add(a, b):
        return (a + b) % P

    @staticmethod
    def sub(a, b):
        return (a - b) % P

    @staticmethod
    def mul(a, b):
        return a * b % P

    @staticmethod
    def sq(a):
        return a * a % P

    @staticmethod
    def smul(k, a):
        return k * a % P

    @staticmethod
    def neg(a):
        return -a % P

    @staticmethod
    def inv(a):
        return pow(a, -1, P)

    @staticmethod
    def is_zero(a):
        return a % P == 0


class _Fq2Ops:
    zero = fp2.ZERO
    one = fp2.ONE
    add = staticmethod(fp2.add)
    sub = staticmethod(fp2.sub)
    mul = staticmethod(fp2.mul)
    sq = staticmethod(fp2.sq)
    smul = staticmethod(fp2.smul)
    neg = staticmethod(fp2.neg)
    inv = staticmethod(fp2.inv)
    is_zero = staticmethod(fp2.is_zero)


class SWCurve:
    """y^2 = x^3 + a x + b over field F (a assumed 0 for both BLS12-377 groups)."""

    def __init__(self, F, a, b, cofactor):
        assert F.is_zero(a), "only a=0 supported"
        self.F = F
        self.a = a
        self.b = b
        self.cofactor = cofactor

    # -- affine helpers ----------------------------------------------------
    def is_on_curve(self, pt):
        if pt is None:
            return True
        x, y = pt
        F = self.F
        return F.is_zero(F.sub(F.sq(y), F.add(F.mul(F.sq(x), x), self.b)))

    def neg(self, pt):
        if pt is None:
            return None
        return (pt[0], self.F.neg(pt[1]))

    # -- Jacobian core -----------------------------------------------------
    def to_jac(self, pt):
        if pt is None:
            return (self.F.one, self.F.one, self.F.zero)
        return (pt[0], pt[1], self.F.one)

    def from_jac(self, jac):
        X, Y, Z = jac
        F = self.F
        if F.is_zero(Z):
            return None
        zi = F.inv(Z)
        zi2 = F.sq(zi)
        return (F.mul(X, zi2), F.mul(Y, F.mul(zi, zi2)))

    def jac_double(self, pt):
        X1, Y1, Z1 = pt
        F = self.F
        if F.is_zero(Z1):
            return pt
        A = F.sq(X1)
        B = F.sq(Y1)
        C = F.sq(B)
        D = F.smul(2, F.sub(F.sq(F.add(X1, B)), F.add(A, C)))
        E = F.smul(3, A)
        FF = F.sq(E)
        X3 = F.sub(FF, F.smul(2, D))
        Y3 = F.sub(F.mul(E, F.sub(D, X3)), F.smul(8, C))
        Z3 = F.mul(F.smul(2, Y1), Z1)
        return (X3, Y3, Z3)

    def jac_add(self, p1, p2):
        F = self.F
        X1, Y1, Z1 = p1
        X2, Y2, Z2 = p2
        if F.is_zero(Z1):
            return p2
        if F.is_zero(Z2):
            return p1
        Z1Z1 = F.sq(Z1)
        Z2Z2 = F.sq(Z2)
        U1 = F.mul(X1, Z2Z2)
        U2 = F.mul(X2, Z1Z1)
        S1 = F.mul(F.mul(Y1, Z2), Z2Z2)
        S2 = F.mul(F.mul(Y2, Z1), Z1Z1)
        if U1 == U2:
            if S1 == S2:
                return self.jac_double(p1)
            return (F.one, F.one, F.zero)
        H = F.sub(U2, U1)
        I = F.sq(F.smul(2, H))
        J = F.mul(H, I)
        r = F.smul(2, F.sub(S2, S1))
        V = F.mul(U1, I)
        X3 = F.sub(F.sub(F.sq(r), J), F.smul(2, V))
        Y3 = F.sub(F.mul(r, F.sub(V, X3)), F.smul(2, F.mul(S1, J)))
        Z3 = F.mul(F.smul(2, F.mul(Z1, Z2)), H)
        return (X3, Y3, Z3)

    # -- public API --------------------------------------------------------
    def add(self, p1, p2):
        return self.from_jac(self.jac_add(self.to_jac(p1), self.to_jac(p2)))

    def double(self, pt):
        return self.from_jac(self.jac_double(self.to_jac(pt)))

    def mul(self, k: int, pt):
        if pt is None or k == 0:
            return None
        # no scalar reduction: callers pass arbitrary integers (cofactors!)
        acc = (self.F.one, self.F.one, self.F.zero)
        base = self.to_jac(pt)
        if k < 0:
            base = self.to_jac(self.neg(pt))
            k = -k
        for bit in bin(k)[2:]:
            acc = self.jac_double(acc)
            if bit == "1":
                acc = self.jac_add(acc, base)
        return self.from_jac(acc)

    def msum(self, pts):
        acc = (self.F.one, self.F.one, self.F.zero)
        for pt in pts:
            acc = self.jac_add(acc, self.to_jac(pt))
        return self.from_jac(acc)

    def msm(self, scalars, pts, c: int = 8):
        """Pippenger multi-scalar multiplication (host oracle for the
        device MSM; also the Groth16 prover's host path)."""
        assert len(scalars) == len(pts)
        entries = [(s, p) for s, p in zip(scalars, pts) if p is not None and s != 0]
        if not entries:
            return None
        nbits = max(s.bit_length() for s, _ in entries)
        windows = (nbits + c - 1) // c
        inf = (self.F.one, self.F.one, self.F.zero)
        result = inf
        for w in reversed(range(windows)):
            if result is not inf:
                for _ in range(c):
                    result = self.jac_double(result)
            buckets = [None] * (1 << c)
            for s, p in entries:
                d = (s >> (w * c)) & ((1 << c) - 1)
                if d:
                    buckets[d] = (
                        self.to_jac(p)
                        if buckets[d] is None
                        else self.jac_add(buckets[d], self.to_jac(p))
                    )
            acc = inf
            total = inf
            for b in range(len(buckets) - 1, 0, -1):
                if buckets[b] is not None:
                    acc = self.jac_add(acc, buckets[b])
                total = self.jac_add(total, acc)
            result = self.jac_add(result, total)
        return self.from_jac(result)

    def fixed_base_table(self, base, c: int = 8, nbits: int = None):
        """Precompute window tables for fast repeated scalar muls of one
        base (Groth16 setup: thousands of generator multiples)."""
        assert nbits is not None, "pass the scalar bit-length"
        windows = (nbits + c - 1) // c
        table = []
        cur = self.to_jac(base)
        for _ in range(windows):
            row = [None] * (1 << c)
            acc = (self.F.one, self.F.one, self.F.zero)
            for d in range(1, 1 << c):
                acc = self.jac_add(acc, cur)
                row[d] = acc
            table.append(row)
            for _ in range(c):
                cur = self.jac_double(cur)
        return (c, table)

    def fixed_base_mul(self, table, k: int):
        c, rows = table
        acc = (self.F.one, self.F.one, self.F.zero)
        w = 0
        while k:
            d = k & ((1 << c) - 1)
            if d:
                acc = self.jac_add(acc, rows[w][d])
            k >>= c
            w += 1
        return self.from_jac(acc)

    def scale_by_cofactor(self, pt):
        return self.mul(self.cofactor, pt)

    def get_point_from_x(self, x, greatest):
        """arkworks GroupAffine::get_point_from_x: y = sqrt(x^3 + b),
        pick the lexicographically greatest root iff `greatest`."""
        raise NotImplementedError  # specialized below


class _G1Curve(SWCurve):
    def get_point_from_x(self, x, greatest):
        y2 = (x * x % P * x + self.b) % P
        y = fp.sqrt(y2, P)
        if y is None:
            return None
        neg_y = (-y) % P
        big, small = (y, neg_y) if y > neg_y else (neg_y, y)
        return (x, big if greatest else small)


class _G2Curve(SWCurve):
    def get_point_from_x(self, x, greatest):
        y2 = fp2.add(fp2.mul(fp2.sq(x), x), self.b)
        y = fp2.sqrt(y2)
        if y is None:
            return None
        neg_y = fp2.neg(y)
        if fp2.cmp(y, neg_y) > 0:
            big, small = y, neg_y
        else:
            big, small = neg_y, y
        return (x, big if greatest else small)


G1 = _G1Curve(_FqOps, 0, 1, G1_COFACTOR)
G2 = _G2Curve(_Fq2Ops, fp2.ZERO, (G2_B_C0, G2_B_C1), G2_COFACTOR)


# ---------------------------------------------------------------------------
# Twisted Edwards over Fq (hosts the Bowe-Hopwood Pedersen CRH)
#   a x^2 + y^2 = 1 + d x^2 y^2, a = -1, d = ED_D, cofactor 8
# Extended coordinates (X, Y, T, Z) with x = X/Z, y = Y/Z, T = XY/Z.
# ---------------------------------------------------------------------------

ED_IDENTITY = (0, 1, 0, 1)


def ed_is_on_curve(pt):
    x, y, t, z = pt
    zi = pow(z, -1, P)
    xa, ya = x * zi % P, y * zi % P
    return (ED_A * xa * xa + ya * ya - 1 - ED_D * xa * xa % P * ya % P * ya) % P == 0


def ed_from_affine(xy):
    x, y = xy
    return (x % P, y % P, x * y % P, 1)


def ed_to_affine(pt):
    x, y, t, z = pt
    zi = pow(z, -1, P)
    return (x * zi % P, y * zi % P)


def ed_add(p1, p2):
    """Unified addition in extended coordinates (valid for a=-1 curves)."""
    X1, Y1, T1, Z1 = p1
    X2, Y2, T2, Z2 = p2
    A = (Y1 - X1) * (Y2 - X2) % P
    B = (Y1 + X1) * (Y2 + X2) % P
    C = 2 * T1 % P * T2 % P * ED_D % P
    D = 2 * Z1 * Z2 % P
    E = (B - A) % P
    F = (D - C) % P
    G = (D + C) % P
    H = (B + A) % P
    X3 = E * F % P
    Y3 = G * H % P
    T3 = E * H % P
    Z3 = F * G % P
    return (X3, Y3, T3, Z3)


def ed_double(p1):
    X1, Y1, T1, Z1 = p1
    A = X1 * X1 % P
    B = Y1 * Y1 % P
    C = 2 * Z1 * Z1 % P
    D = (-A) % P  # a = -1
    E = ((X1 + Y1) * (X1 + Y1) - A - B) % P
    G = (D + B) % P
    F = (G - C) % P
    H = (D - B) % P
    X3 = E * F % P
    Y3 = G * H % P
    T3 = E * H % P
    Z3 = F * G % P
    return (X3, Y3, T3, Z3)


def ed_neg(p1):
    X1, Y1, T1, Z1 = p1
    return ((-X1) % P, Y1, (-T1) % P, Z1)


def ed_mul(k: int, pt):
    acc = ED_IDENTITY
    if k < 0:
        pt = ed_neg(pt)
        k = -k
    for bit in bin(k)[2:]:
        acc = ed_double(acc)
        if bit == "1":
            acc = ed_add(acc, pt)
    return acc


def ed_get_point_from_x(x, greatest):
    """arkworks TE get_point_from_x: y^2 = (1 - a x^2) / (1 - d x^2)."""
    x %= P
    x2 = x * x % P
    num = (1 - ED_A * x2) % P
    den = (1 - ED_D * x2) % P
    if den == 0:
        return None
    y2 = num * pow(den, -1, P) % P
    y = fp.sqrt(y2, P)
    if y is None:
        return None
    neg_y = (-y) % P
    big, small = (y, neg_y) if y > neg_y else (neg_y, y)
    return (x, big if greatest else small)

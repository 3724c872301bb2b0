"""BW6-761 host math: the outer curve for the epoch SNARK.

(reference consumes ark-bw6-761; crates/epoch-snark/src/api/mod.rs:11-16
aliases BWCurve = BW6_761 with Fr == BLS12-377's Fq.)

  - E:  y^2 = x^3 - 1 over Fq (761 bits), G1 = E(Fq)[r], r = BLS12-377 p
  - E': y^2 = x^3 + 4 over Fq (sextic M-twist), G2 = E'(Fq)[r]
  - GT in Fq6 = Fq3[v]/(v^2 - u), Fq3 = Fq[u]/(u^3 + 4)
  - untwist psi: E' -> E(Fq6): (x, y) -> (-x/4 * u^2, -y/4 * u*v)

The pairing here is the TATE pairing with a shared final exponentiation.
Any bilinear non-degenerate pairing yields identical Groth16 accept/reject
decisions (only group elements are ever serialized), so host verification
is interoperable with arkworks' optimal-ate; the device kernels will get
the optimal-ate loop for performance later.

Curve orders were re-derived via the CM method (D = -3) and verified by
annihilation tests; q matches the EHG20 polynomial q(x) (asserted below).
"""

from .params import P as R_BW6  # scalar field of BW6 = base field of BLS12-377
from .params import BW6_P as Q
from . import curves as _curves

X_BLS = 0x8508C00000000001

# q(x) from EHG20, asserted against the known modulus
_qpoly = (
    103 * X_BLS**12 - 379 * X_BLS**11 + 250 * X_BLS**10 + 691 * X_BLS**9
    - 911 * X_BLS**8 - 79 * X_BLS**7 + 623 * X_BLS**6 - 640 * X_BLS**5
    + 274 * X_BLS**4 + 763 * X_BLS**3 + 73 * X_BLS**2 + 254 * X_BLS + 229
)
assert _qpoly % 9 == 0 and _qpoly // 9 == Q

# trace of E: y^2 = x^3 - 1 (CM-derived, verified by annihilation)
TRACE = 3362637538168598222219435186298528655381674028954528064283340709388076588006567983337308081752755143497537638367248
_CM_Y = 2327979834116721846122857819342346041630394402507777770613906795574054381627779834062290838568927395079900712927242
assert TRACE * TRACE + 3 * _CM_Y * _CM_Y == 4 * Q

N_E = Q + 1 - TRACE                      # |E(Fq)|
N_TWIST = Q + 1 - (TRACE + 3 * _CM_Y) // 2  # |E'(Fq)|
assert N_E % R_BW6 == 0 and N_TWIST % R_BW6 == 0
G1_COFACTOR = N_E // R_BW6
G2_COFACTOR = N_TWIST // R_BW6

G1_B = Q - 1  # y^2 = x^3 - 1
G2_B = 4      # y^2 = x^3 + 4


# --------------------------------------------------------------------------
# Fq
# --------------------------------------------------------------------------

def fq_sqrt(a):
    """q ≡ 3 mod 4."""
    a %= Q
    s = pow(a, (Q + 1) // 4, Q)
    return s if s * s % Q == a else None


class _FqOps:
    zero = 0
    one = 1

    @staticmethod
    def add(a, b):
        return (a + b) % Q

    @staticmethod
    def sub(a, b):
        return (a - b) % Q

    @staticmethod
    def mul(a, b):
        return a * b % Q

    @staticmethod
    def sq(a):
        return a * a % Q

    @staticmethod
    def smul(k, a):
        return k * a % Q

    @staticmethod
    def neg(a):
        return -a % Q

    @staticmethod
    def inv(a):
        return pow(a, -1, Q)

    @staticmethod
    def is_zero(a):
        return a % Q == 0


class _BW6Curve(_curves.SWCurve):
    def __init__(self, b, cofactor):
        # bypass parent init's a=0 assert plumbing with our Fq ops
        self.F = _FqOps
        self.a = 0
        self.b = b % Q
        self.cofactor = cofactor

    def get_point_from_x(self, x, greatest):
        y2 = (x * x % Q * x + self.b) % Q
        y = fq_sqrt(y2)
        if y is None:
            return None
        neg_y = (-y) % Q
        big, small = (y, neg_y) if y > neg_y else (neg_y, y)
        return (x, big if greatest else small)


G1 = _BW6Curve(G1_B, G1_COFACTOR)
G2 = _BW6Curve(G2_B, G2_COFACTOR)


def _derive_generator(curve):
    """Deterministic subgroup generator: smallest x giving a curve point,
    cofactor-cleared. (Generator choice does not affect wire formats; only
    subgroup membership matters for interop.)"""
    x = 1
    while True:
        pt = curve.get_point_from_x(x, False)
        if pt is not None:
            g = curve.scale_by_cofactor(pt)
            if g is not None:
                return g
        x += 1


G1_GENERATOR = _derive_generator(G1)
G2_GENERATOR = _derive_generator(G2)


# --------------------------------------------------------------------------
# Fq3 / Fq6 tower: u^3 = -4, v^2 = u
# --------------------------------------------------------------------------

F3_ZERO = (0, 0, 0)
F3_ONE = (1, 0, 0)


def f3_nr(a):
    """multiply Fq3 element by u."""
    a0, a1, a2 = a
    return (-4 * a2 % Q, a0, a1)


def f3_add(a, b):
    return tuple((x + y) % Q for x, y in zip(a, b))


def f3_sub(a, b):
    return tuple((x - y) % Q for x, y in zip(a, b))


def f3_neg(a):
    return tuple(-x % Q for x in a)


def f3_mul(a, b):
    a0, a1, a2 = a
    b0, b1, b2 = b
    v0 = a0 * b0 % Q
    v1 = a1 * b1 % Q
    v2 = a2 * b2 % Q
    c0 = (v0 - 4 * (((a1 + a2) * (b1 + b2) - v1 - v2) % Q)) % Q
    c1 = ((a0 + a1) * (b0 + b1) - v0 - v1 - 4 * v2) % Q
    c2 = ((a0 + a2) * (b0 + b2) - v0 - v2 + v1) % Q
    return (c0, c1, c2)


def f3_sq(a):
    return f3_mul(a, a)


def f3_inv(a):
    a0, a1, a2 = a
    t0 = a0 * a0 % Q
    t1 = a1 * a1 % Q
    t2 = a2 * a2 % Q
    t3 = a0 * a1 % Q
    t4 = a0 * a2 % Q
    t5 = a1 * a2 % Q
    # norms with nonresidue -4
    c0 = (t0 + 4 * t5) % Q
    c1 = (-4 * t2 - t3) % Q
    c2 = (t1 - t4) % Q
    det = (a0 * c0 + (-4) * (a2 * c1 + a1 * c2)) % Q
    dinv = pow(det, -1, Q)
    return (c0 * dinv % Q, c1 * dinv % Q, c2 * dinv % Q)


F6_ZERO = (F3_ZERO, F3_ZERO)
F6_ONE = (F3_ONE, F3_ZERO)


def f6_add(a, b):
    return (f3_add(a[0], b[0]), f3_add(a[1], b[1]))


def f6_mul(a, b):
    a0, a1 = a
    b0, b1 = b
    v0 = f3_mul(a0, b0)
    v1 = f3_mul(a1, b1)
    c0 = f3_add(v0, f3_nr(v1))
    c1 = f3_sub(f3_sub(f3_mul(f3_add(a0, a1), f3_add(b0, b1)), v0), v1)
    return (c0, c1)


def f6_sq(a):
    return f6_mul(a, a)


def f6_inv(a):
    a0, a1 = a
    t = f3_sub(f3_sq(a0), f3_nr(f3_sq(a1)))
    ti = f3_inv(t)
    return (f3_mul(a0, ti), f3_neg(f3_mul(a1, ti)))


def f6_pow(a, e):
    result = F6_ONE
    base = a
    while e > 0:
        if e & 1:
            result = f6_mul(result, base)
        base = f6_sq(base)
        e >>= 1
    return result


def f6_is_one(a):
    return a == F6_ONE


# --------------------------------------------------------------------------
# Tate pairing
# --------------------------------------------------------------------------

_FINAL_EXP = (Q**6 - 1) // R_BW6
_QUARTER = pow(4, -1, Q)


def _untwist(qpt):
    """E'(Fq) affine -> psi(Q) in E(Fq6): x6 = (-x/4) u^2, y6 = (-y/4) u v."""
    xq, yq = qpt
    xc = (-xq) * _QUARTER % Q
    yc = (-yq) * _QUARTER % Q
    x6 = ((0, 0, xc), F3_ZERO)
    y6 = (F3_ZERO, (0, yc, 0))
    return x6, y6


def miller_loop(pairs):
    """Product of Tate Miller loops f_{r,P}(psi(Q)) over affine pairs."""
    pairs = [(p, qq) for (p, qq) in pairs if p is not None and qq is not None]
    if not pairs:
        return F6_ONE
    data = []
    for p, qq in pairs:
        x6, y6 = _untwist(qq)
        data.append((p, x6, y6))
    ts = [p for (p, _, _) in data]
    f = F6_ONE
    bits = bin(R_BW6)[3:]
    for bit in bits:
        f = f6_sq(f)
        for i, (p, x6, y6) in enumerate(data):
            xt, yt = ts[i]
            # tangent at T: lam = 3x^2 / 2y (a=0)
            lam = 3 * xt * xt % Q * pow(2 * yt % Q, -1, Q) % Q
            # line at psi(Q): (y6 - yT) - lam*(x6 - xT)
            #   = (lam*xT - yT, 0, -lam*xc)  +  (0, yc, 0) * v
            c = (lam * xt - yt) % Q
            line = (
                (c, 0, (-lam) * x6[0][2] % Q),
                y6[1],
            )
            f = f6_mul(f, line)
            # double T
            x3 = (lam * lam - 2 * xt) % Q
            y3 = (lam * (xt - x3) - yt) % Q
            ts[i] = (x3, y3)
        if bit == "1":
            for i, (p, x6, y6) in enumerate(data):
                if ts[i] is None:
                    continue
                xt, yt = ts[i]
                xp, yp = p
                if xt == xp:
                    # T == -P (the final bit of r): vertical line x6 - xP
                    assert yt == (-yp) % Q, "unexpected Miller degenerate case"
                    line = (((-xp) % Q, 0, x6[0][2]), F3_ZERO)
                    f = f6_mul(f, line)
                    ts[i] = None  # T + P = infinity
                    continue
                lam = (yt - yp) * pow((xt - xp) % Q, -1, Q) % Q
                c = (lam * xp - yp) % Q
                line = (
                    (c % Q, 0, (-lam) * x6[0][2] % Q),
                    y6[1],
                )
                f = f6_mul(f, line)
                x3 = (lam * lam - xt - xp) % Q
                y3 = (lam * (xt - x3) - yt) % Q
                ts[i] = (x3, y3)
    return f


def f3_smul(k, a):
    return tuple(k * x % Q for x in a)


def final_exponentiation(f):
    return f6_pow(f, _FINAL_EXP)


def pairing(p_aff, q_aff):
    return final_exponentiation(miller_loop([(p_aff, q_aff)]))


def product_of_pairings(pairs):
    return final_exponentiation(miller_loop(pairs))


def pairing_check(pairs) -> bool:
    return f6_is_one(product_of_pairings(pairs))

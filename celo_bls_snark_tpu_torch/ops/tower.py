"""Batched Fq2/Fq6/Fq12 tower arithmetic (BLS12-377), the PyTorch
counterpart of the JAX package's ops/tower.py.

Elements are nested tuples of [n_limbs, B] int32 tensors:
  Fq2  = (c0, c1)                u^2 = -5
  Fq6  = (a0, a1, a2) of Fq2     v^3 = u
  Fq12 = (b0, b1) of Fq6         w^2 = v

All multiplications are STACKED: a tower-level product expands (via
Karatsuba at every level) into a list of independent Fq multiplies that run
as ONE wide kernel call (fq.mul_many): the composition of an Fq12 mul is
one mont_mul launch of width 54*B, which keeps kernel launches flat as the
tower deepens. On the card the Fq12 multiply (f12_mul, f12_sq) and the
cyclotomic squaring (f12_cyclo_sq) are one kernel each, products and
combination together; their compositions stay as the _plain versions.

Host oracle: hostmath/{fp2,fq12}.py (cross-validated in tests).
"""

from ..hostmath import fp2 as hfp2
from ..hostmath.fq12 import _GAMMA_V, _GAMMA_V2, _GAMMA_W
from ..utils.tree import tree_leaves, tree_map
from . import field
from .field import FQ, fq


# ---------------------------------------------------------------------------
# Fq2 — deferred-pair machinery
# ---------------------------------------------------------------------------

def f2_zeros(batch, device):
    return (fq.zeros(batch, device), fq.zeros(batch, device))


def f2_ones(batch, device):
    return (fq.ones(batch, device), fq.zeros(batch, device))


def f2_add(a, b):
    return (fq.add(a[0], b[0]), fq.add(a[1], b[1]))


def f2_sub(a, b):
    return (fq.sub(a[0], b[0]), fq.sub(a[1], b[1]))


def f2_neg(a):
    return (fq.neg(a[0]), fq.neg(a[1]))


def f2_conj(a):
    return (a[0], fq.neg(a[1]))


def f2_smul(k: int, a):
    return (fq.mul_small(a[0], k), fq.mul_small(a[1], k))


def f2_mul_by_nonresidue(a):
    """(a0 + a1 u) * u = -5 a1 + a0 u."""
    return (fq.neg(fq.mul_small(a[1], 5)), a[0])


def _f2_mul_pairs(a, b):
    """Karatsuba: 3 independent fq products + a combiner."""
    pairs = [(a[0], b[0]), (a[1], b[1]), (fq.add(a[0], a[1]), fq.add(b[0], b[1]))]

    def combine(r):
        v0, v1, t = r
        return (fq.sub(v0, fq.mul_small(v1, 5)), fq.sub(t, fq.add(v0, v1)))

    return pairs, combine


def f2_mul_batch(ab_list):
    """Multiply many independent Fq2 pairs in one fq kernel call."""
    allpairs, combines = [], []
    for a, b in ab_list:
        p, c = _f2_mul_pairs(a, b)
        allpairs += p
        combines.append(c)
    res = fq.mul_many(allpairs)
    return [c(res[3 * i : 3 * i + 3]) for i, c in enumerate(combines)]


def f2_mul(a, b):
    return f2_mul_batch([(a, b)])[0]


def f2_sq(a):
    # v0 = a0^2, v1 = a1^2, a0a1 -> (v0 - 5 v1, 2 a0 a1)
    v0, v1, a0a1 = fq.mul_many([(a[0], a[0]), (a[1], a[1]), (a[0], a[1])])
    return (fq.sub(v0, fq.mul_small(v1, 5)), fq.add(a0a1, a0a1))


def f2_fmul(c, a):
    """Multiply by an Fq element c."""
    r = fq.mul_many([(c, a[0]), (c, a[1])])
    return (r[0], r[1])


def f2_inv(a):
    norm = fq.add(fq.sq(a[0]), fq.mul_small(fq.sq(a[1]), 5))
    ninv = fq.inv(norm)
    r = fq.mul_many([(a[0], ninv), (fq.neg(a[1]), ninv)])
    return (r[0], r[1])


def f2_is_zero(a):
    return fq.is_zero(a[0]) & fq.is_zero(a[1])


def f2_eq(a, b):
    return fq.eq(a[0], b[0]) & fq.eq(a[1], b[1])


def f2_select(c, a, b):
    return (fq.select(c, a[0], b[0]), fq.select(c, a[1], b[1]))


def f2_const(v0: int, v1: int, device, batch=(1,)):
    return (fq.const(v0, batch, device), fq.const(v1, batch, device))


# ---------------------------------------------------------------------------
# Fq6 — (c0, c1, c2) over Fq2, v^3 = u
# ---------------------------------------------------------------------------

def f6_zeros(batch, device):
    return (f2_zeros(batch, device),) * 3


def f6_ones(batch, device):
    return (f2_ones(batch, device), f2_zeros(batch, device), f2_zeros(batch, device))


def f6_add(a, b):
    return tuple(f2_add(x, y) for x, y in zip(a, b))


def f6_sub(a, b):
    return tuple(f2_sub(x, y) for x, y in zip(a, b))


def f6_neg(a):
    return tuple(f2_neg(x) for x in a)


def _f6_mul_pairs(a, b):
    """Toom/Karatsuba: 6 independent Fq2 products + a combiner."""
    a0, a1, a2 = a
    b0, b1, b2 = b
    pairs = [
        (a0, b0),
        (a1, b1),
        (a2, b2),
        (f2_add(a1, a2), f2_add(b1, b2)),
        (f2_add(a0, a1), f2_add(b0, b1)),
        (f2_add(a0, a2), f2_add(b0, b2)),
    ]

    def combine(r):
        v0, v1, v2, m12, m01, m02 = r
        c0 = f2_add(v0, f2_mul_by_nonresidue(f2_sub(m12, f2_add(v1, v2))))
        c1 = f2_add(f2_sub(m01, f2_add(v0, v1)), f2_mul_by_nonresidue(v2))
        c2 = f2_add(f2_sub(m02, f2_add(v0, v2)), v1)
        return (c0, c1, c2)

    return pairs, combine


def f6_mul_batch(ab_list):
    f2pairs, combines = [], []
    for a, b in ab_list:
        p, c = _f6_mul_pairs(a, b)
        f2pairs += p
        combines.append(c)
    res = f2_mul_batch(f2pairs)
    return [c(res[6 * i : 6 * i + 6]) for i, c in enumerate(combines)]


def f6_mul(a, b):
    return f6_mul_batch([(a, b)])[0]


def f6_sq(a):
    return f6_mul(a, a)


def f6_smul(a, s):
    """Multiply each Fq2 coefficient by Fq2 scalar s (one kernel call)."""
    r = f2_mul_batch([(x, s) for x in a])
    return tuple(r)


def f6_mul_by_v(a):
    return (f2_mul_by_nonresidue(a[2]), a[0], a[1])


def f6_inv(a):
    a0, a1, a2 = a
    t0, t1, t2, t3, t4, t5 = f2_mul_batch(
        [(a0, a0), (a1, a1), (a2, a2), (a0, a1), (a0, a2), (a1, a2)]
    )
    c0 = f2_sub(t0, f2_mul_by_nonresidue(t5))
    c1 = f2_sub(f2_mul_by_nonresidue(t2), t3)
    c2 = f2_sub(t1, t4)
    m0, m1, m2 = f2_mul_batch([(a0, c0), (a2, c1), (a1, c2)])
    t6 = f2_add(m0, f2_mul_by_nonresidue(f2_add(m1, m2)))
    t6i = f2_inv(t6)
    r = f2_mul_batch([(c0, t6i), (c1, t6i), (c2, t6i)])
    return tuple(r)


def f6_select(c, a, b):
    return tuple(f2_select(c, x, y) for x, y in zip(a, b))


# ---------------------------------------------------------------------------
# Fq12 — (c0, c1) over Fq6, w^2 = v
# ---------------------------------------------------------------------------

def f12_zeros(batch, device):
    return (f6_zeros(batch, device), f6_zeros(batch, device))


def f12_ones(batch, device):
    return (f6_ones(batch, device), f6_zeros(batch, device))


def f12_add(a, b):
    return (f6_add(a[0], b[0]), f6_add(a[1], b[1]))


def f12_mul(a, b):
    """f12_mul_plain's function. CUDA tensors: ONE launch of the f12_mul
    kernel (ops/field.py, csrc/f12_mul.cu), limb for limb the composition's
    result, where the composition is 245 launches; a square (b is a) loads
    its operand once. CPU tensors: the composition."""
    return field.f12_mul(FQ, a, b)


def f12_mul_plain(a, b):
    """The plain version of the f12_mul kernel, and the composition it
    replaces: Karatsuba at every level, 54 fq products in ONE 54*B-wide
    multiply launch, then the combines."""
    a0, a1 = a
    b0, b1 = b
    v0, v1, t = f6_mul_batch([(a0, b0), (a1, b1), (f6_add(a0, a1), f6_add(b0, b1))])
    c0 = f6_add(v0, f6_mul_by_v(v1))
    c1 = f6_sub(f6_sub(t, v0), v1)
    return (c0, c1)


def f12_sq(a):
    return f12_mul(a, a)


def f12_cyclo_sq(a):
    """Granger-Scott squaring for unitary elements (the cyclotomic subgroup
    every post-easy-part final-exp value lives in), f12_cyclo_sq_plain's
    function. CUDA tensors: ONE launch of the f12_cyclo_sq kernel
    (ops/field.py, csrc/cyclo_sq.cu), limb for limb the composition's
    result, where the composition is 119 launches; CPU tensors: the
    composition."""
    return field.f12_cyclo_sq(FQ, a)


def f12_cyclo_sq_plain(a):
    """The plain version of the f12_cyclo_sq kernel, and the composition it
    replaces: 3 Fq4 squarings (6 Fq2 muls = 18 fq products) + a
    mul-by-one canonicalization of the 6 input coefficients (12 fq
    products), all in ONE 30*B-wide multiply launch — vs 54*B for f12_sq
    per squaring of the final exp's ~315-deep pow chains.

    The canonicalization is load-bearing, not an optimization: the +-2z
    terms below bypass the Montgomery multiply, so without it the lazy
    value drift DOUBLES per squaring (V_k = 2 V_{k-1} + O(p)) and a chain
    blows through the 256p lazy budget after ~5 iterations. Canonical z
    (< 2p) makes the output bound a constant (< 64p) for arbitrary chains.
    Oracle: hostmath/fq12.py::cyclotomic_sq."""
    (z0, z4, z3), (z2, z1, z5) = a
    zs = (z0, z1, z2, z3, z4, z5)
    batch = z0[0].shape[1:]
    one = FQ.ones(batch, z0[0].device)
    pairs, combines = [], []
    for za, zb in ((z0, z1), (z2, z3), (z4, z5)):
        p, c = _f2_mul_pairs(za, zb)
        pairs += p
        combines.append(c)
        p, c = _f2_mul_pairs(
            f2_add(za, zb), f2_add(za, f2_mul_by_nonresidue(zb))
        )
        pairs += p
        combines.append(c)
    for z in zs:
        pairs += [(z[0], one), (z[1], one)]
    res = fq.mul_many(pairs)
    f2res = [combines[i](res[3 * i : 3 * i + 3]) for i in range(6)]
    z0, z1, z2, z3, z4, z5 = [
        (res[18 + 2 * i], res[18 + 2 * i + 1]) for i in range(6)
    ]
    ts = []
    for g in range(3):
        tmp, s = f2res[2 * g], f2res[2 * g + 1]
        ta = f2_sub(f2_sub(s, tmp), f2_mul_by_nonresidue(tmp))
        ts.append((ta, f2_add(tmp, tmp)))
    (t0, t1), (t2, t3), (t4, t5) = ts

    def m32(t, z):  # 3t - 2z
        d = f2_sub(t, z)
        return f2_add(f2_add(d, d), t)

    def p32(t, z):  # 3t + 2z
        d = f2_add(t, z)
        return f2_add(f2_add(d, d), t)

    nt5 = f2_mul_by_nonresidue(t5)
    return (
        (m32(t0, z0), m32(t2, z4), m32(t4, z3)),
        (p32(nt5, z2), p32(t1, z1), p32(t3, z5)),
    )


def f12_conj(a):
    return (a[0], f6_neg(a[1]))


def f12_inv(a):
    a0, a1 = a
    s0, s1 = f6_mul_batch([(a0, a0), (a1, a1)])
    t = f6_sub(s0, f6_mul_by_v(s1))
    ti = f6_inv(t)
    r0, r1 = f6_mul_batch([(a0, ti), (a1, ti)])
    return (r0, f6_neg(r1))


def f12_select(c, a, b):
    return (f6_select(c, a[0], b[0]), f6_select(c, a[1], b[1]))


def f2_is_zero_many(vals):
    """Stacked Fq2 zero-tests (one kernel call for all components)."""
    flat = []
    for v in vals:
        flat += [v[0], v[1]]
    z = fq.is_zero_many(flat)
    return [z[2 * i] & z[2 * i + 1] for i in range(len(vals))]


def f12_is_one(a):
    x0 = tree_leaves(a)[0]
    one = f12_ones(x0.shape[1:], x0.device)
    diffs = tree_leaves(tree_map(fq.sub, a, one))
    zs = fq.is_zero_many(diffs)
    out = zs[0]
    for z in zs[1:]:
        out = out & z
    return out


def f12_mul_line(f, c_a, c_w, c_w3):
    """Multiply f by a Miller-loop line L = (c_a, 0, 0) + (c_w, c_w3, 0)*w
    (all coefficients Fq2). One stacked kernel call for all products
    (sparse: 15 Fq2 products instead of 18)."""
    a0, a1 = f
    batch = c_a[0].shape[1:]
    ca2 = c_a
    z2 = f2_zeros(batch, c_a[0].device)
    b1 = (c_w, c_w3, z2)
    s_b = (f2_add(ca2, c_w), c_w3, z2)  # b0 + b1
    s_a = f6_add(a0, a1)
    # v0 = a0 * (ca2,0,0): 3 scalar Fq2 products
    # v1 = a1 * b1 (sparse c2=0): via _f6_mul_pairs (6 products)
    # t  = (a0+a1) * s_b:          6 products
    p1, c1f = _f6_mul_pairs(a1, b1)
    p2, c2f = _f6_mul_pairs(s_a, s_b)
    scalar_pairs = [(x, ca2) for x in a0]
    res = f2_mul_batch(scalar_pairs + p1 + p2)
    v0 = tuple(res[0:3])
    v1 = c1f(res[3:9])
    t = c2f(res[9:15])
    c0 = f6_add(v0, f6_mul_by_v(v1))
    c1 = f6_sub(f6_sub(t, v0), v1)
    return (c0, c1)


# ---------------------------------------------------------------------------
# Frobenius (gamma constants from the host tower, embedded as constants)
# ---------------------------------------------------------------------------

def _gamma_consts(device):
    gv = f2_const(*_GAMMA_V, device)
    gv2 = f2_const(*_GAMMA_V2, device)
    gw = f2_const(*_GAMMA_W, device)
    gvw = f2_const(*hfp2.mul(_GAMMA_V, _GAMMA_W), device)
    gv2w = f2_const(*hfp2.mul(_GAMMA_V2, _GAMMA_W), device)
    return gv, gv2, gw, gvw, gv2w


def f12_frob(a):
    a0, a1 = a
    gv, gv2, gw, gvw, gv2w = _gamma_consts(a0[0][0].device)
    # b0 = (conj(a00), conj(a01)*gv, conj(a02)*gv2)
    # b1 = (conj(a10)*gw, conj(a11)*gv*gw, conj(a12)*gv2*gw)
    prods = f2_mul_batch(
        [
            (f2_conj(a0[1]), gv),
            (f2_conj(a0[2]), gv2),
            (f2_conj(a1[0]), gw),
            (f2_conj(a1[1]), gvw),
            (f2_conj(a1[2]), gv2w),
        ]
    )
    b0 = (f2_conj(a0[0]), prods[0], prods[1])
    b1 = (prods[2], prods[3], prods[4])
    return (b0, b1)


def f12_frob_n(a, n: int):
    for _ in range(n):
        a = f12_frob(a)
    return a

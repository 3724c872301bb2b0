"""Batched short-Weierstrass group law (BLS12-377 G1 over Fq and G2 over
Fq2, BW6-761 G1 and G2 over Fq761), the PyTorch counterpart of the JAX
package's ops/curve.py.

Points are homogeneous projective (X, Y, Z) tuples of limb tensors;
infinity is (0, 1, 0) (Z == 0). The group law is the COMPLETE a=0 addition
of Renes-Costello-Batina (EUROCRYPT 2016, Algorithms 7-9): one formula
covers add/double/infinity with no case selects and no zero tests.

Completeness precondition: inputs lie in the odd-order r-subgroup (the
formulas admit exceptions only at even-torsion points). Signatures,
public keys and cofactor-cleared hashes, and their sums and multiples, all
do.

Independent field multiplies inside each formula are stacked into single
wide kernel launches (F.mul_many layers): a complete add is 2 launches of
6 multiplies each.

Host oracle: hostmath/curves.py.
"""

import numpy as np
import torch

from ..hostmath import fp2
from ..hostmath.params import G2_B_C1 as _G2_B_C1
from ..hostmath.params import P
from ..utils import aotcache
from ..utils.tree import tree_leaves, tree_map
from .field import FQ, fq, fq761, ops_for
from . import tower as tw


class _F2Wrap:
    """Adapter giving Fq2 the same callable surface as fq for generic code."""

    add = staticmethod(tw.f2_add)
    sub = staticmethod(tw.f2_sub)
    mul = staticmethod(tw.f2_mul)
    mul_many = staticmethod(tw.f2_mul_batch)
    sq = staticmethod(tw.f2_sq)
    neg = staticmethod(tw.f2_neg)
    inv = staticmethod(tw.f2_inv)
    is_zero = staticmethod(tw.f2_is_zero)
    is_zero_many = staticmethod(tw.f2_is_zero_many)
    eq = staticmethod(tw.f2_eq)
    select = staticmethod(tw.f2_select)
    zeros = staticmethod(tw.f2_zeros)
    ones = staticmethod(tw.f2_ones)

    @staticmethod
    def smul(k, a):
        return tw.f2_smul(k, a)


class _FqWrap:
    add = staticmethod(fq.add)
    sub = staticmethod(fq.sub)
    mul = staticmethod(fq.mul)
    mul_many = staticmethod(fq.mul_many)
    sq = staticmethod(fq.sq)
    neg = staticmethod(fq.neg)
    inv = staticmethod(fq.inv)
    is_zero = staticmethod(fq.is_zero)
    is_zero_many = staticmethod(fq.is_zero_many)
    eq = staticmethod(fq.eq)
    select = staticmethod(fq.select)
    zeros = staticmethod(fq.zeros)
    ones = staticmethod(fq.ones)

    @staticmethod
    def smul(k, a):
        return fq.mul_small(a, k)


class _Fq761Wrap(_FqWrap):
    """BW6-761 base-field adapter (both BW6 G1 and G2 live over Fq761;
    the groups differ only in the curve constant b, i.e. in b3_mul)."""

    add = staticmethod(fq761.add)
    sub = staticmethod(fq761.sub)
    mul = staticmethod(fq761.mul)
    mul_many = staticmethod(fq761.mul_many)
    sq = staticmethod(fq761.sq)
    neg = staticmethod(fq761.neg)
    inv = staticmethod(fq761.inv)
    is_zero = staticmethod(fq761.is_zero)
    is_zero_many = staticmethod(fq761.is_zero_many)
    eq = staticmethod(fq761.eq)
    select = staticmethod(fq761.select)
    zeros = staticmethod(fq761.zeros)
    ones = staticmethod(fq761.ones)

    @staticmethod
    def smul(k, a):
        return fq761.mul_small(a, k)


_CONST_BITS = {}


def _const_bits(k: int, device) -> torch.Tensor:
    """The bits of k, MSB first, as an int32 [nbits] tensor on `device`,
    cached: a graph takes no host data, so scalar_mul_const's bits are
    copied to the card once, outside any capture."""
    key = (k, torch.device(device))
    bits = _CONST_BITS.get(key)
    if bits is None:
        nb = max(1, k.bit_length())
        bits = _CONST_BITS[key] = torch.tensor(
            [(k >> (nb - 1 - i)) & 1 for i in range(nb)], dtype=torch.int32,
            device=device)
    return bits


def make_curve_ops(F, b3_mul):
    """Complete a=0 projective group law over field adapter F.

    b3_mul(t) must return 3*b*t (lazy ok) for the curve constant b."""

    def infinity(batch, device):
        return (F.zeros(batch, device), F.ones(batch, device), F.zeros(batch, device))

    def is_infinity(pt):
        return F.is_zero(pt[2])

    def from_affine(xy):
        x, y = xy
        x0 = tree_leaves(x)[0]
        return (x, y, F.ones(x0.shape[1:], x0.device))

    def to_affine(pt):
        """Batched; infinity lanes return (0, 0)."""
        X, Y, Z = pt
        zi = F.inv(Z)  # inv(0) = 0, so infinity lanes collapse to (0, 0)
        xa, ya = F.mul_many([(X, zi), (Y, zi)])
        return (xa, ya)

    def neg(pt):
        return (pt[0], F.neg(pt[1]), pt[2])

    def double(pt):
        # RCB Algorithm 9 (a=0): 6M+2S, two stacked-mul layers, complete.
        X, Y, Z = pt
        t0, t1, t2, xy = F.mul_many([(Y, Y), (Y, Z), (Z, Z), (X, Y)])
        z3 = F.smul(8, t0)
        t2 = b3_mul(t2)
        y3 = F.add(t0, t2)
        t0 = F.sub(t0, F.smul(3, t2))
        X3a, Z3, Y3a, X3b = F.mul_many(
            [(t2, z3), (t1, z3), (t0, y3), (t0, xy)]
        )
        Y3 = F.add(X3a, Y3a)
        X3 = F.smul(2, X3b)
        return (X3, Y3, Z3)

    def add(p1, p2):
        """COMPLETE addition (RCB Algorithm 7, a=0): 12M, two stacked-mul
        layers, no selects, no zero tests."""
        X1, Y1, Z1 = p1
        X2, Y2, Z2 = p2
        m0, m1, m2, m3, m4, m5 = F.mul_many([
            (X1, X2),
            (Y1, Y2),
            (Z1, Z2),
            (F.add(X1, Y1), F.add(X2, Y2)),
            (F.add(Y1, Z1), F.add(Y2, Z2)),
            (F.add(X1, Z1), F.add(X2, Z2)),
        ])
        t3 = F.sub(F.sub(m3, m0), m1)          # (X1+Y1)(X2+Y2)-X1X2-Y1Y2
        t4 = F.sub(F.sub(m4, m1), m2)          # (Y1+Z1)(Y2+Z2)-Y1Y2-Z1Z2
        y3p = F.sub(F.sub(m5, m0), m2)         # (X1+Z1)(X2+Z2)-X1X2-Z1Z2
        x3a = F.smul(3, m0)
        t2b = b3_mul(m2)
        z3a = F.add(m1, t2b)
        t1b = F.sub(m1, t2b)
        y3b = b3_mul(y3p)
        q0, q1, q2, q3, q4, q5 = F.mul_many([
            (t4, y3b), (t3, t1b), (y3b, x3a),
            (t1b, z3a), (x3a, t3), (z3a, t4),
        ])
        return (F.sub(q1, q0), F.add(q3, q2), F.add(q5, q4))

    def tree_select(c, a, b):
        return tree_map(lambda x, y: torch.where(c[None], x, y), a, b)

    def madd(p1, a2, canonical_bases=False):
        """COMPLETE MIXED addition (RCB Algorithm 8, a=0): p1 (projective)
        += a2 (affine; (0, 0) encodes infinity). canonical_bases=True
        asserts a2's limbs are canonical, so the infinity test is an
        all-limbs-zero compare instead of a REDC."""
        X1, Y1, Z1 = p1
        x2, y2 = a2
        m0, m1, m2, m3, m4 = F.mul_many([
            (X1, x2),
            (Y1, y2),
            (F.add(X1, Y1), F.add(x2, y2)),
            (y2, Z1),
            (x2, Z1),
        ])
        t3 = F.sub(F.sub(m2, m0), m1)
        t4 = F.add(m3, Y1)
        y3p = F.add(m4, X1)
        x3a = F.smul(3, m0)
        t2b = b3_mul(Z1)
        z3a = F.add(m1, t2b)
        t1b = F.sub(m1, t2b)
        y3b = b3_mul(y3p)
        q0, q1, q2, q3, q4, q5 = F.mul_many([
            (t4, y3b), (t3, t1b), (y3b, x3a),
            (t1b, z3a), (x3a, t3), (z3a, t4),
        ])
        out = (F.sub(q1, q0), F.add(q3, q2), F.add(q5, q4))
        # (0, 0) encodes affine infinity: identity on that lane
        if canonical_bases:
            inf2 = None
            for l in tree_leaves((x2, y2)):
                z = (l == 0).all(dim=0)
                inf2 = z if inf2 is None else inf2 & z
            return tree_select(inf2, p1, out)
        inf2x, inf2y = F.is_zero_many([x2, y2])
        return tree_select(inf2x & inf2y, p1, out)

    def scalar_mul_bits(bits, pt):
        """Per-lane scalar mul. bits: [nbits, B] integer tensor (MSB first)."""
        x0 = tree_leaves(pt[0])[0]
        acc = infinity(x0.shape[1:], x0.device)
        for bit in bits:
            acc = double(acc)
            acc_plus = add(acc, pt)
            acc = tree_select(bit != 0, acc_plus, acc)
        return acc

    def scalar_mul_const(k: int, pt):
        """Multiply every lane by the same scalar (the same double, add and
        select per bit as scalar_mul_bits)."""
        x0 = tree_leaves(pt[0])[0]
        bits = _const_bits(k, x0.device)
        bits = bits[:, None].expand(bits.shape[0], *x0.shape[1:])
        return scalar_mul_bits(bits, pt)

    def msum_groups(p, groups: int = 1, fold_lanes: int = 128):
        """Per-group lane sums: [G*B] (G equal contiguous groups) -> [G].

        Two phases, in the JAX package's fold order (so the limbs match):
          1. scan-fold: each group [B] -> [fold_lanes], adding chunks of
             fold_lanes lanes one after another (all groups side by side);
          2. recursive-doubling all-reduce on the remaining lanes
             (x += roll-within-group(x, 2^l), log2 rounds)."""
        G = groups
        x0 = tree_leaves(p)[0]
        total = x0.shape[-1]
        assert total % G == 0, (total, G)
        B = total // G
        L = min(fold_lanes, B)
        while L & (L - 1):  # round L down to a power of two
            L &= L - 1
        pad = (-B) % L
        if pad:
            infp = infinity((pad,), x0.device)
            p = tree_map(
                lambda x, i: torch.cat(
                    [
                        x.reshape(*x.shape[:-1], G, B),
                        i[..., None, :].expand(*x.shape[:-1], G, pad),
                    ],
                    dim=-1,
                ).reshape(*x.shape[:-1], G * (B + pad)),
                p,
                infp,
            )
            B += pad
        if B > L:
            k = B // L
            chunks = tree_map(
                lambda x: x.reshape(*x.shape[:-1], G, k, L)
                .movedim(-2, 0)
                .reshape(k, *x.shape[:-1], G * L),
                p,
            )
            # chunks leaves: [k, n, G*L]; fold over k in order
            p = tree_map(lambda x: x[0], chunks)
            for c in range(1, k):
                p = add(p, tree_map(lambda x: x[c], chunks))
        # recursive-doubling all-reduce over the last L lanes of each group
        for l in range(L.bit_length() - 1):
            shift = 1 << l
            rolled = tree_map(
                lambda a: torch.roll(
                    a.reshape(*a.shape[:-1], G, L), -shift, dims=-1
                ).reshape(a.shape),
                p,
            )
            p = add(p, rolled)
        return tree_map(lambda x: x.reshape(*x.shape[:-1], G, L)[..., 0], p)

    def msum(p, fold_lanes: int = 128):
        """Sum over the last batch axis -> batch of size 1."""
        return msum_groups(p, 1, fold_lanes)

    class Ops:
        pass

    ops = Ops()
    ops.F = F
    ops.infinity = infinity
    ops.is_infinity = is_infinity
    ops.from_affine = from_affine
    ops.to_affine = to_affine
    ops.neg = neg
    ops.double = double
    ops.add = add
    ops.select = tree_select
    ops.tree_select = tree_select
    ops.scalar_mul_bits = scalar_mul_bits
    ops.scalar_mul_const = scalar_mul_const
    ops.msum = msum
    ops.msum_groups = msum_groups
    ops.madd = madd
    return ops


# --- curve constants: b3_mul(t) = 3*b*t per group --------------------------
#
# BLS12-377 G1: y^2 = x^3 + 1        -> 3b = 3 (scalar)
# BLS12-377 G2: y^2 = x^3 + (0, c1)u-part with c1 = -1/5 (D-type twist):
#   3b = (0, 3c1); (a0 + a1 u)(0 + 3c1 u) = (-5*3c1*a1, 3c1*a0)
#   and -15c1 = 3 mod p, so component 0 is a free smul and component 1 one
#   constant multiply.

def _b3_mul_g2(t):
    a0, a1 = t
    d = FQ.const(3 * _G2_B_C1 % P, a0.shape[1:], a0.device)
    return (fq.mul_small(a1, 3), fq.mul(a0, d))


g1 = make_curve_ops(_FqWrap, lambda t: _FqWrap.smul(3, t))
g2 = make_curve_ops(_F2Wrap, _b3_mul_g2)
# BW6-761 G1: y^2 = x^3 - 1 -> 3b = -3; G2: y^2 = x^3 + 4 -> 3b = 12
bw6_g1 = make_curve_ops(
    _Fq761Wrap, lambda t: _Fq761Wrap.neg(_Fq761Wrap.smul(3, t))
)
bw6_g2 = make_curve_ops(_Fq761Wrap, lambda t: _Fq761Wrap.smul(12, t))


# --- host <-> device point packing ----------------------------------------

def pack_jac(spec, points, device):
    """List of affine host points (or None) -> projective batch over a
    prime field. Infinity packs as (0, 1, 0)."""
    xs, ys, zs = [], [], []
    for pt in points:
        if pt is None:
            xs.append(0)
            ys.append(1)
            zs.append(0)
        else:
            xs.append(pt[0])
            ys.append(pt[1])
            zs.append(1)
    return (spec.pack(xs, device), spec.pack(ys, device), spec.pack(zs, device))


def pack_affine(spec, points, device):
    """List of affine host points (None = infinity -> (0, 0)) -> (x, y)."""
    xs = [0 if p is None else p[0] for p in points]
    ys = [0 if p is None else p[1] for p in points]
    return (spec.pack(xs, device), spec.pack(ys, device))


def unpack_jac(spec, dev_pt):
    """Projective batch over a prime field (FQ for BLS12-377 G1, FQ761 for
    BW6 G1/G2) -> list of affine host points (None = infinity), with one
    host modular inverse (Montgomery batch inversion)."""
    X, Y, Z = dev_pt
    xs = spec.unpack(X)
    ys = spec.unpack(Y)
    zs = spec.unpack(Z)
    p = spec.modulus
    prefix = [0] * len(zs)
    acc = 1
    for i, z in enumerate(zs):
        prefix[i] = acc
        if z:
            acc = acc * z % p
    inv = pow(acc, -1, p)
    out = [None] * len(zs)
    for i in range(len(zs) - 1, -1, -1):
        z = zs[i]
        if z:
            zi = inv * prefix[i] % p
            inv = inv * z % p
            out[i] = (xs[i] * zi % p, ys[i] * zi % p)
    return out


def g1_pack(points, device):
    """List of affine host points (or None) -> G1 projective batch."""
    return pack_jac(FQ, points, device)


def g1_unpack(dev_pt):
    """G1 projective batch -> list of affine host points (None=infinity)."""
    return unpack_jac(FQ, dev_pt)


def g2_pack(points, device):
    xs0, xs1, ys0, ys1, zs = [], [], [], [], []
    for pt in points:
        if pt is None:
            xs0.append(0)
            xs1.append(0)
            ys0.append(1)
            ys1.append(0)
            zs.append(0)
        else:
            (x0, x1), (y0, y1) = pt
            xs0.append(x0)
            xs1.append(x1)
            ys0.append(y0)
            ys1.append(y1)
            zs.append(1)
    pk = lambda vals: FQ.pack(vals, device)  # noqa: E731
    return (
        (pk(xs0), pk(xs1)),
        (pk(ys0), pk(ys1)),
        (pk(zs), pk([0] * len(zs))),
    )


def g2_unpack(dev_pt):
    """G2 projective batch -> host affine points, with one host Fq2
    inverse (batch inversion)."""
    X, Y, Z = dev_pt
    x0, x1 = FQ.unpack(X[0]), FQ.unpack(X[1])
    y0, y1 = FQ.unpack(Y[0]), FQ.unpack(Y[1])
    z0, z1 = FQ.unpack(Z[0]), FQ.unpack(Z[1])
    n = len(z0)
    prefix = [fp2.ONE] * n
    acc = fp2.ONE
    zs = list(zip(z0, z1))
    for i, z in enumerate(zs):
        prefix[i] = acc
        if z != (0, 0):
            acc = fp2.mul(acc, z)
    inv = fp2.inv(acc)
    out = [None] * n
    for i in range(n - 1, -1, -1):
        z = zs[i]
        if z != (0, 0):
            zi = fp2.mul(inv, prefix[i])
            inv = fp2.mul(inv, z)
            out[i] = (
                fp2.mul((x0[i], x1[i]), zi),
                fp2.mul((y0[i], y1[i]), zi),
            )
    return out


# --- batch projective->affine on the device + packed point carrier ---------

def _flatten(tree):
    """(leaves, rebuild): rebuild(list of leaves) -> the tree's structure."""
    leaves = tree_leaves(tree)

    def rebuild(vals):
        it = iter(vals)
        return tree_map(lambda _: next(it), tree)

    return leaves, rebuild


class PointVec:
    """A batch of affine points held as RAW canonical uint16 limb matrices
    (numpy [n_limbs, B] per affine field component; infinity = all-zero
    coordinates). The zero-marshaling point representation between the
    setup's device fixed-base kernels, ProvingKey storage, and the
    prover's MSM base packing.

    Acts as a sequence of host affine points (tuples of python ints,
    None = infinity) for serialization/tests; the bulk conversion is lazy
    and cached."""

    def __init__(self, leaves, spec, template):
        self.leaves = [np.asarray(l) for l in leaves]
        self.spec = spec
        self.template = template  # host affine structure, e.g. (0, 0)
        self._host = None
        self._rebuild = _flatten(template)[1]

    def __len__(self):
        return int(self.leaves[0].shape[-1])

    def to_host_list(self):
        if self._host is None:
            cols = [self.spec.unpack_raw(l) for l in self.leaves]
            pts = []
            for vals in zip(*cols):
                if all(v == 0 for v in vals):
                    pts.append(None)
                else:
                    pts.append(self._rebuild(list(vals)))
            self._host = pts
        return self._host

    def __iter__(self):
        return iter(self.to_host_list())

    def __getitem__(self, i):
        return self.to_host_list()[i]

    def __eq__(self, other):
        """Sequence equality against any iterable of host affine points
        (ProvingKey dataclass equality compares query vectors)."""
        if isinstance(other, PointVec):
            other = other.to_host_list()
        if isinstance(other, (list, tuple)):
            return self.to_host_list() == list(other)
        return NotImplemented

    def device_montgomery(self, device, pad_to=None):
        """Affine tree on `device` (Montgomery int32 limbs) shaped like the
        group's pack_fn output: one copy of the limbs to the card, then
        from_raw and reduce_2p as one CUDA graph per shape
        (pv_fromraw_<field>)."""
        B0 = self.leaves[0].shape[-1]
        B = pad_to or B0
        arrs = [
            np.pad(l, ((0, 0), (0, B - B0))) if B > B0 else l
            for l in self.leaves
        ]
        cat = np.concatenate(arrs, axis=-1).astype(np.int32)
        fops = ops_for(self.spec)
        # reduce_2p: from_raw output is < 2p, so a zero (infinity)
        # coordinate can come back as exactly p, whose nonzero limbs
        # would defeat madd's all-zero-limb infinity test
        fn = aotcache.jit(f"pv_fromraw_{self.spec.name}",
                          lambda x: fops.reduce_2p(fops.from_raw(x)), fops)
        dev = fn(torch.from_numpy(cat).to(device))
        parts = [dev[..., i * B : (i + 1) * B] for i in range(len(self.leaves))]
        return self._rebuild(parts)


_AFFINE_RAW = {}


def make_affine_raw(curve, fops, host_inv, template, tag="affine"):
    """Device projective batch -> PointVec, with ONE host modular inverse.

    Montgomery batch inversion on the device: Hillis-Steele inclusive
    prefix/suffix products of the (infinity-masked) Z column, every round
    one full-width field multiply, then inv(z_i) = P_{i-1} * S_{i+1} * T^-1
    where only T^-1 crosses to the host (a handful of bytes).

    Two device programs, as the JAX package's two executables, each one
    CUDA graph per shape: aff1_<tag> (the products and T's raw limbs) and
    aff2_<tag> (the inverses and the affine raw limbs); the host inverse
    runs between them and the fetch after them.

    host_inv: tuple of leaf ints -> tuple of leaf ints (field inverse of
    the total product T, computed on host)."""
    F = curve.F
    spec = fops.spec

    def scan_products(zden, B, idx, reverse):
        P = zden
        s = 1
        while s < B:
            if reverse:
                rolled = tree_map(lambda a: torch.roll(a, -s, dims=-1), P)
                edge = idx >= B - s
            else:
                rolled = tree_map(lambda a: torch.roll(a, s, dims=-1), P)
                edge = idx < s
            rolled = F.select(edge, F.ones((B,), idx.device), rolled)
            P = F.mul(P, rolled)
            s <<= 1
        return P

    def part1(pt):
        Z = pt[2]
        z0 = tree_leaves(Z)[0]
        B, device = z0.shape[-1], z0.device
        idx = torch.arange(B, device=device)
        m = F.is_zero(Z)
        zden = F.select(m, F.ones((B,), device), Z)
        Pf = scan_products(zden, B, idx, reverse=False)
        Sf = scan_products(zden, B, idx, reverse=True)
        total = tree_map(lambda a: a[..., B - 1 : B], Pf)
        return Pf, Sf, m, [fops.to_raw(l) for l in tree_leaves(total)]

    def part2(pt, Pf, Sf, m, invT):
        X, Y, Z = pt
        z0 = tree_leaves(Z)[0]
        B, device = z0.shape[-1], z0.device
        idx = torch.arange(B, device=device)
        ones = F.ones((B,), device)
        left = tree_map(lambda a: torch.roll(a, 1, dims=-1), Pf)
        left = F.select(idx < 1, ones, left)          # P_{i-1}
        right = tree_map(lambda a: torch.roll(a, -1, dims=-1), Sf)
        right = F.select(idx >= B - 1, ones, right)   # S_{i+1}
        invT_b = tree_map(lambda a: a.expand(a.shape[0], B), invT)
        zi = F.mul(F.mul(left, right), invT_b)
        xa = F.mul(X, zi)
        ya = F.mul(Y, zi)
        leaves = []
        for l in tree_leaves((xa, ya)):
            r = fops.to_raw(l)
            # uint16 bit pattern: half the bytes of the fetch
            leaves.append(torch.where(m[None], torch.zeros_like(r), r).to(torch.int16))
        return leaves

    aff1 = aotcache.jit(f"aff1_{tag}", part1, curve, fops)
    aff2 = aotcache.jit(f"aff2_{tag}", part2, curve, fops)

    def run(dev_pt):
        Pf, Sf, m, t_raw = aff1(dev_pt)
        t_ints = tuple(spec.unpack_raw(l)[0] for l in t_raw)
        device = t_raw[0].device
        packed = [spec.pack([v], device) for v in host_inv(t_ints)]
        # match the field-element structure of Z: bare tensor for Fp,
        # component tuple for extension fields
        invT = packed[0] if len(packed) == 1 else tuple(packed)
        leaves = aff2(dev_pt, Pf, Sf, m, invT)
        return PointVec([l.cpu().numpy().view(np.uint16) for l in leaves],
                        spec, template)

    return run


def affine_raw_fn(curve, fops, host_inv, template, tag):
    if tag not in _AFFINE_RAW:
        _AFFINE_RAW[tag] = make_affine_raw(curve, fops, host_inv, template, tag)
    return _AFFINE_RAW[tag]

"""Batched twisted-Edwards ops on the card (Edwards-on-BW6-761), the
PyTorch counterpart of the JAX package's ops/edwards.py.

Hosts the Bowe-Hopwood Pedersen CRH (ops/pedersen.py), the reference's
production sign-path hasher (crates/bls-crypto/src/hashers/composite.rs:
16-32).

Curve: a x^2 + y^2 = 1 + d x^2 y^2 over BLS12-377 Fq (= BW6-761 Fr),
a = -1, d = 79743 (hostmath/curves.py). Points are extended coordinates
(X, Y, T, Z) as tuples of Montgomery int32 limb tensors [n, B]
(ops/field.py conventions: lazy adds, mul erases drift); every product
goes through fq.mul_many, i.e. one mont_mul launch per stacked layer.

Table points for mixed addition are stored as (x, y, td) with td = d*x*y
premultiplied on the host, so the unified a=-1 extended addition costs 7
field products in two stacked mul_many launches.

Bit-exactness oracle: hostmath/curves.py ed_*.
"""

from ..hostmath.params import P, ED_D
from ..utils.tree import tree_map
from .field import FQ, fq


def identity(batch, device):
    z = FQ.zeros(batch, device)
    o = FQ.ones(batch, device)
    return (z, o, z, o)


def neg(pt):
    X, Y, T, Z = pt
    return (fq.neg(X), Y, fq.neg(T), Z)


def tree_select(c, a, b):
    return tree_map(lambda x, y: fq.select(c, x, y), a, b)


def add(p1, p2):
    """Unified extended addition, a = -1 (hostmath ed_add parity).
    Handles identity and doubling inputs."""
    X1, Y1, T1, Z1 = p1
    X2, Y2, T2, Z2 = p2
    A, B, TT, ZZ = fq.mul_many([
        (fq.sub(Y1, X1), fq.sub(Y2, X2)),
        (fq.add(Y1, X1), fq.add(Y2, X2)),
        (T1, T2),
        (Z1, Z2),
    ])
    C = fq.mul(TT, FQ.const(2 * ED_D % P, (1,), TT.device))
    D = fq.add(ZZ, ZZ)
    E = fq.sub(B, A)
    F = fq.sub(D, C)
    G = fq.add(D, C)
    H = fq.add(B, A)
    X3, Y3, T3, Z3 = fq.mul_many([(E, F), (G, H), (E, H), (F, G)])
    return (X3, Y3, T3, Z3)


def madd(p1, a2):
    """Mixed addition: a2 = (x2, y2, td2) affine with Z2 = 1 and
    td2 = d*x2*y2 host-premultiplied. 7 products, 2 launches."""
    X1, Y1, T1, Z1 = p1
    x2, y2, td2 = a2
    A, B, C1 = fq.mul_many([
        (fq.sub(Y1, X1), fq.sub(y2, x2)),
        (fq.add(Y1, X1), fq.add(y2, x2)),
        (T1, td2),
    ])
    C = fq.add(C1, C1)
    D = fq.add(Z1, Z1)
    E = fq.sub(B, A)
    F = fq.sub(D, C)
    G = fq.add(D, C)
    H = fq.add(B, A)
    X3, Y3, T3, Z3 = fq.mul_many([(E, F), (G, H), (E, H), (F, G)])
    return (X3, Y3, T3, Z3)


def pack_affine_td(points, device):
    """Host affine (x, y) pairs (python ints) -> (x, y, td) Montgomery
    tensors [n, B] on `device`, td = d*x*y mod p."""
    xs, ys, tds = [], [], []
    for x, y in points:
        xs.append(x % P)
        ys.append(y % P)
        tds.append(ED_D * x % P * y % P)
    return (FQ.pack(xs, device), FQ.pack(ys, device), FQ.pack(tds, device))


def unpack_extended(pt):
    """Extended batch -> list of host affine (x, y) python-int pairs
    (batched inversion on the host: one modular inverse in all)."""
    X, Y, T, Z = pt
    xs = FQ.unpack(X)
    ys = FQ.unpack(Y)
    zs = FQ.unpack(Z)
    # Montgomery batch inversion of the Z column
    B = len(zs)
    prefix = [1] * (B + 1)
    for i, z in enumerate(zs):
        prefix[i + 1] = prefix[i] * z % P
    inv_all = pow(prefix[B], -1, P)
    zinvs = [0] * B
    for i in range(B - 1, -1, -1):
        zinvs[i] = prefix[i] * inv_all % P
        inv_all = inv_all * zs[i] % P
    return [
        (x * zi % P, y * zi % P) for x, y, zi in zip(xs, ys, zinvs)
    ]

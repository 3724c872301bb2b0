"""Batched optimal-ate pairing for BLS12-377, the PyTorch counterpart of
the JAX package's ops/pairing.py.

Structure (mirrors the batched verification paths of the reference —
crates/bls-crypto/src/bls/signature.rs:125-155):

  - miller_loop_batch: lane-parallel Miller loops (one per (P, Q) pair) in
    homogeneous projective coordinates on the twist (inversion-free; line
    values carry spurious Fq2 factors which the final exponentiation kills).
  - f12_product: log-depth tree product over the batch axis — n+1 Miller
    loops, ONE final exponentiation.
  - final_exponentiation: easy part + the (x-1)^2 (x+p) (x^2+p^2-1) + 3
    addition chain. NOTE: computes f^(3*(p^12-1)/r) — a cofactor-3 scaled
    pairing. Equality checks against 1 are unaffected (gcd(3, r) = 1).

The Miller loop is a Python loop over the 63 low bits of the BLS parameter
X; the (hamming-weight-6) add step runs under a Python `if` on the static
bit. All field products inside a step are stacked into a handful of wide
kernel launches.
"""

import torch

from ..hostmath.params import X
from ..utils.profiling import device_span
from ..utils.tree import tree_leaves, tree_map
from .field import fq
from . import tower as tw

_X_BITS = [int(b) for b in bin(X)[3:]]  # 63 bits after the MSB, MSB-first


def _dbl_step(T, xp_neg3, yp):
    """Double T (projective on twist); return (2T, line coeffs at P).

    Line (scaled by the Fq2 factor 2YZ^2):
      c_a = 2YZ^2 * yP,  c_w = 3X^2 Z * (-xP),  c_w3 = 3X^3 - 2Y^2 Z
    """
    Xt, Yt, Zt = T
    XX, YY, YZ = tw.f2_mul_batch([(Xt, Xt), (Yt, Yt), (Yt, Zt)])
    twoYZ = tw.f2_smul(2, YZ)
    ln = tw.f2_smul(3, XX)
    XXZ, XXX, YYZ, tYZZ, ln2, ld2 = tw.f2_mul_batch(
        [(XX, Zt), (XX, Xt), (YY, Zt), (twoYZ, Zt), (ln, ln), (twoYZ, twoYZ)]
    )
    c_w3 = tw.f2_sub(tw.f2_smul(3, XXX), tw.f2_smul(2, YYZ))
    ca0, ca1, cw0, cw1 = fq.mul_many(
        [(tYZZ[0], yp), (tYZZ[1], yp), (XXZ[0], xp_neg3), (XXZ[1], xp_neg3)]
    )
    c_a = (ca0, ca1)
    c_w = (cw0, cw1)
    ln2Z, Xld2, ld3 = tw.f2_mul_batch([(ln2, Zt), (Xt, ld2), (ld2, twoYZ)])
    X3p = tw.f2_sub(ln2Z, tw.f2_smul(2, Xld2))
    Y3a, Z3, X3, Yld3 = tw.f2_mul_batch(
        [(ln, tw.f2_sub(Xld2, X3p)), (ld3, Zt), (X3p, twoYZ), (Yt, ld3)]
    )
    Y3 = tw.f2_sub(Y3a, Yld3)
    return (X3, Y3, Z3), (c_a, c_w, c_w3)


def _add_step(T, Q, xp_neg, yp):
    """Mixed addition T += Q (Q affine on twist); line through T, Q at P.

    theta = Y - yQ Z, lambda_d = X - xQ Z; line scaled by lambda_d:
      c_a = lambda_d * yP, c_w = theta * (-xP), c_w3 = theta xQ - lambda_d yQ
    """
    Xt, Yt, Zt = T
    xq, yq = Q
    yqZ, xqZ = tw.f2_mul_batch([(yq, Zt), (xq, Zt)])
    th = tw.f2_sub(Yt, yqZ)
    ld = tw.f2_sub(Xt, xqZ)
    C, th2, thxq, ldyq = tw.f2_mul_batch([(ld, ld), (th, th), (th, xq), (ld, yq)])
    c_w3 = tw.f2_sub(thxq, ldyq)
    ca0, ca1, cw0, cw1 = fq.mul_many(
        [(ld[0], yp), (ld[1], yp), (th[0], xp_neg), (th[1], xp_neg)]
    )
    c_a = (ca0, ca1)
    c_w = (cw0, cw1)
    D, E, th2Z = tw.f2_mul_batch([(C, ld), (Xt, C), (th2, Zt)])
    F = tw.f2_sub(tw.f2_add(th2Z, D), tw.f2_smul(2, E))
    X3, thEF, DY, Z3 = tw.f2_mul_batch(
        [(ld, F), (th, tw.f2_sub(E, F)), (D, Yt), (Zt, D)]
    )
    Y3 = tw.f2_sub(thEF, DY)
    return (X3, Y3, Z3), (c_a, c_w, c_w3)


def miller_loop_batch(p_aff, q_aff):
    """Lane-parallel Miller loops.

    p_aff: (xp, yp) Fq tensors [n, B]; q_aff: (xq, yq) Fq2 pairs.
    Lanes whose P or Q is the affine-zero point (the infinity encoding)
    yield f = 1, matching arkworks' filtering of zero pairs. On the card
    the device span gpu.pairing.miller.
    """
    xp, yp = p_aff
    xq, yq = q_aff
    batch, device = xp.shape[1:], xp.device
    with device_span("gpu.pairing.miller", xp):
        inf_p = fq.is_zero(xp) & fq.is_zero(yp)
        inf_q = tw.f2_is_zero(xq) & tw.f2_is_zero(yq)
        skip = inf_p | inf_q
        xp_neg = fq.neg(xp)
        xp_neg3 = fq.mul_small(xp_neg, 3)

        f = tw.f12_ones(batch, device)
        T = (xq, yq, tw.f2_ones(batch, device))
        for bit in _X_BITS:
            f = tw.f12_sq(f)
            T, (c_a, c_w, c_w3) = _dbl_step(T, xp_neg3, yp)
            f = tw.f12_mul_line(f, c_a, c_w, c_w3)
            if bit:
                T, (ca2, cw2, cw32) = _add_step(T, (xq, yq), xp_neg, yp)
                f = tw.f12_mul_line(f, ca2, cw2, cw32)
        return tw.f12_select(skip, tw.f12_ones(batch, device), f)


def f12_product(f):
    """Tree product over the batch axis: [.., B] -> [.., 1]."""
    while tree_leaves(f)[0].shape[-1] > 1:
        x0 = tree_leaves(f)[0]
        if x0.shape[-1] % 2:
            ones = tw.f12_ones((1,), x0.device)
            f = tree_map(lambda x, o: torch.cat([x, o], dim=-1), f, ones)
        even = tree_map(lambda x: x[..., 0::2], f)
        odd = tree_map(lambda x: x[..., 1::2], f)
        f = tw.f12_mul(even, odd)
    return f


def f12_powx(a, e: int, cyclo: bool = False):
    """a^e for a FIXED exponent (e > 0). cyclo=True uses Granger-Scott
    cyclotomic squarings (valid only for unitary `a` — the post-easy-part
    final-exp chains): 30-wide vs 54-wide fq launches. A multiply happens
    only at set bits: for X (7 set bits in 64), 63 squarings + 6 muls."""
    sq = tw.f12_cyclo_sq if cyclo else tw.f12_sq

    def squarings(x, k):
        for _ in range(k):
            x = sq(x)
        return x

    res = a
    run = 0
    for b in bin(e)[3:]:
        run += 1
        if b == "1":
            res = tw.f12_mul(squarings(res, run), a)
            run = 0
    return squarings(res, run)


def final_exponentiation(f):
    """f^(3*(p^12-1)/r): easy part then the chain
    (x-1)^2 (x+p) (x^2+p^2-1) + 3  ==  3*(p^4-p^2+1)/r. On the card the
    device span gpu.pairing.final_exp."""
    with device_span("gpu.pairing.final_exp", f):
        finv = tw.f12_inv(f)
        m = tw.f12_mul(tw.f12_conj(f), finv)      # f^(p^6-1)
        m = tw.f12_mul(tw.f12_frob_n(m, 2), m)    # ^(p^2+1)
        # m is unitary from here on: cyclotomic squarings throughout the chains
        t0 = f12_powx(f12_powx(m, X - 1, cyclo=True), X - 1, cyclo=True)
        t1 = tw.f12_mul(f12_powx(t0, X, cyclo=True), tw.f12_frob(t0))  # ^(x+p)
        t2 = tw.f12_mul(
            tw.f12_mul(
                f12_powx(f12_powx(t1, X, cyclo=True), X, cyclo=True),
                tw.f12_frob_n(t1, 2),
            ),
            tw.f12_conj(t1),
        )  # ^(x^2+p^2-1)
        return tw.f12_mul(t2, tw.f12_mul(tw.f12_cyclo_sq(m), m))  # * m^3


def pairing_check_product(p_aff, q_aff):
    """prod_i e(P_i, Q_i) == 1 over the whole batch; returns bool [1]."""
    f = miller_loop_batch(p_aff, q_aff)
    f = f12_product(f)
    e = final_exponentiation(f)
    return tw.f12_is_one(e)

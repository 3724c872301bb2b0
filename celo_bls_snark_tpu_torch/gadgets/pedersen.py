"""In-circuit Bowe-Hopwood Pedersen CRH over the Edwards curve.

Parity with the ark-crypto-primitives bowe_hopwood gadget as used by
HashToGroupGadget::pedersen_hash (crates/bls-gadgets/src/hash_to_group.rs).
Per 3-bit chunk (b0, b1, b2) with constant chunk generator g:
  value = (1 + b0 + 2*b1) * g, negated iff b2
via a 2-bit constant-table lookup (precomputed multiples 1g..4g) and a
conditional y-negation, accumulated with the COMPLETE twisted-Edwards
addition (witnessed quotients — 7 constraints per add).

The generator table comes from hashers/composite.py (the ChaCha20-derived
table already pinned by the composite CRH golden vectors).
"""

from ..hostmath.params import P, ED_D
from ..hostmath import curves as hc
from ..hashers.composite import crh_parameters, WINDOW_SIZE, CHUNK_SIZE
from ..relations.r1cs import LinearCombination
from .vars import Boolean, FpVar


class EdwardsVar:
    """Affine twisted-Edwards point variable (complete group law)."""

    def __init__(self, x: FpVar, y: FpVar):
        self.x = x
        self.y = y
        self.cs = x.cs

    @classmethod
    def identity(cls, cs):
        return cls(FpVar.const(cs, 0), FpVar.const(cs, 1))

    def value(self):
        if self.x.value is None:
            return None
        return (self.x.value, self.y.value)

    def add(self, o: "EdwardsVar"):
        """Complete TE addition (a = -1, d = ED_D):
        x3 = (x1 y2 + y1 x2) / (1 + d x1 x2 y1 y2)
        y3 = (y1 y2 + x1 x2) / (1 - d x1 x2 y1 y2)"""
        cs = self.cs
        x1x2 = self.x.mul(o.x)
        y1y2 = self.y.mul(o.y)
        x1y2 = self.x.mul(o.y)
        y1x2 = self.y.mul(o.x)
        t = x1x2.mul(y1y2)  # x1 x2 y1 y2
        one = FpVar.const(cs, 1)
        den_x = one.add(t.mul_const(ED_D))
        den_y = one.sub(t.mul_const(ED_D))
        # witness the results, enforce x3 * den_x == num_x etc.
        val = None
        if self.value() is not None and o.value() is not None:
            p1 = hc.ed_from_affine(self.value())
            p2 = hc.ed_from_affine(o.value())
            val = hc.ed_to_affine(hc.ed_add(p1, p2))
        x3 = FpVar.new_witness(cs, 0 if val is None else val[0])
        y3 = FpVar.new_witness(cs, 0 if val is None else val[1])
        cs.enforce_constraint(x3.lc, den_x.lc, x1y2.add(y1x2).lc)
        cs.enforce_constraint(y3.lc, den_y.lc, y1y2.add(x1x2).lc)
        return EdwardsVar(x3, y3)


def _chunk_generator_multiples():
    """[segment][chunk] -> ((x1,y1),...,(x4,y4)) constant multiples."""
    params = crh_parameters()
    out = []
    for seg in params:
        row = []
        for g in seg:
            muls = []
            acc = None
            for _ in range(4):
                acc = g if acc is None else hc.ed_add(acc, g)
                muls.append(hc.ed_to_affine(acc))
            row.append(tuple(muls))
        out.append(row)
    return out


_MULTIPLES = None


def chunk_multiples():
    global _MULTIPLES
    if _MULTIPLES is None:
        _MULTIPLES = _chunk_generator_multiples()
    return _MULTIPLES


def _lookup_coord(cs, b0: Boolean, b1: Boolean, b0b1: Boolean, vals):
    """2-bit constant lookup: vals = (v1, v2, v3, v4) selected by
    1 + b0 + 2*b1. Linear in the bits given the precomputed b0&b1."""
    v1, v2, v3, v4 = vals
    lc = LinearCombination.constant(v1)
    lc = lc + b0.lc().scale((v2 - v1) % P)
    lc = lc + b1.lc().scale((v3 - v1) % P)
    lc = lc + b0b1.lc().scale((v4 - v3 - v2 + v1) % P)
    val = None
    if b0.value is not None:
        idx = 1 + int(bool(b0.value)) + 2 * int(bool(b1.value))
        val = vals[idx - 1]
    return FpVar(cs, lc, None if val is None else val % P)


def pedersen_crh_gadget(cs, message_bits):
    """message_bits: list[Boolean], LE bits of the message bytes (padded to
    a multiple of 3 with constant falses, as the native CRH does).
    Returns (point_var, crh_bits): the CRH point and the 384 LE bits of its
    serialized x-coordinate (the composite hasher's crh output)."""
    with cs.ns("pedersen_crh"):
        bits = list(message_bits)
        while len(bits) % CHUNK_SIZE != 0:
            bits.append(Boolean.false(cs))
        multiples = chunk_multiples()
        acc = EdwardsVar.identity(cs)
        for ci in range(len(bits) // CHUNK_SIZE):
            b0, b1, b2 = bits[3 * ci : 3 * ci + 3]
            seg, j = divmod(ci, WINDOW_SIZE)
            vals = multiples[seg][j]
            b0b1 = b0.and_(b1)
            x_sel = _lookup_coord(cs, b0, b1, b0b1, [v[0] for v in vals])
            y_sel = _lookup_coord(cs, b0, b1, b0b1, [v[1] for v in vals])
            # conditional negation of x: x' = x * (1 - 2 b2)
            one_minus_2b2 = FpVar(
                cs,
                LinearCombination.constant(1) - b2.lc().scale(2),
                None if b2.value is None else (1 - 2 * int(bool(b2.value))) % P,
            )
            x_signed = x_sel.mul(one_minus_2b2)
            acc = acc.add(EdwardsVar(x_signed, y_sel))
        # crh output bits: LE bits of the 48-byte serialized x (377 bits + 7 zeros)
        x_bits = acc.x.to_bits_le()[:377] + [Boolean.false(cs)] * 7
        return acc, x_bits

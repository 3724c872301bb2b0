"""Point-compression sign-bit gadgets.

Parity with crates/bls-gadgets/src/y_to_bit.rs:
  - g1_y_to_bit: bit = (y > (p-1)/2) via FpVar.normalize
  - g2_y_to_bit: lexicographic over Fp2: c1 > half OR (c1 == 0 AND c0 > half),
    tied together with one multiplicative constraint (y_to_bit.rs:44-87).
"""

from ..relations.r1cs import LinearCombination
from .vars import Boolean, FpVar


def g1_y_to_bit(cs, y: FpVar) -> Boolean:
    with cs.ns("g1_y_to_bit"):
        return y.normalize()


def g2_y_to_bit(cs, y_c0: FpVar, y_c1: FpVar) -> Boolean:
    with cs.ns("g2_y_to_bit"):
        half = (cs.p - 1) // 2
        # witness the final bit
        if cs.is_in_setup_mode():
            bit = Boolean.new_witness(cs, False)
        else:
            c0, c1 = y_c0.value, y_c1.value
            bit = Boolean.new_witness(cs, c1 > half or (c1 == 0 and c0 > half))
        y_c0_bit = y_c0.normalize()
        y_c1_bit = y_c1.normalize()
        y_eq_bit = y_c1.is_eq_zero()
        bc = y_eq_bit.and_(y_c0_bit)
        # (1 - c1_bit) * bc = bit - c1_bit
        cs.enforce_constraint(
            LinearCombination.constant(1) - y_c1_bit.lc(),
            bc.lc(),
            bit.lc() - y_c1_bit.lc(),
        )
        return bit

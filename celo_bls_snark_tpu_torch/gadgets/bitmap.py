"""Bitmap occurrence-threshold gadget.

Parity with crates/bls-gadgets/src/bitmap.rs: count occurrences of `value`
(0 or 1) in a bitmap via a linear combination, allocate the count as a
witness, enforce count <= max_occurrences, and tie the LC to the witness
with one constraint. Counting is skipped in setup mode (bitmap.rs:30-33).
"""

from ..relations.r1cs import LinearCombination
from .vars import Boolean, FpVar


def enforce_maximum_occurrences_in_bitmap(cs, bitmap, max_occurrences: FpVar, value: bool):
    """bitmap: list[Boolean]."""
    with cs.ns("enforce_maximum_occurrences_in_bitmap"):
        is_setup = cs.is_in_setup_mode()
        occurrences = 0
        occurrences_lc = LinearCombination()
        for bit in bitmap:
            if not value:
                # add 1 here only for zeros; bits then contribute -1 each
                occurrences_lc = occurrences_lc + LinearCombination.constant(1)
                occurrences_lc = occurrences_lc - bit.lc()
            else:
                occurrences_lc = occurrences_lc + bit.lc()
            if not is_setup:
                occurrences += int(bool(bit.value) == value)

        occ_var = FpVar.new_witness(cs, occurrences)
        # occurrences <= max
        occ_var.enforce_cmp_leq(max_occurrences)
        # tie the LC to the allocated witness: lc * 1 = occ
        cs.enforce_constraint(
            occurrences_lc, LinearCombination.constant(1), occ_var.lc
        )

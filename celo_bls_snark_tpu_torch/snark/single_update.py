"""SingleUpdate gadget: one epoch transition.

Parity with crates/epoch-snark/src/gadgets/single_update.rs: constrain the
epoch data (encoding + sequencing + message hash), chain the entropy to the
previous epoch (gated on non-dummy AND entropy-enabled), and enforce the
signed bitmap against the PREVIOUS epoch's public keys with padding-pk
exclusion.
"""

from ..hostmath.params import P
from ..gadgets.vars import Boolean, FpVar
from ..gadgets.curve_vars import G2Var
from ..gadgets import bls as gbls
from .gadgets_epoch import EpochDataGadget
from .epoch_block import EpochBlock


class SingleUpdateGadget:
    def __init__(self, epoch_data: EpochDataGadget, signed_bitmap):
        self.epoch_data = epoch_data
        self.signed_bitmap = signed_bitmap  # list of Optional[bool]

    @classmethod
    def empty(cls, num_validators: int):
        return cls(EpochDataGadget.empty(num_validators), [None] * num_validators)

    def constrain(
        self,
        cs,
        previous_pubkeys,
        previous_epoch_index: FpVar,
        previous_epoch_randomness: FpVar,
        previous_max_non_signers: FpVar,
        constrain_entropy_bit: Boolean,
        num_validators: int,
        generate_constraints_for_hash: bool,
    ):
        """Returns the ConstrainedEpoch dict (single_update.rs:79-136)."""
        assert num_validators == len(self.epoch_data.public_keys)
        with cs.ns("SingleUpdate"):
            epoch = self.epoch_data.constrain(
                cs, previous_epoch_index, generate_constraints_for_hash
            )
            index_bit = epoch["index"].is_eq_zero().not_()
            # entropy chaining, gated on non-dummy AND entropy-enabled
            previous_epoch_randomness.conditional_enforce_equal(
                epoch["parent_entropy"], index_bit.and_(constrain_entropy_bit)
            )
            bitmap = [
                Boolean.new_witness(cs, bool(b) if b is not None else False)
                for b in self.signed_bitmap
            ]
            padding = G2Var.constant(cs, EpochBlock.padding_pk().pt)
            message_hash, aggregate_pk = gbls.enforce_bitmap_with_aggregate(
                cs,
                previous_pubkeys,
                bitmap,
                epoch["message_hash"],
                previous_max_non_signers,
                padding,
            )
            return {
                "new_pubkeys": epoch["pubkeys"],
                "new_max_non_signers": epoch["maximum_non_signers"],
                "message_hash": message_hash,
                "aggregate_pk": aggregate_pk,
                "index": epoch["index"],
                "epoch_entropy": epoch["epoch_entropy"],
                "parent_entropy": epoch["parent_entropy"],
                "combined_first_epoch_bits": epoch["combined_first_epoch_bits"],
                "combined_last_epoch_bits": epoch["combined_last_epoch_bits"],
                "xof_input_bits": epoch["xof_input_bits"],
                "xof_bits": epoch["xof_bits"],
            }

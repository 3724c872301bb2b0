"""Epoch-data gadgets: in-circuit epoch encodings + transition checks.

Parity with crates/epoch-snark/src/gadgets/{mod,epoch_data}.rs:
  - fr_to_bits / bytes_to_fr / g2_to_bits helpers (mod.rs:86-112)
  - EpochDataGadget.to_bits: the in-circuit mirror of the native
    encode_inner/first/last bit encodings (epoch_data.rs:143-221)
  - enforce_next_epoch: index == previous + 1 unless dummy (index 0)
    (epoch_data.rs:224-233)

The message-hash leg (hash_bits_to_g1 -> gadgets/hash_to_group.py, with
the Pedersen CRH + Blake2Xs gadgets) is wired in via EpochDataGadget
.hash_bits_to_g1 below (epoch_data.rs:237-301 parity).
"""

from ..hostmath.params import P
from ..relations.r1cs import ConstraintSystem
from ..gadgets.vars import Boolean, FpVar
from ..gadgets.curve_vars import G2Var
from ..gadgets.y_to_bit import g2_y_to_bit

ENTROPY_BYTES = 16


def fr_to_bits(cs, var: FpVar, length: int):
    """LE bit decomposition truncated to `length` (mod.rs:94-99)."""
    bits = var.to_bits_le()
    return bits[:length]


def bytes_to_fr(cs, data: bytes) -> FpVar:
    """Witness the field element whose LE bytes are `data` (mod.rs:86-91)."""
    if cs.is_in_setup_mode():
        return FpVar.new_witness(cs, 0)
    v = int.from_bytes(data, "little") % cs.p
    return FpVar.new_witness(cs, v)


def g2_to_bits(cs, pk: G2Var):
    """x.c0 BE bits || x.c1 BE bits || lexicographic y bit (mod.rs:102-112)."""
    c0_bits = pk.x.c0.to_bits_le()[:377][::-1]
    c1_bits = pk.x.c1.to_bits_le()[:377][::-1]
    y_bit = g2_y_to_bit(cs, pk.y.c0, pk.y.c1)
    return c0_bits + c1_bits + [y_bit]


class EpochDataGadget:
    """Option-valued mirror of EpochBlock for in-circuit use
    (epoch_data.rs:25-38). Values None in setup mode."""

    def __init__(self, index, round_, epoch_entropy, parent_entropy,
                 maximum_non_signers, public_keys):
        self.index = index
        self.round = round_
        self.epoch_entropy = epoch_entropy      # bytes | None
        self.parent_entropy = parent_entropy    # bytes | None
        self.maximum_non_signers = maximum_non_signers
        self.public_keys = public_keys          # list of host G2 points | None

    @classmethod
    def empty(cls, num_validators):
        return cls(None, None, None, None, None, [None] * num_validators)

    def to_bits(self, cs: ConstraintSystem):
        """Returns (epoch_bits, extra_data_bits, first_epoch_bits,
        last_epoch_bits, index_var, epoch_entropy_var, parent_entropy_var,
        max_non_signers_var, pubkey_vars) — epoch_data.rs:143-221."""
        setup = cs.is_in_setup_mode()
        index = FpVar.new_witness(cs, 0 if setup else self.index)
        index_bits = fr_to_bits(cs, index, 16)
        round_ = FpVar.new_witness(cs, 0 if setup else self.round)
        round_bits = fr_to_bits(cs, round_, 8)
        maxns = FpVar.new_witness(cs, 0 if setup else self.maximum_non_signers)
        maxns_bits = fr_to_bits(cs, maxns, 32)

        empty = bytes(ENTROPY_BYTES)
        ee = self.epoch_entropy if self.epoch_entropy is not None else empty
        pe = self.parent_entropy if self.parent_entropy is not None else empty
        epoch_entropy_var = bytes_to_fr(cs, ee)
        epoch_entropy_bits = fr_to_bits(cs, epoch_entropy_var, 8 * ENTROPY_BYTES)
        parent_entropy_var = bytes_to_fr(cs, pe)
        parent_entropy_bits = fr_to_bits(cs, parent_entropy_var, 8 * ENTROPY_BYTES)

        epoch_bits = list(epoch_entropy_bits) + list(parent_entropy_bits)
        extra_data_bits = list(index_bits) + list(round_bits) + list(maxns_bits)
        first_epoch_bits = list(index_bits) + list(parent_entropy_bits) + list(maxns_bits)
        last_epoch_bits = list(index_bits) + list(epoch_entropy_bits) + list(maxns_bits)

        pubkey_vars = []
        for pk in self.public_keys:
            # checked allocation: ark's new_variable_omit_prime_order_check
            # (epoch_data.rs:194) still enforces the curve equation on the
            # witnessed coordinates — only x and the y-sign bit are bound by
            # the epoch encoding, so an unchecked y would let a malicious
            # prover feed off-curve points into the pairing gadget.
            pk_var = G2Var.new_witness_checked(cs, pk)
            pk_bits = g2_to_bits(cs, pk_var)
            epoch_bits += pk_bits
            first_epoch_bits += pk_bits
            last_epoch_bits += pk_bits
            pubkey_vars.append(pk_var)

        return (
            epoch_bits,
            extra_data_bits,
            first_epoch_bits,
            last_epoch_bits,
            index,
            epoch_entropy_var,
            parent_entropy_var,
            maxns,
            pubkey_vars,
        )

    @staticmethod
    def enforce_next_epoch(cs, previous_index: FpVar, index: FpVar):
        """index == previous + 1, unless index == 0 (dummy epoch)
        (epoch_data.rs:224-233)."""
        with cs.ns("enforce_next_epoch"):
            prev_plus_one = previous_index.add(FpVar.const(cs, 1))
            index_nonzero = index.is_eq_zero().not_()
            index.conditional_enforce_equal(prev_plus_one, index_nonzero)

    @staticmethod
    def hash_bits_to_g1(cs, epoch_bits, extra_data_bits, generate_constraints_for_hash):
        """BE bit-vectors -> byte-packed LE input -> witnessed try-and-
        increment counter -> HashToGroupGadget (epoch_data.rs:237-301).
        Returns (G1Var, xof_input_bits, xof_bits)."""
        from ..gadgets.hash_to_group import enforce_hash_to_group
        from ..hash_to_curve import composite_hash_to_g1_cip22
        from ..bls import SIG_DOMAIN
        from ..utils.bits import bits_le_to_bytes_le
        from ..utils.config import get_config

        with cs.ns("hash_bits_to_g1"):
            # reverse to LE and pad to whole bytes (with constant zeros)
            def to_le_bytes_bits(bits):
                le = list(bits)[::-1]
                while len(le) % 8:
                    le.append(Boolean.false(cs))
                return le

            msg_bits = to_le_bytes_bits(epoch_bits)
            extra_bits = to_le_bytes_bits(extra_data_bits)
            if cs.is_in_setup_mode():
                counter = 0
            else:
                msg_bytes = bits_le_to_bytes_le([bool(b.value) for b in msg_bits])
                extra_bytes = bits_le_to_bytes_le([bool(b.value) for b in extra_bits])
                # the witness-side native hasher must use the same sign-bit
                # convention the in-circuit extraction will enforce
                compat = get_config().compat_sign_bit == 377
                _, counter = composite_hash_to_g1_cip22(
                    compat=compat
                ).hash_with_attempt_cip22(SIG_DOMAIN, msg_bytes, extra_bytes)
            counter_bits = [
                Boolean.new_witness(cs, bool((counter >> i) & 1)) for i in range(8)
            ]
            return enforce_hash_to_group(
                cs, counter_bits, msg_bits, extra_bits, generate_constraints_for_hash
            )

    def constrain(self, cs, previous_index: FpVar, generate_constraints_for_hash: bool):
        """Full epoch-data constraint (epoch_data.rs:101-139): bit encoding,
        next-epoch sequencing, and the in-circuit message hash.

        Returns a dict with index/entropies/max_non_signers/message_hash/
        pubkeys/first/last bits/crh/xof bits (ConstrainedEpochData parity)."""
        with cs.ns("EpochData"):
            (
                bits,
                extra_bits,
                first_bits,
                last_bits,
                index,
                epoch_entropy,
                parent_entropy,
                maxns,
                pubkeys,
            ) = self.to_bits(cs)
            self.enforce_next_epoch(cs, previous_index, index)
            message_hash, xof_input_bits, xof_bits = self.hash_bits_to_g1(
                cs, bits, extra_bits, generate_constraints_for_hash
            )
            return {
                "index": index,
                "epoch_entropy": epoch_entropy,
                "parent_entropy": parent_entropy,
                "maximum_non_signers": maxns,
                "message_hash": message_hash,
                "pubkeys": pubkeys,
                "combined_first_epoch_bits": first_bits,
                "combined_last_epoch_bits": last_bits,
                "xof_input_bits": xof_input_bits,
                "xof_bits": xof_bits,
            }

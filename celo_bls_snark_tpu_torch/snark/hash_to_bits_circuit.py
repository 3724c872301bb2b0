"""The HashToBits helper circuit (2-SNARK technique).

Parity with crates/epoch-snark/src/gadgets/hash_to_bits.rs: over BLS12-377
Fr, constrain each epoch's XOF-input bits, run in-circuit Blake2Xs(512),
and expose packed input bits + XOF bits as public inputs — the cheap inner
proof that the BW6-761 outer circuit verifies recursively
(epoch_bits.rs:104-132).

Divergence from the reference (soundness fix): each epoch's message is the
FULL 448-bit XOF input `counter || extra_data || crh` — the byte stream the
epoch circuit actually hashes (try_and_increment_cip22.rs:96,
hash_to_group.rs:125-139) — not the bare 384 CRH bits of the reference's
(untested) prover.rs:93-105, whose helper statement attests an XOF over a
different message than the outer circuit consumes.
"""

from ..hostmath.params import R as BLS_FR
from ..bls import SIG_DOMAIN
from ..relations.r1cs import ConstraintSystem
from ..gadgets.vars import Boolean
from ..gadgets.hash_to_bits import hash_to_bits
from ..gadgets.pack import multipack, pack_native

FR_CAPACITY = BLS_FR.bit_length() - 1
# CRH size per epoch: modulus bits rounded up to bytes (hash_to_bits.rs:25-32)
MODULUS_BIT_ROUNDED = ((377 + 7) // 8) * 8  # BW6-Fr modulus bits, byte-rounded
# extra_data = index u16 || round u8 || maximum_non_signers u32 (epoch_block.rs:152-160)
EXTRA_DATA_BITS = 16 + 8 + 32
# full XOF input per epoch: counter byte || extra_data || crh
XOF_INPUT_BITS = 8 + EXTRA_DATA_BITS + MODULUS_BIT_ROUNDED


class HashToBits:
    """message_bits: list (per epoch) of lists of Optional[bool] — the
    LE bit stream of the epoch's XOF input bytes."""

    def __init__(self, message_bits):
        self.message_bits = message_bits

    @classmethod
    def empty(cls, num_epochs: int):
        return cls([[None] * XOF_INPUT_BITS for _ in range(num_epochs)])

    def generate_constraints(self, cs: ConstraintSystem):
        all_bits = []
        xof_bits = []
        for epoch_bits in self.message_bits:
            bits = [
                Boolean.new_witness(cs, bool(b) if b is not None else False)
                for b in epoch_bits
            ]
            hashed = hash_to_bits(cs, bits, 512, SIG_DOMAIN, True)
            all_bits += bits
            xof_bits += hashed
        multipack(cs, all_bits, FR_CAPACITY, as_input=True)
        multipack(cs, xof_bits, FR_CAPACITY, as_input=True)

    # --- native public-input computation (prover.rs:85-118 pattern) -------
    @staticmethod
    def public_inputs(message_bits_values, xof_bits_values):
        """Pack the same bit streams natively to BLS-Fr elements."""
        flat_msg = [b for epoch in message_bits_values for b in epoch]
        return pack_native(flat_msg, BLS_FR, FR_CAPACITY) + pack_native(
            xof_bits_values, BLS_FR, FR_CAPACITY
        )

"""In-circuit CRH -> XOF conversion (Blake2Xs over Booleans).

Parity with crates/bls-gadgets/src/hash_to_group.rs::hash_to_bits
(:195-250): with constraints, run in-circuit Blake2s per 256-bit output
block using the Blake2Xs parameter block; without, just witness the native
XOF output — the escape hatch for the 2-SNARK split (SURVEY.md §1).
"""

from ..bls import SIG_DOMAIN
from ..hashers import DirectHasher
from ..utils.bits import bits_le_to_bytes_le, bytes_le_to_bits_le
from .vars import Boolean
from .blake2s_gadget import blake2s_gadget, blake2xs_params


def hash_to_bits(cs, message_bits, hash_length: int = 512,
                 personalization: bytes = SIG_DOMAIN,
                 generate_constraints_for_hash: bool = True):
    """message_bits: list[Boolean] (LE bits of the message bytes).
    Returns `hash_length` Booleans (LE)."""
    with cs.ns("hash_to_bits"):
        if generate_constraints_for_hash:
            assert hash_length % 256 == 0, "invalid hash length size"
            xof_bits = []
            for i in range(hash_length // 256):
                params = blake2xs_params(i, hash_length // 8, 32, personalization)
                xof_bits += blake2s_gadget(cs, message_bits, params)
            return xof_bits
        # constraints off: witness the natively computed XOF
        if cs.is_in_setup_mode():
            bits = [False] * hash_length
        else:
            msg_bytes = bits_le_to_bytes_le([bool(b.value) for b in message_bits])
            out = DirectHasher().xof(personalization, msg_bytes, hash_length // 8)
            bits = bytes_le_to_bits_le(out, hash_length)
        return [Boolean.new_witness(cs, b) for b in bits]

"""Helpers called by the C ABI shim (ffi/c_abi/bls_snark.cpp)."""

from ..bls import PublicKey
from ..snark.epoch_block import EpochBlock


def make_epoch_block(
    index,
    round_,
    epoch_entropy,
    parent_entropy,
    maximum_non_signers,
    maximum_validators,
    pubkeys_bytes,
):
    """EpochBlockFFI -> EpochBlock (snark/epoch_block.rs:129-146 TryFrom)."""
    n = len(pubkeys_bytes) // 96
    pubkeys = [
        PublicKey.from_bytes(pubkeys_bytes[i * 96 : (i + 1) * 96]) for i in range(n)
    ]
    return EpochBlock(
        index,
        round_,
        bytes(epoch_entropy) if epoch_entropy is not None else None,
        bytes(parent_entropy) if parent_entropy is not None else None,
        maximum_non_signers,
        maximum_validators,
        pubkeys,
    )


def make_epoch_block_from_objs(
    index,
    round_,
    epoch_entropy,
    parent_entropy,
    maximum_non_signers,
    maximum_validators,
    pubkey_objs,
):
    """Unpacked encode_epoch_block_to_bytes[_cip22] args with PublicKey
    HANDLES (snark/epoch_block.rs:17-46,69-95) -> EpochBlock."""
    return EpochBlock(
        index,
        round_,
        bytes(epoch_entropy) if epoch_entropy is not None else None,
        bytes(parent_entropy) if parent_entropy is not None else None,
        maximum_non_signers,
        maximum_validators,
        list(pubkey_objs),
    )

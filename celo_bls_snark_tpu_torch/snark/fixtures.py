"""Synthetic epoch-chain fixtures.

Parity with crates/epoch-snark/tests/fixtures.rs (generate_test_data): a
committee per epoch, each new epoch block signed by the previous epoch's
validators over the block's CIP22 inner-encoding hash, with `faults`
non-signers and chained entropy.
"""

from ..bls import PrivateKey, PublicKey, Signature, SIG_DOMAIN
from ..bls.test_helpers import keygen_mul
from ..hostmath import curves as hc
from ..utils.rngs import XorShiftRng
from .epoch_block import EpochBlock, EpochTransition


def generate_test_data(num_validators: int, faults: int, num_epochs: int,
                       seed: bytes = b"epoch-fixture-rs"):
    """Returns (initial_epoch, transitions, last_epoch)."""
    rng = XorShiftRng(seed[:16])
    maximum_non_signers = faults
    committees = [keygen_mul(num_validators, rng) for _ in range(num_epochs + 1)]

    initial_epoch = EpochBlock(
        index=0,
        round=0,
        epoch_entropy=bytes([1] * 16),
        parent_entropy=bytes(16),
        maximum_non_signers=maximum_non_signers,
        maximum_validators=num_validators,
        new_public_keys=committees[0][1],
    )

    transitions = []
    prev_entropy = initial_epoch.epoch_entropy
    for i in range(1, num_epochs + 1):
        sks_prev, _, _ = committees[i - 1]
        _, pks_new, _ = committees[i]
        entropy = bytes([i + 1] * 16)
        block = EpochBlock(
            index=i,
            round=0,
            epoch_entropy=entropy,
            parent_entropy=prev_entropy,
            maximum_non_signers=maximum_non_signers,
            maximum_validators=num_validators,
            new_public_keys=pks_new,
        )
        prev_entropy = entropy
        h = block.hash_to_g1_cip22()
        # the first `num_validators - faults` validators sign
        bitmap = [True] * (num_validators - faults) + [False] * faults
        sigs = [
            Signature(hc.G1.mul(sk.sk, h))
            for sk, b in zip(sks_prev, bitmap)
            if b
        ]
        transitions.append(
            EpochTransition(
                block=block,
                aggregate_signature=Signature.aggregate(sigs),
                bitmap=bitmap,
            )
        )
    return initial_epoch, transitions, transitions[-1].block

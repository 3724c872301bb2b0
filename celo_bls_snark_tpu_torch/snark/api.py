"""Epoch-SNARK public API (crates/epoch-snark/src/api/).

- verify(): constant-size light-client check of an epoch transition proof
  (verifier.rs:23-40): recompute the two Blake2s commitment hashes, pack
  to BW6-Fr public inputs, Groth16-verify over BW6-761.
- trusted_setup(): builds the empty ValidatorSetUpdate circuit (and the
  optional HashToBits helper circuit for the 2-SNARK mode) and runs
  Groth16 setup over BW6-761 / BLS12-377 (setup.rs:17-105), with the
  setup functions injectable for MPC ceremonies.
- prove(): dummy-update padding, optional CRH->XOF helper proof, and a
  no-zk Groth16 proof (prover.rs:22-82).

`trusted_setup`, `generate_hash_helper` and `prove` take a `device`: the
generator multiples of the setup and the prover's MSMs and h-polynomial
run through snark/accel.py's DeviceAccel on that device. "cuda" (the
default) runs the hand-written kernels and raises without a card; "cpu"
runs every kernel's plain version; None is the host path of
snark/groth16.py with no accelerator, which the caller must ask for.
Circuit synthesis, the QAP and serialization run on the host.

The accelerator is imported inside the functions: snark/accel.py imports
BW6_761_ENGINE from here.
"""

from dataclasses import dataclass
from typing import Optional

from ..hostmath.params import P as BW_FR
from ..hostmath import bw6
from .epoch_block import EpochBlock, hash_first_last_epoch_block
from . import groth16 as g16
from .groth16 import Engine, Proof, VerifyingKey
from .serialize_bw6 import proof_from_bytes, vk_from_bytes


class SynthesisError(Exception):
    """Prover-side failure (ark SynthesisError analogue): unsatisfied
    witness, bad transition count, or an unsupported mode."""


BW6_761_ENGINE = Engine(
    "bw6_761",
    BW_FR,
    bw6.G1,
    bw6.G2,
    bw6.G1_GENERATOR,
    bw6.G2_GENERATOR,
    bw6.pairing_check,
    46,
    g16._find_fr_generator(BW_FR, 46),
)

# BW6-Fr (== BLS12-377 Fq) capacity: MODULUS_BITS - 1
FR_CAPACITY = BW_FR.bit_length() - 1


def pack(bits):
    """BE bit-chunks -> field elements (gadgets/mod.rs:75-83)."""
    out = []
    for i in range(0, len(bits), FR_CAPACITY):
        chunk = bits[i : i + FR_CAPACITY]
        v = 0
        for b in chunk:
            v = (v << 1) | int(bool(b))
        out.append(v % BW_FR)
    return out


def verify_parsed(vk: VerifyingKey, first_epoch: EpochBlock, last_epoch: EpochBlock, proof: Proof) -> bool:
    """epoch_snark::verify with already-deserialized objects."""
    bits = hash_first_last_epoch_block(first_epoch, last_epoch)
    public_inputs = pack(bits)
    return g16.verify_proof(vk, proof, public_inputs, BW6_761_ENGINE)


@dataclass
class Parameters:
    """Groth16 keys for the epoch circuit (+ optional 2-SNARK helper keys)
    — setup.rs:17-22."""

    epochs: object                  # groth16.ProvingKey over BW6-761
    hash_to_bits: Optional[object]  # groth16.ProvingKey over BLS12-377


def _accel(engine_name: str, device):
    """The engine's DeviceAccel on `device`, or None for the host path
    (device=None)."""
    if device is None:
        return None
    from .accel import get_accel

    return get_accel(engine_name, device)


def _to_epoch_data(block: EpochBlock):
    from .gadgets_epoch import EpochDataGadget

    return EpochDataGadget(
        block.index,
        block.round,
        block.epoch_entropy,
        block.parent_entropy,
        block.maximum_non_signers,
        [pk.pt for pk in block.new_public_keys],
    )


def _to_update(transition):
    from .single_update import SingleUpdateGadget

    return SingleUpdateGadget(
        _to_epoch_data(transition.block), list(transition.bitmap)
    )


def _to_dummy_update(num_validators: int):
    """prover.rs:146-160: index 0, zero entropy, generator pubkeys,
    all-ones bitmap."""
    from ..hostmath.params import G2_GENERATOR
    from .gadgets_epoch import EpochDataGadget
    from .single_update import SingleUpdateGadget

    return SingleUpdateGadget(
        EpochDataGadget(
            0, 0, bytes(16), bytes(16), 0, [G2_GENERATOR] * num_validators
        ),
        [True] * num_validators,
    )


def _dummy_block(num_validators: int) -> EpochBlock:
    """The native EpochBlock matching _to_dummy_update bit-for-bit (for the
    hash-helper statement over dummy epochs)."""
    from ..bls import PublicKey
    from ..hostmath.params import G2_GENERATOR

    return EpochBlock(
        index=0,
        round=0,
        epoch_entropy=bytes(16),
        parent_entropy=bytes(16),
        maximum_non_signers=0,
        maximum_validators=num_validators,
        new_public_keys=[PublicKey(G2_GENERATOR)] * num_validators,
    )


def trusted_setup(num_validators: int, num_epochs: int, maximum_non_signers: int,
                  rng, hashes_in_bls12_377: bool = False,
                  device="cuda") -> Parameters:
    """setup.rs:30-46. hashes_in_bls12_377=True selects the 2-SNARK split:
    XOF constraints move to a BLS12-377 helper circuit whose Groth16 proof
    the outer circuit verifies in-circuit (epoch_bits.rs:104-132); the
    helper keys are generated first so the outer circuit embeds the helper
    vk as a constant (setup.rs:87-99)."""
    from ..utils.config import get_config

    if get_config().ark_parity:
        # Tested mode boundary (see Config.ark_parity): this build's
        # circuit is leaner than the deployed Celo constraint system, so
        # a ceremony/proving key built here is NOT byte-compatible with
        # deployed Celo. Verify-side interop is exact; prove-side parity
        # is a deliberate non-goal — fail fast rather than emit keys a
        # caller might mistake for ceremony-compatible ones.
        raise NotImplementedError(
            "ark_parity=True: prove-side byte-parity with the deployed "
            "Celo circuit (18,702-constraint BLS verify, "
            "bls-gadgets/src/bls.rs:401) is not implemented; this build "
            "proves under its own leaner pinned circuit "
            "(tests/golden_matrices.json). Verify-side interop is exact."
        )
    accel = _accel("bw6_761", device)
    helper_accel = _accel("bls12_377", device) if hashes_in_bls12_377 else None

    return setup(
        num_validators, num_epochs, maximum_non_signers, rng,
        lambda hcs, r: g16.generate_parameters(
            hcs, g16.BLS12_377_ENGINE, r, accel=helper_accel
        ),
        lambda cs, r: g16.generate_parameters(
            cs, BW6_761_ENGINE, r, accel=accel
        ),
        hashes_in_bls12_377,
    )


def setup(num_validators: int, num_epochs: int, maximum_non_signers: int,
          rng, hash_to_bits_setup, validator_setup_fn,
          hashes_in_bls12_377: bool = False) -> Parameters:
    """Injectable-setup variant (setup.rs:58-105): the consumer provides the
    Groth16 parameter generators — the in-process random setup
    (trusted_setup), or one returning parameters computed via an MPC
    ceremony. Each setup fn receives the circuit's synthesized
    ConstraintSystem and the rng and returns a ProvingKey."""
    from ..hostmath.params import R as BLS_FR
    from ..relations.r1cs import ConstraintSystem
    from ..utils.profiling import stage
    from .epochs import HashToBitsHelper, ValidatorSetUpdate
    from .hash_to_bits_circuit import HashToBits

    helper_pk = None
    helper = None
    if hashes_in_bls12_377:
        hcs = ConstraintSystem(BLS_FR, "setup")
        HashToBits.empty(num_epochs).generate_constraints(hcs)
        helper_pk = hash_to_bits_setup(hcs, rng)
        helper = HashToBitsHelper(vk=helper_pk.vk, proof=None)

    cs = ConstraintSystem(BW_FR, "setup")
    circuit = ValidatorSetUpdate.empty(
        num_validators, num_epochs, hash_helper=helper
    )
    with stage("setup.synthesis"):
        circuit.generate_constraints(cs)
    epochs_pk = validator_setup_fn(cs, rng)
    return Parameters(epochs=epochs_pk, hash_to_bits=helper_pk)


def xof_input_message_bits(blocks):
    """Each block's XOF input `counter || extra_data || CRH bytes` as LE
    bits — the native twin of the bit stream the circuit collects
    (gadgets/hash_to_group.py enforce_hash_to_group)."""
    from ..bls import SIG_DOMAIN
    from ..hash_to_curve import composite_hash_to_g1_cip22
    from ..hash_to_curve.common import G1_BYTES, hash_length
    from ..utils.bits import bytes_le_to_bits_le

    h2c = composite_hash_to_g1_cip22()
    message_bits = []
    for block in blocks:
        inner_bytes, extra_bytes = block.encode_inner_to_bytes_cip22()
        crh_bytes = h2c.hasher.crh(SIG_DOMAIN, inner_bytes, hash_length(G1_BYTES))
        _, counter = h2c.hash_with_attempt_cip22(
            SIG_DOMAIN, inner_bytes, extra_bytes
        )
        msg = bytes([counter]) + extra_bytes + crh_bytes
        message_bits.append(bytes_le_to_bits_le(msg, 8 * len(msg)))
    return message_bits


def generate_hash_helper(helper_pk, blocks, device="cuda"):
    """The 2-SNARK helper proof (prover.rs:85-118): natively compute each
    epoch's XOF input (counter || extra_data || CRH bytes) and prove the
    HashToBits circuit tying those inputs to their Blake2Xs outputs.

    Divergences from the reference, both required for a verifying proof:
    `blocks` is the PADDED update list (prover.rs:57 passes only the real
    transitions, which cannot satisfy a helper circuit sized for
    max_transitions and omits the dummy epochs' XOF bits the outer circuit
    collects), and the message is the full XOF input rather than the bare
    CRH bytes (see snark/hash_to_bits_circuit.py)."""
    from ..hostmath.params import R as BLS_FR
    from ..relations.r1cs import ConstraintSystem
    from ..utils.profiling import stage
    from .epochs import HashToBitsHelper
    from .hash_to_bits_circuit import HashToBits

    accel = _accel("bls12_377", device)
    if accel is not None:
        with stage("prover.prewarm"):
            accel.prewarm_prove(helper_pk)

    message_bits = xof_input_message_bits(blocks)
    cs = ConstraintSystem(BLS_FR, "prove")
    HashToBits(message_bits).generate_constraints(cs)
    evals = cs.evaluate_abc()
    bad = cs.which_is_unsatisfied_from_evals(*evals)
    if bad is not None:
        raise SynthesisError(
            f"hash helper witness unsatisfied constraint: {bad}"
        )
    proof = g16.create_proof_no_zk(
        helper_pk, cs, g16.BLS12_377_ENGINE, accel=accel, evals=evals
    )
    return HashToBitsHelper(vk=helper_pk.vk, proof=proof)


def prove(parameters: Parameters, num_validators: int, initial_epoch: EpochBlock,
          transitions, max_transitions: int = 0, device="cuda"):
    """prover.rs:22-82: pad real transitions with dummy updates inserted
    before the final epoch; aggregate all signatures plus one generator per
    dummy; generate the hash-helper proof when in 2-SNARK mode; prove the
    ValidatorSetUpdate circuit (no zk randomization)."""
    from ..hostmath.params import G1_GENERATOR
    from ..hostmath import curves as hcurves
    from ..relations.r1cs import ConstraintSystem
    from ..utils.profiling import stage
    from .epochs import ValidatorSetUpdate

    if not transitions:
        raise SynthesisError("prove() needs at least one epoch transition")
    accel = _accel("bw6_761", device)
    if accel is not None:
        with stage("prover.prewarm"):  # the kernel library, the twiddle tables
            accel.prewarm_prove(parameters.epochs)
    num_dummy = 0
    if max_transitions > 0:
        if max_transitions < len(transitions):
            raise SynthesisError(
                f"more transitions ({len(transitions)}) than the circuit "
                f"supports ({max_transitions})"
            )
        num_dummy = max_transitions - len(transitions)
    updates = [_to_update(t) for t in transitions[:-1]]
    updates += [_to_dummy_update(num_validators) for _ in range(num_dummy)]
    updates.append(_to_update(transitions[-1]))

    helper = None
    if parameters.hash_to_bits is not None:
        blocks = [t.block for t in transitions[:-1]]
        blocks += [_dummy_block(num_validators) for _ in range(num_dummy)]
        blocks.append(transitions[-1].block)
        helper = generate_hash_helper(parameters.hash_to_bits, blocks, device)

    asig_pt = hcurves.G1.msum(
        [t.aggregate_signature.pt for t in transitions]
        + [G1_GENERATOR] * num_dummy
    )
    circuit = ValidatorSetUpdate(
        _to_epoch_data(initial_epoch),
        updates,
        num_validators,
        asig_pt,
        hash_helper=helper,
    )
    cs = ConstraintSystem(BW_FR, "prove")
    with stage("prover.witness_synthesis"):
        circuit.generate_constraints(cs)
    with stage("prover.satisfaction_check"):
        evals = cs.evaluate_abc()
        bad = cs.which_is_unsatisfied_from_evals(*evals)
    if bad is not None:
        raise SynthesisError(
            f"witness generation produced unsatisfied constraint: {bad}"
        )
    return g16.create_proof_no_zk(
        parameters.epochs, cs, BW6_761_ENGINE, accel=accel, evals=evals
    )


def verify(vk_bytes: bytes, proof_bytes: bytes, first_epoch: EpochBlock, last_epoch: EpochBlock) -> bool:
    """The C-FFI `verify` (crates/bls-snark-sys/src/snark/mod.rs:23-45):
    byte inputs, boolean output."""
    try:
        vk = vk_from_bytes(vk_bytes)
        proof = proof_from_bytes(proof_bytes)
        return verify_parsed(vk, first_epoch, last_epoch, proof)
    except Exception:
        return False

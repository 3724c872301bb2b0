"""The ValidatorSetUpdate circuit — the epoch SNARK's main statement.

Parity with crates/epoch-snark/src/gadgets/epochs.rs (both modes):

  enforce: constrain the initial epoch -> loop over updates rotating
  (index, entropy, pubkeys, max_non_signers) via conditional selects on the
  dummy bit, collecting per-epoch (aggregate_pk, message_hash) pairs; the
  last iteration aggregates ALL final pubkeys, serializes them into the
  last-epoch bits and forbids a dummy last epoch; then one in-circuit
  (n+1)-pairing batch verification, and EpochBits.verify_edges exposes the
  Blake2s commitments of the first/last encodings as packed public inputs.

2-SNARK mode (hash_helper set): the Blake2Xs constraints are replaced by an
in-circuit Groth16 verification (epoch_bits.rs:104-132) of the BLS12-377
HashToBits helper proof, whose public inputs are the packed XOF-input and
XOF-output bit streams of every epoch.
"""

from dataclasses import dataclass
from typing import Optional

from ..hostmath.params import P, R as BLS_FR, G1_GENERATOR, G2_GENERATOR
from ..relations.r1cs import LinearCombination
from ..hostmath import curves as hc
from ..bls import OUT_DOMAIN
from ..gadgets.vars import Boolean, FpVar
from ..gadgets.curve_vars import G1Var, G2Var
from ..gadgets import bls as gbls
from ..gadgets.blake2s_gadget import blake2s_gadget, blake2s_param_words
from ..gadgets.groth16_verify import ProofVar, enforce_groth16_verify
from ..gadgets.pack import multipack
from .gadgets_epoch import EpochDataGadget, g2_to_bits
from .single_update import SingleUpdateGadget

# BW6-Fr capacity (gadgets use MODULUS_BITS - 1)
FR_CAPACITY = P.bit_length() - 1
# the helper proof's packing capacity is the INNER field's (BLS12-377 Fr)
BLS_FR_CAPACITY = BLS_FR.bit_length() - 1


@dataclass
class HashToBitsHelper:
    """The 2-SNARK recursion payload (epochs.rs:36-41): the helper circuit's
    verifying key (a circuit constant) and its Groth16 proof (a witness;
    None during setup synthesis)."""

    vk: object                 # groth16.VerifyingKey over BLS12-377
    proof: Optional[object]    # groth16.Proof over BLS12-377 | None


class ValidatorSetUpdate:
    def __init__(self, initial_epoch: EpochDataGadget, epochs, num_validators,
                 aggregated_signature, hash_helper: Optional[HashToBitsHelper] = None):
        self.initial_epoch = initial_epoch
        self.epochs = epochs  # list[SingleUpdateGadget]
        self.num_validators = num_validators
        self.aggregated_signature = aggregated_signature  # host G1 affine | None
        self.hash_helper = hash_helper  # None => all constraints in BW6

    @classmethod
    def empty(cls, num_validators, num_epochs, hash_helper=None):
        return cls(
            EpochDataGadget.empty(num_validators),
            [SingleUpdateGadget.empty(num_validators) for _ in range(num_epochs)],
            num_validators,
            None,
            hash_helper,
        )

    def generate_constraints(self, cs):
        with cs.ns("ValidatorSetUpdate"):
            (
                _bits,
                _extra,
                first_epoch_bits,
                _last,
                first_index,
                first_entropy,
                _parent,
                initial_maxns,
                initial_pubkeys,
            ) = self.initial_epoch.to_bits(cs)

            (
                last_epoch_bits,
                xof_input_bits,
                xof_bits,
                aggregated_pks,
                message_hashes,
            ) = self._verify_intermediate_epochs(
                cs, first_index, first_entropy, initial_pubkeys, initial_maxns
            )

            # (n+1)-pairing aggregate-signature verification. Checked
            # allocation mirrors ark's omit_prime_order_check semantics
            # (epochs.rs:304): the curve equation is still enforced — an
            # off-curve "signature" witness must be unsatisfiable.
            sig_var = G1Var.new_witness_checked(cs, self.aggregated_signature)
            gbls.batch_verify_prepared(
                cs, list(zip(aggregated_pks, message_hashes)), sig_var
            )

            # 2-SNARK mode: the XOF bits are unconstrained witnesses above,
            # so the helper proof tying input->XOF MUST be verified here
            # (epoch_bits.rs:42-52 verify -> verify_proof)
            if self.hash_helper is not None:
                self._verify_helper_proof(cs, xof_input_bits, xof_bits)

            # public-input commitments (EpochBits::verify_edges)
            self._verify_edges(cs, first_epoch_bits, last_epoch_bits)
            return xof_input_bits, xof_bits

    def _verify_intermediate_epochs(self, cs, first_index, first_entropy,
                                    initial_pubkeys, initial_maxns):
        dummy_pk = G2Var.constant(cs, G2_GENERATOR)
        dummy_msg = G1Var.constant(cs, G1_GENERATOR)
        entropy_bit = first_entropy.is_eq_zero().not_()

        prev_index = first_index
        prev_pubkeys = initial_pubkeys
        prev_maxns = initial_maxns
        prev_entropy = first_entropy
        agg_pks, msg_hashes = [], []
        all_crh, all_xof = [], []
        last_epoch_bits = []
        for i, epoch in enumerate(self.epochs):
            constrained = epoch.constrain(
                cs,
                prev_pubkeys,
                prev_index,
                prev_entropy,
                prev_maxns,
                entropy_bit,
                self.num_validators,
                self.hash_helper is None,
            )
            index_bit = constrained["index"].is_eq_zero().not_()
            prev_entropy = FpVar.conditionally_select(
                index_bit, constrained["epoch_entropy"], prev_entropy
            )
            prev_index = FpVar.conditionally_select(
                index_bit, constrained["index"], prev_index
            )
            prev_pubkeys = [
                new.select(index_bit, old)
                for new, old in zip(constrained["new_pubkeys"], prev_pubkeys)
            ]
            prev_maxns = FpVar.conditionally_select(
                index_bit, constrained["new_max_non_signers"], prev_maxns
            )
            agg_pks.append(constrained["aggregate_pk"].select(index_bit, dummy_pk))
            msg_hashes.append(
                constrained["message_hash"].select(index_bit, dummy_msg)
            )
            all_crh += constrained["xof_input_bits"]
            all_xof += constrained["xof_bits"]
            if i == len(self.epochs) - 1:
                last_apk = gbls.enforce_aggregated_all_pubkeys(cs, prev_pubkeys)
                last_apk_bits = g2_to_bits(cs, last_apk)
                last_epoch_bits = (
                    list(constrained["combined_last_epoch_bits"]) + last_apk_bits
                )
                # forbid a dummy last epoch
                one = LinearCombination.constant(1)
                cs.enforce_constraint(index_bit.lc(), one, one)
        return last_epoch_bits, all_crh, all_xof, agg_pks, msg_hashes

    def _verify_helper_proof(self, cs, xof_input_bits, xof_bits):
        """In-circuit Groth16 verification of the HashToBits helper proof
        (epoch_bits.rs:104-132): its public inputs are the XOF input/output
        bit streams chunked at the INNER curve's capacity — the exact
        packing the helper circuit itself applied (hash_to_bits_circuit.py
        multipack), so a satisfied verifier constraint means every epoch's
        witnessed XOF bits are the true Blake2Xs of its input bits."""
        with cs.ns("verify_helper_proof"):
            def chunks(bits):
                return [
                    bits[i : i + BLS_FR_CAPACITY]
                    for i in range(0, len(bits), BLS_FR_CAPACITY)
                ]

            proof_var = ProofVar.new_witness(cs, self.hash_helper.proof)
            enforce_groth16_verify(
                cs,
                self.hash_helper.vk,
                chunks(xof_input_bits) + chunks(xof_bits),
                proof_var,
            )

    @staticmethod
    def _verify_edges(cs, first_epoch_bits, last_epoch_bits):
        """In-circuit Blake2s(OUT_DOMAIN) of the first/last encodings, packed
        as public inputs (epoch_bits.rs:57-101)."""
        with cs.ns("verify_edges"):
            out_bits = []
            for bits in (first_epoch_bits, last_epoch_bits):
                msg = list(bits)[::-1]
                while len(msg) % 8:
                    msg.append(Boolean.false(cs))
                params = blake2s_param_words(digest_size=32, person=OUT_DOMAIN)
                out_bits += blake2s_gadget(cs, msg, params)
            return multipack(cs, out_bits, FR_CAPACITY, as_input=True)

"""The port's epoch circuit and its serializers (celo_bls_snark_tpu_torch/
snark/{encoding,epoch_block,fixtures,gadgets_epoch,single_update,
hash_to_bits_circuit,epochs,matrix_hash,serialize_bw6,serialize_pk}.py)
against the JAX package and the pinned vectors: epoch-block encodings
equal the reference's hex, a padded prove-mode ValidatorSetUpdate and the
HashToBits helper circuit equal the JAX package's constraint for
constraint, setup-mode empty(3, 3) has the pinned matrix digests, key and
proof bytes equal the JAX package's, and the pinned production proof
verifies through the port's api.verify. Host code only; tolerance 0."""

import json
import os
import random

import pytest
import torch_both
import vectors_epoch as VE
import vectors_snark

from celo_bls_snark_tpu.snark import epoch_block as jeb
from celo_bls_snark_tpu.bls import PublicKey as JPublicKey
from celo_bls_snark_tpu_torch.bls import PublicKey
from celo_bls_snark_tpu_torch.hostmath import curves as hc
from celo_bls_snark_tpu_torch.hostmath.params import G1_GENERATOR, G2_GENERATOR, P, R
from celo_bls_snark_tpu_torch.relations.r1cs import ConstraintSystem
from celo_bls_snark_tpu_torch.snark import api
from celo_bls_snark_tpu_torch.snark.epoch_block import EpochBlock, hash_first_last_epoch_block
from celo_bls_snark_tpu_torch.snark.epochs import ValidatorSetUpdate
from celo_bls_snark_tpu_torch.snark.matrix_hash import matrices_hashes

GOLDEN = os.path.join(os.path.dirname(__file__), "golden_matrices.json")

# (pinned hex, block arguments, encoder) of tests/test_epoch_block.py
ENCODINGS = {
    "with_entropy": (VE.WITH_ENTROPY, (120, 5, bytes([255] * 16), bytes([254] * 16), 3, 10),
                     "encode_first_epoch_to_bytes_cip22"),
    "without_entropy": (VE.WITHOUT_ENTROPY, (120, 5, None, None, 3, 10),
                        "encode_first_epoch_to_bytes_cip22"),
    "before_donut": (VE.BEFORE_DONUT, (120, 10, None, None, 3, 10), "encode_to_bytes"),
    "padded": (VE.WITH_ENTROPY_PADDED, (120, 5, bytes([255] * 16), bytes([254] * 16), 3, 11),
               "encode_first_epoch_to_bytes_cip22"),
}


@pytest.mark.parametrize("name", list(ENCODINGS))
def test_epoch_block_encoding_equals_pinned_hex(name):
    want, args, method = ENCODINGS[name]
    block = EpochBlock(*args, [PublicKey(G2_GENERATOR) for _ in range(10)])
    jblock = jeb.EpochBlock(*args, [JPublicKey(G2_GENERATOR) for _ in range(10)])
    assert getattr(block, method)().hex() == want == getattr(jblock, method)().hex()


def test_epoch_hashes_equal_jax():
    def blocks(mod, pk):
        return (mod.EpochBlock(0, 0, None, bytes(16), 1, 4, [pk(G2_GENERATOR)] * 4),
                mod.EpochBlock(3, 0, bytes(16), None, 1, 4, [pk(G2_GENERATOR)] * 4))

    import celo_bls_snark_tpu_torch.snark.epoch_block as teb

    first, last = blocks(teb, PublicKey)
    jfirst, jlast = blocks(jeb, JPublicKey)
    bits = hash_first_last_epoch_block(first, last)
    assert len(bits) == 512 and bits == jeb.hash_first_last_epoch_block(jfirst, jlast)
    pt = last.hash_to_g1_cip22()
    assert pt == jlast.hash_to_g1_cip22()
    assert hc.G1.is_on_curve(pt) and hc.G1.mul(R, pt) is None
    assert last.encode_inner_to_bytes_cip22() == jlast.encode_inner_to_bytes_cip22()


def padded_chain(m, cs):
    """2 validators, 0 faults, one real transition padded to
    max_transitions = 2: the dummy epoch goes before the final one
    (api.prove's padding). Returns the packed verifier inputs."""
    a, hcm = m("snark.api"), m("hostmath.curves")
    first, transitions, last = m("snark.fixtures").generate_test_data(2, 0, 1)
    updates = [a._to_dummy_update(2), a._to_update(transitions[0])]
    asig = hcm.G1.msum([transitions[0].aggregate_signature.pt, G1_GENERATOR])
    m("snark.epochs").ValidatorSetUpdate(
        a._to_epoch_data(first), updates, 2, asig).generate_constraints(cs)
    return a.pack(m("snark.epoch_block").hash_first_last_epoch_block(first, last))


@pytest.fixture(scope="module")
def chain():
    """The padded chain synthesized by both packages, held equal (counts,
    digests, assignments, satisfaction) by torch_both.synth_both."""
    cs, inputs, _ = torch_both.synth_both(padded_chain, P)
    return cs, inputs


def test_padded_chain_is_satisfied(chain):
    cs, _ = chain
    assert cs.which_is_unsatisfied() is None


def test_padded_chain_instance_is_the_verifier_inputs(chain):
    cs, inputs = chain
    assert cs.num_instance == 3 and cs.instance_assignment[1:] == inputs


def test_empty_3v_3e_has_the_pinned_digests():
    """Setup mode synthesizes the matrices that tests/golden_matrices.json
    pins for the 3-validator, 3-epoch circuit."""
    cs = ConstraintSystem(P, "setup")
    ValidatorSetUpdate.empty(3, 3).generate_constraints(cs)
    with open(GOLDEN) as f:
        assert matrices_hashes(cs) == json.load(f)["validator_set_update_3v_3e"]


@pytest.mark.parametrize("mode", ["setup", "prove"])
def test_hash_to_bits_helper_equal_jax(mode):
    """HashToBits.empty(2) in setup mode; one epoch of seeded bits in prove
    mode, whose instance is the helper statement's public inputs."""
    rnd = random.Random(5)

    def build(m, cs):
        h2b = m("snark.hash_to_bits_circuit")
        if mode == "setup":
            h2b.HashToBits.empty(2).generate_constraints(cs)
            return None
        msg = [[rnd.random() < 0.5 for _ in range(h2b.XOF_INPUT_BITS)]]
        h2b.HashToBits(msg).generate_constraints(cs)
        b = m("utils.bits")
        xof = m("hashers").DirectHasher().xof(b"ULforxof", b.bits_le_to_bytes_le(msg[0]), 64)
        return h2b.HashToBits.public_inputs(msg, b.bytes_le_to_bits_le(xof, 512))

    state = rnd.getstate()

    def seeded(m, cs):  # both packages draw the same bits
        rnd.setstate(state)
        return build(m, cs)

    cs, inputs, _ = torch_both.synth_both(seeded, R, mode)
    if mode == "prove":
        assert cs.is_satisfied() and cs.instance_assignment[1:] == inputs


def square_circuit(cs, x=None, w=None):
    """x = w^2, padded with four squarings (the JAX package's pk serde
    test circuit)."""
    from celo_bls_snark_tpu_torch.gadgets.vars import FpVar

    xv, wv = FpVar.new_input(cs, x), FpVar.new_witness(cs, w)
    wv.mul(wv).enforce_equal(xv)
    for _ in range(4):
        wv.mul(wv)


@pytest.mark.parametrize("engine_name", ["bw6_761", "bls12_377"])
def test_key_and_proof_bytes_equal_jax(engine_name):
    from celo_bls_snark_tpu.relations.r1cs import ConstraintSystem as JCS
    from celo_bls_snark_tpu.gadgets.vars import FpVar as JFpVar
    from celo_bls_snark_tpu.snark import api as japi
    from celo_bls_snark_tpu.snark import groth16 as jg16
    from celo_bls_snark_tpu.snark import serialize_bw6 as jsb
    from celo_bls_snark_tpu.snark import serialize_pk as jspk
    from celo_bls_snark_tpu.utils.rngs import XorShiftRng as JXorShiftRng
    from celo_bls_snark_tpu_torch.snark import groth16 as g16
    from celo_bls_snark_tpu_torch.snark import serialize_bw6 as sb
    from celo_bls_snark_tpu_torch.snark import serialize_pk as spk
    from celo_bls_snark_tpu_torch.utils.rngs import XorShiftRng

    bw6 = engine_name == "bw6_761"
    eng = api.BW6_761_ENGINE if bw6 else g16.BLS12_377_ENGINE
    jeng = japi.BW6_761_ENGINE if bw6 else jg16.BLS12_377_ENGINE

    def jsquare(cs, x=None, w=None):
        xv, wv = JFpVar.new_input(cs, x), JFpVar.new_witness(cs, w)
        wv.mul(wv).enforce_equal(xv)
        for _ in range(4):
            wv.mul(wv)

    cs, jcs = ConstraintSystem(eng.fr, "setup"), JCS(jeng.fr, "setup")
    square_circuit(cs)
    jsquare(jcs)
    pk = g16.generate_parameters(cs, eng, XorShiftRng(b"pk-serde-test-00"))
    jpk = jg16.generate_parameters(jcs, jeng, JXorShiftRng(b"pk-serde-test-00"))
    for compressed in (False, True):
        blob = spk.pk_to_bytes(pk, engine_name, compressed=compressed)
        assert blob == jspk.pk_to_bytes(jpk, engine_name, compressed=compressed)
        assert spk.pk_from_bytes(blob, engine_name, compressed=compressed) == pk
        vk_blob = spk.vk_to_bytes_generic(pk.vk, engine_name, compressed)
        assert vk_blob == jspk.vk_to_bytes_generic(jpk.vk, engine_name, compressed)
        assert spk.vk_from_bytes_generic(vk_blob, engine_name, compressed) == pk.vk
    with pytest.raises(ValueError):
        spk.pk_from_bytes(blob[:-1], engine_name, compressed=True)
    w = 31337
    x = w * w % eng.fr
    cs, jcs = ConstraintSystem(eng.fr, "prove"), JCS(jeng.fr, "prove")
    square_circuit(cs, x, w)
    jsquare(jcs, x, w)
    proof = g16.create_proof_no_zk(pk, cs, eng)
    jproof = jg16.create_proof_no_zk(jpk, jcs, jeng)
    assert (proof.a, proof.b, proof.c) == (jproof.a, jproof.b, jproof.c)
    if bw6:
        assert sb.vk_to_bytes(pk.vk) == jsb.vk_to_bytes(jpk.vk)
        assert sb.proof_to_bytes(proof) == jsb.proof_to_bytes(jproof)
        assert sb.proof_from_bytes(sb.proof_to_bytes(proof)) == proof
        assert sb.vk_from_bytes(sb.vk_to_bytes(pk.vk)) == pk.vk


@pytest.fixture(scope="module")
def pinned():
    def pks(data):
        return [PublicKey.from_bytes(data[i * 96:(i + 1) * 96]) for i in range(len(data) // 96)]

    def grab(name):
        return bytes.fromhex(getattr(vectors_snark, name))

    return {
        "proof": grab("ENTROPY_PROOF"),
        "vk": grab("ENTROPY_VK"),
        "first": EpochBlock(0, 0, bytes.fromhex("01" * 16), bytes.fromhex("02" * 16), 1, 4,
                            pks(grab("ENTROPY_FIRST_PUBKEYS"))),
        "last": EpochBlock(2, 0, bytes.fromhex("03" * 16), bytes.fromhex("02" * 16), 1, 4,
                           pks(grab("ENTROPY_LAST_PUBKEYS"))),
    }


def test_pinned_production_proof_verifies(pinned):
    assert api.verify(pinned["vk"], pinned["proof"], pinned["first"], pinned["last"])


@pytest.mark.parametrize("tamper", ["swapped", "parent_entropy", "garbage_proof"])
def test_pinned_production_proof_rejects(pinned, tamper):
    first, last, proof = pinned["first"], pinned["last"], pinned["proof"]
    if tamper == "swapped":
        first, last = last, first
    elif tamper == "parent_entropy":  # the first commitment covers it
        first = EpochBlock(first.index, first.round, first.epoch_entropy, bytes(16),
                           first.maximum_non_signers, first.maximum_validators,
                           first.new_public_keys)
    else:
        proof = proof[:-1]
    assert not api.verify(pinned["vk"], proof, first, last)

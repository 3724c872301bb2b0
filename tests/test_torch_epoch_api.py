"""The port's epoch-SNARK API (celo_bls_snark_tpu_torch/snark/api.py)
against the JAX package's: injected setup generators see equal constraint
systems in both modes, the ark_parity boundary raises, prove(device=None)
synthesizes the same padded witness as the JAX prove (the Groth16 step is
replaced in both packages by a recorder of its constraint system), and
the entry points' default device raises without a card. Host code only;
tolerance 0. The card runs setup, prove and verify in full in
chip_smoke.py's epoch_snark phase."""

import subprocess
import sys
from dataclasses import replace
from types import SimpleNamespace

import pytest
import torch

from celo_bls_snark_tpu.snark import api as japi
from celo_bls_snark_tpu.snark import fixtures as jfixtures
from celo_bls_snark_tpu.snark import groth16 as jg16
from celo_bls_snark_tpu.hostmath.params import G1_GENERATOR, G2_GENERATOR
from celo_bls_snark_tpu_torch.snark import api
from celo_bls_snark_tpu_torch.snark import fixtures
from celo_bls_snark_tpu_torch.snark import groth16 as g16
from celo_bls_snark_tpu_torch.utils import config
from celo_bls_snark_tpu_torch.utils.rngs import XorShiftRng

no_card = pytest.mark.skipif(
    torch.cuda.is_available(),
    reason="checks the error raised without a card; with one the default device runs",
)


def injected_setup(mod, two_snark):
    """mod.setup with recording generators: each returns a stand-in key
    (a vk of the right shape for the helper, whose vk the outer circuit
    embeds as constants)."""
    calls = []

    def helper_setup(hcs, rng):
        calls.append(("helper", hcs.num_constraints, hcs.num_instance, hcs.num_witness))
        vk = mod.VerifyingKey(alpha_g1=G1_GENERATOR, beta_g2=G2_GENERATOR,
                              gamma_g2=G2_GENERATOR, delta_g2=G2_GENERATOR,
                              gamma_abc_g1=[G1_GENERATOR] * hcs.num_instance)
        return SimpleNamespace(vk=vk, tag="helper-pk")

    def epoch_setup(cs, rng):
        calls.append(("epochs", cs.num_constraints, cs.num_instance, cs.num_witness))
        return SimpleNamespace(vk=None, tag="epoch-pk")

    params = mod.setup(2, 1, 0, None, helper_setup, epoch_setup,
                       hashes_in_bls12_377=two_snark)
    return calls, params


@pytest.mark.parametrize("two_snark", [False, True])
def test_injected_setup_equal_jax(two_snark):
    calls, params = injected_setup(api, two_snark)
    assert calls == injected_setup(japi, two_snark)[0]
    assert [c[0] for c in calls] == (["helper", "epochs"] if two_snark else ["epochs"])
    assert params.epochs.tag == "epoch-pk"
    if two_snark:
        assert params.hash_to_bits.tag == "helper-pk"
    else:
        assert params.hash_to_bits is None


def test_ark_parity_boundary_raises():
    prev = config.get_config()
    config.set_config(replace(prev, ark_parity=True))
    try:
        with pytest.raises(NotImplementedError, match="ark_parity"):
            api.trusted_setup(2, 1, 0, XorShiftRng(b"e2e-trusted-setp"), device=None)
    finally:
        config.set_config(prev)


def test_config_reads_the_new_fields_from_the_environment(monkeypatch):
    monkeypatch.setenv("CELO_BLS_TPU_ARK_PARITY", "1")
    monkeypatch.setenv("CELO_BLS_TPU_COMPAT_SIGN_BIT", "383")
    cfg = config._from_env(config.Config())
    assert (cfg.ark_parity, cfg.compat_sign_bit) == (True, 383)
    assert (config.Config().ark_parity, config.Config().compat_sign_bit) == (False, 377)


def recorded_prove(mod, g16mod, fixtures_mod, monkeypatch, **kw):
    """mod.prove over the 2-validator chain with one real transition
    padded to max_transitions = 2, with the Groth16 step replaced by a
    recorder of the synthesized system."""
    seen = {}

    def record(pk, cs, engine, accel=None, evals=None):
        seen.update(cs=cs, accel=accel, engine=engine.name, nevals=len(evals[0]))
        return "proof"

    monkeypatch.setattr(g16mod, "create_proof_no_zk", record)
    first, transitions, last = fixtures_mod.generate_test_data(2, 0, 1)
    params = mod.Parameters(epochs=SimpleNamespace(), hash_to_bits=None)
    assert mod.prove(params, 2, first, transitions, max_transitions=2, **kw) == "proof"
    return seen, mod.pack(mod.hash_first_last_epoch_block(first, last))


def test_prove_host_path_synthesizes_the_jax_witness(monkeypatch):
    seen, inputs = recorded_prove(api, g16, fixtures, monkeypatch, device=None)
    jseen, jinputs = recorded_prove(japi, jg16, jfixtures, monkeypatch)
    cs, jcs = seen["cs"], jseen["cs"]
    assert seen["accel"] is None and seen["engine"] == jseen["engine"] == "bw6_761"
    assert (cs.num_constraints, cs.num_instance, cs.num_witness) == \
        (jcs.num_constraints, jcs.num_instance, jcs.num_witness)
    assert seen["nevals"] == jseen["nevals"] == cs.num_constraints
    assert cs.full_assignment() == jcs.full_assignment()
    assert cs.instance_assignment[1:] == inputs == jinputs


def test_prove_rejects_bad_transition_counts():
    first, transitions, _ = fixtures.generate_test_data(2, 0, 1)
    params = api.Parameters(epochs=SimpleNamespace(), hash_to_bits=None)
    with pytest.raises(api.SynthesisError):
        api.prove(params, 2, first, [], device=None)
    with pytest.raises(api.SynthesisError):
        api.prove(params, 2, first, transitions * 3, max_transitions=2, device=None)


@no_card
def test_default_device_raises_without_a_card():
    rng = XorShiftRng(b"e2e-trusted-setp")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        api.trusted_setup(2, 1, 0, rng)
    first, transitions, _ = fixtures.generate_test_data(2, 0, 1)
    params = api.Parameters(epochs=SimpleNamespace(), hash_to_bits=None)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        api.prove(params, 2, first, transitions)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        api.generate_hash_helper(SimpleNamespace(), [])
    assert api._accel("bw6_761", None) is None
    assert api._accel("bls12_377", "cpu").device.type == "cpu"


def test_importing_the_api_loads_no_accelerator():
    code = ("import sys, celo_bls_snark_tpu_torch.snark.api; "
            "bad = [m for m in sys.modules if m.endswith('snark.accel') or m.startswith('jax') "
            "or m.startswith('celo_bls_snark_tpu.')]; "
            "assert not bad, bad")
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120)

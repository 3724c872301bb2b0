"""The port's Groth16 device path (celo_bls_snark_tpu_torch/snark/accel.py
with snark/groth16.py, relations/r1cs.py) against the JAX package on the
CPU.

compute_h_evals gives the JAX accelerator's raw limbs and the host
oracle's coefficients. The slice as a whole: a small circuit, synthesized
by the port's gadgets into the port's constraint system (and by the JAX
package's into the JAX package's), is set up and proven by the port with
its torch accelerator
(device="cpu": every kernel's plain version); the proving key and the
proof equal the JAX package's host key and proof bit for bit (same rng,
r = s = 0, so both are deterministic) and the proof verifies, for both
engines. Integer work: the tolerance is 0."""

import dataclasses
import random

import numpy as np
import pytest
import torch

from celo_bls_snark_tpu.gadgets.vars import FpVar as JFpVar
from celo_bls_snark_tpu.ops import curve as jdc
from celo_bls_snark_tpu.ops import field as jf
from celo_bls_snark_tpu.ops import msm as jmsm
from celo_bls_snark_tpu.relations import r1cs as jr1cs
from celo_bls_snark_tpu.snark import accel as jaccel
from celo_bls_snark_tpu.snark import api as japi
from celo_bls_snark_tpu.snark import groth16 as jg16
from celo_bls_snark_tpu.utils.rngs import XorShiftRng as JXorShiftRng
from celo_bls_snark_tpu_torch import convert
from celo_bls_snark_tpu_torch.gadgets.vars import FpVar
from celo_bls_snark_tpu_torch.ops import field as tf
from celo_bls_snark_tpu_torch.ops import msm as tmsm
from celo_bls_snark_tpu_torch.relations import r1cs as tr1cs
from celo_bls_snark_tpu_torch.snark import accel as taccel
from celo_bls_snark_tpu_torch.snark import api as tapi
from celo_bls_snark_tpu_torch.snark import groth16 as tg16
from celo_bls_snark_tpu_torch.utils.rngs import XorShiftRng

# one thread: the plain versions loop over small tensors, and the test
# suite's parallel workers would otherwise contend for every core
torch.set_num_threads(1)

ENGINES = {
    "bls12_377": (jg16.BLS12_377_ENGINE, tg16.BLS12_377_ENGINE),
    "bw6_761": (japi.BW6_761_ENGINE, tapi.BW6_761_ENGINE),
}
SEED = b"accel-g16-test00"


def synth(cs, x=None, w=None, fpvar=FpVar):
    """x = w^2 and w^4 = x^2, the circuit of the JAX package's device
    accelerator test, with the gadgets of either package."""
    xv = fpvar.new_input(cs, x)
    wv = fpvar.new_witness(cs, w)
    wv.mul(wv).enforce_equal(xv)
    a = wv.mul(wv)
    b = a.mul(wv)
    b.mul(wv).enforce_equal(xv.mul(xv))


def plain(obj):
    """Keys and proofs of either package as nested plain python values."""
    if dataclasses.is_dataclass(obj):
        return {f.name: plain(getattr(obj, f.name)) for f in dataclasses.fields(obj)}
    if isinstance(obj, (list, tuple)) or hasattr(obj, "to_host_list"):
        return [plain(v) for v in obj]
    return obj


def host_h(eng, a_e, b_e, c_e, d):
    """The host oracle of the h-polynomial pipeline (python ints)."""
    r, g = eng.fr, eng.fr_generator
    omega = tg16._root_of_unity(eng, d)
    gpow = [pow(g, i, r) for i in range(d)]
    ac, bc, cc = (
        tg16.fft([c * s % r for c, s in zip(tg16.ifft(e, omega, r), gpow)], omega, r)
        for e in (a_e, b_e, c_e)
    )
    tinv = pow((pow(g, d, r) - 1) % r, -1, r)
    hs = tg16.ifft([(x * y - z) % r * tinv % r for x, y, z in zip(ac, bc, cc)], omega, r)
    ginv = pow(g, -1, r)
    return [c * pow(ginv, i, r) % r for i, c in enumerate(hs)][: d - 1]


@pytest.mark.parametrize("name", list(ENGINES))
def test_compute_h_evals_limbs_match_jax_and_host(name):
    jeng, teng = ENGINES[name]
    rng = random.Random(20261016)
    d, r = 16, teng.fr
    a_e, b_e, c_e = ([rng.randrange(r) for _ in range(d)] for _ in range(3))
    got = taccel.get_accel(name, "cpu").compute_h_evals(a_e, b_e, c_e, d, teng.fr_generator)
    want = jaccel.get_accel(name).compute_h_evals(a_e, b_e, c_e, d, jeng.fr_generator)
    assert isinstance(got, tmsm.RawScalarVec) and got.limbs.dtype == np.uint16
    np.testing.assert_array_equal(got.limbs, np.asarray(want.limbs))
    assert got.to_ints() == host_h(teng, a_e, b_e, c_e, d)
    with tf.mul_kernel("tc"):
        again = taccel.get_accel(name, "cpu").compute_h_evals(
            a_e, b_e, c_e, d, teng.fr_generator)
    np.testing.assert_array_equal(again.limbs, got.limbs)


@pytest.mark.parametrize("name", list(ENGINES))
def test_slice_key_and_proof_equal_jax_host_bit_for_bit(name):
    jeng, teng = ENGINES[name]
    accel = taccel.get_accel(name, "cpu")
    cs, jcs = tr1cs.ConstraintSystem(teng.fr, "setup"), jr1cs.ConstraintSystem(jeng.fr, "setup")
    synth(cs)
    synth(jcs, fpvar=JFpVar)
    pk = tg16.generate_parameters(cs, teng, XorShiftRng(SEED), accel=accel)
    jpk = jg16.generate_parameters(jcs, jeng, JXorShiftRng(SEED))
    assert plain(pk) == plain(jpk)
    assert accel.prewarm_prove(pk) == []
    w = 987654321
    x = w * w % teng.fr
    cs, jcs = tr1cs.ConstraintSystem(teng.fr, "prove"), jr1cs.ConstraintSystem(jeng.fr, "prove")
    synth(cs, x, w)
    synth(jcs, x, w, fpvar=JFpVar)
    assert cs.full_assignment() == jcs.full_assignment()
    assert cs.is_satisfied()
    proof = tg16.create_proof_no_zk(pk, cs, teng, accel=accel)
    jproof = jg16.create_proof_no_zk(jpk, jcs, jeng)
    assert plain(proof) == plain(jproof)
    assert tg16.verify_proof(pk.vk, proof, [x], teng)
    assert not tg16.verify_proof(pk.vk, proof, [x + 1], teng)
    assert jg16.verify_proof(jpk.vk, jg16.Proof(**plain(proof)), [x], jeng)


def test_fixed_base_batch_and_msm_through_the_accelerator():
    """The setup's workload and the prover's MSM through DeviceAccel alone:
    generator multiples as a PointVec, then an MSM over that PointVec."""
    accel = taccel.get_accel("bls12_377", "cpu")
    eng = tg16.BLS12_377_ENGINE
    rng = random.Random(3)
    ks = [rng.randrange(1, 1 << 30) for _ in range(5)] + [0]
    bases = accel.g1.fixed_base_batch(ks)
    assert list(bases) == [eng.g1.mul(k, eng.g1_gen) if k else None for k in ks]
    ss = [rng.randrange(eng.fr) for _ in ks]
    want = eng.g1.mul(sum(k * s for k, s in zip(ks, ss)) % eng.fr, eng.g1_gen)
    assert accel.g1.msm(bases, ss, c=8, L=2) == want
    raw = tmsm.RawScalarVec(tf.FR.pack_raw(ss, "cpu").numpy(), tf.FR)
    assert accel.g1.msm(list(bases), raw, c=8, L=2) == want


def test_accel_is_cached_and_takes_no_mesh():
    accel = taccel.get_accel("bw6_761", "cpu")
    assert taccel.get_accel("bw6_761", "cpu") is accel
    assert accel.device.type == "cpu" and accel.g2.key == "bw6-g2"
    accel.set_mesh(None)
    # the mesh routes (parallel/mesh.py) take a mesh on the accelerator's
    # own device only
    from celo_bls_snark_tpu_torch.parallel.mesh import Mesh

    with pytest.raises(ValueError, match="set_mesh"):
        accel.set_mesh(Mesh(None, 0, 2, torch.device("cuda", 0)))
    assert accel.mesh is None
    with pytest.raises(ValueError):
        taccel.DeviceAccel("bn254", "cpu")


def test_convert_carries_prover_state_both_ways():
    rng = random.Random(4)
    pts = [jg16.BLS12_377_ENGINE.g1.mul(3 + i, jg16.BLS12_377_ENGINE.g1_gen)
           for i in range(3)] + [None]
    leaves = [jf.FQ.pack_raw([0 if p is None else p[k] for p in pts]) for k in (0, 1)]
    jpv = jdc.PointVec(leaves, jf.FQ, (0, 0))
    pv = convert.point_vec_from_numpy(jpv.leaves, tf.FQ, (0, 0))
    assert list(pv) == pts == list(jpv)
    back = jdc.PointVec(convert.point_vec_to_numpy(pv), jf.FQ, (0, 0))
    assert list(back) == pts
    vals = [rng.randrange(tf.FR.modulus) for _ in range(5)]
    jsv = jmsm.RawScalarVec(jf.FR.pack_raw(vals), jf.FR)
    sv = convert.raw_scalars_from_numpy(jsv.limbs, tf.FR)
    assert sv.to_ints() == vals
    assert jmsm.RawScalarVec(convert.raw_scalars_to_numpy(sv), jf.FR).to_ints() == vals
    plan = jmsm.plan_msm(vals, 253, 6, 2)
    dev = convert.plan_from_numpy(*plan[:4], "cpu")
    for a, b in zip(convert.plan_to_numpy(*dev), plan[:4]):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    table = np.asarray(jf.FQ.pack(vals))
    np.testing.assert_array_equal(
        convert.tree_to_numpy(convert.tree_from_numpy(table, "cpu")), table)

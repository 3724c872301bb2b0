"""The port's R1CS gadgets (celo_bls_snark_tpu_torch/gadgets/) against the
JAX package's: each circuit of tests/test_gadgets*.py is synthesized by
both packages from the same values, and the two constraint systems must
have equal constraint, instance and witness counts, equal
matrix_hash.matrices_hashes digests, equal assignments and equal
satisfaction. Host code only, no JAX compile; tolerance 0."""

import random

import pytest
import torch_both

from celo_bls_snark_tpu_torch.hostmath import curves as hc
from celo_bls_snark_tpu_torch.hostmath import fq12 as hf12
from celo_bls_snark_tpu_torch.hostmath.params import G1_GENERATOR, G2_GENERATOR, P, R


def synth_both(build, field=P, mode="prove"):
    tcs, ret, _ = torch_both.synth_both(build, field, mode)
    return tcs, ret


def rnd(seed):
    return random.Random(seed)


def c_fp_core(m, cs):
    v = m("gadgets.vars")
    a, b = v.FpVar.new_witness(cs, 3), v.FpVar.new_witness(cs, 5)
    x = v.FpVar.new_input(cs, 15)
    with cs.ns("outer"):
        with cs.ns("inner"):
            c = a.mul(b)
    c.enforce_equal(x)
    z = a.sub(a).is_eq_zero()
    inv = b.inverse()
    n = a.normalize()
    _ = a.add(b).sub(a).neg().mul_const(7)
    a.enforce_cmp_leq(b)
    return [c.value, z.value, inv.value, n.value, cs.constraint_counts_by_namespace()]


def c_booleans(m, cs):
    v = m("gadgets.vars")
    vals = []
    for x in (False, True):
        for y in (False, True):
            bx, by = v.Boolean.new_witness(cs, x), v.Boolean.new_witness(cs, y)
            outs = [bx.and_(by), bx.or_(by), bx.xor(by), bx.not_()]
            sel = v.FpVar.conditionally_select(bx, v.FpVar.new_witness(cs, 7),
                                               v.FpVar.new_witness(cs, 9))
            vals.append([o.value for o in outs] + [sel.value])
    bits = [v.Boolean.new_witness(cs, b) for b in (True, True, False, True)]
    vals.append(v.Boolean.kary_and(bits).value)
    return vals


def c_uint32(m, cs):
    u = m("gadgets.uint32").UInt32
    r = rnd(1)
    a, b, c = (u.new_witness(cs, r.getrandbits(32)) for _ in range(3))
    s = u.addmany(cs, [a, b, c, u.constant(cs, 0xDEADBEEF)])
    return [s.value(), a.xor(b).value(), a.rotr(7).value()]


@pytest.mark.parametrize("bits,max_occ,value", [
    ((1, 0, 1, 0, 1), 2, False), ((1, 0, 0, 0, 1), 2, False),
    ((1, 1, 0, 0), 2, True), ((1, 1, 1, 0), 2, True),
])
def test_bitmap_equal_jax(bits, max_occ, value):
    def build(m, cs):
        v = m("gadgets.vars")
        bitmap = [v.Boolean.new_witness(cs, bool(b)) for b in bits]
        m("gadgets.bitmap").enforce_maximum_occurrences_in_bitmap(
            cs, bitmap, v.FpVar.const(cs, max_occ), value)

    cs, _ = synth_both(build)
    want = (bits.count(0) if not value else bits.count(1)) <= max_occ
    assert cs.is_satisfied() == want


def c_pack(m, cs):
    v, pk = m("gadgets.vars"), m("gadgets.pack")
    vals = [True, False, True] * 100
    fps = pk.multipack(cs, [v.Boolean.new_witness(cs, b) for b in vals], 252, True)
    return [f.value for f in fps] + pk.pack_native(vals, R, 252)


def c_y_to_bit(m, cs):
    v, y2b = m("gadgets.vars"), m("gadgets.y_to_bit")
    out = []
    for k in (1, 2, 7, 123):
        p1, p2 = hc.G1.mul(k, G1_GENERATOR), hc.G2.mul(k, G2_GENERATOR)
        out.append(y2b.g1_y_to_bit(cs, v.FpVar.new_witness(cs, p1[1])).value)
        out.append(y2b.g2_y_to_bit(cs, v.FpVar.new_witness(cs, p2[1][0]),
                                   v.FpVar.new_witness(cs, p2[1][1])).value)
    for c0 in (5, P - 5):  # c1 == 0 falls through to c0
        out.append(y2b.g2_y_to_bit(cs, v.FpVar.new_witness(cs, c0),
                                   v.FpVar.new_witness(cs, 0)).value)
    return out


def c_checked_points(m, cs):
    cv, y2b = m("gadgets.curve_vars"), m("gadgets.y_to_bit")
    g1 = cv.G1Var.new_witness_checked(cs, None if cs.is_in_setup_mode() else G1_GENERATOR)
    y2b.g1_y_to_bit(cs, g1.y)
    g2 = cv.G2Var.new_witness_checked(cs, None if cs.is_in_setup_mode() else G2_GENERATOR)
    y2b.g2_y_to_bit(cs, g2.y.c0, g2.y.c1)
    return cs.num_constraints


def c_ext_vars(m, cs):
    ev, v = m("gadgets.ext_vars"), m("gadgets.vars")
    r = rnd(2)

    def f2():
        return (r.randrange(P), r.randrange(P))

    def f6():
        return (f2(), f2(), f2())

    a, b = ev.Fp2Var.new_witness(cs, f2()), ev.Fp2Var.new_witness(cs, f2())
    out = [a.mul(b).value(), a.square().value(), a.inverse().value()]
    x = ev.Fp12Var.new_witness(cs, (f6(), f6()))
    out += [x.frobenius().value(), x.mul(x).value(), x.square().value()]
    f = (f6(), f6())
    u = hf12.mul(hf12.conj(f), hf12.inv(f))
    u = hf12.mul(hf12.frob_n(u, 2), u)  # unitary: the easy part
    uv = ev.Fp12Var.new_witness(cs, u)
    out.append(uv.cyclotomic_square().value())
    out.append(uv.mul_by_sparse_line(v.FpVar.new_witness(cs, r.randrange(P)),
                                     ev.Fp2Var.new_witness(cs, f2()),
                                     ev.Fp2Var.new_witness(cs, f2())).value())
    return out


def c_curve_vars(m, cs):
    cv = m("gadgets.curve_vars")
    p1, p2 = hc.G1.mul(5, G1_GENERATOR), hc.G1.mul(7, G1_GENERATOR)
    q1, q2 = hc.G2.mul(3, G2_GENERATOR), hc.G2.mul(11, G2_GENERATOR)
    v1, v2 = cv.G1Var.new_witness(cs, p1), cv.G1Var.new_witness(cs, p2)
    w1, w2 = cv.G2Var.new_witness(cs, q1), cv.G2Var.new_witness(cs, q2)
    return [v1.add_unchecked(v2).value(), v1.double().value(),
            w1.add_unchecked(w2).value(), v1.is_eq(v2).value]


def c_blake2s(m, cs):
    v, bg = m("gadgets.vars"), m("gadgets.blake2s_gadget")
    msg = b"the port's blake2s gadget, 70 bytes long: two compressions of 64 byte"
    bits = [v.Boolean.new_witness(cs, (x >> i) & 1 == 1) for x in msg for i in range(8)]
    out = bg.blake2s_gadget(cs, bits, bg.blake2s_param_words(digest_size=32,
                                                             person=b"ULforout"))
    return [o.value for o in out]


def c_hash_to_bits(m, cs):
    v, h2b = m("gadgets.vars"), m("gadgets.hash_to_bits")
    bits = [v.Boolean.new_witness(cs, b) for b in [True, False, False, True] * 12]
    on = h2b.hash_to_bits(cs, bits, 512, b"ULforxof", True)
    off = h2b.hash_to_bits(cs, bits, 512, b"ULforxof", False)
    return [b.value for b in on] + [b.value for b in off]


def c_pedersen(m, cs):
    v = m("gadgets.vars")
    msg = b"hello pedersen"
    bits = [v.Boolean.new_witness(cs, (x >> i) & 1 == 1) for x in msg for i in range(8)]
    pt, crh = m("gadgets.pedersen").pedersen_crh_gadget(cs, bits)
    return [pt.value(), [b.value for b in crh]]


CIRCUITS = {
    "fp_core": c_fp_core, "booleans": c_booleans, "uint32": c_uint32,
    "pack": c_pack, "y_to_bit": c_y_to_bit, "checked_points": c_checked_points,
    "ext_vars": c_ext_vars, "curve_vars": c_curve_vars, "blake2s": c_blake2s,
    "hash_to_bits": c_hash_to_bits, "pedersen": c_pedersen,
}


@pytest.mark.parametrize("name", list(CIRCUITS))
def test_circuit_equal_jax(name):
    cs, _ = synth_both(CIRCUITS[name])
    assert cs.is_satisfied()


@pytest.mark.parametrize("name", ["fp_core", "checked_points", "blake2s", "pedersen"])
def test_setup_mode_equal_jax_and_prove_mode(name):
    """Setup-mode synthesis gives the same matrices in both packages, and
    the same counts as the prove-mode run."""
    def build(m, cs):
        CIRCUITS[name](m, cs)

    setup, _ = synth_both(build, mode="setup")
    prove, _ = synth_both(build)
    assert (setup.num_constraints, setup.num_instance, setup.num_witness) == \
        (prove.num_constraints, prove.num_instance, prove.num_witness)


def test_checked_point_and_y_to_bit_counts():
    """The reference's pinned figures (y_to_bit.rs:211,251): a checked G1
    point and its y-to-bit is 1,003 constraints, a checked G2 point 2,014."""
    cs, count = synth_both(c_checked_points, mode="setup")
    assert count == 1003 + 2014


def test_off_curve_point_unsatisfied_in_both():
    def build(m, cs):
        m("gadgets.curve_vars").G1Var.new_witness_checked(
            cs, (G1_GENERATOR[0], G1_GENERATOR[1] + 1))

    cs, _ = synth_both(build)
    assert not cs.is_satisfied()


def h2g_circuit(constraints_for_hash, msg=b"epoch message for h2g", extra=b"xx",
                counter=None):
    def build(m, cs):
        v = m("gadgets.vars")
        h2c = m("hash_to_curve").composite_hash_to_g1_cip22()
        pt, c = h2c.hash_with_attempt_cip22(b"ULforxof", msg, extra)

        def bits(data):
            return [v.Boolean.new_witness(cs, (x >> i) & 1 == 1) for x in data for i in range(8)]

        g1, crh_bits, xof_bits = m("gadgets.hash_to_group").enforce_hash_to_group(
            cs, bits(bytes([c if counter is None else counter])), bits(msg), bits(extra),
            constraints_for_hash)
        return [g1.value(), pt, [b.value for b in crh_bits], [b.value for b in xof_bits]]

    return build


@pytest.mark.parametrize("constraints_for_hash", [True, False])
def test_hash_to_group_equal_jax(constraints_for_hash):
    cs, (g1, native, _, _) = synth_both(h2g_circuit(constraints_for_hash))
    assert cs.is_satisfied() and g1 == native


def bls_verify_circuit(bitmap_vals, max_ns, forge=False):
    """The in-circuit BLS verify of tests/test_gadgets_pairing.py with
    checked point allocation throughout."""
    def build(m, cs):
        v, cv = m("gadgets.vars"), m("gadgets.curve_vars")
        rng = m("utils.rngs").XorShiftRng(b"gadget-bls-test!")
        sks = [m("bls").PrivateKey.generate(rng) for _ in bitmap_vals]
        h = m("hash_to_curve").composite_hash_to_g1_cip22().hash(
            b"ULforxof", b"epoch data", b"")
        asig = hc.G1.msum([hc.G1.mul(sk.sk, h) for sk, b in zip(sks, bitmap_vals) if b])
        if forge:
            asig = hc.G1.mul(999, h)
        m("gadgets.bls").verify(
            cs,
            [cv.G2Var.new_witness_checked(cs, sk.to_public().pt) for sk in sks],
            [v.Boolean.new_witness(cs, b) for b in bitmap_vals],
            cv.G1Var.new_witness_checked(cs, h),
            cv.G1Var.new_witness_checked(cs, asig),
            v.FpVar.const(cs, max_ns),
        )

    return build


def test_single_bls_verify_is_18439_constraints():
    """One in-circuit BLS verify costs 18,439 constraints in both packages
    (tests/test_gadgets_pairing.py::test_verify_constraint_count)."""
    cs, _ = synth_both(bls_verify_circuit([True], 0))
    assert cs.is_satisfied()
    assert cs.num_constraints == 18439


@pytest.mark.parametrize("bitmap_vals,max_ns,forge,ok", [
    ([True, True, True, False], 1, True, False),
    ([True, True, False, False], 1, False, False),
])
def test_bls_verify_verdicts_equal_jax(bitmap_vals, max_ns, forge, ok):
    cs, _ = synth_both(bls_verify_circuit(bitmap_vals, max_ns, forge))
    assert cs.is_satisfied() == ok


def test_pairing_gadget_equal_jax_and_host():
    def build(m, cs):
        cv, pg = m("gadgets.curve_vars"), m("gadgets.pairing_gadget")
        p1, q1 = hc.G1.mul(5, G1_GENERATOR), hc.G2.mul(9, G2_GENERATOR)
        f = pg.miller_loop_gadget(cs, [(cv.G1Var.new_witness(cs, p1),
                                        cv.G2Var.new_witness(cs, q1))])
        e = pg.final_exponentiation_gadget(cs, f)
        hp = m("hostmath.pairing")
        return [e.value(), hp.final_exponentiation_3d(hp.miller_loop([(p1, q1)]))]

    cs, (got, host) = synth_both(build)
    assert cs.is_satisfied() and got == host


def test_groth16_verify_gadget_equal_jax():
    """The 2-SNARK recursion gadget: a BLS12-377 proof of a 20-bit
    multipacked input verified inside a BW6-761 system
    (tests/test_groth16_recursion.py); the proof is made by the port.
    Unsatisfied systems are compared in the BLS verify cases above."""
    from celo_bls_snark_tpu_torch.gadgets.pack import multipack
    from celo_bls_snark_tpu_torch.gadgets.vars import Boolean
    from celo_bls_snark_tpu_torch.relations.r1cs import ConstraintSystem
    from celo_bls_snark_tpu_torch.snark import groth16 as g16
    from celo_bls_snark_tpu_torch.utils.rngs import XorShiftRng

    nbits = 20
    bits = [rnd(3).random() < 0.5 for _ in range(nbits)]

    def inner(cs, vals):
        multipack(cs, [Boolean.new_witness(cs, b) for b in vals], nbits, as_input=True)

    cs = ConstraintSystem(R, "setup")
    inner(cs, [False] * nbits)
    pk = g16.generate_parameters(cs, g16.BLS12_377_ENGINE, XorShiftRng(b"recursion-seed00"))
    cs = ConstraintSystem(R, "prove")
    inner(cs, bits)
    proof = g16.create_proof_no_zk(pk, cs, g16.BLS12_377_ENGINE)

    def outer(m, cs):
        v, gv = m("gadgets.vars"), m("gadgets.groth16_verify")
        bv = [v.Boolean.new_witness(cs, b) for b in bits]
        gv.enforce_groth16_verify(cs, pk.vk, [bv], gv.ProofVar.new_witness(cs, proof))

    cs, _ = synth_both(outer, field=P)
    assert cs.is_satisfied()

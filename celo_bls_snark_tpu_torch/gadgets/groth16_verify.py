"""In-circuit Groth16 verification of a BLS12-377 proof (over BW6-761 Fr).

The recursion gadget of the 2-SNARK technique — parity with
crates/epoch-snark/src/gadgets/epoch_bits.rs:104-132 (ark's
Groth16VerifierGadget): the outer ValidatorSetUpdate circuit verifies the
HashToBits helper proof whose public inputs are the packed CRH/XOF bit
streams. BW6-761's scalar field equals BLS12-377's base field, so the
helper proof's group elements are native coordinates here.

The verifying key is a circuit CONSTANT (embedded at setup time, like ark's
`new_verifier_key` allocation from the params); the prepared-input MSM
  acc = gamma_abc[0] + sum_i x_i * gamma_abc[i+1]
is computed over the INSTANCE BITS: x_i is the BE-packed chunk (the same
packing as gadgets/pack.py::multipack, which the helper circuit used to
expose its inputs), so each bit contributes a host-precomputed constant
multiple 2^(L-1-j) * gamma_abc[i+1] via one conditional mixed addition.

The pairing equation e(A, B) == e(alpha, beta) e(acc, gamma) e(C, delta)
is enforced as final_exp(miller(-A, B) * miller(acc, gamma) *
miller(C, delta)) == const, with const = e3d(alpha, beta) precomputed on
the host (matching the gadget's cofactor-3-scaled final exponentiation).
"""

from ..hostmath import curves as hc
from ..hostmath import pairing as hp
from ..hostmath import fp2 as hf2
from ..hostmath.params import G1_GENERATOR, G2_GENERATOR
from .vars import Boolean
from .curve_vars import G1Var, G2Var
from .ext_vars import Fp12Var
from .pairing_gadget import miller_loop_gadget, final_exponentiation_gadget


class ProofVar:
    """Witnessed Groth16 proof (a: G1, b: G2, c: G1) over BLS12-377."""

    def __init__(self, a: G1Var, b: G2Var, c: G1Var):
        self.a = a
        self.b = b
        self.c = c

    @classmethod
    def new_witness(cls, cs, proof):
        """proof: groth16.Proof or None (setup mode / placeholder).

        Allocation is CHECKED (curve equation enforced per element),
        matching ark's ProofVar::new_witness (epoch_bits.rs:110), whose SW
        AffineVar allocation omits only the prime-order check — off-curve
        proof elements would make the Miller-loop algebra a non-pairing."""
        a = proof.a if proof is not None else G1_GENERATOR
        b = proof.b if proof is not None else G2_GENERATOR
        c = proof.c if proof is not None else G1_GENERATOR
        return cls(
            G1Var.new_witness_checked(cs, a),
            G2Var.new_witness_checked(cs, b),
            G1Var.new_witness_checked(cs, c),
        )


def _prepare_inputs(cs, vk, input_bit_chunks):
    """acc = gamma_abc[0] + sum over chunks/bits of constant multiples."""
    assert len(input_bit_chunks) == len(vk.gamma_abc_g1) - 1, (
        f"{len(input_bit_chunks)} input chunks vs "
        f"{len(vk.gamma_abc_g1) - 1} vk inputs"
    )
    # NOTE: the conditional-add chain below uses add_unchecked, which is
    # unsatisfiable when the two operands share an x-coordinate. The addends
    # are fixed vk-derived constants and acc is their running subset-sum, so
    # an honest prover only hits an equal-x collision with negligible
    # probability (the vk points are setup-randomized); a malicious prover
    # gains nothing — a failed add makes the circuit UNsatisfiable, never
    # satisfiable-with-wrong-value. Same caveat as ark's AffineVar chains.
    acc = G1Var.constant(cs, vk.gamma_abc_g1[0])
    for i, bits in enumerate(input_bit_chunks):
        base = vk.gamma_abc_g1[i + 1]
        L = len(bits)
        # host table of 2^(L-1-j) * base, built by repeated doubling
        mults = [base]
        for _ in range(L - 1):
            mults.append(hc.G1.double(mults[-1]))
        mults.reverse()  # mults[j] = 2^(L-1-j) * base
        for j, b in enumerate(bits):
            pj = G1Var.constant(cs, mults[j])
            added = acc.add_unchecked(pj)
            acc = added.select(b, acc)
    return acc


def enforce_groth16_verify(cs, vk, input_bit_chunks, proof: ProofVar):
    """Enforce that `proof` verifies under the constant `vk`
    (groth16.VerifyingKey over BLS12-377) with public inputs equal to the
    BE-packed `input_bit_chunks` (list of Boolean lists, one per instance
    element — the multipack convention of the helper circuit)."""
    with cs.ns("groth16_verify"):
        acc = _prepare_inputs(cs, vk, input_bit_chunks)
        gamma = G2Var.constant(cs, vk.gamma_g2)
        delta = G2Var.constant(cs, vk.delta_g2)
        f = miller_loop_gadget(
            cs, [(proof.a.neg(), proof.b), (acc, gamma), (proof.c, delta)]
        )
        e = final_exponentiation_gadget(cs, f)
        # RHS: e3d(alpha, beta)^{-1}... the equation moved A to the left:
        # e(-A,B) e(acc,gamma) e(C,delta) == e(alpha,beta)^{-1}
        rhs = hp.final_exponentiation_3d(
            hp.miller_loop([(vk.alpha_g1, vk.beta_g2)])
        )
        rhs_inv = _f12_inv_host(rhs)
        e.enforce_equal(Fp12Var.const(cs, rhs_inv))


def _f12_inv_host(a):
    from ..hostmath import fq12 as hfq12

    return hfq12.inv(a)

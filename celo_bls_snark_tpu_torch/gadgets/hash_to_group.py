"""In-circuit CIP-22 try-and-increment hash-to-G1.

Parity with crates/bls-gadgets/src/hash_to_group.rs (HashToGroupGadget):
  - enforce_hash_to_group: Pedersen-CRH the message, prepend the witnessed
    counter + extra data, Blake2Xs to 512 bits (with the constraints-on/off
    2-SNARK switch), decompress and cofactor-multiply (:105-177).
  - hash_to_group: x from bits[0..377], sign from bit 377 (compat) / 383;
    witness the point, re-derive the x bits in-circuit and enforce equality
    (which also range-checks x < p), enforce the sign via y-to-bit, then
    the G1-cofactor scalar multiplication (:256-341).
"""

from ..bls import SIG_DOMAIN
from ..relations.r1cs import LinearCombination
from ..hostmath.params import P, G1_COFACTOR
from ..hostmath import curves as hc, fp as hfp
from .vars import Boolean, FpVar
from .curve_vars import G1Var
from .y_to_bit import g1_y_to_bit
from .hash_to_bits import hash_to_bits
from .pedersen import pedersen_crh_gadget
from ..utils.config import get_config

# compat (deployed Celo): sign bit position 377; upstream (non-compat): 383
# — the reference switches on the `compat` cargo feature
# (hash_to_group.rs:39-44); here it's Config.compat_sign_bit, read at call
# time so a process can pin either mode.
X_BITS = 377


def hash_to_group(cs, xof_bits):
    """xof_bits: 512 Booleans (LE). Returns the cofactor-cleared G1Var."""
    with cs.ns("hash_to_group"):
        x_bits = xof_bits[:X_BITS]
        sign_bit = xof_bits[get_config().compat_sign_bit]
        # witness the decompressed point from the native values
        if cs.is_in_setup_mode():
            pt = None
        else:
            x_val = 0
            for i, b in enumerate(x_bits):
                x_val |= int(bool(b.value)) << i
            greatest = bool(sign_bit.value)
            pt = hc.G1.get_point_from_x(x_val, greatest)
            assert pt is not None, "witness does not decompress (wrong counter?)"
        p_var = G1Var.new_witness(cs, pt)
        # re-compress: the point's x bits must equal the XOF bits
        # (to_bits_le enforces x < p, so out-of-range XOF values are
        # unsatisfiable, matching the native retry)
        px_bits = p_var.x.to_bits_le()
        for pb, xb in zip(px_bits[:X_BITS], x_bits):
            cs.enforce_constraint(
                pb.lc() - xb.lc(),
                LinearCombination.constant(1),
                LinearCombination(),
            )
        # on-curve: y^2 = x^3 + 1
        y2 = p_var.y.mul(p_var.y)
        x2 = p_var.x.mul(p_var.x)
        x3 = x2.mul(p_var.x)
        y2.enforce_equal(x3.add(FpVar.const(cs, 1)))
        # sign: y-to-bit equals the hash's sign bit
        ybit = g1_y_to_bit(cs, p_var.y)
        cs.enforce_constraint(
            ybit.lc() - sign_bit.lc(),
            LinearCombination.constant(1),
            LinearCombination(),
        )
        # cofactor multiplication (constant scalar double-and-add)
        return _scale_by_cofactor(cs, p_var)


def _scale_by_cofactor(cs, p_var: G1Var):
    with cs.ns("scale_by_cofactor"):
        bits = bin(G1_COFACTOR)[2:]
        acc = p_var
        for b in bits[1:]:
            acc = acc.double()
            if b == "1":
                acc = acc.add_unchecked(p_var)
        return acc


def enforce_hash_to_group(cs, counter_bits, message_bits, extra_data_bits,
                          generate_constraints_for_hash: bool):
    """counter_bits: 8 Booleans (LE); message/extra bits: LE bits of bytes.

    Returns (G1Var, xof_input_bits, xof_bits) — hash_to_group.rs:105-177.

    Divergence from the reference: the second return value is the FULL XOF
    input (counter || extra_data || crh bits), not the bare CRH bits of
    hash_to_group.rs:144. It feeds the 2-SNARK helper statement
    (snark/hash_to_bits_circuit.py), and the actual XOF runs over
    counter||extra||crh (try_and_increment_cip22.rs:96) — a helper proof
    over CRH-only bits (prover.rs:101-103, untested upstream) would attest
    a different hash than the one the circuit uses."""
    with cs.ns("enforce_hash_to_group"):
        _pt, crh_bits = pedersen_crh_gadget(cs, message_bits)
        inp = list(counter_bits) + list(extra_data_bits) + list(crh_bits)
        xof_bits = hash_to_bits(
            cs, inp, 512, SIG_DOMAIN, generate_constraints_for_hash
        )
        g1 = hash_to_group(cs, xof_bits)
        return g1, inp, xof_bits

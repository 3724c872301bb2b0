"""Synthesize one circuit with the JAX package's modules and with the
port's, and hold the two constraint systems equal (the helper of the
tests/test_torch_{gadgets,epoch_circuit}.py comparisons)."""

import importlib

JAX_PKG, PORT_PKG = "celo_bls_snark_tpu", "celo_bls_snark_tpu_torch"


def synth_both(build, field, mode="prove"):
    """Synthesize `build(m, cs)` with each package's modules (`m(name)`
    imports `<package>.<name>`). The two systems must have equal
    constraint, instance and witness counts, equal matrix digests
    (snark/matrix_hash.py, each package's own), equal assignments, equal
    satisfaction and equal build results. Returns the port's system, its
    build result and its digests."""
    out = {}
    for pkg in (JAX_PKG, PORT_PKG):
        def m(name, pkg=pkg):
            return importlib.import_module(f"{pkg}.{name}")

        cs = m("relations.r1cs").ConstraintSystem(field, mode)
        ret = build(m, cs)
        out[pkg] = (cs, ret, m("snark.matrix_hash").matrices_hashes(cs))
    (jcs, jret, jhash), (tcs, tret, thash) = out[JAX_PKG], out[PORT_PKG]
    assert (tcs.num_constraints, tcs.num_instance, tcs.num_witness) == \
        (jcs.num_constraints, jcs.num_instance, jcs.num_witness)
    assert thash == jhash
    assert tcs.full_assignment() == jcs.full_assignment()
    if mode == "prove":
        assert tcs.is_satisfied() == jcs.is_satisfied()
    assert tret == jret
    return tcs, tret, thash

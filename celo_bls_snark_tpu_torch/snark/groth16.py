"""Groth16 zkSNARK over a pairing engine (host reference implementation).

Mirrors ark-groth16 as consumed by the reference
(crates/epoch-snark/src/api/{setup,prover,verifier}.rs):
  - generate_parameters (the `generate_random_parameters` entry)
  - create_proof_no_zk (r = s = 0, prover.rs:78)
  - prepare/verify_proof

QAP reduction follows the libsnark/arkworks convention: the evaluation
domain has size >= num_constraints + num_instance, with the instance
variables pinned into the A-polynomials at the extra rows (input
consistency). The prover's hot path (3 MSMs + 4 FFTs + coset division) is
the workload the sharded device MSM/NTT kernels accelerate (ops/msm.py,
ops/ntt.py); this module is the semantics oracle and the small-circuit
path.
"""

from dataclasses import dataclass

from ..hostmath.params import R as BLS_FR
from ..hostmath import curves as hcurves
from ..hostmath import pairing as hpairing
from ..hostmath.params import G1_GENERATOR, G2_GENERATOR


class Engine:
    """A pairing engine: scalar field + G1/G2 + pairing product check."""

    def __init__(self, name, fr, g1, g2, g1_gen, g2_gen, pairing_check, two_adicity, fr_generator):
        self.name = name
        self.fr = fr
        self.g1 = g1
        self.g2 = g2
        self.g1_gen = g1_gen
        self.g2_gen = g2_gen
        self.pairing_check = pairing_check
        self.two_adicity = two_adicity
        self.fr_generator = fr_generator  # multiplicative generator of Fr*


def _find_fr_generator(r, two_adicity):
    """Smallest multiplicative-generator candidate for root-of-unity
    derivation: need an element of exact 2-adic order 2^two_adicity."""
    t = (r - 1) >> two_adicity
    g = 2
    while True:
        y = pow(g, t, r)
        if pow(y, 1 << (two_adicity - 1), r) != 1:
            return g
        g += 1


BLS12_377_ENGINE = Engine(
    "bls12_377",
    BLS_FR,
    hcurves.G1,
    hcurves.G2,
    G1_GENERATOR,
    G2_GENERATOR,
    hpairing.pairing_check,
    47,
    _find_fr_generator(BLS_FR, 47),
)


# --------------------------------------------------------------------------
# FFT over Fr
# --------------------------------------------------------------------------

def _root_of_unity(engine, n):
    assert n & (n - 1) == 0
    r = engine.fr
    k = n.bit_length() - 1
    assert k <= engine.two_adicity
    base = pow(engine.fr_generator, (r - 1) >> engine.two_adicity, r)
    return pow(base, 1 << (engine.two_adicity - k), r)


def fft(vals, omega, r):
    """In-place iterative radix-2 NTT (host oracle for ops/ntt.py)."""
    n = len(vals)
    if n == 1:
        return list(vals)
    vals = list(vals)
    # bit reversal
    j = 0
    for i in range(1, n):
        bit = n >> 1
        while j & bit:
            j ^= bit
            bit >>= 1
        j |= bit
        if i < j:
            vals[i], vals[j] = vals[j], vals[i]
    length = 2
    while length <= n:
        wlen = pow(omega, n // length, r)
        for i in range(0, n, length):
            w = 1
            for k in range(i, i + length // 2):
                u = vals[k]
                v = vals[k + length // 2] * w % r
                vals[k] = (u + v) % r
                vals[k + length // 2] = (u - v) % r
                w = w * wlen % r
        length <<= 1
    return vals


def ifft(vals, omega, r):
    n = len(vals)
    inv_n = pow(n, -1, r)
    out = fft(vals, pow(omega, -1, r), r)
    return [x * inv_n % r for x in out]


# --------------------------------------------------------------------------
# Parameters
# --------------------------------------------------------------------------

@dataclass
class VerifyingKey:
    alpha_g1: tuple
    beta_g2: tuple
    gamma_g2: tuple
    delta_g2: tuple
    gamma_abc_g1: list


@dataclass
class ProvingKey:
    vk: VerifyingKey
    beta_g1: tuple
    delta_g1: tuple
    a_query: list       # u_i(tau) * G1, all variables
    b_g1_query: list    # v_i(tau) * G1
    b_g2_query: list    # v_i(tau) * G2
    h_query: list       # tau^i * t(tau)/delta * G1
    l_query: list       # (beta u_i + alpha v_i + w_i)/delta * G1, witness i


@dataclass
class Proof:
    a: tuple  # G1 affine
    b: tuple  # G2 affine
    c: tuple  # G1 affine


def _batch_inverse(vals, r):
    """Montgomery batch inversion: one modular inverse + 3(n-1) mulmods."""
    n = len(vals)
    prefix = [0] * n
    acc = 1
    for i, v in enumerate(vals):
        prefix[i] = acc
        acc = acc * v % r
    inv = pow(acc, -1, r)
    out = [0] * n
    for i in range(n - 1, -1, -1):
        out[i] = inv * prefix[i] % r
        inv = inv * vals[i] % r
    return out


def _qap_evals_at_tau(cs, tau, engine):
    """Evaluate the QAP polynomials u_i, v_i, w_i at tau.

    Returns (u, v, w, t_at_tau, domain_size). Instance variables are pinned
    into A at rows [nc, nc+ni) per the libsnark reduction. Lagrange
    denominators invert in one batch; the matrix accumulation runs over the
    cached CSR export (r1cs.to_csr)."""
    import numpy as np

    r = engine.fr
    nc = cs.num_constraints
    ni = cs.num_instance
    d = 1
    while d < nc + ni:
        d <<= 1
    omega = _root_of_unity(engine, d)
    # Lagrange coefficients at tau over the radix-2 domain:
    # L_j(tau) = (omega^j / d) * (tau^d - 1) / (tau - omega^j)
    t_at_tau = (pow(tau, d, r) - 1) % r
    pows = [0] * d
    wj = 1
    for j in range(d):
        pows[j] = wj
        wj = wj * omega % r
    denom_inv = _batch_inverse([(tau - w) % r for w in pows], r)
    dinv = pow(d, -1, r)
    scale = t_at_tau * dinv % r
    lag = np.asarray(
        [scale * w % r * di % r for w, di in zip(pows, denom_inv)],
        dtype=object,
    )
    nvars = ni + cs.num_witness
    uvw = []
    for mat in cs.to_csr():
        indptr, cols, coeffs = mat
        acc = np.zeros(nvars, dtype=object)
        if len(cols):
            rows = np.repeat(np.arange(nc, dtype=np.int64), np.diff(indptr))
            np.add.at(acc, cols, coeffs * lag[rows])
        uvw.append(acc % r)
    u, v, w = uvw
    for i in range(ni):
        u[i] = (u[i] + lag[nc + i]) % r
    return list(u), list(v), list(w), t_at_tau, d


def generate_parameters(cs, engine, rng, accel=None):
    """Trusted setup (ark generate_random_parameters semantics). `cs` must be
    a setup-mode-synthesized ConstraintSystem over engine.fr. With `accel`
    (snark/accel.py DeviceAccel) the generator multiples run as device
    fixed-base batch kernels."""
    r = engine.fr

    def fr_rand():
        while True:
            v = rng.gen_u64() | (rng.gen_u64() << 64) | (rng.gen_u64() << 128) | (rng.gen_u64() << 192)
            v &= (1 << (r.bit_length())) - 1
            if 0 < v < r:
                return v

    from ..utils.profiling import stage

    alpha, beta, gamma, delta, tau = (fr_rand() for _ in range(5))
    with stage("setup.qap_evals_at_tau"):
        u, v, w, t_at_tau, d = _qap_evals_at_tau(cs, tau, engine)
    ni = cs.num_instance
    g1, g2 = engine.g1, engine.g2
    G1g, G2g = engine.g1_gen, engine.g2_gen
    ginv = pow(gamma, -1, r)
    dinv = pow(delta, -1, r)

    nvars = len(u)
    if accel is not None:
        # device fixed-base batches: one kernel run per query array
        def g1batch(ks):
            return accel.g1.fixed_base_batch([k % r for k in ks])

        def g2batch(ks):
            return accel.g2.fixed_base_batch([k % r for k in ks])

        abc = [(beta * u[i] + alpha * v[i] + w[i]) % r for i in range(nvars)]
        singles = g1batch([alpha, beta, delta])
        alpha_g1, beta_g1, delta_g1 = singles
        beta_g2, gamma_g2, delta_g2 = g2batch([beta, gamma, delta])
        # powers of tau for the h query
        taus = []
        acc = t_at_tau * dinv % r
        for _ in range(d - 1):
            taus.append(acc)
            acc = acc * tau % r
        with stage("setup.fb_gamma_abc"):
            gamma_abc = g1batch([abc[i] * ginv for i in range(ni)])
        vk = VerifyingKey(
            alpha_g1=alpha_g1,
            beta_g2=beta_g2,
            gamma_g2=gamma_g2,
            delta_g2=delta_g2,
            gamma_abc_g1=gamma_abc,
        )
        with stage("setup.fb_a_query"):
            a_query = g1batch(u)
        with stage("setup.fb_b_g1_query"):
            b_g1_query = g1batch(v)
        with stage("setup.fb_b_g2_query"):
            b_g2_query = g2batch(v)
        with stage("setup.fb_h_query"):
            h_query = g1batch(taus)
        with stage("setup.fb_l_query"):
            l_query = g1batch([abc[i] * dinv for i in range(ni, nvars)])
        return ProvingKey(
            vk=vk,
            beta_g1=beta_g1,
            delta_g1=delta_g1,
            a_query=a_query,
            b_g1_query=b_g1_query,
            b_g2_query=b_g2_query,
            h_query=h_query,
            l_query=l_query,
        )

    # fixed-base window tables: the setup is thousands of generator multiples
    t1 = g1.fixed_base_table(G1g, nbits=r.bit_length())
    t2 = g2.fixed_base_table(G2g, nbits=r.bit_length())

    def g1mul(k):
        return g1.fixed_base_mul(t1, k % r)

    def g2mul(k):
        return g2.fixed_base_mul(t2, k % r)

    vk = VerifyingKey(
        alpha_g1=g1mul(alpha),
        beta_g2=g2mul(beta),
        gamma_g2=g2mul(gamma),
        delta_g2=g2mul(delta),
        gamma_abc_g1=[
            g1mul((beta * u[i] + alpha * v[i] + w[i]) * ginv) for i in range(ni)
        ],
    )
    pk = ProvingKey(
        vk=vk,
        beta_g1=g1mul(beta),
        delta_g1=g1mul(delta),
        a_query=[g1mul(u[i]) for i in range(nvars)],
        b_g1_query=[g1mul(v[i]) for i in range(nvars)],
        b_g2_query=[g2mul(v[i]) for i in range(nvars)],
        h_query=[g1mul(pow(tau, i, r) * t_at_tau % r * dinv) for i in range(d - 1)],
        l_query=[
            g1mul((beta * u[i] + alpha * v[i] + w[i]) * dinv)
            for i in range(ni, nvars)
        ],
    )
    return pk


def _compute_h(cs, engine, accel=None, evals=None):
    """h(X) = (A(X) B(X) - C(X)) / t(X) coefficients, via coset FFTs
    (on device when `accel` is given). `evals` takes the precomputed
    (A@z, B@z, C@z) object arrays from cs.evaluate_abc() so the prover's
    satisfaction check and QAP evaluation share one matrix pass."""
    import numpy as np

    r = engine.fr
    nc = cs.num_constraints
    ni = cs.num_instance
    d = 1
    while d < nc + ni:
        d <<= 1
    omega = _root_of_unity(engine, d)
    if evals is None:
        evals = cs.evaluate_abc()
    a_e, b_e, c_e = evals
    a_evals = np.zeros(d, dtype=object)
    b_evals = np.zeros(d, dtype=object)
    c_evals = np.zeros(d, dtype=object)
    a_evals[:nc] = a_e
    b_evals[:nc] = b_e
    c_evals[:nc] = c_e
    a_evals[nc : nc + ni] = cs.instance_assignment
    a_evals, b_evals, c_evals = list(a_evals), list(b_evals), list(c_evals)
    if accel is not None:
        return accel.compute_h_evals(
            a_evals, b_evals, c_evals, d, engine.fr_generator
        )
    a_coeffs = ifft(a_evals, omega, r)
    b_coeffs = ifft(b_evals, omega, r)
    c_coeffs = ifft(c_evals, omega, r)
    # evaluate on the coset g*H
    g = engine.fr_generator
    def coset_fft(coeffs):
        scaled = [c * pow(g, i, r) % r for i, c in enumerate(coeffs)]
        return fft(scaled, omega, r)
    a_c = coset_fft(a_coeffs)
    b_c = coset_fft(b_coeffs)
    c_c = coset_fft(c_coeffs)
    # t on coset: t(gx) = g^d x^d - 1 is constant g^d - 1 on |x|=domain
    t_c_inv = pow((pow(g, d, r) - 1) % r, -1, r)
    h_c = [(a * b - c) % r * t_c_inv % r for a, b, c in zip(a_c, b_c, c_c)]
    # back to coefficients, unscale by coset
    h_scaled = ifft(h_c, omega, r)
    ginv = pow(g, -1, r)
    h_coeffs = [c * pow(ginv, i, r) % r for i, c in enumerate(h_scaled)]
    # degree d-2
    return h_coeffs[: d - 1]


def create_proof_no_zk(pk: ProvingKey, cs, engine, accel=None, evals=None) -> Proof:
    """Prover with r = s = 0 (the reference's create_proof_no_zk,
    crates/epoch-snark/src/api/prover.rs:78). With `accel`, the 4 MSMs and
    the h-polynomial coset NTTs run on device — the stage the reference
    parallelizes with rayon inside ark-groth16 (SURVEY.md section 2.5).
    `evals` forwards precomputed cs.evaluate_abc() output (shared with the
    caller's satisfaction check). The proving-key query bases are cached
    device-resident across calls (keyed by pk identity)."""
    from ..utils.profiling import stage

    r = engine.fr
    g1, g2 = engine.g1, engine.g2
    z = cs.full_assignment()
    ni = cs.num_instance
    with stage("prover.h_poly"):
        h = _compute_h(cs, engine, accel, evals=evals)

    if accel is not None:
        from ..ops.msm import RawScalarVec

        pkid = id(pk)

        def _norm(scalars):
            # RawScalarVec (device h output) is canonical by construction
            if isinstance(scalars, RawScalarVec):
                return scalars
            return [s % r for s in scalars]

        def msm_g1(bases, scalars, which):
            return accel.g1.msm(bases, _norm(scalars), cache_key=(pkid, which))

        def msm_g2(bases, scalars, which):
            return accel.g2.msm(bases, _norm(scalars), cache_key=(pkid, which))
    else:
        def msm_g1(bases, scalars, which):
            return g1.msm([s % r for s in scalars], list(bases))

        def msm_g2(bases, scalars, which):
            return g2.msm([s % r for s in scalars], list(bases))

    with stage("prover.msm_a"):
        a = g1.add(pk.vk.alpha_g1, msm_g1(pk.a_query, z, "a"))
    with stage("prover.msm_b_g2"):
        b_g2 = g2.add(pk.vk.beta_g2, msm_g2(pk.b_g2_query, z, "b_g2"))
    with stage("prover.msm_l"):
        c1 = msm_g1(pk.l_query, z[ni:], "l")
    with stage("prover.msm_h"):
        c2 = msm_g1(pk.h_query, h, "h")
    c = g1.add(c1, c2)
    return Proof(a=a, b=b_g2, c=c)


def verify_proof(vk: VerifyingKey, proof: Proof, public_inputs, engine) -> bool:
    """e(A, B) == e(alpha, beta) e(sum x_i gamma_abc_i, gamma) e(C, delta).

    public_inputs excludes the leading ONE."""
    r = engine.fr
    g1 = engine.g1
    assert len(public_inputs) == len(vk.gamma_abc_g1) - 1
    acc = vk.gamma_abc_g1[0]
    for x, base in zip(public_inputs, vk.gamma_abc_g1[1:]):
        acc = g1.add(acc, g1.mul(x % r, base) if x % r else None)
    return engine.pairing_check(
        [
            (g1.neg(proof.a), proof.b),
            (vk.alpha_g1, vk.beta_g2),
            (acc, vk.gamma_g2),
            (proof.c, vk.delta_g2),
        ]
    )

"""The flagship verification step at a small size (the counterpart of the
JAX package's __graft_entry__.py::entry): BDN18 aggregate-signature batch
verification, an (n+1)-pairing product check; and its multi-rank dry run
(dryrun_multichip).

    fn, args = entry()          # on the card
    ok = fn(*args)              # bool tensor [1]
    dryrun_multichip(mesh)      # on every rank of parallel/distributed.py's mesh
"""

import random
import time

from .hash_to_curve import composite_hash_to_g1_cip22
from .hostmath import curves as hc
from .hostmath.params import G1_GENERATOR, R
from .keys import SIG_DOMAIN, PrivateKey, PublicKey
from .ops import bls as dbls
from .ops import curve as dc
from .ops import pairing as dp
from .ops import tower as tw
from .utils.devices import require_device
from .utils.rngs import XorShiftRng


def example_inputs(n_messages=8, n_validators=4, device="cuda"):
    """A committee of `n_validators` signing `n_messages` CIP22-hashed
    messages: (sig_jac, hashes_aff, apk_aff) on `device`."""
    device = require_device(device)
    rng = XorShiftRng(b"graft-entry-seed")
    h2c = composite_hash_to_g1_cip22()
    sks = [PrivateKey.generate(rng) for _ in range(n_validators)]
    apk = PublicKey.aggregate([sk.to_public() for sk in sks])
    sk_sum = sum(sk.sk for sk in sks) % R
    hashes, sigs = [], []
    for i in range(n_messages):
        h = h2c.hash(SIG_DOMAIN, b"entry block %d" % i, b"")
        hashes.append(h)
        sigs.append(hc.G1.mul(sk_sum, h))
    sig_jac = dc.g1_pack(sigs, device)
    hashes_aff = dbls.pack_g1_affine(hashes, device)
    apk_aff = dbls.pack_g2_affine([apk.pt] * n_messages, device)
    return sig_jac, hashes_aff, apk_aff


def verify_stages(sig_jac, hashes_aff, apk_aff):
    """The verification with its intermediates: a dict with `final_exp`
    (the Fq12 final-exponentiation output) and `ok` (bool tensor [1])."""
    asig_aff = dc.g1.to_affine(dc.g1.msum(sig_jac))
    negg2 = dbls.neg_g2_gen_affine(asig_aff[0].device)
    f = dp.miller_loop_batch(dbls.cat_lanes(asig_aff, hashes_aff),
                             dbls.cat_lanes(negg2, apk_aff))
    e = dp.final_exponentiation(dp.f12_product(f))
    return {"final_exp": e, "ok": tw.f12_is_one(e)}


def verify(sig_jac, hashes_aff, apk_aff):
    return verify_stages(sig_jac, hashes_aff, apk_aff)["ok"]


def host_h_poly(engine, a_e, b_e, c_e, d, g):
    """The h coefficients [0, d-1) of the Groth16 coset pipeline, in host
    python ints (snark/groth16.py fft/ifft)."""
    from .snark.groth16 import _root_of_unity, fft, ifft

    r = engine.fr
    omega = _root_of_unity(engine, d)
    gpow, gipow = [1] * d, [1] * d
    ginv = pow(g, -1, r)
    for i in range(1, d):
        gpow[i] = gpow[i - 1] * g % r
        gipow[i] = gipow[i - 1] * ginv % r
    ac, bc, cc = (fft([c * s % r for c, s in zip(ifft(e, omega, r), gpow)], omega, r)
                  for e in (a_e, b_e, c_e))
    tinv = pow((pow(g, d, r) - 1) % r, -1, r)
    hs = ifft([(x * y - z) % r * tinv % r for x, y, z in zip(ac, bc, cc)], omega, r)
    return [c * s % r for c, s in zip(hs, gipow)][: d - 1]


def dryrun_multichip(mesh) -> None:
    """The verification and prover steps sharded over `mesh`, at the JAX
    package's dry-run shapes (__graft_entry__.py::dryrun_multichip), each
    against a host oracle. Every rank of the mesh calls it with the same
    seeds, so every rank holds the same global inputs:

      - the sharded (n+1)-pairing check: sharded signature sum, then
        data-parallel Miller loops with a cross-rank Fq12 product;
      - the dense sharded MSM (2D points);
      - the sharded Pippenger MSM, 256D - 3 points (an uneven tail), c = 6,
        L = 64;
      - the four-step NTT round trip over BW6-Fr, N = max(1024, 16 D^2);
      - the prover's h-polynomial at 2^13 and its MSM at 2^11 through
        DeviceAccel("bls12_377").set_mesh(mesh) (sharded when D > 1)."""
    from .ops.field import FQ
    from .ops import ntt as dntt
    from .parallel import mesh as pmesh
    from .snark.accel import DeviceAccel
    from .snark.groth16 import BLS12_377_ENGINE

    dev, D = mesh.device, mesh.size
    t0 = time.monotonic()

    def progress(name):
        print(f"[dryrun rank {mesh.rank}/{D} {time.monotonic() - t0:7.1f}s] {name}",
              flush=True)

    progress("sharded (n+1)-pairing verification")
    B = 2 * D - 1  # with the signature leg: 2 pairing legs a rank
    sig_jac, hashes_aff, apk_aff = example_inputs(B, 2, dev)
    # pad the signature batch with one infinity so it shards evenly
    sig_jac = dbls.cat_lanes(sig_jac, dc.g1_pack([None], dev))
    asig_aff = dc.g1.to_affine(pmesh.sharded_msum_g1(mesh, sig_jac))
    p_all = dbls.cat_lanes(asig_aff, hashes_aff)
    q_all = dbls.cat_lanes(dbls.neg_g2_gen_affine(dev), apk_aff)
    assert bool(pmesh.sharded_pairing_check(mesh, p_all, q_all)[0]), \
        "sharded verification returned False"

    progress("sharded dense MSM")
    rnd = random.Random(7)
    pts = [hc.G1.mul(rnd.randrange(1, R), G1_GENERATOR) for _ in range(2 * D)]
    scalars = [rnd.randrange(R) for _ in range(2 * D)]
    out = pmesh.sharded_msm_g1(mesh, dbls.scalars_to_bits(scalars, dev),
                               dc.g1_pack(pts, dev))
    want = hc.G1.msum([hc.G1.mul(s, p) for s, p in zip(scalars, pts)])
    assert dc.g1_unpack(out)[0] == want, "sharded dense MSM mismatch"

    progress("sharded Pippenger MSM")
    pts = chain_points(hc.G1, G1_GENERATOR, 5, 256 * D - 3)
    scalars = [rnd.randrange(R) for _ in pts]
    got = pmesh.sharded_msm_pippenger(mesh, pts, scalars, c=6, L=64)
    assert got == hc.G1.msm(scalars, pts, c=8), "sharded Pippenger MSM mismatch"

    progress("sharded four-step NTT over BW6-Fr")
    N = max(1024, 16 * D * D)
    vals = [rnd.randrange(FQ.modulus) for _ in range(N)]
    fwd = pmesh.sharded_ntt(mesh, FQ.pack(vals, dev), dntt.ntt_bw6)
    back = pmesh.sharded_ntt(mesh, fwd, dntt.ntt_bw6, inverse=True)
    assert FQ.unpack(back) == vals, "sharded NTT round trip mismatch"

    progress("prover h-polynomial (2^13) and MSM (2^11) through set_mesh")
    accel = DeviceAccel("bls12_377", dev)
    accel.set_mesh(mesh)
    try:
        d_h, gen = 1 << 13, BLS12_377_ENGINE.fr_generator
        evals = [[rnd.randrange(R) for _ in range(d_h)] for _ in range(3)]
        h = accel.compute_h_evals(*evals, d_h, gen)
        pts = chain_points(hc.G1, G1_GENERATOR, 3, 1 << 11, step=2)
        scalars = [rnd.randrange(R) for _ in pts]
        got = accel.g1.msm(pts, scalars, c=6, L=64)
    finally:
        accel.set_mesh(None)
    assert h == host_h_poly(BLS12_377_ENGINE, *evals, d_h, gen), \
        "mesh-routed h-polynomial != host oracle"
    assert got == hc.G1.msm(scalars, pts, c=8), "mesh-routed MSM != host oracle"
    progress("done")


def chain_points(host_curve, gen, a, n, step=1):
    """[(a + step i) gen for i < n]: one host multiplication for the first
    point and the step, then n - 1 affine chain adds."""
    pts = [host_curve.mul(a, gen)]
    inc = host_curve.mul(step, gen)
    for _ in range(n - 1):
        pts.append(host_curve.add(pts[-1], inc))
    return pts


def entry(device="cuda"):
    """Returns (fn, example_args): the flagship verification step."""
    return verify, example_inputs(device=device)


if __name__ == "__main__":
    fn, args = entry()
    print("entry ok:", bool(fn(*args)[0]))

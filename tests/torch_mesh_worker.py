"""One rank of a multi-process CPU job over the port's mesh
(celo_bls_snark_tpu_torch/parallel/), for tests/test_torch_parallel.py.

Every rank builds the same global inputs from one numpy seed (`inputs`),
joins the job through the port's own init_distributed (gloo, a file://
store) and global_mesh, runs every sharded function of parallel/mesh.py
and the mesh-routed DeviceAccel, and writes what it got to
<out_dir>/rank<r>.pkl. The test compares the ranks' results with each
other, with the host oracles, with the port on one rank and with the JAX
package. Imports no JAX.

Usage: python tests/torch_mesh_worker.py <rank> <world_size> <store_dir> <out_dir> <job>
  job: "full" (every function) or "small" (the NTT and msum only)
"""

import os
import pickle
import sys

# the repo root, so the package imports when run as a bare script
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from celo_bls_snark_tpu_torch.hostmath import curves as hc  # noqa: E402
from celo_bls_snark_tpu_torch.hostmath.params import (  # noqa: E402
    G1_GENERATOR, G2_GENERATOR, P, R,
)

SEED = 20261017
N_NTT = 1 << 8      # BLS12-377 Fr
N_NTT_BW6 = 64      # BW6-761 Fr
D_H = 1 << 8        # the h-polynomial's domain
B_PIP = 199         # an uneven last shard
B_ROUTED = 64       # the accelerator's MSM (>= 4 points a rank)
NBITS_SHORT = 32    # the dense and Pippenger MSMs' scalars: 8 windows of 4 bits


def _ints(rng, n, modulus):
    return [int.from_bytes(rng.bytes(64), "little") % modulus for _ in range(n)]


def inputs():
    """The job's global inputs, the same on every rank and in the test."""
    rng = np.random.default_rng(SEED)
    ks = _ints(rng, 16, R)
    pip_ks = _ints(rng, B_PIP, R)
    pip_sc = _ints(rng, B_PIP - 2, 1 << NBITS_SHORT) + [0, 1]
    a = _ints(rng, 2, R)
    return {
        "msum_pts": [hc.G1.mul(k, G1_GENERATOR) for k in ks],
        "msum_g2_pts": [hc.G2.mul(k, G2_GENERATOR) for k in ks[:4]],
        "dense_scalars": _ints(rng, 8, 1 << NBITS_SHORT),
        "pip_pts": [hc.G1.mul(k, G1_GENERATOR) for k in pip_ks],
        "pip_scalars": pip_sc,
        # e(aP, Q) e(-aP, Q) e(bP, Q) e(-bP, Q) == 1
        "pair_p": [hc.G1.mul(a[0], G1_GENERATOR), hc.G1.mul(R - a[0], G1_GENERATOR),
                   hc.G1.mul(a[1], G1_GENERATOR), hc.G1.mul(R - a[1], G1_GENERATOR)],
        "pair_q": [G2_GENERATOR] * 4,
        "ntt_fr": _ints(rng, N_NTT, R),
        "ntt_bw6": _ints(rng, N_NTT_BW6, P),
        "h_evals": [_ints(rng, D_H, R) for _ in range(3)],
        "routed_scalars": _ints(rng, B_ROUTED, R),
    }


def run_full(mesh, x, out):
    from celo_bls_snark_tpu_torch.ops import bls as dbls
    from celo_bls_snark_tpu_torch.ops import curve as dc
    from celo_bls_snark_tpu_torch.ops import msm as dmsm
    from celo_bls_snark_tpu_torch.ops import ntt as dntt
    from celo_bls_snark_tpu_torch.ops import pairing as dp
    from celo_bls_snark_tpu_torch.ops import tower as tw
    from celo_bls_snark_tpu_torch.ops.field import FQ, FR
    from celo_bls_snark_tpu_torch.parallel import mesh as pmesh
    from celo_bls_snark_tpu_torch.snark.accel import DeviceAccel
    from celo_bls_snark_tpu_torch.snark.groth16 import BLS12_377_ENGINE
    from celo_bls_snark_tpu_torch.utils import profiling
    from celo_bls_snark_tpu_torch.utils.tree import tree_leaves

    dev = mesh.device
    out["msum_g2"] = dc.g2_unpack(pmesh.sharded_msum_g2(
        mesh, dc.g2_pack(x["msum_g2_pts"], dev)))[0]
    pts = x["msum_pts"][:8]
    bits = dbls.scalars_to_bits(x["dense_scalars"], dev, NBITS_SHORT)
    out["msm_g1"] = dc.g1_unpack(pmesh.sharded_msm_g1(mesh, bits, dc.g1_pack(pts, dev)))[0]
    out["pippenger"] = pmesh.sharded_msm_pippenger(
        mesh, x["pip_pts"], x["pip_scalars"], c=4, L=4, nbits=NBITS_SHORT)
    # the same MSM from a PointVec and a RawScalarVec (no python ints)
    pv = dc.PointVec([FQ.pack_raw([0 if p is None else p[i] for p in x["pip_pts"]],
                                  "cpu").numpy() for i in (0, 1)], FQ, (0, 0))
    raw = dmsm.RawScalarVec(FR.pack_raw(x["pip_scalars"], "cpu").numpy(), FR)
    out["pippenger_raw"] = pmesh.sharded_msm_pippenger(
        mesh, pv, raw, c=4, L=4, nbits=NBITS_SHORT, cache_key="worker-bases")
    p_aff = dbls.pack_g1_affine(x["pair_p"], dev)
    q_aff = dbls.pack_g2_affine(x["pair_q"], dev)
    f = pmesh.sharded_miller_product(mesh, p_aff, q_aff)
    out["miller_product"] = [l.numpy() for l in tree_leaves(f)]
    out["pairing"] = bool(tw.f12_is_one(dp.final_exponentiation(f))[0])
    bad = dbls.pack_g1_affine([x["pair_p"][1]] + x["pair_p"][1:], dev)
    out["pairing_tampered"] = bool(pmesh.sharded_pairing_check(mesh, bad, q_aff)[0])
    fwd = pmesh.sharded_ntt(mesh, FQ.pack(x["ntt_bw6"], dev), dntt.ntt_bw6)
    out["ntt_bw6"] = fwd.numpy()
    out["ntt_bw6_back"] = FQ.unpack(pmesh.sharded_ntt(mesh, fwd, dntt.ntt_bw6, inverse=True))

    # the accelerator through set_mesh: counted calls and the stages timed
    # show the route taken
    calls = {"msm": 0}
    sharded = pmesh.sharded_msm_pippenger

    def counting(*a, **k):
        calls["msm"] += 1
        return sharded(*a, **k)

    pmesh.sharded_msm_pippenger = counting
    accel = DeviceAccel("bls12_377", dev)
    accel.set_mesh(mesh)
    try:
        profiling.reset()
        out["h_poly"] = accel.compute_h_evals(
            *x["h_evals"], D_H, BLS12_377_ENGINE.fr_generator).limbs
        out["h_poly_stages"] = sorted(profiling.report())
        pts = x["pip_pts"][:B_ROUTED]
        out["routed_msm"] = accel.g1.msm(pts, x["routed_scalars"], c=8, L=8)
        out["routed_msm_sharded_calls"] = calls["msm"]
    finally:
        accel.set_mesh(None)
        pmesh.sharded_msm_pippenger = sharded
    profiling.reset()
    out["h_poly_single"] = accel.compute_h_evals(
        *x["h_evals"], D_H, BLS12_377_ENGINE.fr_generator).limbs
    out["h_poly_single_stages"] = sorted(profiling.report())


def main():
    rank, world, store, out_dir, job = sys.argv[1:6]
    rank, world = int(rank), int(world)
    torch.set_num_threads(1)

    from celo_bls_snark_tpu_torch.ops import curve as dc
    from celo_bls_snark_tpu_torch.ops import ntt as dntt
    from celo_bls_snark_tpu_torch.ops.field import FR
    from celo_bls_snark_tpu_torch.parallel import distributed as pdist
    from celo_bls_snark_tpu_torch.parallel import mesh as pmesh

    dev = pdist.init_distributed(f"file://{store}", world, rank, device="cpu")
    try:
        assert pdist.process_count() == world
        assert pdist.is_coordinator() == (rank == 0)
        mesh = pdist.global_mesh()
        assert (mesh.rank, mesh.size, mesh.device, dev) == \
            (rank, world, torch.device("cpu"), torch.device("cpu")), mesh
        x = inputs()
        out = {}
        out["msum_g1"] = dc.g1_unpack(pmesh.sharded_msum_g1(
            mesh, dc.g1_pack(x["msum_pts"], dev)))[0]
        fwd = pmesh.sharded_ntt(mesh, FR.pack(x["ntt_fr"], dev), dntt.ntt_fr)
        out["ntt_fr"] = fwd.numpy()
        out["ntt_fr_back"] = FR.unpack(
            pmesh.sharded_ntt(mesh, fwd, dntt.ntt_fr, inverse=True))
        if job == "full":
            run_full(mesh, x, out)
    finally:
        pdist.shutdown()
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)
    print(f"TORCH_MESH_WORKER_OK rank={rank}", flush=True)


if __name__ == "__main__":
    main()

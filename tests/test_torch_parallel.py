"""The port's mesh (celo_bls_snark_tpu_torch/parallel/) on the CPU: real
multi-process jobs over gloo through the port's own init_distributed and
global_mesh (tests/torch_mesh_worker.py: one 2-rank job over every
function, one 4-rank job over the NTT and msum), each result held against
the hostmath oracle, the port on one rank and, for the four-step NTT and
the h-polynomial, the JAX package's parallel/mesh.py on 2 of the test
process's virtual CPU devices. The mesh-routed DeviceAccel, set_mesh's
checks and the bring-up's single-process cases run in this process.
Integer work: the tolerance is 0."""

import os
import pickle
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_mesh_worker as W
from celo_bls_snark_tpu.ops import ntt as jntt
from celo_bls_snark_tpu.ops.field import FR as JFR
from celo_bls_snark_tpu.parallel import mesh as jmesh
from celo_bls_snark_tpu_torch.entry import host_h_poly
from celo_bls_snark_tpu_torch.hostmath import curves as hc
from celo_bls_snark_tpu_torch.hostmath.params import G1_GENERATOR, R
from celo_bls_snark_tpu_torch.ops import bls as dbls
from celo_bls_snark_tpu_torch.ops import curve as dc
from celo_bls_snark_tpu_torch.ops import msm as dmsm
from celo_bls_snark_tpu_torch.ops import ntt as dntt
from celo_bls_snark_tpu_torch.ops import pairing as dp
from celo_bls_snark_tpu_torch.ops.field import FQ, FR
from celo_bls_snark_tpu_torch.parallel import distributed as pdist
from celo_bls_snark_tpu_torch.parallel import mesh as pmesh
from celo_bls_snark_tpu_torch.snark import accel as taccel
from celo_bls_snark_tpu_torch.snark.groth16 import BLS12_377_ENGINE, _root_of_unity, fft
from celo_bls_snark_tpu_torch.utils.tree import tree_leaves
from torch_capture_guard import rehearse_captures

# one thread: the plain versions loop over small tensors, and the test
# suite's parallel workers would otherwise contend for every core
torch.set_num_threads(1)

WORKER = os.path.join(os.path.dirname(os.path.abspath(__file__)), "torch_mesh_worker.py")
REPO = os.path.dirname(os.path.dirname(WORKER))
CPU = torch.device("cpu")


def _spawn(tmp, world, job, timeout=300):
    """Run `world` ranks of the worker; returns each rank's results."""
    out = tmp / "out"
    out.mkdir()
    env = {**os.environ, "OMP_NUM_THREADS": "1"}
    procs = [subprocess.Popen(
        [sys.executable, WORKER, str(r), str(world), str(tmp / "store"), str(out), job],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, cwd=REPO, env=env, text=True)
        for r in range(world)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0 and f"TORCH_MESH_WORKER_OK rank={r}" in log, log[-4000:]
    results = []
    for r in range(world):
        with open(out / f"rank{r}.pkl", "rb") as f:
            results.append(pickle.load(f))
    return results


@pytest.fixture(scope="module")
def x():
    return W.inputs()


@pytest.fixture(scope="module")
def two(tmp_path_factory):
    return _spawn(tmp_path_factory.mktemp("mesh2"), 2, "full")


@pytest.fixture(scope="module")
def four(tmp_path_factory):
    return _spawn(tmp_path_factory.mktemp("mesh4"), 4, "small")


@pytest.fixture(scope="module")
def one():
    """The port on one rank: a mesh without a process group."""
    return pmesh.make_mesh(None, "cpu")


def _same_on_every_rank(results, key):
    for res in results[1:]:
        a, b = results[0][key], res[key]
        if isinstance(a, np.ndarray):
            np.testing.assert_array_equal(a, b)
        else:
            assert a == b, key
    return results[0][key]


# --- sums and MSMs -------------------------------------------------------------

@pytest.mark.parametrize("world", [2, 4])
def test_sharded_msum_g1(world, two, four, one, x):
    got = _same_on_every_rank(two if world == 2 else four, "msum_g1")
    assert got == hc.G1.msum(x["msum_pts"])
    assert got == dc.g1_unpack(pmesh.sharded_msum_g1(one, dc.g1_pack(x["msum_pts"], CPU)))[0]


def test_sharded_msum_g2(two, one, x):
    got = _same_on_every_rank(two, "msum_g2")
    assert got == hc.G2.msum(x["msum_g2_pts"])
    assert got == dc.g2_unpack(pmesh.sharded_msum_g2(one, dc.g2_pack(x["msum_g2_pts"], CPU)))[0]


def test_sharded_msm_g1(two, one, x):
    got = _same_on_every_rank(two, "msm_g1")
    pts, sc = x["msum_pts"][:8], x["dense_scalars"]
    assert got == hc.G1.msum([hc.G1.mul(s, p) for s, p in zip(sc, pts)])
    bits = dbls.scalars_to_bits(sc, CPU, W.NBITS_SHORT)
    assert got == dc.g1_unpack(pmesh.sharded_msm_g1(one, bits, dc.g1_pack(pts, CPU)))[0]


def test_sharded_msm_pippenger_uneven_tail(two, one, x):
    """199 points over 2 ranks (100 + 99 and a pad), c = 4, L = 4, the
    scalars ending in 0 and 1; the same from a PointVec and a RawScalarVec."""
    got = _same_on_every_rank(two, "pippenger")
    pts, sc = x["pip_pts"], x["pip_scalars"]
    assert sc[-2:] == [0, 1]
    assert got == hc.G1.msm(sc, pts, c=8)
    assert _same_on_every_rank(two, "pippenger_raw") == got
    assert got == pmesh.sharded_msm_pippenger(one, pts, sc, c=4, L=4, nbits=W.NBITS_SHORT)


# --- pairing ----------------------------------------------------------------------

def test_sharded_pairing_check(two, x):
    """4 pairs with a product of 1: True; the first P replaced: False. The
    2-rank Miller product equals the one-rank product limb for limb (the
    ranks' partial products fold in the one-rank tree's order)."""
    assert _same_on_every_rank(two, "pairing") is True
    assert _same_on_every_rank(two, "pairing_tampered") is False
    f = dp.f12_product(dp.miller_loop_batch(dbls.pack_g1_affine(x["pair_p"], CPU),
                                            dbls.pack_g2_affine(x["pair_q"], CPU)))
    for a, b in zip(two[0]["miller_product"], tree_leaves(f)):
        np.testing.assert_array_equal(a, b.numpy())


# --- four-step NTT -----------------------------------------------------------------

@pytest.mark.parametrize("world", [2, 4])
def test_sharded_ntt_limb_exact(world, two, four, one, x):
    got = _same_on_every_rank(two if world == 2 else four, "ntt_fr")
    x0 = FR.pack(x["ntt_fr"], CPU)
    np.testing.assert_array_equal(got, pmesh.sharded_ntt(one, x0, dntt.ntt_fr).numpy())
    w = _root_of_unity(BLS12_377_ENGINE, W.N_NTT)
    assert FR.unpack(torch.from_numpy(got)) == fft(x["ntt_fr"], w, R)
    assert FR.unpack(torch.from_numpy(got)) == FR.unpack(dntt.ntt_fr.ntt(x0))
    assert _same_on_every_rank(two if world == 2 else four, "ntt_fr_back") == x["ntt_fr"]


def test_sharded_ntt_equals_jax(two, x):
    jm = jmesh.make_mesh(jax.devices()[:2])
    want = jmesh.sharded_ntt(jm, jnp.asarray(JFR.pack(x["ntt_fr"])), jntt.ntt_fr)
    np.testing.assert_array_equal(two[0]["ntt_fr"], np.asarray(want))


def test_sharded_ntt_bw6(two, one, x):
    got = _same_on_every_rank(two, "ntt_bw6")
    x0 = FQ.pack(x["ntt_bw6"], CPU)
    np.testing.assert_array_equal(got, pmesh.sharded_ntt(one, x0, dntt.ntt_bw6).numpy())
    assert FQ.unpack(torch.from_numpy(got)) == FQ.unpack(dntt.ntt_bw6.ntt(x0))
    assert _same_on_every_rank(two, "ntt_bw6_back") == x["ntt_bw6"]


@pytest.mark.parametrize("ops,spec,inverse", [(dntt.ntt_fr, FR, False),
                                              (dntt.ntt_bw6, FQ, True)])
def test_four_step_twiddles_are_the_host_table(ops, spec, inverse):
    """Gathered from the master table on the device, the limbs of the host
    table of w^(k1 i2) packed value by value."""
    N, N1 = 256, 16
    w = ops.root_fn(N)
    w = pow(w, -1, ops.r) if inverse else w
    host = [pow(w, k1 * i2, ops.r) for k1 in range(N1) for i2 in range(N // N1)]
    got = pmesh._four_step_twiddles(ops, N, N1, inverse, "cpu")
    np.testing.assert_array_equal(got.reshape(spec.n, -1).numpy(), spec.pack(host, CPU).numpy())


def test_four_step_split_checks_the_ranks():
    assert pmesh._four_step_split(1 << 8, 4) == (16, 16)
    assert pmesh._four_step_split(1 << 13, 2) == (64, 128)
    for N, D in ((64, 16), (1 << 8, 3), (1 << 10, 6)):
        with pytest.raises(ValueError):
            pmesh._four_step_split(N, D)
    with pytest.raises(ValueError):
        pmesh.shard_batch(pmesh.Mesh(None, 0, 2, CPU), FR.pack([1, 2, 3], CPU))


# --- the accelerator through set_mesh -------------------------------------------

def test_set_mesh_routes_h_poly_and_msm(two, x):
    """compute_h_evals at 2^8 over 2 ranks equals the one-rank RawScalarVec
    limb for limb and the host pipeline; the MSM took the sharded route
    under the mesh, and after set_mesh(None) the h-polynomial took the
    single-card route again."""
    r0 = _same_on_every_rank(two, "h_poly")
    accel = taccel.DeviceAccel("bls12_377", "cpu")
    g = BLS12_377_ENGINE.fr_generator
    single = accel.compute_h_evals(*x["h_evals"], W.D_H, g)
    np.testing.assert_array_equal(r0, single.limbs)
    assert single.to_ints() == host_h_poly(BLS12_377_ENGINE, *x["h_evals"], W.D_H, g)
    assert "h_poly.sharded" in two[0]["h_poly_stages"]
    assert "h_poly.device" not in two[0]["h_poly_stages"]
    pts, sc = x["pip_pts"][:W.B_ROUTED], x["routed_scalars"]
    want = hc.G1.msm(sc, pts, c=8)
    assert _same_on_every_rank(two, "routed_msm") == want
    assert [t["routed_msm_sharded_calls"] for t in two] == [1, 1]
    np.testing.assert_array_equal(_same_on_every_rank(two, "h_poly_single"), r0)
    assert "h_poly.device" in two[0]["h_poly_single_stages"]
    assert "h_poly.sharded" not in two[0]["h_poly_single_stages"]


def test_sharded_compute_h_equals_jax(two, x):
    """The 2-rank h-polynomial (gathered and re-sharded between transforms)
    limb for limb against the JAX package's on 2 devices; the JAX side
    returns all d coefficients, the accelerator the d - 1 that h has."""
    jm = jmesh.make_mesh(jax.devices()[:2])
    raws = [np.asarray(JFR.pack_raw(e)) for e in x["h_evals"]]
    want = jmesh.sharded_compute_h(jm, jntt.ntt_fr, *raws, W.D_H,
                                   BLS12_377_ENGINE.fr_generator)
    np.testing.assert_array_equal(two[0]["h_poly"], want[:, :W.D_H - 1])


def test_set_mesh_of_one_rank_keeps_the_single_card_route(one, monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("a one-rank mesh took the sharded route")

    monkeypatch.setattr(pmesh, "sharded_msm_pippenger", refuse)
    monkeypatch.setattr(pmesh, "sharded_compute_h", refuse)
    accel = taccel.get_accel("bls12_377", "cpu")
    accel.set_mesh(one)
    try:
        pts = [hc.G1.mul(3 + i, G1_GENERATOR) for i in range(8)]
        assert accel.g1.msm(pts, list(range(8)), c=4, L=2) == \
            hc.G1.msm(list(range(8)), pts, c=4)
        g = BLS12_377_ENGINE.fr_generator
        evals = [[(7 * i + j) % R for i in range(16)] for j in range(3)]
        assert accel.compute_h_evals(*evals, 16, g).to_ints() == \
            host_h_poly(BLS12_377_ENGINE, *evals, 16, g)
    finally:
        accel.set_mesh(None)


def test_set_mesh_checks_the_device_and_warns_when_it_cannot_route():
    accel = taccel.get_accel("bls12_377", "cpu")
    with pytest.raises(ValueError, match="set_mesh"):
        accel.set_mesh(pmesh.Mesh(None, 0, 1, torch.device("cuda", 0)))
    assert accel.mesh is None
    # two ranks but 3 points (< 4 a rank): every rank runs the MSM whole
    accel.set_mesh(pmesh.Mesh(None, 0, 2, CPU))
    try:
        pts = [hc.G1.mul(5 + i, G1_GENERATOR) for i in range(3)]
        with pytest.warns(UserWarning, match="does not shard"):
            got = accel.g1.msm(pts, [1, 2, 3], c=4, L=2)
        assert got == hc.G1.msm([1, 2, 3], pts, c=4)
    finally:
        accel.set_mesh(None)
    assert accel.mesh is None and accel.mesh_size == 1


# --- the programs as CUDA graphs ------------------------------------------------------

def _rehearse_mesh_program(name, one, x):
    """(got, want, tag) of one sharded function on the one-rank CPU mesh."""
    cpu = "D1_r0_cpu"
    if name == "msum_g2":
        got = dc.g2_unpack(pmesh.sharded_msum_g2(one, dc.g2_pack(x["msum_g2_pts"], CPU)))[0]
        return got, hc.G2.msum(x["msum_g2_pts"]), f"mesh_msum_g2_{cpu}"
    if name == "msm_g1_dense":
        pts, sc = x["msum_pts"][:8], x["dense_scalars"]
        bits = dbls.scalars_to_bits(sc, CPU, W.NBITS_SHORT)
        got = dc.g1_unpack(pmesh.sharded_msm_g1(one, bits, dc.g1_pack(pts, CPU)))[0]
        return got, hc.G1.msum([hc.G1.mul(s, p) for s, p in zip(sc, pts)]), \
            f"mesh_msm_g1_dense_{cpu}"
    if name == "pippenger":
        pts, sc = x["pip_pts"][:40], x["pip_scalars"][:40]
        got = pmesh.sharded_msm_pippenger(one, pts, sc, c=4, L=4, nbits=W.NBITS_SHORT)
        return got, hc.G1.msm(sc, pts, c=8), f"mesh_pip_g1_c4_L4_{cpu}"
    if name == "miller_product":
        # the pairing check's program is this body and the final
        # exponentiation, which tests/test_torch_slice.py holds under the guard
        p_aff = dbls.pack_g1_affine(x["pair_p"][:2], CPU)
        q_aff = dbls.pack_g2_affine(x["pair_q"][:2], CPU)
        got = tree_leaves(pmesh.sharded_miller_product(one, p_aff, q_aff))
        want = tree_leaves(dp.f12_product(dp.miller_loop_batch(p_aff, q_aff)))
        return [t.tolist() for t in got], [t.tolist() for t in want], \
            f"mesh_miller_product_{cpu}"
    if name == "ntt_bw6_inverse":
        x0 = FQ.pack(x["ntt_bw6"], CPU)
        got = pmesh.sharded_ntt(one, x0, dntt.ntt_bw6, inverse=True)
        return FQ.unpack(dntt.ntt_bw6.ntt(got)), x["ntt_bw6"], f"mesh_ntt_fq377_1_None_{cpu}"
    assert name == "compute_h"
    g = BLS12_377_ENGINE.fr_generator
    raws = [FR.pack_raw(e, CPU) for e in x["h_evals"]]
    got = pmesh.sharded_compute_h(one, dntt.ntt_fr, *raws, W.D_H, g)
    want = host_h_poly(BLS12_377_ENGINE, *x["h_evals"], W.D_H, g)
    return dmsm.RawScalarVec(got.astype(np.uint16)[:, :W.D_H - 1], FR).to_ints(), want, \
        f"mesh_compute_h_fr253_{g}_{cpu}"


@pytest.mark.parametrize("name", ["msum_g2", "msm_g1_dense", "pippenger", "miller_product",
                                  "ntt_bw6_inverse", "compute_h"])
def test_mesh_programs_run_clean_under_the_capture_guard(name, one, x):
    """Each sharded function's program (tests/torch_capture_guard.py: an
    eager call, then the body again under the guard, as the card's first
    call and capture run it) on the one-rank mesh, with the tag that names
    the mesh's size, rank and device: the guarded result equals the host
    oracle's or the single-card function's."""
    with rehearse_captures() as seen:
        got, want, tag = _rehearse_mesh_program(name, one, x)
    assert got == want
    assert tag in seen


# --- bring-up ------------------------------------------------------------------------

def test_init_distributed_single_process_is_a_no_op(monkeypatch):
    for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(k, raising=False)
    assert pdist.init_distributed(device="cpu") == CPU
    assert not torch.distributed.is_initialized()
    assert pdist.process_count() == 1 and pdist.is_coordinator()
    mesh = pdist.global_mesh(device="cpu")
    assert (mesh.group, mesh.rank, mesh.size, mesh.device) == (None, 0, 1, CPU)
    with pytest.raises(ValueError, match="together"):
        pdist.init_distributed("file:///nowhere", device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            pdist.global_mesh()  # the card by default: nothing falls back

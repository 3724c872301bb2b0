"""The port's group law (celo_bls_snark_tpu_torch/ops/curve.py: BLS12-377
G1/G2 and BW6-761 G1/G2) limb for limb against the JAX package's
ops/curve.py on the CPU, on the same packed points, and against the
hostmath curve oracles; PointVec and the device batch inversion
(make_affine_raw) leaf for leaf."""

import random

import jax
import numpy as np
import pytest
import torch

from celo_bls_snark_tpu.hostmath import bw6 as hbw6
from celo_bls_snark_tpu.hostmath import curves as hc
from celo_bls_snark_tpu.hostmath import fp2 as hfp2
from celo_bls_snark_tpu.hostmath.params import BW6_P, G1_GENERATOR, G2_GENERATOR, P, R
from celo_bls_snark_tpu.ops import field as jf
from celo_bls_snark_tpu.ops import bls as jbls
from celo_bls_snark_tpu.ops import curve as jdc
from celo_bls_snark_tpu_torch.convert import tree_from_numpy, tree_to_numpy
from celo_bls_snark_tpu_torch.ops import curve as tdc
from celo_bls_snark_tpu_torch.ops import field as tf
from celo_bls_snark_tpu_torch.utils.tree import tree_leaves

# one thread: the plain versions loop over small tensors, and the test
# suite's parallel workers would otherwise contend for every core
torch.set_num_threads(1)

CURVES = {
    "g1": (jdc.g1, tdc.g1, jdc.g1_pack, tdc.g1_unpack, hc.G1, G1_GENERATOR),
    "g2": (jdc.g2, tdc.g2, jdc.g2_pack, tdc.g2_unpack, hc.G2, G2_GENERATOR),
}


def assert_same(jax_tree, torch_tree):
    w = tree_leaves(jax.tree.map(np.asarray, jax_tree))
    g = tree_leaves(tree_to_numpy(torch_tree))
    assert len(w) == len(g)
    for x, y in zip(w, g):
        np.testing.assert_array_equal(y, x)


@pytest.fixture(scope="module")
def points():
    rng = random.Random(20261016)
    out = {}
    for name, (_, _, _, _, host, gen) in CURVES.items():
        pts = [host.mul(rng.randrange(1, R), gen) for _ in range(6)]
        out[name] = pts + [None, pts[0]]  # infinity and a repeated point
    return out


@pytest.mark.parametrize("name", ["g1", "g2"])
def test_add_double_limb_exact(points, name):
    jops, tops, pack, unpack, host, _ = CURVES[name]
    pts = points[name]
    other = pts[1:] + pts[:1]  # includes P + P and P + infinity lanes
    a, b = pack(pts), pack(other)
    ta, tb = tree_from_numpy(a, "cpu"), tree_from_numpy(b, "cpu")
    s = tops.add(ta, tb)
    assert_same(jops.add(a, b), s)
    assert unpack(s) == [host.add(x, y) for x, y in zip(pts, other)]
    # lazy (non-canonical) projective inputs: the sum fed back in
    s_np = tree_to_numpy(s)
    d = tops.double(s)
    assert_same(jops.double(s_np), d)
    assert unpack(d) == [host.double(host.add(x, y)) for x, y in zip(pts, other)]


@pytest.mark.parametrize("name", ["g1", "g2"])
def test_to_affine_limb_exact(points, name):
    jops, tops, pack, _, host, _ = CURVES[name]
    pts = points[name]
    a = pack(pts)
    got = tops.to_affine(tree_from_numpy(a, "cpu"))
    assert_same(jops.to_affine(a), got)


def test_msum_groups_limb_exact(points):
    """The fold order (chunked scan-fold, then recursive doubling) keeps the
    JAX package's lane order: 2 groups of 4 lanes folded by 2, and the
    padding path (groups of 3 lanes folded by 2)."""
    pts = points["g1"]
    a = jdc.g1_pack(pts)
    ta = tree_from_numpy(a, "cpu")
    got = tdc.g1.msum_groups(ta, 2, fold_lanes=2)
    assert_same(jdc.g1.msum_groups(a, 2, fold_lanes=2), got)
    assert tdc.g1_unpack(got) == [hc.G1.msum(pts[:4]), hc.G1.msum(pts[4:])]
    a6 = jdc.g1_pack(pts[:6])
    got6 = tdc.g1.msum_groups(tree_from_numpy(a6, "cpu"), 2, fold_lanes=4)
    assert_same(jdc.g1.msum_groups(a6, 2, fold_lanes=4), got6)
    assert tdc.g1_unpack(got6) == [hc.G1.msum(pts[:3]), hc.G1.msum(pts[3:6])]


def test_msum_g2_limb_exact(points):
    pts = points["g2"][:4]
    a = jdc.g2_pack(pts)
    got = tdc.g2.msum(tree_from_numpy(a, "cpu"))
    assert_same(jdc.g2.msum(a), got)
    assert tdc.g2_unpack(got) == [hc.G2.msum(pts)]


@pytest.mark.parametrize("name", ["g1", "g2"])
def test_scalar_mul_const_limb_exact(points, name):
    jops, tops, pack, unpack, host, _ = CURVES[name]
    pts = points[name][:3]
    k = 0b101101
    a = pack(pts)
    got = tops.scalar_mul_const(k, tree_from_numpy(a, "cpu"))
    assert_same(jops.scalar_mul_const(k, a), got)
    assert unpack(got) == [host.mul(k, p) for p in pts]


@pytest.mark.parametrize("canonical", [False, True])
@pytest.mark.parametrize("name", ["g1", "g2"])
def test_madd_limb_exact(points, name, canonical):
    """Mixed addition with an affine (0, 0) infinity lane, through both
    infinity tests (REDC zero test, or the all-limbs-zero compare)."""
    jops, tops, pack, unpack, host, _ = CURVES[name]
    apack = jbls.pack_g1_affine if name == "g1" else jbls.pack_g2_affine
    pts = points[name]
    other = pts[2:] + pts[:2]
    p1, a2 = pack(pts), apack(other)
    got = tops.madd(tree_from_numpy(p1, "cpu"), tree_from_numpy(a2, "cpu"),
                    canonical_bases=canonical)
    assert_same(jops.madd(p1, a2, canonical_bases=canonical), got)
    assert unpack(got) == [host.add(x, y) for x, y in zip(pts, other)]


def test_packing_matches_jax(points):
    for name in ("g1", "g2"):
        _, _, pack, unpack, _, _ = CURVES[name]
        tpack = tdc.g1_pack if name == "g1" else tdc.g2_pack
        assert_same(pack(points[name]), tpack(points[name], "cpu"))
        assert unpack(tpack(points[name], "cpu")) == points[name]


# --- BW6-761 (both groups over Fq761) and the prover's point carriers ------

BW6 = {
    "bw6_g1": (jdc.bw6_g1, tdc.bw6_g1, hbw6.G1, hbw6.G1_GENERATOR),
    "bw6_g2": (jdc.bw6_g2, tdc.bw6_g2, hbw6.G2, hbw6.G2_GENERATOR),
}


@pytest.fixture(scope="module")
def bw6_points():
    rng = random.Random(20261017)
    out = {}
    for name, (_, _, host, gen) in BW6.items():
        pts = [host.mul(rng.randrange(1, P), gen) for _ in range(3)]
        out[name] = pts + [None, pts[0]]
    return out


@pytest.mark.parametrize("name", ["bw6_g1", "bw6_g2"])
def test_bw6_add_double_limb_exact(bw6_points, name):
    jops, tops, host, _ = BW6[name]
    pts = bw6_points[name]
    other = pts[1:] + pts[:1]  # P + Q, P + infinity, infinity + P, P + P
    a, b = jdc.pack_jac(jf.FQ761, pts), jdc.pack_jac(jf.FQ761, other)
    assert_same(a, tdc.pack_jac(tf.FQ761, pts, "cpu"))
    ta, tb = tree_from_numpy(a, "cpu"), tree_from_numpy(b, "cpu")
    s = tops.add(ta, tb)
    assert_same(jops.add(a, b), s)
    assert tdc.unpack_jac(tf.FQ761, s) == [host.add(x, y) for x, y in zip(pts, other)]
    d = tops.double(s)
    assert_same(jops.double(tree_to_numpy(s)), d)
    assert tdc.unpack_jac(tf.FQ761, d) == [
        host.double(host.add(x, y)) for x, y in zip(pts, other)]


@pytest.mark.parametrize("canonical", [False, True])
@pytest.mark.parametrize("name", ["bw6_g1", "bw6_g2"])
def test_bw6_madd_limb_exact(bw6_points, name, canonical):
    jops, tops, host, _ = BW6[name]
    pts = bw6_points[name]
    other = pts[2:] + pts[:2]
    p1, a2 = jdc.pack_jac(jf.FQ761, pts), jdc.pack_affine(jf.FQ761, other)
    assert_same(a2, tdc.pack_affine(tf.FQ761, other, "cpu"))
    got = tops.madd(tree_from_numpy(p1, "cpu"), tree_from_numpy(a2, "cpu"),
                    canonical_bases=canonical)
    assert_same(jops.madd(p1, a2, canonical_bases=canonical), got)
    assert tdc.unpack_jac(tf.FQ761, got) == [host.add(x, y) for x, y in zip(pts, other)]


RAW_CASES = {
    "bls-g1": (jdc.g1, tdc.g1, jf.fq, tf.fq, hc.G1, G1_GENERATOR, (0, 0),
               lambda v: (pow(v[0], -1, P),), jdc.g1_pack),
    "bls-g2": (jdc.g2, tdc.g2, jf.fq, tf.fq, hc.G2, G2_GENERATOR,
               ((0, 0), (0, 0)),
               lambda v: hfp2.inv((v[0], v[1])),
               jdc.g2_pack),
    "bw6-g1": (jdc.bw6_g1, tdc.bw6_g1, jf.fq761, tf.fq761, hbw6.G1,
               hbw6.G1_GENERATOR, (0, 0), lambda v: (pow(v[0], -1, BW6_P),),
               lambda pts: jdc.pack_jac(jf.FQ761, pts)),
}


@pytest.mark.parametrize("name", list(RAW_CASES))
def test_affine_raw_and_pointvec_leaves_match_jax(name):
    """Device batch inversion -> PointVec: the raw uint16 leaves equal the
    JAX package's, the points equal the host's (infinity lanes included),
    and device_montgomery (padded) gives the JAX package's limbs."""
    jops, tops, jfo, tfo, host, gen, template, host_inv, pack = RAW_CASES[name]
    rng = random.Random(20261018)
    pts = [host.mul(rng.randrange(1, R), gen) for _ in range(4)]
    pts = pts[:2] + [None] + pts[2:]
    proj = pack(pts)
    # non-trivial Z: double every lane first
    jproj = jops.double(proj)
    tproj = tops.double(tree_from_numpy(proj, "cpu"))
    want = jdc.make_affine_raw(jops, jfo, host_inv, template, f"t_{name}")(jproj)
    got = tdc.make_affine_raw(tops, tfo, host_inv, template)(tproj)
    assert len(got.leaves) == len(want.leaves)
    for g, w in zip(got.leaves, want.leaves):
        assert g.dtype == np.uint16
        np.testing.assert_array_equal(g, np.asarray(w))
    doubled = [host.double(p) for p in pts]
    assert got == doubled and list(got) == doubled and got[2] is None
    assert len(got) == 5
    assert_same(want.device_montgomery(8), got.device_montgomery("cpu", 8))

"""The port's MSM module (celo_bls_snark_tpu_torch/ops/msm.py) against the
JAX package's ops/msm.py on the CPU and against the hostmath oracles.

Host planning (window digits, plan arrays, fixed-base digits) is numpy on
both sides and must be equal array for array. Where both sides compute
limbs on the same inputs (one Pippenger run, the Straus grouped MSM, the
fixed-base scan) the projective limbs must be equal: the port gathers the
Straus table entry where the JAX package adds 2^c masked entries, and loops
in Python where it scans. Where the value is fixed (msm_pippenger and the
bit-plane MSM on every group) the affine host point must equal hostmath's.
Integer work throughout: the tolerance is 0."""

import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from celo_bls_snark_tpu.hostmath import bw6 as hbw6
from celo_bls_snark_tpu.hostmath import curves as hc
from celo_bls_snark_tpu.hostmath.params import G1_GENERATOR, G2_GENERATOR, P, R
from celo_bls_snark_tpu.ops import bls as jbls
from celo_bls_snark_tpu.ops import curve as jdc
from celo_bls_snark_tpu.ops import field as jf
from celo_bls_snark_tpu.ops import msm as jmsm
from celo_bls_snark_tpu_torch.convert import tree_from_numpy, tree_to_numpy
from celo_bls_snark_tpu_torch.ops import bls as tbls
from celo_bls_snark_tpu_torch.ops import curve as tdc
from celo_bls_snark_tpu_torch.ops import field as tf
from celo_bls_snark_tpu_torch.ops import msm as tmsm
from celo_bls_snark_tpu_torch.utils.tree import tree_leaves

# one thread: the plain versions loop over small tensors, and the test
# suite's parallel workers would otherwise contend for every core
torch.set_num_threads(1)


def assert_same(jax_tree, torch_tree):
    w = tree_leaves(jax.tree.map(np.asarray, jax_tree))
    g = tree_leaves(tree_to_numpy(torch_tree))
    assert len(w) == len(g)
    for x, y in zip(w, g):
        np.testing.assert_array_equal(y, x)


def host_msm(curve, scalars, pts):
    return curve.msum([curve.mul(s, p) if s and p is not None else None
                       for s, p in zip(scalars, pts)])


# --- host planning: numpy on both sides ------------------------------------

@pytest.mark.parametrize("nbits,c", [(253, 4), (253, 16), (377, 13), (64, 24)])
def test_window_digits_match_jax(nbits, c):
    rng = random.Random(1)
    scalars = [0, 1, (1 << nbits) - 1] + [rng.randrange(1 << nbits) for _ in range(9)]
    got = tmsm.window_digits(scalars, nbits, c)
    np.testing.assert_array_equal(got, jmsm.window_digits(scalars, nbits, c))
    W = -(-nbits // c)
    assert got.shape == (W, 12) and got.dtype == np.int32
    for i, s in enumerate(scalars):
        assert sum(int(d) << (c * (W - 1 - w)) for w, d in enumerate(got[:, i])) == s


@pytest.mark.parametrize("nbits,c,L", [(253, 4, 4), (253, 16, 4), (377, 7, 8)])
def test_plan_msm_arrays_match_jax_and_generic(nbits, c, L):
    rng = random.Random(2)
    scalars = [rng.randrange(1 << nbits) for _ in range(9)] + [0, 1, 1, (1 << nbits) - 1]
    fast = tmsm.plan_msm(scalars, nbits, c, L)
    for a, b in zip(fast, jmsm.plan_msm(scalars, nbits, c, L)):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(fast, tmsm.plan_msm_generic(scalars, nbits, c, L)):
        np.testing.assert_array_equal(a, b)
    assert fast[4] % L == 0 and fast[0].shape == (-(-nbits // c), fast[4])


def test_plan_msm_from_raw_scalar_vec_and_window_limit():
    rng = random.Random(3)
    vals = [rng.randrange(R) for _ in range(10)] + [0, R - 1]
    limbs = tf.FR.pack_raw(vals, "cpu").numpy()
    raw = tmsm.RawScalarVec(limbs, tf.FR)
    jraw = jmsm.RawScalarVec(limbs, jf.FR)
    assert len(raw) == 12 and raw == vals and list(raw) == vals
    np.testing.assert_array_equal(raw.byte_matrix(36), jraw.byte_matrix(36))
    for a, b in zip(tmsm.plan_msm(raw, 253, 8, 4), tmsm.plan_msm(vals, 253, 8, 4)):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(tmsm.plan_msm(raw, 253, 8, 4), jmsm.plan_msm(jraw, 253, 8, 4)):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(AssertionError):
        tmsm.plan_msm(vals, 253, 25, 4)  # a window must fit one 32-bit read


def test_fixed_base_plan_and_table_match_jax():
    rng = random.Random(4)
    scalars = [rng.randrange(R) for _ in range(6)] + [0, 1]
    np.testing.assert_array_equal(tmsm.fixed_base_plan(scalars, 253, 5),
                                  jmsm.fixed_base_plan(scalars, 253, 5))
    assert tmsm.fixed_base_table(hc.G1, G1_GENERATOR, 12, 3) == \
        jmsm.fixed_base_table(hc.G1, G1_GENERATOR, 12, 3)
    assert tmsm._auto_c(1 << 20, 377) == jmsm._auto_c(1 << 20, 377) == 16
    assert [tmsm._auto_c(b) for b in (8, 1000, 1 << 16)] == \
        [jmsm._auto_c(b) for b in (8, 1000, 1 << 16)]


# --- limbs against the JAX package on the same inputs ----------------------

def test_pippenger_device_limb_exact():
    """One Pippenger run (2 windows of 2 bits, 4 lanes of 2 steps) gives
    the JAX package's projective limbs and the host's point."""
    pts = [hc.G1.mul(3 + i, G1_GENERATOR) for i in range(7)] + [None]
    scalars = [5, 0, 15, 1, 1, 9, 6, 7]
    plan = tmsm.plan_msm(scalars, 4, 2, 4)
    aff = jdc.pack_affine(jf.FQ, pts)
    want = jmsm._pippenger_device(jdc.g1, aff, *plan[:4], 2, 4)
    got = tmsm._pippenger_device(tdc.g1, tree_from_numpy(aff, "cpu"), *plan[:4], 2, 4)
    assert_same(want, got)
    assert tdc.g1_unpack(got) == [host_msm(hc.G1, scalars, pts)]


def test_straus_msm_groups_limb_exact():
    """The table gather equals the JAX package's one-hot masked adds."""
    rng = random.Random(5)
    B, G, c, nbits = 6, 2, 2, 6
    pts = [hc.G1.mul(rng.randrange(1, R), G1_GENERATOR) for _ in range(B)]
    scalars = [rng.randrange(1 << nbits) for _ in range(B - 1)] + [0]
    digits = tmsm.window_digits(scalars, nbits, c)
    jac = jdc.g1_pack(pts)
    want = jmsm.straus_msm_groups(jdc.g1, jnp.asarray(digits), jac, G, c)
    got = tmsm.straus_msm_groups(tdc.g1, digits, tree_from_numpy(jac, "cpu"), G, c)
    assert_same(want, got)
    assert tdc.g1_unpack(got) == [host_msm(hc.G1, scalars[:3], pts[:3]),
                                  host_msm(hc.G1, scalars[3:], pts[3:])]


def test_fixed_base_batch_mul_limb_exact():
    rng = random.Random(6)
    nbits, c = 20, 5
    scalars = [rng.randrange(1 << nbits) for _ in range(5)] + [0, 1]
    table = tmsm.fixed_base_table(hc.G1, G1_GENERATOR, nbits, c)
    digits = tmsm.fixed_base_plan(scalars, nbits, c)
    jtab = jdc.pack_affine(jf.FQ, table)
    want = jmsm._fixed_base_device(jdc.g1, jtab, jnp.asarray(digits))
    got = tmsm.fixed_base_batch_mul(tdc.g1, tree_from_numpy(jtab, "cpu"), digits)
    assert_same(want, got)
    assert tdc.g1_unpack(got) == [hc.G1.mul(s, G1_GENERATOR) if s else None
                                  for s in scalars]


# --- host points where the value is fixed ----------------------------------

def test_pippenger_g1_full_width():
    rng = random.Random(7)
    B = 19
    pts = [hc.G1.mul(rng.randrange(1, R), G1_GENERATOR) for _ in range(B)]
    scalars = [rng.randrange(R) for _ in range(B)]
    out = tmsm.msm_pippenger(pts, scalars, c=8, L=8, device="cpu")
    assert out == host_msm(hc.G1, scalars, pts)


def test_pippenger_skewed_digits_zero_scalars_and_infinity():
    """0/1-heavy scalars (the witness-vector shape) put many points in one
    bucket; zero scalars and infinity bases drop out."""
    rng = random.Random(8)
    B = 24
    pts = [hc.G1.mul(3 + i, G1_GENERATOR) for i in range(B)]
    pts[5] = None
    scalars = [1] * 10 + [0] * 8 + [2] * 4 + [rng.randrange(1 << 32), 1]
    out = tmsm.msm_pippenger(pts, scalars, nbits=32, c=4, L=4, device="cpu")
    assert out == host_msm(hc.G1, scalars, pts)
    assert tmsm.msm_pippenger(pts, [0] * B, nbits=8, c=4, L=4, device="cpu") is None


@pytest.mark.parametrize("name", ["bw6_g1", "bw6_g2"])
def test_pippenger_bw6(name):
    rng = random.Random(9)
    host, gen, curve = {
        "bw6_g1": (hbw6.G1, hbw6.G1_GENERATOR, tdc.bw6_g1),
        "bw6_g2": (hbw6.G2, hbw6.G2_GENERATOR, tdc.bw6_g2),
    }[name]
    B = 11
    pts = [host.mul(5 + i, gen) for i in range(B)]
    scalars = [rng.randrange(1 << 40) for _ in range(B - 1)] + [P - 1]
    out = tmsm.msm_pippenger(pts[:-1], scalars[:-1], curve=curve, spec=tf.FQ761,
                             nbits=40, c=5, L=4, device="cpu")
    assert out == host_msm(host, scalars[:-1], pts[:-1])
    # one full-width scalar through all 377 bits
    one = tmsm.msm_pippenger(pts[-1:], scalars[-1:], curve=curve, spec=tf.FQ761,
                             nbits=377, c=8, L=1, device="cpu")
    assert one == host.mul(P - 1, pts[-1])


def test_pippenger_g2_pack_fns_and_base_cache():
    rng = random.Random(10)
    B = 5
    pts = [hc.G2.mul(rng.randrange(1, R), G2_GENERATOR) for _ in range(B)]
    scalars = [rng.randrange(1 << 24) for _ in range(B)]
    kw = dict(curve=tdc.g2, nbits=24, c=4, L=2, pack_fn=tbls.pack_g2_affine,
              unpack_fn=tdc.g2_unpack, device="cpu")
    want = host_msm(hc.G2, scalars, pts)
    assert tmsm.msm_pippenger(pts, scalars, cache_key="q", **kw) == want
    # the memoized bases serve the second call: the points are not packed again
    key = next(k for k in tmsm._BASE_PACK_CACHE if k[0] == "q")
    assert key[1:3] == (B, 6)
    assert tmsm.msm_pippenger([None] * B, scalars, cache_key="q", **kw) == want
    del tmsm._BASE_PACK_CACHE[key]


def test_bitplane_msm_and_dense_device_msm():
    rng = random.Random(11)
    pts = [hc.G1.mul(5, G1_GENERATOR), None, G1_GENERATOR, hc.G1.mul(9, G1_GENERATOR)]
    scalars = [3, 7, 0, rng.randrange(1 << 10)]
    bits = torch.from_numpy(np.asarray(jbls.scalars_to_bits(scalars, nbits=10)))
    jac = tdc.g1_pack(pts, "cpu")
    want = [host_msm(hc.G1, scalars, pts)]
    assert tdc.g1_unpack(tmsm.msm_g1(bits, jac)) == want
    assert tdc.g1_unpack(tbls.msm_g1_device(bits, jac)) == want
    q = [hc.G2.mul(2, G2_GENERATOR), G2_GENERATOR]
    bits2 = torch.from_numpy(np.asarray(jbls.scalars_to_bits([5, 6], nbits=3)))
    want2 = [host_msm(hc.G2, [5, 6], q)]
    assert tdc.g2_unpack(tmsm.msm_g2(bits2, tdc.g2_pack(q, "cpu"))) == want2
    assert tdc.g2_unpack(tbls.msm_g2_device(bits2, tdc.g2_pack(q, "cpu"))) == want2

"""The port's Edwards-BW6 arithmetic (celo_bls_snark_tpu_torch/ops/
edwards.py) and batched Bowe-Hopwood Pedersen CRH (ops/pedersen.py) against
the JAX package's ops/edwards.py and ops/pedersen.py on the same inputs,
limb for limb, and the CRH digests against the host
hashers/composite.py::bh_pedersen_crh."""

import random

import jax
import numpy as np
import pytest
import torch

from celo_bls_snark_tpu.ops import edwards as jed
from celo_bls_snark_tpu.ops import pedersen as jped
from celo_bls_snark_tpu.ops.field import FQ as JFQ
from celo_bls_snark_tpu_torch.convert import tree_from_numpy, tree_to_numpy
from celo_bls_snark_tpu_torch.hashers.composite import bh_pedersen_crh
from celo_bls_snark_tpu_torch.hostmath import curves as hc
from celo_bls_snark_tpu_torch.hostmath.params import P
from celo_bls_snark_tpu_torch.ops import edwards as ted
from celo_bls_snark_tpu_torch.ops import pedersen as tped
from celo_bls_snark_tpu_torch.utils.tree import tree_leaves

torch.set_num_threads(1)


def random_points(rng, count):
    """Subgroup points of the Edwards curve in extended coordinates, each
    scaled by a random Z (a projective representative)."""
    pts = []
    while len(pts) < count:
        aff = hc.ed_get_point_from_x(rng.randrange(P), rng.random() < 0.5)
        if aff is None:
            continue
        X, Y, T, Z = hc.ed_mul(8, hc.ed_from_affine(aff))
        z = rng.randrange(1, P)
        pts.append((X * z % P, Y * z % P, T * z % P, Z * z % P))
    return pts


def pack_extended(pts):
    """Host extended points -> the JAX package's numpy [n, B] Montgomery tree."""
    return tuple(np.asarray(JFQ.pack([p[i] for p in pts])) for i in range(4))


def assert_trees_equal(got, want):
    g = tree_leaves(tree_to_numpy(got))
    w = [np.asarray(x).astype(np.int32) for x in jax.tree.leaves(want)]
    assert len(g) == len(w)
    for x, y in zip(g, w):
        np.testing.assert_array_equal(x, y)


@pytest.fixture(scope="module")
def pairs():
    """Lanes: random + random, identity + random, random + identity,
    doubling, a point plus its negative."""
    rng = random.Random(5)
    a = random_points(rng, 6)
    b = random_points(rng, 6)
    ident = hc.ED_IDENTITY
    p1 = a + [ident, a[0], a[1], a[2]]
    p2 = b + [b[0], ident, a[1], hc.ed_neg(a[2])]
    return p1, p2


def test_add_equals_jax(pairs):
    p1, p2 = pairs
    j1, j2 = pack_extended(p1), pack_extended(p2)
    want = jax.jit(jed.add)(j1, j2)
    got = ted.add(tree_from_numpy(j1, "cpu"), tree_from_numpy(j2, "cpu"))
    assert_trees_equal(got, want)
    host = [hc.ed_to_affine(hc.ed_add(x, y)) for x, y in zip(p1, p2)]
    assert ted.unpack_extended(got) == host


def test_madd_equals_jax(pairs):
    p1, p2 = pairs
    aff = [hc.ed_to_affine(p) for p in p2]
    j1 = pack_extended(p1)
    ja2 = jed.pack_affine_td(aff)
    ta2 = ted.pack_affine_td(aff, "cpu")
    assert_trees_equal(ta2, ja2)
    want = jax.jit(jed.madd)(j1, ja2)
    got = ted.madd(tree_from_numpy(j1, "cpu"), ta2)
    assert_trees_equal(got, want)
    host = [hc.ed_to_affine(hc.ed_add(x, y)) for x, y in zip(p1, p2)]
    assert ted.unpack_extended(got) == host


def test_neg_and_identity(pairs):
    p1, _ = pairs
    t1 = tree_from_numpy(pack_extended(p1), "cpu")
    assert ted.unpack_extended(ted.neg(t1)) == [hc.ed_to_affine(hc.ed_neg(p)) for p in p1]
    assert ted.unpack_extended(ted.identity((3,), "cpu")) == [(0, 1)] * 3


# messages: seeded random bytes, all-zero and all-0xff, at 22 bytes (the
# hash bench's length: 59 chunks, padded to 64 lanes) and 5 bytes
def crh_messages(length, count=4, seed=3):
    rng = np.random.default_rng(seed + length)
    msgs = [rng.integers(0, 256, length, dtype=np.uint8).tobytes()
            for _ in range(count)]
    return msgs + [b"\x00" * length, b"\xff" * length]


@pytest.mark.parametrize("length", (5, 22))
def test_bh_plan_equals_jax(length):
    msgs = crh_messages(length)
    for got, want in zip(tped.bh_plan(msgs), jped.bh_plan(msgs)):
        np.testing.assert_array_equal(got, want)


def test_bh_table_equals_jax():
    got = tped.bh_table(14, "cpu")
    assert got is tped.bh_table(14, "cpu")  # cached per chunk count and device
    assert_trees_equal(got, jped.bh_table(14))


@pytest.mark.parametrize("length,lc", ((5, 8), (22, 8), (22, 4)))
def test_bh_crh_device_equals_jax_and_host(length, lc):
    msgs = crh_messages(length)
    want = jped.bh_crh_device(msgs, Lc=lc)
    got = tped.bh_crh_device(msgs, "cpu", Lc=lc)
    assert_trees_equal(got, want)
    host = [int(hc.ed_to_affine(bh_pedersen_crh(m))[0]).to_bytes(48, "little")
            for m in msgs]
    assert tped.bh_crh_digests(msgs, "cpu", Lc=lc) == host


def test_bh_plan_rejects_unequal_lengths():
    with pytest.raises(ValueError):
        tped.bh_plan([b"ab", b"abc"])


@pytest.mark.gpu
def test_crh_card_equals_cpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    msgs = crh_messages(22)
    card = tped.bh_crh_device(msgs, "cuda")
    cpu = tped.bh_crh_device(msgs, "cpu")
    for x, y in zip(tree_leaves(card), tree_leaves(cpu)):
        assert torch.equal(x.cpu(), y)

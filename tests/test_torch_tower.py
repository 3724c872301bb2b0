"""The port's Fq2/Fq6/Fq12 tower (celo_bls_snark_tpu_torch/ops/tower.py)
limb for limb against the JAX package's ops/tower.py on the CPU, on the
same packed inputs, and against the hostmath Fq12 oracle."""

import random

import jax
import numpy as np
import pytest

from celo_bls_snark_tpu.hostmath import fq12 as hfq12
from celo_bls_snark_tpu.ops import tower as jtw
from celo_bls_snark_tpu.ops.field import FQ
from celo_bls_snark_tpu_torch.convert import tree_from_numpy, tree_to_numpy
from celo_bls_snark_tpu_torch.ops import tower as ttw
from celo_bls_snark_tpu_torch.utils.tree import tree_leaves

B = 3
P = FQ.modulus


def rand_f12(rng):
    """B random host Fq12 values (nested python-int tuples)."""
    return [
        tuple(
            tuple((rng.randrange(P), rng.randrange(P)) for _ in range(3))
            for _ in range(2)
        )
        for _ in range(B)
    ]


def pack_f12(vals):
    """B host Fq12 values -> Fq12 tree of [n, B] numpy arrays."""
    return tuple(
        tuple(
            tuple(FQ.pack([v[i][j][k] for v in vals]) for k in range(2))
            for j in range(3)
        )
        for i in range(2)
    )


def unpack_f12(tree):
    leaves = [FQ.unpack(np.asarray(l)) for l in tree_leaves(tree)]
    out = []
    for lane in range(len(leaves[0])):
        it = iter(l[lane] for l in leaves)
        out.append(tuple(tuple((next(it), next(it)) for _ in range(3))
                         for _ in range(2)))
    return out


def assert_same(jax_tree, torch_tree):
    w = tree_leaves(jax.tree.map(np.asarray, jax_tree))
    g = tree_leaves(tree_to_numpy(torch_tree))
    assert len(w) == len(g)
    for x, y in zip(w, g):
        np.testing.assert_array_equal(y, x)


@pytest.fixture(scope="module")
def inputs():
    rng = random.Random(20261016)
    a, b = rand_f12(rng), rand_f12(rng)
    line = [tuple((rng.randrange(P), rng.randrange(P)) for _ in range(3))
            for _ in range(B)]
    cs = tuple(
        tuple(FQ.pack([l[c][k] for l in line]) for k in range(2)) for c in range(3)
    )
    return a, b, pack_f12(a), pack_f12(b), cs


@pytest.mark.parametrize("op", ["f12_mul", "f12_sq", "f12_cyclo_sq", "f12_frob",
                                "f12_conj", "f12_inv"])
def test_f12_ops_limb_exact(inputs, op):
    _, _, a, b, _ = inputs
    ta, tb = tree_from_numpy(a, "cpu"), tree_from_numpy(b, "cpu")
    if op == "f12_mul":
        assert_same(jtw.f12_mul(a, b), ttw.f12_mul(ta, tb))
    else:
        assert_same(getattr(jtw, op)(a), getattr(ttw, op)(ta))


def test_f12_mul_line_limb_exact(inputs):
    _, _, a, _, (ca, cw, cw3) = inputs
    t = lambda x: tree_from_numpy(x, "cpu")  # noqa: E731
    assert_same(jtw.f12_mul_line(a, ca, cw, cw3),
                ttw.f12_mul_line(t(a), t(ca), t(cw), t(cw3)))


def test_f12_against_oracle_and_is_one(inputs):
    av, bv, a, b, _ = inputs
    ta, tb = tree_from_numpy(a, "cpu"), tree_from_numpy(b, "cpu")
    assert unpack_f12(ttw.f12_mul(ta, tb)) == [hfq12.mul(x, y) for x, y in zip(av, bv)]
    assert unpack_f12(ttw.f12_frob(ta)) == [hfq12.frob(x) for x in av]
    prod = ttw.f12_mul(ta, ttw.f12_inv(ta))
    assert ttw.f12_is_one(prod).tolist() == [True] * B
    assert ttw.f12_is_one(ta).tolist() == [False] * B
    assert ttw.f12_is_one(ttw.f12_ones((B,), "cpu")).tolist() == [True] * B


def test_f2_ops_limb_exact(inputs):
    _, _, a, b, _ = inputs
    x, y = a[0][0], b[1][2]
    t = lambda v: tree_from_numpy(v, "cpu")  # noqa: E731
    assert_same(jtw.f2_mul(x, y), ttw.f2_mul(t(x), t(y)))
    assert_same(jtw.f2_sq(x), ttw.f2_sq(t(x)))
    assert_same(jtw.f2_inv(x), ttw.f2_inv(t(x)))
    assert_same(jtw.f6_inv(a[1]), ttw.f6_inv(t(a[1])))

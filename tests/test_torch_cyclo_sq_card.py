"""The cyclotomic squaring's kernel (csrc/cyclo_sq.cu) on the card, against
its plain version, ops/tower.py::f12_cyclo_sq_plain (the composition it
replaces), limb for limb; and the final exponentiation that runs it.

Every test here needs a CUDA card and skips without one. The file imports
nothing of the JAX package, so that on a machine without it the tests run
by importing the module and calling them:

    python3 -c "import sys; sys.path.insert(0, 'tests');
                import test_torch_cyclo_sq_card as t; t.run_all()"
"""

import numpy as np
import pytest
import torch

from celo_bls_snark_tpu_torch.ops import field as F
from celo_bls_snark_tpu_torch.ops import pairing as TP
from celo_bls_snark_tpu_torch.ops import tower as TT
from celo_bls_snark_tpu_torch.utils import aotcache
from celo_bls_snark_tpu_torch.utils.tree import tree_leaves, tree_map

SPEC = F.FQ
N, P = SPEC.n, SPEC.modulus


def needs_card():
    if not torch.cuda.is_available():
        pytest.skip("runs the CUDA kernel: needs a CUDA card")


def random_f12(B, seed):
    """An Fq12 batch of lazy [n, B] coefficients, values in (-8p, 8p),
    limbs re-split by signed carries up to 2^6."""
    rng = np.random.default_rng(seed)
    vals = [[int.from_bytes(rng.bytes(48), "little") % (16 * P) - 8 * P
             for _ in range(B)] for _ in range(12)]
    leaves = []
    for row in vals:
        limbs = SPEC._limbs_from_ints([v % (1 << (16 * N)) for v in row]).astype(np.int64)
        neg = np.array([v < 0 for v in row])
        limbs[N - 1, neg] -= 1 << 16  # two's complement: the top limb carries the sign
        d = rng.integers(-64, 65, size=(N - 1, B))
        limbs[:-1] += d << 16
        limbs[1:] -= d
        leaves.append(torch.from_numpy(limbs.astype(np.int32)))
    return tuple(tuple((leaves[6 * h + 2 * s], leaves[6 * h + 2 * s + 1]) for s in range(3))
                 for h in range(2))


def strided(tree, device):
    """The same values as views on `device`: even leaves as column slices
    of wider tensors (row stride 3B), odd leaves as rows of one [12, n, B]
    tensor."""
    leaves = tree_leaves(tree)
    B = leaves[0].shape[1]
    stack = torch.stack(leaves).to(device)
    out = []
    for i, x in enumerate(leaves):
        if i % 2 == 0:
            wide = torch.zeros((N, 3 * B), dtype=torch.int32, device=device)
            wide[:, B:2 * B] = x.to(device)
            out.append(wide[:, B:2 * B])
        else:
            out.append(stack[i])
    assert out[0].stride() == (3 * B, 1) and out[1].stride() == (B, 1)
    return tuple(tuple((out[6 * h + 2 * s], out[6 * h + 2 * s + 1]) for s in range(3))
                 for h in range(2))


def assert_same(got, want):
    for x, y in zip(tree_leaves(got), tree_leaves(want)):
        assert x.shape == y.shape
        np.testing.assert_array_equal(x.cpu().numpy(), y.cpu().numpy())


@pytest.mark.gpu
@pytest.mark.parametrize("B", [1, 33, 300, 6000])
def test_kernel_equals_plain_on_card(B):
    needs_card()
    a = random_f12(B, seed=B)
    dev = torch.device("cuda")
    x = strided(a, dev)
    before = F.f12_cyclo_sq.launches
    got = TT.f12_cyclo_sq(x)
    assert F.f12_cyclo_sq.launches == before + 1
    assert_same(got, TT.f12_cyclo_sq_plain(x))  # the composition on the card
    assert_same(got, TT.f12_cyclo_sq_plain(a))  # and on the CPU
    # one broadcast coefficient (lane stride 0) and a chain of squarings
    b = tree_map(lambda t: t.to(dev), a)
    b = ((b[0][0], b[0][1], (b[0][2][0][:, :1].expand(N, B), b[0][2][1])), b[1])
    want = b
    for _ in range(3):
        b, want = TT.f12_cyclo_sq(b), TT.f12_cyclo_sq_plain(want)
    assert_same(b, want)


@pytest.mark.gpu
def test_final_exponentiation_on_card_equals_cpu():
    needs_card()
    f = random_f12(2, seed=7)
    want = TP.final_exponentiation(f)
    got = TP.final_exponentiation(tree_map(lambda t: t.cuda(), f))
    assert_same(got, want)


@pytest.mark.gpu
def test_final_exponentiation_launches():
    """One final exponentiation launches the kernel 316 times and mont_mul
    316 times fewer than the composition did, eagerly and in a replayed
    graph."""
    needs_card()
    f = tree_map(lambda t: t.cuda(), random_f12(1, seed=3))

    def counts():
        return F.mont_mul.launches, F.f12_cyclo_sq.launches

    kernel_route = TT.f12_cyclo_sq
    F.reset_launches()
    TT.f12_cyclo_sq = TT.f12_cyclo_sq_plain  # the composition, as before
    try:
        TP.final_exponentiation(f)
    finally:
        TT.f12_cyclo_sq = kernel_route
    composed = counts()
    F.reset_launches()
    TP.final_exponentiation(f)
    fused = counts()
    assert composed[1] == 0 and fused[1] == 316
    assert composed[0] - fused[0] == 316
    program = aotcache.jit("test_final_exp_cyclo", TP.final_exponentiation)
    program(f)  # eager
    program(f)  # capture and replay
    aotcache.reset_replays()
    program(f)
    assert aotcache.graph_launches() == {"mont_mul": fused[0], "f12_cyclo_sq": 316,
                                         "f12_mul": 35}
    aotcache.clear()


def run_all():
    """Every test of the file, without pytest's runner (a machine whose
    pytest set-up imports JAX)."""
    for B in (1, 33, 300, 6000):
        test_kernel_equals_plain_on_card(B)
    test_final_exponentiation_on_card_equals_cpu()
    test_final_exponentiation_launches()
    print("test_torch_cyclo_sq_card: all passed")

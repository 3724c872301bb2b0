"""The Fq12 multiply's kernel (csrc/f12_mul.cu) on the card, against its
plain version, ops/tower.py::f12_mul_plain (the composition it replaces),
limb for limb; and the pairings that run it.

Every test here needs a CUDA card and skips without one. The file imports
nothing of the JAX package, so that on a machine without it the tests run
by importing the module and calling them:

    python3 -c "import sys; sys.path.insert(0, 'tests');
                import test_torch_f12_mul_card as t; t.run_all()"
"""

import pytest
import torch

from celo_bls_snark_tpu_torch import bench
from celo_bls_snark_tpu_torch.ops import bls as dbls
from celo_bls_snark_tpu_torch.ops import curve as dc
from celo_bls_snark_tpu_torch.ops import field as F
from celo_bls_snark_tpu_torch.ops import tower as TT
from celo_bls_snark_tpu_torch.utils import aotcache
from celo_bls_snark_tpu_torch.utils.tree import tree_map
from test_torch_cyclo_sq_card import assert_same, needs_card, random_f12

N = F.FQ.n
WIDTHS = [1, 2, 33, 300, 600, 6000, 12000]


def operands(B, seed):
    """a with every leaf the even lanes of a [n, 2B] tensor (lane stride
    2), b with one leaf a single lane broadcast against [n, B] (lane stride
    0); both on the card, and their values on the CPU."""
    wide = random_f12(2 * B, seed)
    b_cpu = random_f12(B, seed + 1)
    a = tree_map(lambda t: t.cuda()[:, 0::2], wide)
    b = tree_map(lambda t: t.cuda(), b_cpu)
    b = ((b[0][0], b[0][1], (b[0][2][0][:, :1], b[0][2][1])), b[1])
    a_cpu = tree_map(lambda t: t[:, 0::2], wide)
    b_cpu = ((b_cpu[0][0], b_cpu[0][1], (b_cpu[0][2][0][:, :1], b_cpu[0][2][1])), b_cpu[1])
    return a, b, a_cpu, b_cpu


@pytest.mark.gpu
@pytest.mark.parametrize("B", WIDTHS)
def test_kernel_equals_plain_on_card(B):
    needs_card()
    a, b, a_cpu, b_cpu = operands(B, seed=B)
    for x, y, x_cpu, y_cpu in ((a, b, a_cpu, b_cpu), (a, a, a_cpu, a_cpu)):
        before = F.f12_mul.launches
        got = TT.f12_mul(x, y)
        assert F.f12_mul.launches == before + 1
        assert_same(got, TT.f12_mul_plain(x, y))  # the composition on the card
        if B <= 600:
            assert_same(got, TT.f12_mul_plain(x_cpu, y_cpu))  # and on the CPU
    # a chain of squarings, and the tensor-core multiply's composition
    want = got = a
    for _ in range(3):
        got, want = TT.f12_sq(got), TT.f12_mul_plain(want, want)
    assert_same(got, want)
    with F.mul_kernel("tc"):
        assert_same(TT.f12_mul(a, b), TT.f12_mul_plain(a, b))


def pairing_programs():
    """(name, program, args, f12_mul launches a call): the grouped check at
    32 groups (33 Miller lanes, 6 levels of tree product) and at 1 (2
    lanes, 1 level), and the strategies' independent pair checks (one
    product of the pairs' halves); 63 squarings a Miller loop and 35
    multiplies a final exponentiation besides."""
    sigs, hashes, apk = bench.build_inputs(64, 3, device="cuda", n_seed=4)
    apks = tree_map(lambda x: x.repeat(1, 32), apk)
    dev = sigs[0].device
    p = dbls._interleave(dc.g1.to_affine(sigs), dc.g1.to_affine(hashes))
    q = dbls._interleave(dbls.neg_g2_gen_affine(dev, 64),
                         tree_map(lambda x: x.repeat(1, 64), apk))
    return [("grouped_32", lambda s, h, k: dbls.batch_verify_grouped_device(s, h, k, 32),
             (sigs, hashes, apks), 104),
            ("grouped_1", lambda s, h, k: dbls.batch_verify_grouped_device(s, h, k, 1),
             (sigs, hashes, apk), 99),
            ("pairs", dbls.verify_pairs_device, (p, q), 99)]


@pytest.mark.gpu
def test_pairing_launches():
    """Each verification launches the kernel once an Fq12 multiply, and
    mont_mul as many times fewer than the composition did, eagerly and in a
    replayed graph; the verdicts hold."""
    needs_card()
    for name, fn, args, want in pairing_programs():
        kernel_route = TT.f12_mul
        F.reset_launches()
        TT.f12_mul = TT.f12_mul_plain  # the composition, as before
        try:
            assert bool(fn(*args).all())
        finally:
            TT.f12_mul = kernel_route
        composed = F.mont_mul.launches, F.f12_mul.launches
        F.reset_launches()
        assert bool(fn(*args).all())
        fused = F.mont_mul.launches, F.f12_mul.launches
        assert composed[1] == 0 and fused[1] == want, name
        assert composed[0] - fused[0] == want, name
        program = aotcache.jit(f"test_f12_mul_{name}", fn)
        program(*args)  # eager
        program(*args)  # capture and replay
        aotcache.reset_replays()
        assert bool(program(*args).all())
        replayed = aotcache.graph_launches()
        assert replayed["f12_mul"] == want and replayed["mont_mul"] == fused[0], name
        aotcache.clear()


def run_all():
    """Every test of the file, without pytest's runner (a machine whose
    pytest set-up imports JAX)."""
    for B in WIDTHS:
        test_kernel_equals_plain_on_card(B)
    test_pairing_launches()
    print("test_torch_f12_mul_card: all passed")

"""The cyclotomic squaring's kernel body (csrc/cyclo_sq.cuh) on the CPU.

The kernel's per-lane arithmetic also compiles for the host
(csrc/cyclo_sq_host_check.cpp, built with g++ where the machine has one):
its output is held limb for limb against the composition it replaces
(ops/tower.py::f12_cyclo_sq_plain, the kernel's plain version) and against
the JAX package's f12_cyclo_sq, on random lazy inputs, on inputs whose
pre-added operands reach the lazy contract's edges, and along a chain of 64
squarings. The routing of ops/field.py's wrapper and the count of
squarings in a final exponentiation are checked on CPU tensors; the kernel
itself on the card is tests/test_torch_cyclo_sq_card.py."""

import random
import shutil
import subprocess

import jax
import numpy as np
import pytest
import torch

from celo_bls_snark_tpu.ops import tower as jtw
from celo_bls_snark_tpu_torch.convert import tree_from_numpy, tree_to_numpy
from celo_bls_snark_tpu_torch.ops import field as F
from celo_bls_snark_tpu_torch.ops import kernels as K
from celo_bls_snark_tpu_torch.ops import pairing as TP
from celo_bls_snark_tpu_torch.ops import tower as TT
from celo_bls_snark_tpu_torch.utils.tree import tree_leaves, tree_map

torch.set_num_threads(1)

SPEC = F.FQ
N, P = SPEC.n, SPEC.modulus
# the widest operand sums 8 coefficients' worth (y0 + y1 = za0 - 5 zb1 +
# za1 + zb0): coefficients within these keep every operand inside the
# multiply's contract, |limb| < 2^26 and |value| < 256p
EDGE_VALUE = 32 * P - 1
EDGE_CARRY = 124  # limbs up to 65,535 + 124 * 2^16 + 124 < 2^23


def limbs_of(v, carries):
    """Signed lazy limbs of the value v: its two's-complement limbs,
    re-split by the signed carries (carry k moves from limb k + 1 to k)."""
    w = v % (1 << (16 * N))
    limbs = [(w >> (16 * k)) & 0xFFFF for k in range(N)]
    if v < 0:
        limbs[N - 1] -= 1 << 16
    for k, d in enumerate(carries):
        limbs[k] += d << 16
        limbs[k + 1] -= d
    return limbs


def edge_limbs(v, rng):
    """Lazy limbs of v near +-2^23: carries of +-EDGE_CARRY."""
    return limbs_of(v, [rng.choice((-EDGE_CARRY, EDGE_CARRY)) for _ in range(N - 1)])


def random_input(rng, B):
    """[12, n, B] lazy limbs: values in (-8p, 8p), carries up to 2^6
    (limbs below 2^23, as the squaring's own outputs)."""
    z = np.zeros((12, N, B), np.int64)
    for i in range(12):
        for lane in range(B):
            z[i, :, lane] = limbs_of(rng.randrange(-8 * P, 8 * P),
                                     [rng.randrange(-64, 65) for _ in range(N - 1)])
    return z.astype(np.int32)


def edge_input(rng, B=6):
    """[12, n, B] lazy limbs at the contract's edges: in lane 2m (value
    +EDGE_VALUE) and 2m + 1 (-EDGE_VALUE) each squaring's (za, zb) is
    (L, L), (L, -L) with L edge limbs, so that y0 + y1 = 8 L: operand values
    near +-256p and limbs near +-2^26; the last two lanes hold the value 0
    and random values up to the edge, with limbs near +-2^23."""
    z = np.zeros((12, N, B), np.int64)
    slot = (0, 4, 3, 2, 1, 5)  # slot of z_i among ((z0, z4, z3), (z2, z1, z5))
    for lane in range(B):
        if lane < B - 2:
            L = np.array(edge_limbs(EDGE_VALUE if lane % 2 == 0 else -EDGE_VALUE, rng))
            for g in range(3):
                za, zb = 2 * slot[2 * g], 2 * slot[2 * g + 1]
                z[za, :, lane], z[za + 1, :, lane] = L, L
                z[zb, :, lane], z[zb + 1, :, lane] = L, -L
        else:
            for i in range(12):
                v = 0 if lane == B - 2 else rng.choice([-1, 1]) * rng.randrange(EDGE_VALUE)
                z[i, :, lane] = edge_limbs(v, rng)
    assert np.abs(z).max() < 1 << 23
    return z.astype(np.int32)


def as_tree(z):
    """[12, n, B] -> the Fq12 tree ((c0, c1) x 3) x 2 of [n, B] arrays."""
    return tuple(tuple((z[6 * h + 2 * s], z[6 * h + 2 * s + 1]) for s in range(3))
                 for h in range(2))


def leaves_np(tree):
    return np.stack([np.asarray(x) for x in tree_leaves(tree)])


@pytest.fixture(scope="module")
def host_body(tmp_path_factory):
    """csrc/cyclo_sq_host_check.cpp built with g++: the kernel's per-lane
    arithmetic, compiled for the host."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to build the host check of the kernel body")
    exe = tmp_path_factory.mktemp("cyclo_sq") / "cyclo_sq_host_check"
    subprocess.run([gxx, "-std=c++17", "-O1", "-o", str(exe),
                    str(K.CSRC / "cyclo_sq_host_check.cpp")], check=True)

    def run(z, depth):
        B = z.shape[2]
        fields = [N, B, depth, SPEC.n0inv32, *SPEC.offset_limbs, *SPEC.p_words,
                  *SPEC.to_mont(1), *z.reshape(-1)]
        out = subprocess.run([str(exe)], input=" ".join(str(int(x)) for x in fields),
                             capture_output=True, text=True, check=True)
        rows = np.array([[int(x) for x in ln.split()] for ln in out.stdout.splitlines()])
        assert rows.shape == (B, 12 * N)
        return rows.reshape(B, 12, N).transpose(1, 2, 0)

    return run


def operand_extremes(z):
    """The largest |limb| and |value| over the 30 products' operands of
    one squaring of z (python integers)."""
    slot = (0, 4, 3, 2, 1, 5)
    co = lambda i, c: z[2 * slot[i] + c].astype(np.int64)  # noqa: E731
    ops = []
    for g in range(3):
        a0, a1, b0, b1 = co(2 * g, 0), co(2 * g, 1), co(2 * g + 1, 0), co(2 * g + 1, 1)
        ops += [a0, a1, b0, b1, a0 + a1, b0 + b1, a0 + b0, a0 - 5 * b1, a1 + b1,
                a1 + b0, a0 + b0 + a1 + b1, a0 - 5 * b1 + a1 + b0]
    limb = max(int(np.abs(x).max()) for x in ops)
    value = max(abs(F.limbs_to_int(x[:, j])) for x in ops for j in range(x.shape[1]))
    return limb, value


@pytest.mark.parametrize("case", ["random", "edges", "chain64"])
def test_kernel_body_limb_exact_on_host(host_body, case):
    rng = random.Random(f"cyclo-{case}")
    z = {"random": lambda: random_input(rng, 8), "edges": lambda: edge_input(rng),
         "chain64": lambda: random_input(rng, 3)}[case]()
    depth = 64 if case == "chain64" else 1
    if case == "edges":
        limb, value = operand_extremes(z)
        assert (1 << 25) < limb < (1 << 26) and 200 * P < value < 256 * P
    got = host_body(z, depth)
    plain = TT.f12_cyclo_sq_plain(tree_from_numpy(as_tree(z), "cpu"))
    ref = as_tree(z)
    for _ in range(depth - 1):
        plain = TT.f12_cyclo_sq_plain(plain)
    np.testing.assert_array_equal(got, leaves_np(tree_to_numpy(plain)))
    for _ in range(depth):
        ref = jtw.f12_cyclo_sq(ref)
    np.testing.assert_array_equal(got, leaves_np(jax.tree.map(np.asarray, ref)))


def test_wrapper_routes_cpu_to_the_composition():
    rng = random.Random(15)
    a = tree_from_numpy(as_tree(random_input(rng, 4)), "cpu")
    F.reset_launches()
    got = TT.f12_cyclo_sq(a)
    want = TT.f12_cyclo_sq_plain(a)
    for x, y in zip(tree_leaves(got), tree_leaves(want)):
        assert torch.equal(x, y)
    assert F.f12_cyclo_sq.launches == 0 and F.mont_mul.launches == 0
    with pytest.raises(ValueError):
        F.f12_cyclo_sq(SPEC, tree_map(lambda x: x.to("meta"), a))
    mixed = ((a[0][0], a[0][1], (a[0][2][0].to("meta"), a[0][2][1])), a[1])
    with pytest.raises(ValueError):
        F.f12_cyclo_sq(SPEC, mixed)


def test_final_exponentiation_takes_316_squarings(monkeypatch):
    """5 chains of 63 squarings (f12_powx by X - 1 twice and X three times)
    and one for m^3: the wrapper's plain route on CPU tensors, 316 calls."""
    calls = []
    plain = TT.f12_cyclo_sq_plain

    def counted(a):
        calls.append(1)
        return plain(a)

    monkeypatch.setattr(TT, "f12_cyclo_sq_plain", counted)
    rng = random.Random(16)
    f = tree_from_numpy(as_tree(random_input(rng, 1)), "cpu")
    F.reset_launches()
    TP.final_exponentiation(f)
    assert len(calls) == 316
    assert F.f12_cyclo_sq.launches == 0

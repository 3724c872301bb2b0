"""The Fq12 multiply's kernel body (csrc/f12_mul.cuh) on the CPU.

The kernel's per-lane arithmetic also compiles for the host
(csrc/f12_mul_host_check.cpp, built with g++ where the machine has one):
its output is held limb for limb against the composition it replaces
(ops/tower.py::f12_mul_plain, the kernel's plain version) and against the
JAX package's f12_mul, on random lazy inputs, on inputs whose pre-added
operands reach the lazy contract's edges, on a square, on operands read as
the wrapper hands them to the kernel (lane-stride-2 slices, a broadcast
lane) and along a chain of 63 squarings, whose result is also checked mod
p. The wrapper's routing and the count of multiplies in each part of the
pairing are checked on CPU tensors; the kernel itself on the card is
tests/test_torch_f12_mul_card.py."""

import random
import shutil
import subprocess

import jax
import numpy as np
import pytest
import torch

from celo_bls_snark_tpu.ops import tower as jtw
from celo_bls_snark_tpu_torch.convert import tree_from_numpy, tree_to_numpy
from celo_bls_snark_tpu_torch.hostmath import fq12 as hfq12
from celo_bls_snark_tpu_torch.ops import field as F
from celo_bls_snark_tpu_torch.ops import kernels as K
from celo_bls_snark_tpu_torch.ops import pairing as TP
from celo_bls_snark_tpu_torch.ops import tower as TT
from celo_bls_snark_tpu_torch.utils.tree import tree_leaves, tree_map
from test_torch_cyclo_sq import as_tree, edge_limbs, leaves_np, random_input

torch.set_num_threads(1)

SPEC = F.FQ
N, P = SPEC.n, SPEC.modulus
# the widest operand sums 8 coefficients ((x0 + x1) + (x0' + x1') at the
# Fq12 and Fq6 levels, c0 + c1 at the Fq2 level): coefficients within these
# keep every operand inside the multiply's contract, |limb| < 2^26 and
# |value| < 256p
EDGE_VALUE = 32 * P - 1
LANES = 6  # every case at one width: the JAX multiply compiles once
jax_f12_mul = jax.jit(jtw.f12_mul)


@pytest.fixture(scope="module")
def host_body(tmp_path_factory):
    """csrc/f12_mul_host_check.cpp built with g++: the kernel's per-lane
    arithmetic, compiled for the host. run(a, b, depth) multiplies a by b
    (b None: squares a `depth` times)."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to build the host check of the kernel body")
    exe = tmp_path_factory.mktemp("f12_mul") / "f12_mul_host_check"
    subprocess.run([gxx, "-std=c++17", "-O1", "-o", str(exe),
                    str(K.CSRC / "f12_mul_host_check.cpp")], check=True)

    def run(a, b=None, depth=1):
        B = a.shape[2]
        z = a if b is None else np.concatenate([a, b])
        fields = [N, B, 1 if b is None else 2, depth, SPEC.n0inv32, *SPEC.offset_limbs,
                  *SPEC.p_words, *z.reshape(-1)]
        out = subprocess.run([str(exe)], input=" ".join(str(int(x)) for x in fields),
                             capture_output=True, text=True, check=True)
        rows = np.array([[int(x) for x in ln.split()] for ln in out.stdout.splitlines()])
        assert rows.shape == (B, 12 * N)
        return rows.reshape(B, 12, N).transpose(1, 2, 0)

    return run


def edge_input(rng, B=LANES):
    """[12, n, B] lazy limbs at the contract's edges: every coefficient of
    lane 2m is L and of lane 2m + 1 is -L, L edge limbs of EDGE_VALUE, so
    that the widest operand sums to +-8 L (value near 256p, limbs near
    2^26)."""
    z = np.zeros((12, N, B), np.int64)
    for lane in range(B):
        L = np.array(edge_limbs(EDGE_VALUE if lane % 2 == 0 else -EDGE_VALUE, rng))
        z[:, :, lane] = L
    return z.astype(np.int32)


def widest_operand(z):
    """The largest |limb| and |value| of the operand row that sums 8
    coefficients (Fq6 pair 2, Fq2 pair 1 + 2, component sum) over lanes."""
    x = z.astype(np.int64)
    w = sum(x[6 * h + 2 * s + c] for h in range(2) for s in (1, 2) for c in range(2))
    return int(np.abs(w).max()), max(abs(F.limbs_to_int(w[:, j])) for j in range(w.shape[1]))


def kernel_reads(operands):
    """The [12, n, B] values the kernel reads from the wrapper's operand
    views: limb k of lane l at data_ptr + k row + l col, in each view's own
    storage."""
    out = []
    for x in operands:
        base = torch.as_strided(x, (x.untyped_storage().nbytes() // 4,), (1,), 0)
        off = (x.data_ptr() - base.data_ptr()) // 4
        out.append(torch.as_strided(base, x.shape, x.stride(), off).numpy())
    return np.stack(out)


def strided_operands(rng, B):
    """a with every leaf a lane-stride-2 slice (the even lanes of a [n, 2B]
    tensor, as the tree product and the pair checks slice a Miller loop's
    output), b with leaf 4 one lane broadcast against [n, B]."""
    wide = random_input(rng, 2 * B)
    a = tuple(tuple((torch.from_numpy(wide[6 * h + 2 * s])[:, 0::2],
                     torch.from_numpy(wide[6 * h + 2 * s + 1])[:, 0::2]) for s in range(3))
              for h in range(2))
    b = tree_from_numpy(as_tree(random_input(rng, B)), "cpu")
    b = ((b[0][0], b[0][1], (b[0][2][0][:, :1], b[0][2][1])), b[1])
    return a, b


def mont_values(z):
    """[12, n, B] Montgomery limbs -> B host Fq12 values (python ints)."""
    rinv = pow(SPEC.mont_r, -1, P)
    out = []
    for lane in range(z.shape[2]):
        c = [F.limbs_to_int(z[i, :, lane]) * rinv % P for i in range(12)]
        out.append(tuple(tuple((c[6 * h + 2 * s], c[6 * h + 2 * s + 1]) for s in range(3))
                         for h in range(2)))
    return out


@pytest.mark.parametrize("case", ["product", "square", "edges", "strided", "chain63"])
def test_kernel_body_limb_exact_on_host(host_body, case):
    rng = random.Random(f"f12-mul-{case}")
    depth = 63 if case == "chain63" else 1
    if case == "strided":
        ta, tb = strided_operands(rng, LANES)
        ops, _ = F.f12_mul.operands(SPEC, (ta, tb))  # views, no copy
        assert ops[0][0].stride(1) == 2 and ops[1][4].stride(1) == 0
        assert ops[1][4].data_ptr() == tb[0][2][0].data_ptr()
        a, b = kernel_reads(ops[0]), kernel_reads(ops[1])
        assert (a == leaves_np(tree_map(lambda x: x.expand(N, LANES), ta))).all()
        assert (b == leaves_np(tree_map(lambda x: x.expand(N, LANES), tb))).all()
    else:
        a = edge_input(rng) if case == "edges" else random_input(rng, LANES)
        b = np.flip(a, axis=2).copy() if case in ("product", "edges") else None
        ta = tree_from_numpy(as_tree(a), "cpu")
        tb = None if b is None else tree_from_numpy(as_tree(b), "cpu")
    if case == "edges":
        limb, value = widest_operand(a)
        assert (1 << 25) < limb < (1 << 26) and 200 * P < value < 256 * P
    got = host_body(a, b, depth)
    plain, ref = ta, as_tree(a)
    for _ in range(depth):
        plain = TT.f12_mul_plain(plain, plain if tb is None else tb)
        ref = jax_f12_mul(ref, ref if b is None else as_tree(b))
    np.testing.assert_array_equal(got, leaves_np(tree_to_numpy(plain)))
    np.testing.assert_array_equal(got, leaves_np(jax.tree.map(np.asarray, ref)))
    if case == "chain63":  # the lazy bound held: the chain is right mod p
        want = mont_values(a)
        for _ in range(depth):
            want = [hfq12.mul(x, x) for x in want]
        assert mont_values(got) == want


def test_wrapper_routes_cpu_to_the_composition():
    rng = random.Random(17)
    a = tree_from_numpy(as_tree(random_input(rng, 4)), "cpu")
    b = tree_from_numpy(as_tree(random_input(rng, 4)), "cpu")
    F.reset_launches()
    for got, want in ((TT.f12_mul(a, b), TT.f12_mul_plain(a, b)),
                      (TT.f12_sq(a), TT.f12_mul_plain(a, a))):
        for x, y in zip(tree_leaves(got), tree_leaves(want)):
            assert torch.equal(x, y)
    assert F.f12_mul.launches == 0 and F.mont_mul.launches == 0
    with pytest.raises(ValueError):
        F.f12_mul(SPEC, tree_map(lambda x: x.to("meta"), a), tree_map(lambda x: x.to("meta"), b))
    mixed = ((a[0][0], a[0][1], (a[0][2][0].to("meta"), a[0][2][1])), a[1])
    with pytest.raises(ValueError):
        F.f12_mul(SPEC, mixed, b)


def _stub_pairing(monkeypatch, calls):
    """Count f12_mul_plain's calls (the wrapper's CPU route) with every
    other Fq12 and point operation of the pairing replaced by a cheap
    stand-in of the same shape."""
    monkeypatch.setattr(TT, "f12_mul_plain", lambda a, b: calls.append(1) or a)
    for name in ("f12_cyclo_sq", "f12_inv", "f12_conj", "f12_frob"):
        monkeypatch.setattr(TT, name, lambda a: a)
    monkeypatch.setattr(TT, "f12_frob_n", lambda a, n: a)
    monkeypatch.setattr(TT, "f12_mul_line", lambda f, *line: f)
    monkeypatch.setattr(TP, "_dbl_step", lambda T, *args: (T, (T[0], T[0], T[0])))
    monkeypatch.setattr(TP, "_add_step", lambda T, *args: (T, (T[0], T[0], T[0])))


@pytest.mark.parametrize("part,lanes,want", [
    ("miller", 1, 63), ("final_exp", 1, 35), ("product", 33, 6), ("product", 2, 1)])
def test_pairing_multiplies(monkeypatch, part, lanes, want):
    """63 squarings of f a Miller loop; 35 multiplies a final
    exponentiation (7 explicit, 28 in f12_powx: 6 set bits of X after the
    first, three chains, 5 of X - 1, two); one a level of the tree product
    (6 levels at 33 lanes, 1 at 2)."""
    calls = []
    _stub_pairing(monkeypatch, calls)
    f = tree_from_numpy(as_tree(random_input(random.Random(lanes), lanes)), "cpu")
    if part == "miller":
        g1 = (f[0][0][0], f[0][0][1])
        TP.miller_loop_batch(g1, (f[0][1], f[0][2]))
    elif part == "final_exp":
        TP.final_exponentiation(f)
    else:
        TP.f12_product(f)
    assert len(calls) == want

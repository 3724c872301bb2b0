"""The port's field arithmetic (celo_bls_snark_tpu_torch/ops/field.py)
against the JAX package's ops/field.py on the CPU, and against the
hostmath python-int oracle.

On the CPU the JAX multiply is mul_conv, the plain reference of the Pallas
multiply kernel; the port's multiply is the plain version of its mont_mul
kernel. Both compute (A B + m p) / R with A = a + 256p, so the limbs must be
equal. The port's REDC follows the Pallas REDC kernel, REDC(x + 256p),
while the JAX CPU path reduces with mul_conv by a raw 1, which may differ
by exactly p: those two are compared mod p and through is_zero_many.

The tensor-core multiply's plain version (_mul_tc_plain) is held limb for
limb against mul_conv at every width, and against the Pallas kernel it
ports (_make_pallas_mul_mxu, jitted in interpret mode) at n = 17 and 25.
At n = 49 the interpreted Pallas kernel does not compile within minutes on
the CPU, so there the comparison is against mul_conv alone.

mont_mul's plain version (_mul_words_plain) runs the kernel's mixed-radix
rounds (32-bit digits, one last 16-bit digit); it is held limb for limb
against mul_conv and the 16-bit-radix plain version, its digits against
m = -A B p^-1 mod R, and the ranges the kernel's word arithmetic relies on
against Python integers. mont_redc's plain version (_redc_words_plain) runs
the same rounds without the a_i B rows; it is held limb for limb against the
16-bit-radix REDC and the kernel's value model, and its digits against
m = -X p^-1 mod R. Where the machine has g++, the CUDA sources' word
arithmetic itself (csrc/field_common.cuh, which also compiles for the host)
is run on the same inputs."""

import ctypes
import functools
import random
import shutil
import subprocess

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import jax_answers
from celo_bls_snark_tpu.ops import field as jf
from celo_bls_snark_tpu_torch.ops import field as tf
from celo_bls_snark_tpu_torch.ops import kernels as tk

# one thread: the plain versions loop over small tensors, and the test
# suite's parallel workers would otherwise contend for every core
torch.set_num_threads(1)

SPECS = [
    pytest.param(jf.FQ, tf.FQ, jf.fq, tf.fq, id="fq377"),
    pytest.param(jf.FR, tf.FR, jf.fr, tf.fr, id="fr253"),
    pytest.param(jf.FQ761, tf.FQ761, jf.fq761, tf.fq761, id="fq761"),
]


def lazy_limbs(n, vals, rng, spread=1 << 9):
    """Signed lazy limbs of the given (possibly negative) values: the
    two's-complement limbs, re-split by random signed carries."""
    arr = np.zeros((n, len(vals)), np.int64)
    for j, v in enumerate(vals):
        w = v % (1 << (16 * n))
        limbs = [(w >> (16 * k)) & 0xFFFF for k in range(n)]
        if v < 0:
            limbs[n - 1] -= 1 << 16
        for k in range(n - 1):
            d = rng.randrange(-spread, spread)
            limbs[k] += d << 16
            limbs[k + 1] -= d
        arr[:, j] = limbs
    assert np.abs(arr).max() < 1 << 26
    return arr.astype(np.int32)


def lazy_inputs(spec, rng, B=48):
    """Random lazy values in (-200p, 200p) plus the edge values 0, 1, p-1."""
    p = spec.modulus
    vals = [0, 1, p - 1] + [rng.randrange(-200 * p, 200 * p) for _ in range(B - 3)]
    return lazy_limbs(spec.n, vals, rng)


def t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def redc_model(spec, limbs):
    """REDC(x + 256p) as python ints, lane by lane."""
    p, R = spec.modulus, 1 << (16 * spec.n)
    pinv = pow(p, -1, R)
    out = []
    for j in range(limbs.shape[1]):
        X = tf.limbs_to_int(limbs[:, j]) + tf.LAZY_P_BUDGET * p
        out.append((X + ((-X * pinv) % R) * p) // R)
    return out


@pytest.mark.parametrize("js,ts,jops,tops", SPECS)
def test_spec_constants_match(js, ts, jops, tops):
    assert ts.n == js.n and ts.mont_r == js.mont_r and ts.mont_r2 == js.mont_r2
    assert ts.n0inv == js.n0inv
    for name in ("p_limbs", "nprime_limbs", "offset_limbs"):
        np.testing.assert_array_equal(getattr(ts, name), getattr(js, name))


@pytest.mark.parametrize("js,ts,jops,tops", SPECS)
def test_pack_unpack_match(js, ts, jops, tops):
    rng = random.Random(1)
    vals = [0, 1, js.modulus - 1] + [rng.randrange(js.modulus) for _ in range(5)]
    packed = ts.pack(vals, "cpu")
    np.testing.assert_array_equal(packed.numpy(), js.pack(vals))
    assert ts.unpack(packed) == vals
    lazy = lazy_inputs(js, rng, 8)
    assert ts.unpack(t(lazy)) == js.unpack(lazy)


@pytest.mark.parametrize("js,ts,jops,tops", SPECS)
def test_mul_limb_exact_against_mul_conv(js, ts, jops, tops):
    rng = random.Random(2)
    a, b = lazy_inputs(js, rng), lazy_inputs(js, rng)
    want = np.asarray(jops.mul_conv(jnp.asarray(a), jnp.asarray(b)))
    got = tops.mul(t(a), t(b)).numpy()
    np.testing.assert_array_equal(got, want)
    assert got.min() >= 0 and got.max() < 1 << 16
    assert all(v < 2 * js.modulus for v in (tf.limbs_to_int(c) for c in got.T))


def test_mul_many_sq_broadcast_match_jax():
    rng = random.Random(3)
    a, b, c = (lazy_inputs(jf.FQ, rng, 6) for _ in range(3))
    one = jf.FQ.const(7, (1,))
    want = jf.fq.mul_many([(a, b), (c, np.asarray(one)), (b, c)])
    got = tf.fq.mul_many([(t(a), t(b)), (t(c), tf.FQ.const(7, (1,), "cpu")),
                          (t(b), t(c))])
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    np.testing.assert_array_equal(tf.fq.sq(t(a)).numpy(),
                                  np.asarray(jf.fq.sq(jnp.asarray(a))))


@pytest.mark.parametrize("js,ts,jops,tops", SPECS)
def test_redc_exact_against_kernel_model(js, ts, jops, tops):
    rng = random.Random(4)
    p = js.modulus
    # lanes 0..3 are lazy zeros (0, p, -p, 5p): the zero test must see them
    vals = [0, p, -p, 5 * p] + [rng.randrange(-200 * p, 200 * p) for _ in range(28)]
    x = lazy_limbs(js.n, vals, rng)
    got = tops.redc_many([t(x)])[0].numpy()
    assert [tf.limbs_to_int(c) for c in got.T] == redc_model(js, x)
    assert got.min() >= 0 and got.max() < 1 << 16
    want = np.asarray(jops.redc_many([jnp.asarray(x)])[0])
    for g, w in zip(got.T, want.T):
        assert tf.limbs_to_int(g) % p == tf.limbs_to_int(w) % p
    np.testing.assert_array_equal(
        tops.is_zero_many([t(x)])[0].numpy(),
        np.asarray(jops.is_zero_many([jnp.asarray(x)])[0]),
    )
    assert tops.is_zero_many([t(x)])[0][:4].all()
    assert [v % p for v in redc_model(js, x)[:4]] == [0] * 4


def test_reduce_canonical_raw_match_jax_and_oracle():
    rng = random.Random(5)
    P = jf.FQ.modulus
    x = lazy_inputs(jf.FQ, rng, 16)
    np.testing.assert_array_equal(tf.fq.to_canonical(t(x)).numpy(),
                                  np.asarray(jf.fq.to_canonical(jnp.asarray(x))))
    vals = [v % P for v in jf.FQ.unpack(x)]
    canon = tf.fq.to_canonical(t(x)).numpy()
    assert [jf.FQ.from_mont(c) for c in canon.T] == vals
    assert all(tf.limbs_to_int(c) < P for c in canon.T)
    raw = tf.fq.to_raw(t(x))
    assert tf.FQ.unpack_raw(raw) == vals
    assert tf.FQ.unpack(tf.fq.from_raw(raw)) == vals
    m = tf.fq.mul(t(x), t(x))
    np.testing.assert_array_equal(tf.fq.reduce_2p(m).numpy(),
                                  np.asarray(jf.fq.reduce_2p(jnp.asarray(m.numpy()))))


def test_pow_inv_legendre_against_oracle():
    rng = random.Random(6)
    P = jf.FQ.modulus
    vals = [0, 1, P - 1] + [rng.randrange(P) for _ in range(5)]
    a = tf.FQ.pack(vals, "cpu")
    assert tf.FQ.unpack(tf.fq.inv(a)) == [pow(v, P - 2, P) for v in vals]
    for e in (0, 5, 200, 0xDEADBEEF12345):
        assert tf.FQ.unpack(tf.fq.pow_const(a, e)) == [pow(v, e, P) for v in vals]
    want = [pow(v, (P - 1) // 2, P) == 1 for v in vals]
    assert tf.fq.legendre_is_qr(a).tolist() == want
    # limb-exact against the JAX windowed pow on one exponent
    e = (1 << 40) + 12345
    np.testing.assert_array_equal(
        tf.fq.pow_const(a, e).numpy(),
        np.asarray(jf.fq.pow_const(jnp.asarray(a.numpy()), e)),
    )


def test_lazy_ops_and_select_match_jax():
    rng = random.Random(7)
    a, b = lazy_inputs(jf.FQ, rng, 8), lazy_inputs(jf.FQ, rng, 8)
    c = np.array([True, False] * 4)
    pairs = [
        (tf.fq.add(t(a), t(b)), jf.fq.add(a, b)),
        (tf.fq.sub(t(a), t(b)), jf.fq.sub(a, b)),
        (tf.fq.neg(t(a)), jf.fq.neg(a)),
        (tf.fq.mul_small(t(a), 12), jf.fq.mul_small(jnp.asarray(a), 12)),
        (tf.fq.select(torch.from_numpy(c), t(a), t(b)), jf.fq.select(c, a, b)),
    ]
    for g, w in pairs:
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    with pytest.raises(AssertionError):
        tf.fq.mul_small(t(a), 13)


def test_wrappers_route_cpu_to_plain_and_count_only_launches():
    rng = random.Random(8)
    a = t(lazy_inputs(jf.FQ, rng, 4))
    tf.reset_launches()
    tf.fq.mul(a, a)
    tf.fq.is_zero(a)
    with tf.mul_kernel("tc"):
        tf.fq.mul(a, a)
    tf.mont_mul_shape(tf.FQ, a, a, 64)
    assert [k.name for k in tf.KERNELS] == [
        "mont_mul", "mont_redc", "mont_mul_tc", "mont_mul_shape", "f12_cyclo_sq",
        "f12_mul"]
    assert [k.launches for k in tf.KERNELS] == [0, 0, 0, 0, 0, 0]
    with pytest.raises(ValueError):
        tf.mont_mul(tf.FQ, a.to(torch.int64), a.to(torch.int64))
    with pytest.raises(ValueError):
        tf.mont_redc(tf.FQ, a.to("meta"))


@pytest.mark.parametrize("js,ts,jops,tops", SPECS)
def test_mul_tc_plain_limb_exact_against_mul_conv(js, ts, jops, tops):
    rng = random.Random(10)
    a, b = lazy_inputs(js, rng), lazy_inputs(js, rng)
    want = np.asarray(jops.mul_conv(jnp.asarray(a), jnp.asarray(b)))
    got = tf._mul_tc_plain(ts, t(a), t(b)).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, tf._mul_plain(ts, t(a), t(b)).numpy())
    with tf.mul_kernel("tc"):
        np.testing.assert_array_equal(tops.mul(t(a), t(b)).numpy(), want)


PALLAS_MXU_SPECS = {"fq377": jf.FQ, "fr253": jf.FR}


def pallas_mxu_inputs(name):
    """B = 128 (the Pallas kernel takes blocks of 128 lanes), lazy inputs
    with the edge values 0, 1 and p-1 in the first lanes."""
    rng = random.Random(11)
    js = PALLAS_MXU_SPECS[name]
    return name, lazy_inputs(js, rng, 128), lazy_inputs(js, rng, 128)


def pallas_mxu_jax(inputs):
    name, a, b = inputs
    js = PALLAS_MXU_SPECS[name]
    pallas = jax.jit(jf._make_pallas_mul_mxu(js, interpret=True))
    return {"out": [np.asarray(pallas(jnp.asarray(a), jnp.asarray(b)))]}


# the Pallas kernel's interpreted output over Fq377, recorded
# (tests/jax_answers.py): it compiles for about 45 s on the CPU; over Fr253,
# about 12 s, it stays live
REC = jax_answers.Recordings(__name__, {
    "pallas_mxu_fq377": (functools.partial(pallas_mxu_inputs, "fq377"), pallas_mxu_jax)})


@pytest.mark.parametrize("js,ts,jops,tops", SPECS[:2])
def test_mul_tc_plain_limb_exact_against_pallas_mxu_interpret(js, ts, jops, tops):
    inputs = pallas_mxu_inputs("fq377" if js is jf.FQ else "fr253")
    _, a, b = inputs
    want = REC.answers(f"pallas_mxu_{inputs[0]}", inputs, pallas_mxu_jax)["out"][0]
    np.testing.assert_array_equal(tf._mul_tc_plain(ts, t(a), t(b)).numpy(), want)


@pytest.mark.parametrize("js,ts,jops,tops", SPECS)
def test_tc_weights_are_the_toeplitz_matrices_of_nprime_and_p(js, ts, jops, tops):
    """W1 x pieces(x) are the radix-2^8 columns of x N' mod R and W2 x
    pieces(m) those of m p, for python ints; the padded form the kernel
    reads only adds zero rows and columns."""
    rng = random.Random(12)
    n, R = ts.n, 1 << (16 * ts.n)
    W1, W2 = tf.tc_weights(ts)
    assert W1.shape == (2 * n, 2 * n) and W2.shape == (4 * n, 2 * n)
    nprime = tf.limbs_to_int(ts.nprime_limbs)
    for x in (0, 1, R - 1, rng.randrange(R)):
        pieces = np.array([(x >> (8 * k)) & 0xFF for k in range(2 * n)], np.int64)
        col = lambda W: sum(int(v) << (8 * k) for k, v in enumerate(W.astype(np.int64) @ pieces))  # noqa: E731
        assert col(W1) % R == x * nprime % R
        assert col(W2) == x * ts.modulus
    P1, P2 = tf.tc_weights(ts, rows_to=16, depth_to=32)
    assert P1.shape[0] % 16 == 0 and P2.shape[0] % 16 == 0 and P1.shape[1] % 32 == 0
    np.testing.assert_array_equal(P1[: 2 * n, : 2 * n], W1)
    np.testing.assert_array_equal(P2[: 4 * n, : 2 * n], W2)
    assert P1.sum() == W1.sum() and P2.sum() == W2.sum()


def test_mul_kernel_selector(monkeypatch):
    """`mul` reads one module-level choice: mont_mul by default, the
    tensor-core multiply with CELO_MUL_MXU=1 at first use (as in the JAX
    package) or inside mul_kernel("tc")."""
    monkeypatch.setattr(tf, "_mul_choice", None)
    monkeypatch.delenv("CELO_MUL_MXU", raising=False)
    assert tf.selected_mul() is tf.mont_mul
    with tf.mul_kernel("tc"):
        assert tf.selected_mul() is tf.mont_mul_tc
        with tf.mul_kernel("cios"):
            assert tf.selected_mul() is tf.mont_mul
        assert tf.selected_mul() is tf.mont_mul_tc
    assert tf.selected_mul() is tf.mont_mul
    monkeypatch.setattr(tf, "_mul_choice", None)
    monkeypatch.setenv("CELO_MUL_MXU", "1")
    assert tf.selected_mul() is tf.mont_mul_tc
    with pytest.raises(ValueError):
        with tf.mul_kernel("mxu"):
            pass
    assert tf.ops_for(tf.FQ761) is tf.fq761 and tf.ops_for(tf.FR) is tf.fr


def test_mont_mul_shape_routes_and_validates():
    rng = random.Random(13)
    a, b = t(lazy_inputs(jf.FQ, rng, 8)), t(lazy_inputs(jf.FQ, rng, 8))
    want = tf._mul_words_plain(tf.FQ, a, b).numpy()
    np.testing.assert_array_equal(want, tf._mul_plain(tf.FQ, a, b).numpy())
    for threads in (32, 64, 128, 256, 512):
        np.testing.assert_array_equal(
            tf.mont_mul_shape(tf.FQ, a, b, threads).numpy(), want)
    with pytest.raises(ValueError):
        tf.mont_mul_shape(tf.FQ, a, b, 96)
    x = t(lazy_inputs(jf.FR, rng, 8))
    with pytest.raises(ValueError):
        tf.mont_mul_shape(tf.FR, x, x, 128)


def edge_inputs(spec, rng, B=40):
    """Lazy limbs (signed carries) of a pair of value lists that stress the
    mixed radix: 0, 1, p - 1, the budget's ends +-255p and +-(256p - 1),
    values whose canonical top limb is nonzero, then random values."""
    p = spec.modulus
    edge = [0, 1, p - 1, 255 * p, -255 * p, 256 * p - 1, -(256 * p - 1),
            200 * p + 1, p, -p]
    va = edge + [rng.randrange(-256 * p + 1, 256 * p) for _ in range(B - len(edge))]
    vb = edge[::-1] + [rng.randrange(-256 * p + 1, 256 * p) for _ in range(B - len(edge))]
    return va, vb, lazy_limbs(spec.n, va, rng), lazy_limbs(spec.n, vb, rng)


@pytest.mark.parametrize("js,ts,jops,tops", SPECS)
def test_mul_words_plain_limb_exact(js, ts, jops, tops):
    """mont_mul's plain version against mul_conv on JAX-CPU, against the
    16-bit-radix plain version and against the integer model."""
    rng = random.Random(15)
    va, vb, a, b = edge_inputs(js, rng)
    got = tf._mul_words_plain(ts, t(a), t(b)).numpy()
    np.testing.assert_array_equal(
        got, np.asarray(jops.mul_conv(jnp.asarray(a), jnp.asarray(b))))
    np.testing.assert_array_equal(got, tf._mul_plain(ts, t(a), t(b)).numpy())
    np.testing.assert_array_equal(got, tf.mont_mul(ts, t(a), t(b)).numpy())
    p, R = js.modulus, 1 << (16 * js.n)
    for j, (x, y) in enumerate(zip(va, vb)):
        X = (x + 256 * p) * (y + 256 * p)
        want = (X + ((-X * pow(p, -1, R)) % R) * p) // R
        assert tf.limbs_to_int(got[:, j]) == want < 2 * p
    assert got.min() >= 0 and got.max() < 1 << 16


@pytest.mark.parametrize("js,ts,jops,tops", SPECS)
def test_mixed_radix_digits_concatenate_to_m(js, ts, jops, tops):
    """n // 2 digits of 32 bits and one of 16: together m = -A B p^-1 mod
    R, the same m as a 16-bit-radix reduction computes."""
    rng = random.Random(16)
    va, vb, a, b = edge_inputs(js, rng)
    digits = []
    tf._mul_words_plain(ts, t(a), t(b), digits)
    assert len(digits) == ts.n // 2 + 1 == ts.n_words
    p, R = js.modulus, 1 << (16 * js.n)
    for j, (x, y) in enumerate(zip(va, vb)):
        m = sum(int(d[j]) << (32 * i) for i, d in enumerate(digits))
        assert int(digits[-1][j]) < 1 << 16
        assert m == (-(x + 256 * p) * (y + 256 * p) * pow(p, -1, R)) % R


@pytest.mark.parametrize("js,ts,jops,tops", SPECS)
def test_word_constants_against_python_integers(js, ts, jops, tops):
    p, n = ts.modulus, ts.n
    assert n % 2 == 1 and ts.n_words == (n + 1) // 2
    assert (ts.n0inv32 * p + 1) % (1 << 32) == 0 and 0 < ts.n0inv32 < 1 << 32
    assert ts.n0inv32 & 0xFFFF == ts.n0inv
    assert sum(int(w) << (32 * j) for j, w in enumerate(ts.p_words)) == p
    assert int(ts.p_words[-1]) == 0  # the guard limb: p has W - 1 words
    c = tk.FieldConstants(ts)
    assert c.args[0] == n
    assert ctypes.sizeof(tk.FieldConsts) == 4 * (49 + 25 + 1)
    assert tk.FieldConsts.pw.offset == 0  # the word pairs start 8-byte aligned
    assert list(c.consts.offset)[:n] == [int(x) for x in ts.offset_limbs]
    assert list(c.consts.pw)[: ts.n_words] == [int(w) for w in ts.p_words]
    assert not any(list(c.consts.offset)[n:]) and not any(list(c.consts.pw)[ts.n_words:])
    assert c.consts.n0inv32 == ts.n0inv32


def redc_edge_inputs(spec, rng, B=40):
    """Lazy limbs (signed carries) of values for REDC: the lazy zeros 0, p,
    -p, 5p, the budget's ends +-(256p - 1) and +-255p, 1, p - 1, then
    random values in the budget."""
    p = spec.modulus
    edge = [0, p, -p, 5 * p, 256 * p - 1, -(256 * p - 1), 255 * p, -255 * p, 1, p - 1]
    vals = edge + [rng.randrange(-256 * p + 1, 256 * p) for _ in range(B - len(edge))]
    return vals, lazy_limbs(spec.n, vals, rng)


@pytest.mark.parametrize("js,ts,jops,tops", SPECS)
def test_redc_words_plain_limb_exact(js, ts, jops, tops):
    """mont_redc's plain version against the 16-bit-radix REDC, the kernel's
    value model and, mod p and through is_zero_many, JAX-CPU's redc_many."""
    rng = random.Random(19)
    vals, x = redc_edge_inputs(js, rng)
    got = tf._redc_words_plain(ts, t(x)).numpy()
    np.testing.assert_array_equal(got, tf._redc_plain(ts, t(x)).numpy())
    np.testing.assert_array_equal(got, tf.mont_redc(ts, t(x)).numpy())
    assert [tf.limbs_to_int(c) for c in got.T] == redc_model(js, x)
    assert got.min() >= 0 and got.max() < 1 << 16
    p = js.modulus
    assert all(tf.limbs_to_int(c) < 2 * p for c in got.T)
    want = np.asarray(jops.redc_many([jnp.asarray(x)])[0])
    for g, w in zip(got.T, want.T):
        assert tf.limbs_to_int(g) % p == tf.limbs_to_int(w) % p
    zero = tops.is_zero_many([t(x)])[0].numpy()
    np.testing.assert_array_equal(zero, np.asarray(jops.is_zero_many([jnp.asarray(x)])[0]))
    assert zero.tolist() == [v % p == 0 for v in vals]


@pytest.mark.parametrize("js,ts,jops,tops", SPECS)
def test_redc_digits_concatenate_to_m(js, ts, jops, tops):
    """REDC's n // 2 digits of 32 bits and one of 16 concatenate to
    m = -X p^-1 mod R, X = x + 256p."""
    rng = random.Random(20)
    vals, x = redc_edge_inputs(js, rng)
    digits = []
    tf._redc_words_plain(ts, t(x), digits)
    assert len(digits) == ts.n_words
    p, R = js.modulus, 1 << (16 * js.n)
    for j, v in enumerate(vals):
        m = sum(int(d[j]) << (32 * i) for i, d in enumerate(digits))
        assert int(digits[-1][j]) < 1 << 16
        assert m == (-(v + 256 * p) * pow(p, -1, R)) % R


def word_rounds(spec, A, Bv):
    """The kernel's rounds on Python integers: per round the sum before
    the shift and t after it; then the last round's sum and the result."""
    p, W = spec.modulus, spec.n_words
    t, trace = 0, []
    for i in range(W - 1):
        s = t + ((A >> (32 * i)) & 0xFFFFFFFF) * Bv
        s += ((s * spec.n0inv32) & 0xFFFFFFFF) * p
        assert s % (1 << 32) == 0
        t = s >> 32
        trace.append((s, t))
    s = t + (A >> (32 * (W - 1))) * Bv
    s += ((s * spec.n0inv) & 0xFFFF) * p
    assert s % (1 << 16) == 0
    return trace, s, s >> 16


@pytest.mark.parametrize("js,ts,jops,tops", SPECS)
def test_word_rounds_stay_in_range(js, ts, jops, tops):
    """What the kernel's registers rely on: with A, B < 512p the running
    sum t fits W words between rounds (t < 514p, no carry word), a round's
    sum fits W + 1 words, the last round's sum fits W words, A's top word is
    a half word, and the result is below 2p."""
    rng = random.Random(17)
    p, W, R = ts.modulus, ts.n_words, 1 << (16 * ts.n)
    top = 512 * p - 1
    assert top < R and top >> (32 * (W - 1)) < 1 << 16
    assert 514 * p < 1 << (32 * W - 23) and (1 << 18) * p < R
    ones = (1 << (top.bit_length() - 1)) - 1  # all words 0xFFFFFFFF below the top
    ends = [1, top, ones, 256 * p, p + 256 * p - 1]
    pairs = [(x, y) for x in ends for y in ends]
    pairs += [(rng.randrange(1, top + 1), rng.randrange(1, top + 1)) for _ in range(200)]
    for A, Bv in pairs:
        trace, last, out = word_rounds(ts, A, Bv)
        for s, tt in trace:
            assert s < 1 << (32 * (W + 1)) and tt < 514 * p < 1 << (32 * W)
        assert last < 1 << (32 * W)
        assert out < 2 * p and out == (A * Bv + ((-A * Bv * pow(p, -1, R)) % R) * p) // R


@pytest.mark.parametrize("js,ts,jops,tops", SPECS)
def test_redc_word_rounds_stay_in_range(js, ts, jops, tops):
    """What mont_redc's registers rely on: from X < 512p, t < 513p fits W
    words between rounds, a round's sum fits W + 1 words, the last round's
    sum fits W words, and the result is (X + m p) / R < 2p."""
    rng = random.Random(21)
    p, W, R = ts.modulus, ts.n_words, 1 << (16 * ts.n)
    top = 512 * p - 1
    ones = (1 << (top.bit_length() - 1)) - 1
    for X in [0, 1, p, top, ones, 256 * p] + [rng.randrange(top + 1) for _ in range(200)]:
        tt = X
        for i in range(W - 1):
            s = tt + ((tt * ts.n0inv32) & 0xFFFFFFFF) * p
            assert s % (1 << 32) == 0 and s < 1 << (32 * (W + 1))
            tt = s >> 32
            assert tt < 513 * p < 1 << (32 * W)
        s = tt + ((tt * ts.n0inv) & 0xFFFF) * p
        assert s % (1 << 16) == 0 and s < 1 << (32 * W)
        assert s >> 16 < 2 * p
        assert s >> 16 == (X + ((-X * pow(p, -1, R)) % R) * p) // R


@pytest.fixture(scope="module")
def host_check(tmp_path_factory):
    """csrc/host_check.cpp built with g++: the CUDA sources' word
    arithmetic, compiled for the host."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to build the host check of the word arithmetic")
    exe = tmp_path_factory.mktemp("host_check") / "host_check"
    subprocess.run([gxx, "-std=c++17", "-O1", "-o", str(exe),
                    str(tk.CSRC / "host_check.cpp")], check=True)
    return exe


@pytest.mark.parametrize("js,ts,jops,tops", SPECS)
def test_cuda_word_arithmetic_on_the_host(js, ts, jops, tops, host_check):
    """load_words, the mixed-radix rounds, the full word product and REDC
    of csrc/field_common.cuh, run on the host: the product's limbs equal
    mul_conv's, the digits equal the plain version's, the full product
    equals Python's; REDC's limbs equal the integer model's and its digits
    the plain version's."""
    rng = random.Random(18)
    va, vb, a, b = edge_inputs(js, rng, 24)
    n, B, p, W = ts.n, len(va), ts.modulus, ts.n_words
    fields = [n, B, ts.n0inv32, *ts.offset_limbs, *ts.p_words,
              *a.reshape(-1), *b.reshape(-1)]
    run = subprocess.run([str(host_check)], input=" ".join(str(int(x)) for x in fields),
                         capture_output=True, text=True, check=True)
    rows = np.array([[int(x) for x in ln.split()] for ln in run.stdout.splitlines()],
                    dtype=np.int64)
    assert rows.shape == (B, n + W + 2 * n + n + W)
    want = np.asarray(jops.mul_conv(jnp.asarray(a), jnp.asarray(b)))
    np.testing.assert_array_equal(rows[:, :n].T, want)
    digits = []
    tf._mul_words_plain(ts, t(a), t(b), digits)
    np.testing.assert_array_equal(rows[:, n : n + ts.n_words].T,
                                  torch.stack(digits).numpy())
    for j, (x, y) in enumerate(zip(va, vb)):
        assert tf.limbs_to_int(rows[j, n + W : 3 * n + W]) == (x + 256 * p) * (y + 256 * p)
    redc = rows[:, 3 * n + W : 4 * n + W]
    assert [tf.limbs_to_int(r) for r in redc] == redc_model(js, a)
    digits = []
    tf._redc_words_plain(ts, t(a), digits)
    np.testing.assert_array_equal(rows[:, 4 * n + W :].T, torch.stack(digits).numpy())


def test_prof_field_sweep_rows_on_cpu():
    """The launch-shape sweep's rows without a card: five block sizes of
    mont_mul's kernel, each built for 512 threads an SM, and mont_mul
    beside them (its own 128-thread instance), all the same limbs."""
    from celo_bls_snark_tpu_torch.scripts import prof_field

    rows = prof_field.sweep(B=8, device="cpu")
    assert [r["threads"] for r in rows] == [32, 64, 128, 256, 512, None]
    assert [r["kernel"] for r in rows] == [
        "mont_mul_kernel<25,32,16>", "mont_mul_kernel<25,64,8>",
        "mont_mul_kernel<25,128,4>", "mont_mul_kernel<25,256,2>",
        "mont_mul_kernel<25,512,1>", "mont_mul_kernel<25,128,4>"]
    assert all(r["equal"] for r in rows)
    # every instance the sweep names is one that csrc/field.cu launches
    src = (tk.CSRC / "field.cu").read_text()
    for th in tk.SHAPE_THREADS:
        assert f"mont_mul_kernel<25, {th}, {512 // th}><<<grid, {th}, 0, s>>>" in src
    assert "mont_mul_kernel<N, kThreads, 4><<<" in src


def test_prof_variants_edits_still_apply():
    """Every variant of scripts/prof_variants.py is a textual edit of
    csrc/: each must still find its place in the sources."""
    from celo_bls_snark_tpu_torch.scripts import prof_variants

    assert "shipped" in prof_variants.VARIANTS
    for name, (edits, which, _) in prof_variants.VARIANTS.items():
        assert set(which) <= {"mul", "redc", "tc"}
        for fname, edit in edits.items():
            text = (tk.CSRC / fname).read_text()
            assert edit(text) != text, name


def test_compiler_report_parsers():
    ptxas = (
        "ptxas info    : Compiling entry function "
        "'_ZN40_GLOBAL__N__ee97de1a_8_field_cu_16e478ab15mont_mul_kernelILi49EEEvPKiS2_PilN4celo11FieldConstsE' for 'sm_90a'\n"
        "ptxas info    : Function properties for _ZN40_X\n"
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads\n"
        "ptxas info    : Used 128 registers, used 0 barriers\n"
        "ptxas info    : Compiling entry function "
        "'_ZN40_GLOBAL__N__ee97de1a_8_field_cu_16e478ab15mont_mul_kernelILi25ELi32ELi16EEEvPKiS2_PilN4celo11FieldConstsE' for 'sm_90a'\n"
        "    8 bytes stack frame, 8 bytes spill stores, 12 bytes spill loads\n"
        "ptxas info    : Used 96 registers, used 0 barriers, 16 bytes smem\n"
        "ptxas info    : Compiling entry function "
        "'_ZN40_GLOBAL__N__ee97de1a_8_field_cu_16e478ab16mont_redc_kernelILi17EEEvPKiPilN4celo11FieldConstsE' for 'sm_90a'\n"
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads\n"
        "ptxas info    : Used 40 registers, used 0 barriers\n"
        "ptxas info    : Compiling entry function "
        "'_ZN46_GLOBAL__N__3b1c2d4e_11_cyclo_sq_cu_5f6a7b8c19f12_cyclo_sq_kernelILi25ELi8EEEvNS_6Fq12InEPilN4celo11FieldConstsE' for 'sm_90a'\n"
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads\n"
        "ptxas info    : Used 64 registers, used 1 barriers, 42080 bytes smem\n"
    )
    rep = tk.ptxas_report(ptxas)
    assert rep["mont_mul_kernel<49>"] == {
        "stack": 0, "spill_stores": 0, "spill_loads": 0, "registers": 128, "smem": 0}
    assert rep["mont_mul_kernel<25,32,16>"] == {
        "stack": 8, "spill_stores": 8, "spill_loads": 12, "registers": 96, "smem": 16}
    assert rep["mont_redc_kernel<17>"]["registers"] == 40
    assert rep["f12_cyclo_sq_kernel<25,8>"] == {
        "stack": 0, "spill_stores": 0, "spill_loads": 0, "registers": 64, "smem": 42080}
    sass = (
        "\t\tFunction : _ZN40_GLOBAL__N__ee97de1a_8_field_cu_16e478ab15mont_mul_kernelILi49EEEvPKiS2_PilN4celo11FieldConstsE\n"
        "        /*0000*/                   LDC R1, c[0x0][0x28] ;\n"
        "        /*0010*/                   IMAD.WIDE.U32 R6, P0, R21, R18, R6 ;\n"
        "        /*0020*/                   IMAD.WIDE.U32.X R8, P0, R19, R18, R8, P0 ;\n"
        "        /*0030*/              @P0  IADD3.X R0, RZ, RZ, R0, P1, P0 ;\n"
        "        /*10040*/                   IMMA.16832.U8.U8 R4, R8.ROW, R2.COL, R4 ;\n"
    )
    assert tk.sass_count("IMAD.WIDE.U32.X", sass) == 1
    assert tk.sass_count("IMAD.WIDE.U32", sass) == 2
    assert tk.sass_count("IMMA", sass) == 1
    hist = tk.sass_histogram(sass)["mont_mul_kernel<49>"]
    assert hist["instructions"] == 5
    assert dict(hist["top"])["IMAD.WIDE"] == 2 and dict(hist["top"])["IADD3.X"] == 1


@pytest.mark.gpu
@pytest.mark.parametrize("js,ts,jops,tops", SPECS)
def test_mul_tc_equals_plain_and_mont_mul_on_card(js, ts, jops, tops):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    rng = random.Random(14)
    a = t(lazy_inputs(js, rng, 300)).cuda()
    b = t(lazy_inputs(js, rng, 300)).cuda()
    before = tf.mont_mul_tc.launches
    got = tf.mont_mul_tc(ts, a, b)
    np.testing.assert_array_equal(got.cpu().numpy(),
                                  tf._mul_tc_plain(ts, a.cpu(), b.cpu()).numpy())
    assert torch.equal(got, tf.mont_mul(ts, a, b))
    assert tf.mont_mul_tc.launches == before + 1


@pytest.mark.gpu
@pytest.mark.parametrize("js,ts,jops,tops", SPECS)
def test_kernels_equal_plain_on_card(js, ts, jops, tops):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    rng = random.Random(9)
    a = t(lazy_inputs(js, rng, 300)).cuda()
    b = t(lazy_inputs(js, rng, 300)).cuda()
    before = tf.mont_mul.launches
    got = tf.mont_mul(ts, a, b).cpu().numpy()
    np.testing.assert_array_equal(got, tf._mul_words_plain(ts, a.cpu(), b.cpu()).numpy())
    np.testing.assert_array_equal(got, tf._mul_plain(ts, a.cpu(), b.cpu()).numpy())
    redc = tf.mont_redc(ts, a).cpu().numpy()
    np.testing.assert_array_equal(redc, tf._redc_words_plain(ts, a.cpu()).numpy())
    np.testing.assert_array_equal(redc, tf._redc_plain(ts, a.cpu()).numpy())
    assert tf.mont_mul.launches == before + 1
    if ts.n == 25:
        for threads in tk.SHAPE_THREADS:
            np.testing.assert_array_equal(
                tf.mont_mul_shape(ts, a, b, threads).cpu().numpy(), got)

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
the CPU, so there the comparison is against mul_conv alone."""

import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from celo_bls_snark_tpu.ops import field as jf
from celo_bls_snark_tpu_torch.ops import field as tf

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
        "mont_mul", "mont_redc", "mont_mul_tc", "mont_mul_shape"]
    assert [k.launches for k in tf.KERNELS] == [0, 0, 0, 0]
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


@pytest.mark.parametrize("js,ts,jops,tops", SPECS[:2])
def test_mul_tc_plain_limb_exact_against_pallas_mxu_interpret(js, ts, jops, tops):
    """The Pallas kernel takes blocks of 128 lanes: B = 128, lazy inputs
    with the edge values 0, 1 and p-1 in the first lanes."""
    rng = random.Random(11)
    a, b = lazy_inputs(js, rng, 128), lazy_inputs(js, rng, 128)
    pallas = jax.jit(jf._make_pallas_mul_mxu(js, interpret=True))
    want = np.asarray(pallas(jnp.asarray(a), jnp.asarray(b)))
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
    for threads in (32, 64, 128, 256, 512):
        np.testing.assert_array_equal(
            tf.mont_mul_shape(tf.FQ, a, b, threads).numpy(),
            tf._mul_plain(tf.FQ, a, b).numpy())
    with pytest.raises(ValueError):
        tf.mont_mul_shape(tf.FQ, a, b, 96)
    x = t(lazy_inputs(jf.FR, rng, 8))
    with pytest.raises(ValueError):
        tf.mont_mul_shape(tf.FR, x, x, 128)


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
    np.testing.assert_array_equal(tf.mont_mul(ts, a, b).cpu().numpy(),
                                  tf._mul_plain(ts, a.cpu(), b.cpu()).numpy())
    np.testing.assert_array_equal(tf.mont_redc(ts, a).cpu().numpy(),
                                  tf._redc_plain(ts, a.cpu()).numpy())
    assert tf.mont_mul.launches == before + 1

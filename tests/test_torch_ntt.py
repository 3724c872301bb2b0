"""The port's NTT (celo_bls_snark_tpu_torch/ops/ntt.py) limb for limb
against the JAX package's ops/ntt.py on the CPU, on both fields (BLS12-377
Fr and BW6-761 Fr), and against the host fft/ifft of snark/groth16.py.

The JAX package's large-N paths (four-step, gather) run only on its
accelerator; on the CPU both sides run the radix-2 reshape butterfly, and
the port runs it at every N. Integer work: the tolerance is 0."""

import functools
import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import jax_answers
from celo_bls_snark_tpu.ops import field as jf
from celo_bls_snark_tpu.ops import ntt as jntt
from celo_bls_snark_tpu.snark import api as japi
from celo_bls_snark_tpu.snark import groth16 as jg16
from celo_bls_snark_tpu_torch.ops import field as tf
from celo_bls_snark_tpu_torch.ops import ntt as tntt
from celo_bls_snark_tpu_torch.snark import api as tapi
from celo_bls_snark_tpu_torch.snark import groth16 as tg16

# one thread: the plain versions loop over small tensors, and the test
# suite's parallel workers would otherwise contend for every core
torch.set_num_threads(1)

FIELDS = {
    "bls_fr": (jntt.ntt_fr, tntt.ntt_fr, jf.FR, tf.FR, jg16.BLS12_377_ENGINE,
               tg16.BLS12_377_ENGINE),
    "bw6_fr": (jntt.ntt_bw6, tntt.ntt_bw6, jf.FQ, tf.FQ, japi.BW6_761_ENGINE,
               tapi.BW6_761_ENGINE),
}
# few distinct sizes: on the JAX side every new N compiles its stages anew
CASES = [("bls_fr", 8), ("bls_fr", 64), ("bls_fr", 1024),
         ("bw6_fr", 8), ("bw6_fr", 1024)]


def values(r, N, seed):
    rng = random.Random(seed)
    return [0, 1, r - 1] + [rng.randrange(r) for _ in range(N - 3)]


def test_engines_and_roots_match():
    for jn, tn, _, _, jeng, teng in FIELDS.values():
        assert (teng.name, teng.fr, teng.two_adicity, teng.fr_generator) == \
            (jeng.name, jeng.fr, jeng.two_adicity, jeng.fr_generator)
        for N in (2, 8, 1 << 20):
            assert tn.root_fn(N) == jn.root_fn(N)


COSET_CASES = [("bls_fr", 64), ("bw6_fr", 8), ("bw6_fr", 1024)]


def ntt_inputs(field, N, coset):
    eng = FIELDS[field][5]
    return field, values(eng.fr, N, 100 + N if coset else N), coset


def ntt_jax(inputs):
    """The forward transform of the packed values and the inverse of its
    output: (coset_)ntt, then (coset_)intt."""
    field, vals, coset = inputs
    jn, js, g = FIELDS[field][0], FIELDS[field][2], FIELDS[field][5].fr_generator
    x = jnp.asarray(js.pack(vals))
    fwd = jn.coset_ntt(x, g) if coset else jn.ntt(x)
    back = jn.coset_intt(fwd, g) if coset else jn.ntt(fwd, inverse=True)
    return {"fwd": [np.asarray(fwd)], "back": [np.asarray(back)]}


# the JAX package's 1024-point transforms, recorded (tests/jax_answers.py):
# they compile for 40-50 s a case on the CPU; the smaller ones, about 30 s
# or less, stay live
REC = jax_answers.Recordings(__name__, {
    **{f"ntt_{f}_1024": (functools.partial(ntt_inputs, f, 1024, False), ntt_jax)
       for f in ("bls_fr", "bw6_fr")},
    "coset_bw6_fr_1024": (functools.partial(ntt_inputs, "bw6_fr", 1024, True), ntt_jax)})


@pytest.mark.parametrize("field,N", CASES)
def test_ntt_and_inverse_limb_exact(field, N):
    _, tn, js, ts, _, eng = FIELDS[field]
    inputs = ntt_inputs(field, N, False)
    vals = inputs[1]
    want = REC.answers(f"ntt_{field}_{N}", inputs, ntt_jax)
    x = js.pack(vals)
    got = tn.ntt(torch.from_numpy(x))
    np.testing.assert_array_equal(got.numpy(), want["fwd"][0])
    omega = tg16._root_of_unity(eng, N)
    assert ts.unpack(got) == tg16.fft(vals, omega, eng.fr)
    # the JAX package's inverse of its own output, which equals got
    back = tn.ntt(got, inverse=True)
    np.testing.assert_array_equal(back.numpy(), want["back"][0])
    assert ts.unpack(back) == vals
    assert ts.unpack(tn.ntt(torch.from_numpy(x), inverse=True)) == \
        tg16.ifft(vals, omega, eng.fr)


@pytest.mark.parametrize("field,N", COSET_CASES)
def test_coset_ntt_limb_exact(field, N):
    _, tn, js, ts, _, eng = FIELDS[field]
    r, g = eng.fr, eng.fr_generator
    inputs = ntt_inputs(field, N, True)
    vals = inputs[1]
    want = REC.answers(f"coset_{field}_{N}", inputs, ntt_jax)
    x = js.pack(vals)
    got = tn.coset_ntt(torch.from_numpy(x), g)
    np.testing.assert_array_equal(got.numpy(), want["fwd"][0])
    omega = tg16._root_of_unity(eng, N)
    scaled = [v * pow(g, i, r) % r for i, v in enumerate(vals)]
    assert ts.unpack(got) == tg16.fft(scaled, omega, r)
    back = tn.coset_intt(got, g)
    np.testing.assert_array_equal(back.numpy(), want["back"][0])
    assert ts.unpack(back) == vals


def test_tables_match_jax_and_are_cached():
    jn, tn, js, ts, _, eng = FIELDS["bw6_fr"]
    N, g = 64, eng.fr_generator
    for inverse in (False, True):
        np.testing.assert_array_equal(
            tn.master_table(N, inverse, "cpu").numpy(),
            np.asarray(jn.master_table(N, inverse)))
    assert tn.master_table(N, False, "cpu") is tn.master_table(N, False, "cpu")
    assert tn.master_table(N, False, "cpu").shape == (ts.n, N // 2)
    np.testing.assert_array_equal(tn.coset_scale(N, g, "cpu").numpy(),
                                  np.asarray(jn.coset_scale(N, g)))
    assert tn.coset_scale(N, g, "cpu") is tn.coset_scale(N, g, "cpu")


def test_batched_ntt_and_module_entry_points():
    """Leading batch dims transform independently; the module-level entry
    points are the BLS-Fr instance."""
    jn, tn, js, ts, _, eng = FIELDS["bls_fr"]
    N = 16
    rows = [values(eng.fr, N, s) for s in (7, 8, 9)]
    x = np.stack([js.pack(v) for v in rows], axis=1)  # [n, 3, N]
    got = tn.ntt(torch.from_numpy(x))
    np.testing.assert_array_equal(got.numpy(), np.asarray(jn.ntt(jnp.asarray(x))))
    for i, v in enumerate(rows):
        np.testing.assert_array_equal(got[:, i].numpy(),
                                      tn.ntt(torch.from_numpy(js.pack(v))).numpy())
    one = torch.from_numpy(js.pack(rows[0]))
    g = eng.fr_generator
    assert torch.equal(tntt.ntt(one), tn.ntt(one))
    assert torch.equal(tntt.ntt(one, inverse=True), tn.ntt(one, inverse=True))
    assert torch.equal(tntt.coset_intt(tntt.coset_ntt(one, g), g),
                       tn.coset_intt(tn.coset_ntt(one, g), g))


def test_ntt_under_tc_multiply_gives_the_same_limbs():
    _, tn, _, ts, _, eng = FIELDS["bw6_fr"]
    x = ts.pack(values(eng.fr, 32, 5), "cpu")
    want = tn.ntt(x)
    with tf.mul_kernel("tc"):
        assert torch.equal(tn.ntt(x), want)

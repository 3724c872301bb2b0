"""The PyTorch port's main path against the JAX package, end to end.

BDN18 grouped batch verification (ops/bls.py::batch_verify_grouped_device)
runs in both packages on the same inputs: JAX on the CPU, where every
multiply is the plain mul_conv, and the port with device="cpu", where every
multiply is the plain version of its mont_mul kernel. The affine P legs,
the Miller-loop output, the Fq12 product, the final-exponentiation output
and the verdict must agree limb for limb; the JAX package's are recorded
by tests/jax_answers.py, and a `slow` test re-derives them. The tampered
two-group run goes under tests/torch_capture_guard.py's guard: the body
that batch_verify_grouped_aot captures on the card takes no host data and
makes no host read once warm."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from celo_bls_snark_tpu.hostmath import curves as jhc
from celo_bls_snark_tpu.hostmath.params import G1_GENERATOR, G2_GENERATOR
from celo_bls_snark_tpu.ops import bls as jbls
from celo_bls_snark_tpu.ops import curve as jdc
from celo_bls_snark_tpu.ops import pairing as jdp
from celo_bls_snark_tpu.ops import tower as jtw

from celo_bls_snark_tpu_torch import bench as tbench
from celo_bls_snark_tpu_torch import entry as tentry
from celo_bls_snark_tpu_torch.convert import tree_from_numpy, tree_to_numpy
from celo_bls_snark_tpu_torch.ops import bls as tbls
from celo_bls_snark_tpu_torch.ops import curve as tdc
from celo_bls_snark_tpu_torch.utils.tree import tree_leaves

import jax_answers
from torch_capture_guard import capture_guard

STAGES = ("p_aff", "miller", "product", "final_exp", "ok")


@jax.jit
def _jax_stages_2(s, h, pk):
    return _jax_stages(s, h, pk, 2)


@jax.jit
def _jax_stages_1(s, h, pk):
    return _jax_stages(s, h, pk, 1)


def _jax_stages(sigs_jac, hashes_jac, apks_aff, groups):
    """The body of the JAX batch_verify_grouped_device, returning every
    intermediate the port's batch_verify_grouped_stages returns."""
    cat = lambda a, b: jax.tree.map(  # noqa: E731
        lambda x, y: jnp.concatenate([x, y], axis=-1), a, b
    )
    partials = jdc.g1.msum_groups(cat(sigs_jac, hashes_jac), 2 * groups,
                                  fold_lanes=1024)
    sig_parts = jax.tree.map(lambda x: x[..., :groups], partials)
    hsums = jax.tree.map(lambda x: x[..., groups:], partials)
    asig = jdc.g1.msum(sig_parts) if groups > 1 else sig_parts
    p_aff = jdc.g1.to_affine(cat(asig, hsums))
    negg2 = jax.tree.map(jnp.asarray, jbls.neg_g2_gen_affine(1))
    miller = jdp.miller_loop_batch(p_aff, cat(negg2, apks_aff))
    product = jdp.f12_product(miller)
    final_exp = jdp.final_exponentiation(product)
    return p_aff, miller, product, final_exp, jtw.f12_is_one(final_exp)


@functools.cache
def _committee():
    sk1, sk2 = 1234567, 7654321
    pk1 = jhc.G2.mul(sk1, G2_GENERATOR)
    pk2 = jhc.G2.mul(sk2, G2_GENERATOR)
    hs = [jhc.G1.mul(3 + i, G1_GENERATOR) for i in range(8)]
    sigs = [jhc.G1.mul(sk1, h) for h in hs[:4]] + [
        jhc.G1.mul(sk2, h) for h in hs[4:]
    ]
    return sigs, hs, [pk1, pk2]


def slice_inputs(case):
    """(sigs, hashes, aggregate keys, groups) of each compared batch."""
    sigs, hs, pks = _committee()
    if case == "one_group":
        return sigs[:4], hs[:4], pks[:1], 1
    if case == "two_groups_tampered":
        sigs = sigs[:3] + [jhc.G1.mul(999, hs[3])] + sigs[4:]
    return sigs, hs, pks, 2


def slice_jax(inputs):
    sigs, hs, pks, groups = inputs
    jax_fn = _jax_stages_2 if groups == 2 else _jax_stages_1
    out = jax_fn(jdc.g1_pack(sigs), jdc.g1_pack(hs), jbls.pack_g2_affine(pks))
    return {name: tree_leaves(jax.tree.map(np.asarray, x))
            for name, x in zip(STAGES, out)}


# the JAX package's stages, recorded (tests/jax_answers.py): each of
# _jax_stages_1 and _jax_stages_2 compiles for about 2 min on the CPU
REC = jax_answers.Recordings(__name__, {
    case: (functools.partial(slice_inputs, case), slice_jax)
    for case in ("two_groups", "two_groups_tampered", "one_group")})

_WARM = []  # the shapes the port has run once in this process


def _compare(case, guard=False):
    """The port's stages against the JAX package's recorded ones on the
    same inputs; returns the (common) verdict. With `guard`, the port's run
    is a warm one under the capture guard."""
    inputs = slice_inputs(case)
    want = REC.load(case, inputs)
    sigs, hs, pks, groups = inputs
    s, h, pk = jdc.g1_pack(sigs), jdc.g1_pack(hs), jbls.pack_g2_affine(pks)
    args = (tree_from_numpy(s, "cpu"), tree_from_numpy(h, "cpu"),
            tree_from_numpy(pk, "cpu"), groups)
    shape = (len(sigs), groups)
    if guard and shape not in _WARM:  # run alone: warm up first
        tbls.batch_verify_grouped_stages(*args)
    if guard:
        with capture_guard():
            got = tbls.batch_verify_grouped_stages(*args)
    else:
        got = tbls.batch_verify_grouped_stages(*args)
    _WARM.append(shape)
    for name in STAGES:
        w = want[name]
        g = tree_leaves(tree_to_numpy(got[name]))
        assert len(w) == len(g), name
        for x, y in zip(w, g):
            np.testing.assert_array_equal(x.astype(np.int64), y.astype(np.int64),
                                          err_msg=name)
    return bool(want["ok"][0][0])


@pytest.fixture(scope="module")
def committee():
    return _committee()


@pytest.mark.parametrize("tampered", [False, True])
def test_grouped_verify_two_groups_matches_jax(tampered):
    case = "two_groups_tampered" if tampered else "two_groups"
    assert _compare(case, guard=tampered) is (not tampered)


def test_grouped_verify_one_group_matches_jax():
    assert _compare("one_group") is True


def test_hashes_pairs_and_aggregates_on_cpu(committee):
    """The other verification entry points of ops/bls.py on the port alone,
    against host arithmetic: the (n+1)-pairing check of one group, the
    per-pair checks (one valid, one tampered), and the aggregations."""
    sigs, hs, pks = committee
    sig_sum = jhc.G1.msum(sigs[:2])
    assert tdc.g1_unpack(tbls.aggregate_g1_device(tdc.g1_pack(sigs[:2], "cpu"))) == [sig_sum]
    assert tdc.g2_unpack(tbls.aggregate_g2_device(tdc.g2_pack(pks, "cpu"))) == [
        jhc.G2.msum(pks)
    ]
    sig_aff = tbls.pack_g1_affine([sig_sum], "cpu")
    pk_aff = tbls.pack_g2_affine(pks[:1] * 2, "cpu")
    h_aff = tbls.pack_g1_affine(hs[:2], "cpu")
    assert bool(tbls.batch_verify_hashes_device(sig_aff, pk_aff, h_aff)[0])
    bad = tbls.pack_g1_affine([jhc.G1.msum([sigs[0], sigs[4]])], "cpu")
    assert not bool(tbls.batch_verify_hashes_device(bad, pk_aff, h_aff)[0])
    # check i pairs lanes 2i, 2i+1: e(sig_i, -g2) * e(H_i, pk1) == 1
    negg2 = jhc.G2.neg(G2_GENERATOR)
    p_aff = tbls.pack_g1_affine([sigs[0], hs[0], sigs[4], hs[1]], "cpu")
    q_aff = tbls.pack_g2_affine([negg2, pks[0], negg2, pks[0]], "cpu")
    assert tbls.verify_pairs_device(p_aff, q_aff).tolist() == [True, False]


def test_entry_verifies_on_cpu():
    fn, args = tentry.entry(device="cpu")
    assert bool(fn(*args)[0])


def test_entry_needs_a_card_unless_asked_for_cpu():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: entry() runs on it")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tentry.entry()


def test_input_builder_matches_jax_hash_chain():
    """The port's input builder, at a reduced size, against the copied
    hash chain of the JAX package (same seed, same committee, same CIP22
    points), and its device expansion against host arithmetic."""
    from celo_bls_snark_tpu.bls import PrivateKey, PublicKey, SIG_DOMAIN
    from celo_bls_snark_tpu.hash_to_curve import composite_hash_to_g1_cip22
    from celo_bls_snark_tpu.hostmath.params import R
    from celo_bls_snark_tpu.utils.rngs import XorShiftRng

    n_validators, n_seed, tiles = 3, 2, 2
    seed = b"benchseedbenchsee"
    rng = XorShiftRng(seed[:16])
    h2c = composite_hash_to_g1_cip22()
    sks = [PrivateKey.generate(rng) for _ in range(n_validators)]
    apk = PublicKey.aggregate([sk.to_public() for sk in sks])
    sk_sum = sum(sk.sk for sk in sks) % R
    want_seeds = [
        h2c.hash(SIG_DOMAIN, b"block %06d" % i, b"") for i in range(n_seed)
    ]
    seeds, apk_pt, got_sum = tbench.host_inputs(n_validators, seed, n_seed)
    assert (seeds, apk_pt, got_sum) == (want_seeds, apk.pt, sk_sum)

    sigs, hashes, apk_aff = tbench.build_inputs(
        n_seed * tiles, n_validators, seed, device="cpu", n_seed=n_seed
    )
    want_h = [jhc.G1.mul(k + 1, s) for k in range(tiles) for s in want_seeds]
    assert tdc.g1_unpack(hashes) == want_h
    assert tdc.g1_unpack(sigs) == [jhc.G1.mul(sk_sum, h) for h in want_h]
    assert bool(tbench.verify(sigs, hashes, apk_aff)[0])

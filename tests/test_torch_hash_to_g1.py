"""The port's batched try-and-increment hash-to-G1 (celo_bls_snark_tpu_torch/
ops/hash_to_g1.py) against the JAX package's ops/hash_to_g1.py and the host
TryAndIncrementCIP22: equal limbs for the candidate parse and the
Tonelli-Shanks, equal affine points and masks for the whole hash."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import jax_answers
from celo_bls_snark_tpu.ops import curve as jdc
from celo_bls_snark_tpu.ops import hash_to_g1 as jh
from celo_bls_snark_tpu.ops.field import FQ as JFQ
from celo_bls_snark_tpu_torch.convert import tree_to_numpy
from celo_bls_snark_tpu_torch.hash_to_curve.try_and_increment import TryAndIncrement
from celo_bls_snark_tpu_torch.hash_to_curve.try_and_increment_cip22 import (
    TryAndIncrementCIP22,
)
from celo_bls_snark_tpu_torch.hashers.composite import composite_hasher
from celo_bls_snark_tpu_torch.hashers.direct import DirectHasher
from celo_bls_snark_tpu_torch.keys import SIG_DOMAIN
from celo_bls_snark_tpu_torch.ops import curve as tdc
from celo_bls_snark_tpu_torch.ops import field as tf
from celo_bls_snark_tpu_torch.ops import hash_to_g1 as th
from celo_bls_snark_tpu_torch.utils import profiling

torch.set_num_threads(1)

# first valid counters under DirectHasher with EXTRA: 2 2 0 6 6 1 1 1, so
# the batch takes counters > 0 and round 2 (counters >= 5)
MSGS = [b"h2g msg %03d" % i for i in range(8, 16)]
EXTRA = b"\x07\x08"


def host(hasher, compat, msgs, extra, with_attempt=False):
    h2c = TryAndIncrementCIP22(hasher, "g1", compat)
    out = [h2c.hash_with_attempt_cip22(SIG_DOMAIN, m, th.extra_data_of(extra, i))
           for i, m in enumerate(msgs)]
    return out if with_attempt else [pt for pt, _ in out]


def xof_words(B, seed):
    """Random XOF words [2, 8, B]; lane 0 is x = 0 with the infinity flag
    (the try-and-increment skips it), lane 1 x = p - 1 (x < p), lane 2
    x = p (not < p)."""
    rng = np.random.default_rng(seed)
    w = rng.integers(0, 1 << 32, (2, 8, B), dtype=np.uint64).astype(np.uint32)
    flat = np.concatenate([w[0], w[1]])  # [16, B]
    p = JFQ.modulus
    for lane, v in ((0, 1 << 382), (1, p - 1), (2, p)):
        flat[:12, lane] = [(v >> (32 * j)) & 0xFFFFFFFF for j in range(12)]
    return np.stack([flat[:8], flat[8:]])


@pytest.mark.parametrize("compat", (True, False))
def test_parse_candidates_equals_jax(compat):
    words = xof_words(16, 1)
    want = jh._parse_candidates(jnp.asarray(words), compat)
    got = th._parse_candidates(torch.from_numpy(words.astype(np.int64)), compat)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert bool(got[2][0]) and bool(got[4][0])  # infinity flag on x = 0
    assert bool(got[3][1]) and not bool(got[3][2])  # p - 1 < p, p is not


def _jax_sqrt_stages(xof, compat):
    x, greatest, valid, w, t = jh._candidate_points(xof, compat)
    _, tt0, is_qr = jh._sqrt_prep(t)
    y = jh._tonelli_shanks_finish(t, w)
    return x, greatest, valid, w, t, tt0, is_qr, y, jh._select_greatest(y, greatest)


def sqrt_inputs():
    return xof_words(12, 2), True


def sqrt_jax(inputs):
    words, compat = inputs
    out = jax.jit(_jax_sqrt_stages, static_argnums=1)(jnp.asarray(words), compat)
    return {"stages": [np.asarray(x) for x in out]}


def device_inputs(compat):
    return SIG_DOMAIN, MSGS, EXTRA, compat, 16


def device_jax(inputs):
    domain, msgs, extra, compat, num_counters = inputs
    jac, has = jh.hash_to_g1_device(domain, msgs, extra, compat=compat,
                                    num_counters=num_counters)
    return {"jac": [np.asarray(x) for x in jac], "has": [np.asarray(has)]}


# the JAX package's limbs, recorded (tests/jax_answers.py): its hash rounds
# compile for 40-95 s a shape on the CPU
REC = jax_answers.Recordings(__name__, {
    "sqrt_stages": (sqrt_inputs, sqrt_jax),
    "device_compat": (functools.partial(device_inputs, True), device_jax),
    "device_noncompat": (functools.partial(device_inputs, False), device_jax)})


def test_sqrt_and_tonelli_shanks_equal_jax():
    """Every candidate lane, valid or garbage, gives the same limbs in both
    packages; on the valid lanes the root squares to x^3 + 1."""
    inputs = sqrt_inputs()
    words, compat = inputs
    want = REC.load("sqrt_stages", inputs)["stages"]
    tw = torch.from_numpy(words.astype(np.int64))
    x, greatest, valid, w, t = th._candidate_points(tw, compat)
    _, tt0, is_qr = th._sqrt_prep(t)
    y = th._tonelli_shanks_finish(t, w)
    got = (x, greatest, valid, w, t, tt0, is_qr, y, th._select_greatest(y, greatest))
    assert len(got) == len(want)
    for g, wnt in zip(got, want):
        np.testing.assert_array_equal(g.numpy().astype(np.int64),
                                      wnt.astype(np.int64))
    assert 0 < int(valid.sum()) < 12
    ys, ts = tf.FQ.unpack(y), tf.FQ.unpack(t)
    for lane in np.nonzero(valid.numpy())[0]:
        assert ys[lane] * ys[lane] % tf.FQ.modulus == ts[lane]


def test_ts_tables_cached_per_device():
    a = th._ts_tables("cpu")
    assert a is th._ts_tables("cpu")
    match38, match40, upd, half = a
    assert tuple(match38.shape) == (tf.FQ.n, 256) and tuple(match40.shape) == (tf.FQ.n, 64)
    assert len(upd) == len(half) == 6


@pytest.mark.parametrize("compat", (True, False))
def test_hash_to_g1_device_equals_jax_and_host(compat):
    want_pts = host(DirectHasher(), compat, MSGS, EXTRA, with_attempt=True)
    assert max(a for _, a in want_pts) >= 5  # counters > 0 and round 2
    inputs = device_inputs(compat)
    want = REC.load("device_compat" if compat else "device_noncompat", inputs)
    domain, msgs, extra, _, num_counters = inputs
    tjac, thas = th.hash_to_g1_device(domain, msgs, extra, compat=compat,
                                      num_counters=num_counters, device="cpu")
    np.testing.assert_array_equal(thas, want["has"][0])
    assert thas.all()
    got = tdc.g1_unpack(tjac)
    assert got == jdc.unpack_jac(jdc.g1, JFQ, tuple(want["jac"]))
    assert got == [pt for pt, _ in want_pts]


def test_fallback_at_one_counter():
    """num_counters=1 sends every message whose counter 0 fails to the host
    fallback; the result still equals the host loop."""
    got = th.hash_to_g1_direct_cip22_batch(SIG_DOMAIN, MSGS, EXTRA,
                                           num_counters=1, device="cpu")
    assert got == host(DirectHasher(), True, MSGS, EXTRA)


@pytest.mark.parametrize("cip22", (True, False), ids=["cip22", "direct"])
def test_round2_merge_in_two_chunks(cip22, monkeypatch):
    """Round 1 over counter 0 alone leaves 35 (CIP22) or 40 (before CIP22)
    of 64 messages pending, above the cap of 32: round 2 indexes them on
    the card in two chunks over counters 1-4, the second padded with
    duplicate lanes, and the messages whose first valid counter is past 4
    (7 and 3) are hashed on the host and merged on the card."""
    monkeypatch.setattr(th, "ROUND1_COUNTERS", 1)
    msgs = [b"h2g msg %03d" % i for i in range(64)]
    if cip22:
        want = host(DirectHasher(), True, msgs, b"", with_attempt=True)
    else:
        h2c = TryAndIncrement(DirectHasher(), "g1", True)
        want = [h2c.hash_with_attempt(SIG_DOMAIN, m, b"") for m in msgs]
    attempts = np.array([a for _, a in want])
    pending, late = (35, 7) if cip22 else (40, 3)
    assert (attempts >= 1).sum() == pending and (attempts >= 5).sum() == late
    profiling.reset()
    jac, fallback = th.hash_messages_device(SIG_DOMAIN, msgs, b"", num_counters=5,
                                            device="cpu", cip22=cip22)
    assert fallback == np.nonzero(attempts >= 5)[0].tolist()
    assert profiling.report()[th.ROUND2_LANES] == {"calls": 1, "total_s": 2 * 32 * 4.0}
    assert tdc.g1_unpack(jac) == [pt for pt, _ in want]


def test_per_message_extra_data():
    extras = [b"e %04d" % i for i in range(len(MSGS))]
    got = th.hash_to_g1_direct_cip22_batch(SIG_DOMAIN, MSGS, extras,
                                           num_counters=24, device="cpu")
    assert got == host(DirectHasher(), True, MSGS, extras)


def test_per_message_extra_data_of_length_zero():
    """All-empty per-message entries are the shared b"" (the JAX package's
    reshape of an empty buffer raises here); unequal lengths are refused."""
    msgs = MSGS[:4]
    got = th.hash_to_g1_direct_cip22_batch(SIG_DOMAIN, msgs, [b""] * 4,
                                           num_counters=24, device="cpu")
    assert got == host(DirectHasher(), True, msgs, b"")
    with pytest.raises(ValueError, match="unequal lengths"):
        th.hash_to_g1_device(SIG_DOMAIN, msgs, [b"", b"a", b"", b""], device="cpu")
    with pytest.raises(ValueError):
        th.hash_to_g1_device(SIG_DOMAIN, msgs, [b""] * 3, device="cpu")


def test_composite_batch_equals_host():
    """The composite hasher's batch (Pedersen CRH on the device, 48-byte
    digests into the counter scan) against TryAndIncrementCIP22 over the
    CompositeHasher, with counters > 0."""
    msgs = MSGS[:4]
    want = host(composite_hasher(), True, msgs, EXTRA, with_attempt=True)
    got = th.hash_to_g1_composite_cip22_batch(SIG_DOMAIN, msgs, EXTRA,
                                              num_counters=24, device="cpu")
    assert got == [pt for pt, _ in want]


def test_entry_points_need_a_card_unless_asked_for_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the entry points run on it")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        th.hash_to_g1_device(SIG_DOMAIN, MSGS, EXTRA)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        th.hash_to_g1_direct_cip22_batch(SIG_DOMAIN, MSGS, EXTRA)


@pytest.mark.gpu
def test_hash_card_equals_cpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    tf.reset_launches()
    card, chas = th.hash_to_g1_device(SIG_DOMAIN, MSGS, EXTRA, num_counters=16,
                                      device="cuda")
    assert tf.mont_mul.launches > 0 and tf.mont_redc.launches > 0
    cpu, phas = th.hash_to_g1_device(SIG_DOMAIN, MSGS, EXTRA, num_counters=16,
                                     device="cpu")
    np.testing.assert_array_equal(chas, phas)
    for x, y in zip(tree_to_numpy(card), tree_to_numpy(cpu)):
        np.testing.assert_array_equal(x, y)

"""The port's host BLS layer (celo_bls_snark_tpu_torch/bls/,
utils/serialization.py, utils/bits.py, hash_to_curve/try_and_increment.py)
against the JAX package's on seeded inputs. Host code only, no JAX
compile: equal bytes, equal points and equal verdicts (tolerance 0)."""

import random

import pytest

from celo_bls_snark_tpu import bls as jbls
from celo_bls_snark_tpu.bls import test_helpers as jhelpers
from celo_bls_snark_tpu import hash_to_curve as jh2c
from celo_bls_snark_tpu import hashers as jhashers
from celo_bls_snark_tpu.utils import bits as jbits
from celo_bls_snark_tpu.utils import serialization as jser
from celo_bls_snark_tpu.utils.rngs import XorShiftRng as JXorShiftRng
from celo_bls_snark_tpu_torch import batch as tbatch_reexport
from celo_bls_snark_tpu_torch import bls as tbls
from celo_bls_snark_tpu_torch import keys as tkeys_reexport
from celo_bls_snark_tpu_torch.bls import test_helpers as thelpers
from celo_bls_snark_tpu_torch import hash_to_curve as th2c
from celo_bls_snark_tpu_torch import hashers as thashers
from celo_bls_snark_tpu_torch.hostmath import curves as hc
from celo_bls_snark_tpu_torch.hostmath.params import G1_GENERATOR, G2_GENERATOR, P, R
from celo_bls_snark_tpu_torch.utils import bits as tbits
from celo_bls_snark_tpu_torch.utils import serialization as tser
from celo_bls_snark_tpu_torch.utils.rngs import XorShiftRng

SEED = b"bls-host-tests01"

# (name, port factory, JAX factory) of the try-and-increment hashers
HASHERS = [
    ("direct", th2c.direct_hash_to_g1, jh2c.direct_hash_to_g1),
    ("composite", th2c.composite_hash_to_g1, jh2c.composite_hash_to_g1),
    ("cip22", th2c.composite_hash_to_g1_cip22, jh2c.composite_hash_to_g1_cip22),
]


def keypairs(n, seed=SEED):
    """n seeded key pairs from each package's own rng."""
    tr, jr = XorShiftRng(seed), JXorShiftRng(seed)
    return ([tbls.PrivateKey.generate(tr) for _ in range(n)],
            [jbls.PrivateKey.generate(jr) for _ in range(n)])


def points(n, seed=7):
    rnd = random.Random(seed)
    g1 = [hc.G1.mul(rnd.randrange(1, R), G1_GENERATOR) for _ in range(n)]
    g2 = [hc.G2.mul(rnd.randrange(1, R), G2_GENERATOR) for _ in range(n)]
    return g1 + [None], g2 + [None]


def test_reexports_are_the_bls_modules():
    assert tkeys_reexport.PrivateKey is tbls.PrivateKey
    assert tkeys_reexport.PublicKey is tbls.PublicKey
    assert tkeys_reexport.SIG_DOMAIN == tbls.SIG_DOMAIN == jbls.SIG_DOMAIN
    assert (tbls.POP_DOMAIN, tbls.OUT_DOMAIN) == (jbls.POP_DOMAIN, jbls.OUT_DOMAIN)
    assert tbatch_reexport.byte_count_from_target_batch_size is \
        tbls.byte_count_from_target_batch_size
    assert tbatch_reexport.SECURITY_BOUND == 128


@pytest.mark.parametrize("nbits", [0, 1, 7, 8, 13, 64, 377, 384])
def test_bits_equal_jax(nbits):
    rnd = random.Random(nbits)
    bits = [bool(rnd.getrandbits(1)) for _ in range(nbits)]
    data = bytes(rnd.getrandbits(8) for _ in range((nbits + 7) // 8 + 1))
    assert tbits.bits_be_to_bytes_le(bits) == jbits.bits_be_to_bytes_le(bits)
    assert tbits.bits_le_to_bytes_le(bits) == jbits.bits_le_to_bytes_le(bits)
    assert tbits.bytes_le_to_bits_be(data, nbits) == jbits.bytes_le_to_bits_be(data, nbits)
    assert tbits.bytes_le_to_bits_le(data, nbits) == jbits.bytes_le_to_bits_le(data, nbits)


def test_scalar_and_field_bytes_equal_jax():
    rnd = random.Random(11)
    for v in [0, 1, P - 1] + [rnd.randrange(P) for _ in range(8)]:
        b = tser.fq_to_bytes(v)
        assert b == jser.fq_to_bytes(v) and tser.fq_from_bytes(b) == v
    for v in [0, 1, R - 1] + [rnd.randrange(R) for _ in range(8)]:
        b = tser.fr_to_bytes(v)
        assert b == jser.fr_to_bytes(v) and tser.fr_from_bytes(b) == v
    pair = (rnd.randrange(P), rnd.randrange(P))
    assert tser.fq2_to_bytes(pair) == jser.fq2_to_bytes(pair)


@pytest.mark.parametrize("group", ["g1", "g2"])
@pytest.mark.parametrize("compressed", [True, False])
def test_point_bytes_round_trip_equal_jax(group, compressed):
    g1, g2 = points(3)
    pts = g1 if group == "g1" else g2
    to_t, from_t = getattr(tser, f"{group}_to_bytes"), getattr(tser, f"{group}_from_bytes")
    to_j, from_j = getattr(jser, f"{group}_to_bytes"), getattr(jser, f"{group}_from_bytes")
    for pt in pts:
        b = to_t(pt, compressed)
        assert b == to_j(pt, compressed)
        assert from_t(b, compressed) == pt == from_j(b, compressed)


def outcome(fn, *args):
    """("ok", value) or ("raises", the exception's class name)."""
    try:
        return ("ok", fn(*args))
    except Exception as e:  # the test compares what each package does
        return ("raises", type(e).__name__)


@pytest.mark.parametrize("group", ["g1", "g2"])
def test_bad_encodings_rejected_as_jax(group):
    g1, g2 = points(1)
    pt = (g1 if group == "g1" else g2)[0]
    good = getattr(tser, f"{group}_to_bytes")(pt, True)
    bad = [
        good[:-1],                                    # short
        good + b"\x00",                               # long
        b"",                                          # empty
        bytes([0xFF]) * len(good),                    # x >= p, all flags
        good[:-1] + bytes([good[-1] ^ 0x3F]),         # x changed: off the curve or not
        bytes(len(good) - 1) + bytes([0x40]),         # infinity flag
        bytes(len(good) - 1) + bytes([0xC0]),         # both flags set
    ]
    for data in bad:
        for compressed in (True, False):
            got = outcome(getattr(tser, f"{group}_from_bytes"), data, compressed)
            want = outcome(getattr(jser, f"{group}_from_bytes"), data, compressed)
            assert got == want, (data.hex(), compressed)
            if len(data) != len(good):
                assert got[0] == "raises"
    assert outcome(tser.fq_from_bytes, tser.fq_to_bytes(0)[:-1] + b"\xff") == \
        outcome(jser.fq_from_bytes, jser.fq_to_bytes(0)[:-1] + b"\xff")
    assert outcome(tser.fr_from_bytes, b"\xff" * 32) == outcome(jser.fr_from_bytes, b"\xff" * 32)


def test_keys_and_key_bytes_equal_jax():
    tks, jks = keypairs(3)
    for t, j in zip(tks, jks):
        assert t.sk == j.sk and t.to_bytes() == j.to_bytes()
        assert tbls.PrivateKey.from_bytes(t.to_bytes()).sk == t.sk
        tp, jp = t.to_public(), j.to_public()
        assert tp.pt == jp.pt
        for compressed in (True, False):
            assert tp.to_bytes(compressed) == jp.to_bytes(compressed)
            assert tbls.PublicKey.from_bytes(tp.to_bytes(compressed), compressed) == tp
    assert tbls.PublicKey.aggregate([k.to_public() for k in tks]).pt == \
        jbls.PublicKey.aggregate([k.to_public() for k in jks]).pt


@pytest.mark.parametrize("name", [h[0] for h in HASHERS])
def test_sign_verify_equal_jax(name):
    _, make_t, make_j = next(h for h in HASHERS if h[0] == name)
    ht, hj = make_t(), make_j()
    (t,), (j,) = keypairs(1)
    msg, extra = b"hello world", b"extra"
    st, sj = t.sign(msg, extra, ht), j.sign(msg, extra, hj)
    assert st.to_bytes() == sj.to_bytes() and st.to_bytes(False) == sj.to_bytes(False)
    assert tbls.Signature.from_bytes(st.to_bytes()) == st
    t.to_public().verify(msg, extra, st, ht)
    with pytest.raises(tbls.VerificationFailed):
        t.to_public().verify(b"goodbye", extra, st, ht)


def test_pop_equal_jax():
    h = th2c.direct_hash_to_g1()
    (t, t2), (j, _) = keypairs(2)
    pk_bytes = t.to_public().to_bytes()
    sig = t.sign_pop(pk_bytes, h)
    assert sig.to_bytes() == j.sign_pop(pk_bytes, jh2c.direct_hash_to_g1()).to_bytes()
    t.to_public().verify_pop(pk_bytes, sig, h)
    with pytest.raises(tbls.VerificationFailed):
        t2.to_public().verify_pop(pk_bytes, sig, h)


def test_aggregation_and_batch_exponents_equal_jax():
    h_t, h_j = th2c.direct_hash_to_g1(), jh2c.direct_hash_to_g1()
    tks, jks = keypairs(3)
    msgs = [(b"m1", b""), (b"m2", b"x"), (b"m3", b"yy")]
    ts = [k.sign(m, e, h_t) for k, (m, e) in zip(tks, msgs)]
    js = [k.sign(m, e, h_j) for k, (m, e) in zip(jks, msgs)]
    agg_t, agg_j = tbls.Signature.aggregate(ts), jbls.Signature.aggregate(js)
    assert agg_t.to_bytes() == agg_j.to_bytes()
    agg_t.batch_verify([k.to_public() for k in tks], tbls.SIG_DOMAIN, msgs, h_t)
    with pytest.raises(tbls.UnevenNumKeysMessages):
        agg_t.batch_verify([tks[0].to_public()], tbls.SIG_DOMAIN, msgs, h_t)
    exps = [5, 0, R + 3]
    assert tbls.Signature.batch(exps, ts).pt == jbls.Signature.batch(exps, js).pt
    pks_t = [k.to_public() for k in tks]
    assert tbls.PublicKey.batch(exps, pks_t).pt == \
        jbls.PublicKey.batch(exps, [k.to_public() for k in jks]).pt
    assert tbls.PublicKey.batch([1], pks_t) is None
    assert tbls.Signature.batch([1], ts) is None


@pytest.mark.parametrize("bad", [False, True])
def test_strict_batch_equal_jax(bad):
    """Batch.verify with seeded exponents and verify_each: the same
    verdict as the JAX package's, with one bad entry or none."""
    h_t, h_j = th2c.direct_hash_to_g1(), jh2c.direct_hash_to_g1()
    tks, jks = keypairs(3)
    msg, extra = b"block", b"extra"
    bt, bj = tbls.Batch(msg, extra), jbls.Batch(msg, extra)
    for i, (t, j) in enumerate(zip(tks, jks)):
        m = b"other message" if bad and i == 1 else msg
        bt.add(t.to_public(), t.sign(m, extra, h_t))
        bj.add(j.to_public(), j.sign(m, extra, h_j))
    got = outcome(bt.verify, h_t, XorShiftRng(SEED))
    want = outcome(bj.verify, h_j, JXorShiftRng(SEED))
    assert got[0] == want[0] == ("raises" if bad else "ok")
    assert outcome(bt.verify_each, h_t)[0] == outcome(bj.verify_each, h_j)[0]
    if bad:
        with pytest.raises(tbls.VerificationFailed):
            bt.verify_each(h_t)
    sizes = [1, 2, 3, 100, 1 << 20, 1 << 126]
    assert [tbls.byte_count_from_target_batch_size(n, 128) for n in sizes] == \
        [jbls.byte_count_from_target_batch_size(n, 128) for n in sizes]


def test_public_key_cache_equal_jax():
    tks, jks = keypairs(5)
    tc, jc = tbls.PublicKeyCache(), jbls.PublicKeyCache()
    tp, jp = [k.to_public() for k in tks], [k.to_public() for k in jks]
    data = tp[0].to_bytes()
    a = tc.deserialize(data)
    assert tc.deserialize(data) is a and a.pt == jc.deserialize(data).pt
    for sel in ([0, 1, 2], [1, 2, 3, 4], [4], [0, 1, 2, 3, 4]):
        got = tc.aggregate([tp[i] for i in sel])
        assert got.pt == jc.aggregate([jp[i] for i in sel]).pt
        assert got.pt == tbls.PublicKey.aggregate([tp[i] for i in sel]).pt
    tc.clear_cache()
    assert tc.aggregate(tp[:2]).pt == tbls.PublicKey.aggregate(tp[:2]).pt
    small, jsmall = tbls.PublicKeyCache(), jbls.PublicKeyCache()
    small.CACHE_SIZE = jsmall.CACHE_SIZE = 2  # the LRU order at a small size
    for i in (0, 1, 0, 2, 3):
        small.deserialize(tp[i].to_bytes())
        jsmall.deserialize(tp[i].to_bytes())
    assert list(small.de) == list(jsmall.de) == [tp[2].to_bytes(), tp[3].to_bytes()]


@pytest.mark.parametrize("hasher", ["direct", "composite"])
@pytest.mark.parametrize("group", ["g1", "g2"])
def test_try_and_increment_equal_jax(hasher, group):
    from celo_bls_snark_tpu.hashers import DirectHasher as JDirect
    from celo_bls_snark_tpu.hashers.composite import composite_hasher as jcomposite
    from celo_bls_snark_tpu_torch.hashers import DirectHasher, composite_hasher

    t = th2c.TryAndIncrement(DirectHasher() if hasher == "direct" else composite_hasher(),
                             group)
    j = jh2c.TryAndIncrement(JDirect() if hasher == "direct" else jcomposite(), group)
    for msg, extra in [(b"", b""), (b"hello", b"x"), (b"\x00" * 37, b"extra data")]:
        assert t.hash_with_attempt(tbls.SIG_DOMAIN, msg, extra) == \
            j.hash_with_attempt(jbls.SIG_DOMAIN, msg, extra)


def test_test_helpers_equal_jax():
    sks, pks, apks = thelpers.keygen_batch(2, 3, XorShiftRng(SEED))
    jsks, jpks, japks = jhelpers.keygen_batch(2, 3, JXorShiftRng(SEED))
    assert [[k.sk for k in ks] for ks in sks] == [[k.sk for k in ks] for ks in jsks]
    assert [a.pt for a in apks] == [a.pt for a in japks]
    hs = [hc.G1.mul(5 + i, G1_GENERATOR) for i in range(2)]
    got = thelpers.sign_batch(hs, sks)
    assert [s.pt for s in got] == [s.pt for s in jhelpers.sign_batch(hs, jsks)]
    assert thelpers.sum_g1(hs) == jhelpers.sum_g1(hs)
    assert thelpers.sum_g2([a.pt for a in apks]) == jhelpers.sum_g2([a.pt for a in apks])


def test_hasher_base_class():
    """hashers.Hasher, exported as the JAX module exports it: a subclass
    whose crh and xof delegate to the port's DirectHasher hashes to the JAX
    DirectHasher's bytes through the base's hash; the base's crh and xof
    raise NotImplementedError."""
    assert "Hasher" in thashers.__all__ and "Hasher" in jhashers.__all__

    class Delegating(thashers.Hasher):
        direct = thashers.DirectHasher()

        def crh(self, domain, message, xof_digest_length):
            return self.direct.crh(domain, message, xof_digest_length)

        def xof(self, domain, hashed_message, xof_digest_length):
            return self.direct.xof(domain, hashed_message, xof_digest_length)

    rnd = random.Random(41)
    for n, out in ((0, 64), (37, 96), (150, 32)):
        msg = bytes(rnd.randrange(256) for _ in range(n))
        assert Delegating().hash(b"ULforprf", msg, out) == \
            jhashers.DirectHasher().hash(b"ULforprf", msg, out)
    for method in (thashers.Hasher().crh, thashers.Hasher().xof):
        with pytest.raises(NotImplementedError):
            method(b"ULforprf", b"msg", 64)

"""The reference against the program's own host code where they should
agree byte for byte (the layout the program takes, the hasher, the exponent
size), and the reference's two forms of each block check against each
other."""

import random

import numpy as np
import pytest

from benchmark.reference import group, hashing, inputs, pack, verify, work
from benchmark.reference.params import G1_GENERATOR, G2_GENERATOR, R


def test_packing_is_the_programs_layout():
    from celo_bls_snark_tpu_torch.ops import bls as dbls
    from celo_bls_snark_tpu_torch.ops import curve as dc
    from celo_bls_snark_tpu_torch.ops import msm as dmsm

    rng = random.Random(1)
    g1 = [group.G1.mul(rng.randrange(1, R), G1_GENERATOR) for _ in range(3)]
    g2 = [group.G2.mul(rng.randrange(1, R), G2_GENERATOR) for _ in range(3)]

    def same(a, b):
        if isinstance(b, tuple):
            return all(same(x, y) for x, y in zip(a, b))
        return np.array_equal(a.numpy(), b)

    assert same(dc.g1_pack(g1, "cpu"), pack.g1_projective(g1))
    assert same(dc.g2_pack(g2, "cpu"), pack.g2_projective(g2))
    assert same(dbls.pack_g1_affine(g1, "cpu"), pack.g1_affine(g1))
    assert same(dbls.pack_g2_affine(g2, "cpu"), pack.g2_affine(g2))
    exps = [rng.getrandbits(136) % R for _ in range(5)]
    assert np.array_equal(dmsm.window_digits(exps, 136, 4), pack.window_digits(exps, 136, 4))


@pytest.mark.parametrize("cip22", [True, False], ids=["cip22", "before_cip22"])
@pytest.mark.parametrize("hasher", ["composite", "direct"])
def test_hash_is_the_programs_host_hash(hasher, cip22):
    from celo_bls_snark_tpu_torch.hash_to_curve.try_and_increment import TryAndIncrement
    from celo_bls_snark_tpu_torch.hash_to_curve.try_and_increment_cip22 import (
        TryAndIncrementCIP22)
    from celo_bls_snark_tpu_torch.hashers import DirectHasher, composite_hasher

    kind = TryAndIncrementCIP22 if cip22 else TryAndIncrement
    theirs = kind(composite_hasher() if hasher == "composite" else DirectHasher(), "g1", True)
    seal = work.message({"message_format": "celo header %08d", "message_digest": "sha256",
                         "message_suffix": "02"}, 7)
    assert len(seal) == 33
    for msg, extra in [(seal, b""), (b"block 000301", b"extra 0301")]:
        assert hashing.hash_to_g1(hasher, b"ULforxof", msg, extra, True, cip22) == theirs.hash(
            b"ULforxof", msg, extra)


def test_multiples_are_scalar_multiples():
    rng = random.Random(5)
    pts = [group.G1.mul(rng.randrange(1, R), G1_GENERATOR) for _ in range(3)]
    rows = group.multiples(pts, 6)
    assert all(rows[k - 1][j] == group.G1.mul(k, pts[j]) for k in range(1, 7) for j in range(3))


def test_exponent_size_is_the_programs():
    from celo_bls_snark_tpu_torch.batch import byte_count_from_target_batch_size

    for n in (1, 2, 20, 300, 6000):
        assert inputs.exponent_bytes(n, 128) == byte_count_from_target_batch_size(n, 128)
    assert inputs.exponent_bytes(20, 128) == 17


def test_block_checks_agree_in_both_forms():
    rng = random.Random(7)
    h = hashing.hash_to_g1("direct", b"ULforxof", b"block 000001", b"")
    sks = [rng.randrange(1, R) for _ in range(3)]
    sigs = [group.G1.mul(k, h) for k in sks]
    pks = [group.G2.mul(k, G2_GENERATOR) for k in sks]
    exps = [rng.getrandbits(136) % R for _ in sks]
    d = group.G1.mul(5, h)
    swapped = [group.G1.add(sigs[0], d), group.G1.add(sigs[1], group.G1.neg(d)), sigs[2]]
    forged = [sigs[0], sigs[1], group.G1.add(sigs[2], d)]
    for s, strict, screen, each in [(sigs, True, True, True), (swapped, False, True, False),
                                    (forged, False, False, False)]:
        assert verify.strict_block_ok(h, s, pks, exps) == strict
        assert verify.strict_block_dl(h, s, sks, exps) == strict
        assert verify.screen_block_ok(h, s, pks) == screen
        assert verify.screen_block_dl(h, s, sks) == screen
        assert verify.individual_block_ok(h, s, pks, 3) == each
        assert verify.individual_block_dl(h, s, sks) == each


def test_grouped_check_counts_lanes():
    rng = random.Random(9)
    hs = [hashing.hash_to_g1("direct", b"ULforxof", b"m%d" % i, b"") for i in range(2)]
    sk = rng.randrange(1, R)
    apk = group.G2.mul(sk, G2_GENERATOR)
    sigs = [group.G1.mul(sk, h) for h in hs]
    assert verify.grouped_ok([(sigs, [3, 2], 0)], [([(hs, [3, 2], 0)], apk)])
    assert not verify.grouped_ok([(sigs, [2, 3], 0)], [([(hs, [3, 2], 0)], apk)])
    # counts of either sign, points under the map: -2 H_0 + endo(3 H_1)
    ok = [([(hs, [-2, 0], 0), (hs, [0, 3], 1)], apk)]
    assert verify.grouped_ok([(sigs, [-2, 0], 0), (sigs, [0, 3], 1)], ok)
    assert not verify.grouped_ok([(sigs, [-2, 0], 0), (sigs, [0, 3], 2)], ok)


def test_endo_is_a_scalar_multiple_on_g1():
    h = hashing.hash_to_g1("direct", b"ULforxof", b"m", b"")
    lam = next(x for x in (pow(g, (R - 1) // 3, R) for g in range(2, 64)) if x != 1)
    assert group.endo(h, 1) in (group.G1.mul(lam, h), group.G1.mul(lam * lam % R, h))
    assert group.endo(group.endo(group.endo(h, 1), 1), 1) == h

"""Test fixture helpers (feature `test-helpers` parity).

Mirrors crates/bls-crypto/src/test_helpers.rs: committee keygen, direct
group-element signing, aggregation — reused by the epoch-snark fixtures
(crates/epoch-snark/tests/fixtures.rs).
"""

from ..hostmath.params import R, G2_GENERATOR
from ..hostmath import curves
from .keys import PrivateKey, PublicKey
from .signature import Signature


def keygen(rng):
    """One (sk, pk) pair (test_helpers.rs:10-16)."""
    sk = PrivateKey.generate(rng)
    return sk, sk.to_public()


def keygen_mul(n, rng):
    """n keypairs plus the aggregate public key (test_helpers.rs:19-33)."""
    sks, pks = [], []
    for _ in range(n):
        sk, pk = keygen(rng)
        sks.append(sk)
        pks.append(pk)
    apk = PublicKey.aggregate(pks)
    return sks, pks, apk


def keygen_batch(batch_size, n, rng):
    """batch_size committees of n keys each + per-committee aggregates
    (test_helpers.rs:36-56)."""
    sks, pks, apks = [], [], []
    for _ in range(batch_size):
        s, p, apk = keygen_mul(n, rng)
        sks.append(s)
        pks.append(p)
        apks.append(apk)
    return sks, pks, apks


def sum_g1(elements):
    return curves.G1.msum(elements)


def sum_g2(elements):
    return curves.G2.msum(elements)


def sign(message_hash_g1, sks):
    """Sign a G1 hash point directly with each key (test_helpers.rs:59-66)."""
    return [Signature(curves.G1.mul(sk.sk, message_hash_g1)) for sk in sks]


def sign_batch(message_hashes, sks_batch):
    """Per-committee signatures over per-committee message hashes
    (test_helpers.rs:69-81): returns one aggregate signature per committee."""
    out = []
    for h, sks in zip(message_hashes, sks_batch):
        sigs = sign(h, sks)
        out.append(Signature.aggregate(sigs))
    return out

"""The port's hashing-included batch verification,
celo_bls_snark_tpu_torch/ops/bls.py::batch_verify_messages_device, against
the JAX package's on the same inputs: equal verdicts for the DirectHasher
and the composite CRH, honest and tampered.

(Apart from tests/test_torch_hash_to_g1.py and
tests/test_torch_strict_verify.py so that each file runs in a few minutes
alone: the JAX package compiles its hash rounds and pairing on the CPU.)"""

import numpy as np
import pytest
import torch

from celo_bls_snark_tpu.ops import bls as jbls
from celo_bls_snark_tpu.ops import curve as jdc
from celo_bls_snark_tpu_torch.hash_to_curve.try_and_increment_cip22 import (
    TryAndIncrementCIP22,
    composite_hash_to_g1_cip22,
)
from celo_bls_snark_tpu_torch.hashers.direct import DirectHasher
from celo_bls_snark_tpu_torch.hostmath import curves as hc
from celo_bls_snark_tpu_torch.hostmath.params import R
from celo_bls_snark_tpu_torch.keys import SIG_DOMAIN, PrivateKey, PublicKey
from celo_bls_snark_tpu_torch.ops import bls as tbls
from celo_bls_snark_tpu_torch.ops import curve as tdc
from celo_bls_snark_tpu_torch.utils.rngs import XorShiftRng

torch.set_num_threads(1)

# first valid counters 1 3 0 0 3 1 0 0 (DirectHasher) and 0 3 1 4 1 0 4 0
# (composite): counters > 0, all inside round 1
MSGS = [b"verify msg %03d" % i for i in range(8)]


@pytest.fixture(scope="module")
def committee():
    rng = XorShiftRng(b"devmsgverify0001")
    sks = [PrivateKey.generate(rng) for _ in range(3)]
    apk = PublicKey.aggregate([sk.to_public() for sk in sks])
    return sum(sk.sk for sk in sks) % R, apk.pt


@pytest.mark.parametrize("composite", (False, True))
def test_batch_verify_messages_equals_jax(committee, composite):
    sk_sum, apk = committee
    h2c = composite_hash_to_g1_cip22() if composite else \
        TryAndIncrementCIP22(DirectHasher(), "g1", True)
    sigs = [hc.G1.mul(sk_sum, h2c.hash(SIG_DOMAIN, m, b"")) for m in MSGS]
    tampered = [sigs[1]] + sigs[1:]
    for lanes, want in ((sigs, True), (tampered, False)):
        got = tbls.batch_verify_messages_device(
            tdc.g1_pack(lanes, "cpu"), tbls.pack_g2_affine([apk], "cpu"),
            SIG_DOMAIN, MSGS, b"", composite=composite)
        jgot = jbls.batch_verify_messages_device(
            jdc.g1_pack(lanes), jbls.pack_g2_affine([apk]), SIG_DOMAIN, MSGS,
            b"", composite=composite)
        assert bool(got[0]) is bool(np.asarray(jgot)[0]) is want


def test_batch_verify_messages_host_fallback(committee):
    """With one counter, the messages whose counter 0 fails are hashed on
    the host and merged on the card; the verdicts hold."""
    sk_sum, apk = committee
    h2c = TryAndIncrementCIP22(DirectHasher(), "g1", True)
    sigs = [hc.G1.mul(sk_sum, h2c.hash(SIG_DOMAIN, m, b"")) for m in MSGS]
    apk_aff = tbls.pack_g2_affine([apk], "cpu")
    assert bool(tbls.batch_verify_messages_device(
        tdc.g1_pack(sigs, "cpu"), apk_aff, SIG_DOMAIN, MSGS, num_counters=1)[0])
    bad = sigs[:7] + [sigs[0]]
    assert not bool(tbls.batch_verify_messages_device(
        tdc.g1_pack(bad, "cpu"), apk_aff, SIG_DOMAIN, MSGS, num_counters=1)[0])


@pytest.mark.gpu
def test_batch_verify_messages_on_card(committee):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    sk_sum, apk = committee
    h2c = TryAndIncrementCIP22(DirectHasher(), "g1", True)
    sigs = [hc.G1.mul(sk_sum, h2c.hash(SIG_DOMAIN, m, b"")) for m in MSGS]
    assert bool(tbls.batch_verify_messages_device(
        tdc.g1_pack(sigs, "cuda"), tbls.pack_g2_affine([apk], "cuda"),
        SIG_DOMAIN, MSGS)[0])

"""The port's strict per-epoch batch verification,
celo_bls_snark_tpu_torch/ops/bls.py::strict_batch_verify_device, against
the JAX package's on the same inputs (equal per-epoch verdicts), and the
port's exponent sizing (batch.py) against the JAX package's bls/batch.py."""

import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from celo_bls_snark_tpu.bls import batch as jbatch
from celo_bls_snark_tpu.ops import bls as jbls
from celo_bls_snark_tpu.ops import curve as jdc
from celo_bls_snark_tpu_torch import batch as tbatch
from celo_bls_snark_tpu_torch.hash_to_curve.try_and_increment_cip22 import (
    composite_hash_to_g1_cip22,
)
from celo_bls_snark_tpu_torch.hostmath import curves as hc
from celo_bls_snark_tpu_torch.hostmath.params import G2_GENERATOR, R
from celo_bls_snark_tpu_torch.keys import SIG_DOMAIN
from celo_bls_snark_tpu_torch.ops import bls as tbls
from celo_bls_snark_tpu_torch.ops import curve as tdc
from celo_bls_snark_tpu_torch.ops import msm as tmsm

torch.set_num_threads(1)


@pytest.mark.parametrize("size", (1, 2, 20, 100, 1 << 20))
def test_byte_count_equals_jax(size):
    assert tbatch.byte_count_from_target_batch_size(size, tbatch.SECURITY_BOUND) == \
        jbatch.byte_count_from_target_batch_size(size, jbatch.SECURITY_BOUND)
    assert tbatch.SECURITY_BOUND == jbatch.SECURITY_BOUND


def test_strict_batch_verify_flips_the_bad_epoch():
    """G = 3 epochs x V = 4 validators (the same validators every epoch,
    per-epoch extra_data, composite hashes), one planted bad signature in
    epoch 1: [True, False, True] in both packages."""
    G, V = 3, 4
    rng = random.Random(11)
    h2c = composite_hash_to_g1_cip22()
    hs = [h2c.hash(SIG_DOMAIN, b"block %06d" % g, b"extra %04d" % g) for g in range(G)]
    sks = [rng.randrange(1, R) for _ in range(V)]
    pks = [hc.G2.mul(s, G2_GENERATOR) for s in sks] * G
    sigs = [hc.G1.mul(s, hs[g]) for g in range(G) for s in sks]
    sigs[V + 2] = hc.G1.double(sigs[V + 2])
    # 2-byte exponents (4 windows) keep the JAX package's CPU compile short;
    # chip_smoke.py runs the 17 bytes of byte_count_from_target_batch_size
    digits = tmsm.window_digits([rng.randrange(1 << 16) for _ in range(G * V)], 16, 4)
    got = tbls.strict_batch_verify_device(
        torch.from_numpy(digits), tdc.g1_pack(sigs, "cpu"), tdc.g2_pack(pks, "cpu"),
        tbls.pack_g1_affine(hs, "cpu"), G, c=4)
    want = jax.jit(jbls.strict_batch_verify_device, static_argnums=(4, 5))(
        jnp.asarray(digits), jdc.g1_pack(sigs), jdc.g2_pack(pks),
        jax.tree.map(jnp.asarray, jbls.pack_g1_affine(hs)), G, 4)
    assert got.tolist() == np.asarray(want).tolist() == [True, False, True]


def test_interleave():
    a = (torch.arange(6).reshape(2, 3),)
    b = (torch.arange(6, 12).reshape(2, 3),)
    out = tbls._interleave(a, b)[0]
    assert out.tolist() == [[0, 6, 1, 7, 2, 8], [3, 9, 4, 10, 5, 11]]

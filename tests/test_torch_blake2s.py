"""The port's batched Blake2s / Blake2Xs (celo_bls_snark_tpu_torch/ops/
blake2s.py) against the JAX package's ops/blake2s.py and the host
DirectHasher: the same seeded messages through both, equal words."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from celo_bls_snark_tpu.ops import blake2s as jb
from celo_bls_snark_tpu_torch.hashers.direct import DirectHasher
from celo_bls_snark_tpu_torch.keys import SIG_DOMAIN
from celo_bls_snark_tpu_torch.ops import blake2s as tb
from celo_bls_snark_tpu_torch.utils import aotcache
from torch_capture_guard import rehearse_captures

torch.set_num_threads(1)

LENGTHS = (0, 37, 64, 150)
B = 5
NODE_OFFSET = 3 | (96 << 32)
PERSON = b"ULforxof"


def messages(length, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, length, dtype=np.uint8).tobytes() for _ in range(B)]


@pytest.mark.parametrize("length", LENGTHS)
def test_pack_messages_equals_jax(length):
    msgs = messages(length, length)
    got = tb.pack_messages(msgs)
    np.testing.assert_array_equal(got, np.asarray(jb.pack_messages(msgs)))
    assert got.dtype == np.uint32


@pytest.mark.parametrize("length", LENGTHS)
def test_blake2s_batch_equals_jax(length):
    msgs = messages(length, 100 + length)
    words = tb.pack_messages(msgs)
    want = jb.blake2s_batch(jnp.asarray(words), length, digest_size=32,
                            node_offset=NODE_OFFSET, person=PERSON)
    got = tb.blake2s_batch(tb.words_to_device(words, "cpu"), length,
                           digest_size=32, node_offset=NODE_OFFSET, person=PERSON)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want).astype(np.int64))


@pytest.mark.parametrize("length", LENGTHS)
def test_blake2xs_batch_equals_jax(length):
    msgs = messages(length, 200 + length)
    words = tb.pack_messages(msgs)
    # 80 bytes: two full blocks and a partial third (digest_size 16)
    want = jb.blake2xs_batch(jnp.asarray(words), length, 80, person=PERSON)
    got = tb.blake2xs_batch(tb.words_to_device(words, "cpu"), length, 80, person=PERSON)
    assert tuple(got.shape) == (3, 8, B)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want).astype(np.int64))


@pytest.mark.parametrize("length", LENGTHS)
def test_direct_hash_batch_equals_direct_hasher(length):
    msgs = messages(length, 300 + length)
    want = [DirectHasher().hash(SIG_DOMAIN, m, 64) for m in msgs]
    assert tb.direct_hash_batch(msgs, 64, SIG_DOMAIN, "cpu") == want


@pytest.mark.parametrize("length,out_size", [(0, 64), (150, 80)])
def test_direct_hash_batch_runs_clean_under_the_capture_guard(length, out_size):
    """direct_hash_batch's CRH and XOF as one program per message length,
    output size and domain: an eager call, then the body again under the
    capture guard (tests/torch_capture_guard.py), gives the host bytes."""
    msgs = messages(length, 400 + length)
    want = [DirectHasher().hash(SIG_DOMAIN, m, out_size) for m in msgs]
    with rehearse_captures() as seen:
        assert tb.direct_hash_batch(msgs, out_size, SIG_DOMAIN, "cpu") == want
    assert seen == [f"direct_hash_{length}_{out_size}_{SIG_DOMAIN.hex()}"]


def test_pack_messages_rejects_unequal_lengths():
    with pytest.raises(ValueError):
        tb.pack_messages([b"ab", b"abc"])


@pytest.mark.gpu
def test_blake2s_card_equals_cpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    msgs = messages(150, 7)
    words = tb.pack_messages(msgs)
    cpu = tb.blake2xs_batch(tb.words_to_device(words, "cpu"), 150, 64, person=PERSON)
    card = tb.blake2xs_batch(tb.words_to_device(words, "cuda"), 150, 64, person=PERSON)
    assert torch.equal(card.cpu(), cpu)
    want = tb.direct_hash_batch(msgs, 64, SIG_DOMAIN, "cpu")
    aotcache.clear()
    # eager, captured and replayed, replayed: the replays equal the eager run
    for _ in range(3):
        assert tb.direct_hash_batch(msgs, 64, SIG_DOMAIN, "cuda") == want
    (entry,) = [e for e in aotcache.entries() if e.jit.tag.startswith("direct_hash_150_64")]
    assert entry.replays == 2

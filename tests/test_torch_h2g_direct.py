"""The port's try-and-increment before CIP22 on the card
(ops/hash_to_g1.py::hash_to_g1_device with cip22=False, as syncing Celo
nodes hash committed seals) against the host TryAndIncrement over the
DirectHasher and the benchmark's own reference: equal points, round 2 and
the host fallback included; the grouped check over it; and the CIP22 path
through the same round, its points and graph tags."""

import numpy as np
import pytest
import torch

from celo_bls_snark_tpu_torch.hash_to_curve.try_and_increment import TryAndIncrement
from celo_bls_snark_tpu_torch.hash_to_curve.try_and_increment_cip22 import (
    TryAndIncrementCIP22,
)
from celo_bls_snark_tpu_torch.hashers.direct import DirectHasher
from celo_bls_snark_tpu_torch.hostmath import curves as hc
from celo_bls_snark_tpu_torch.hostmath.params import G2_GENERATOR, R
from celo_bls_snark_tpu_torch.keys import SIG_DOMAIN
from celo_bls_snark_tpu_torch.ops import bls as tbls
from celo_bls_snark_tpu_torch.ops import blake2s as db
from celo_bls_snark_tpu_torch.ops import curve as tdc
from celo_bls_snark_tpu_torch.ops import hash_to_g1 as th
from celo_bls_snark_tpu_torch.utils import aotcache, profiling

torch.set_num_threads(1)

# first valid counters before CIP22 (DirectHasher, no extra data): 2 0 0 0
# 3 10, so with round 1 over counter 0 and num_counters 3 the batch takes
# round 1, round 2 (counters 1, 2) and the host fallback (3 and 10)
MSGS = [b"direct msg %03d" % i for i in range(6, 12)]
ATTEMPTS = [2, 0, 0, 0, 3, 10]
COUNTERS = 3


def host_direct(msgs, extra=b""):
    h2c = TryAndIncrement(DirectHasher(), "g1", True)
    return [h2c.hash_with_attempt(SIG_DOMAIN, m, th.extra_data_of(extra, i))
            for i, m in enumerate(msgs)]


@pytest.fixture(scope="module")
def direct_hashes():
    """The hashes of MSGS through hash_messages_device (round 1 over counter
    0), as host points, and the lanes the host fallback hashed."""
    mp = pytest.MonkeyPatch()
    mp.setattr(th, "ROUND1_COUNTERS", 1)
    try:
        jac, fallback = th.hash_messages_device(SIG_DOMAIN, MSGS, b"", num_counters=COUNTERS,
                                                device="cpu", cip22=False)
    finally:
        mp.undo()
    return tdc.g1_unpack(jac), fallback


@pytest.mark.parametrize("cip22", (False, True), ids=["direct", "cip22"])
def test_lane_words_are_counter_extra_message(cip22):
    """Lane c * m + i of a round is c_lo + c || extra_data_i || row_i,
    word for word as the host packs it, per-message extra data included.
    Row i is message i before CIP22, and under CIP22 its CRH digest, made
    and left on the device."""
    msgs = [b"m%02d" % i + bytes(range(60)) for i in range(5)]
    extras = [b"e%d" % i for i in range(5)]
    if cip22:
        rows = th._message_crh_rows(SIG_DOMAIN, msgs, "cpu")
        want_rows = [DirectHasher().crh(SIG_DOMAIN, m, th.HASH_BYTES) for m in msgs]
    else:
        rows = want_rows = msgs
    words, msg_len = th.lane_message_words(rows, th.extra_data_rows(extras, 5), "cpu")
    assert msg_len == 1 + 2 + len(want_rows[0])
    assert words.shape == ((16 if cip22 else 32), 5)
    c_lo, nc = 7, 3
    got = th._lane_words(words, c_lo, nc).numpy()
    want = db.pack_messages([bytes([c_lo + c]) + e + r for c in range(nc)
                             for r, e in zip(want_rows, extras)])
    np.testing.assert_array_equal(got, want.astype(np.int64))


def test_direct_hash_equals_host_try_and_increment(direct_hashes):
    pts, fallback = direct_hashes
    want = host_direct(MSGS)
    assert [c for _, c in want] == ATTEMPTS
    # the host hashed exactly the messages whose first valid counter is >= 3
    assert fallback == [i for i, c in enumerate(ATTEMPTS) if c >= COUNTERS]
    assert pts == [pt for pt, _ in want]


def test_direct_hash_equals_the_benchmark_reference(direct_hashes):
    from benchmark.reference import hashing

    pts, _ = direct_hashes
    assert pts == [hashing.hash_to_g1("direct", SIG_DOMAIN, m, b"", True, cip22=False)
                   for m in MSGS]


@pytest.mark.parametrize("cip22", (False, True), ids=["direct", "cip22"])
def test_a_candidate_of_cofactor_order_goes_to_the_host(cip22, monkeypatch):
    """A first valid candidate whose cofactor multiple is infinity (here
    x = 0, a point of order 3, put in counter 0 of message 0 on the card and
    on the host alike) is skipped by the host path, before CIP22 and under
    it: the card hands the message to the host, which moves on to the next
    counter."""
    msgs = MSGS[1:4]
    # the lane hash that gives counter 0 of message 0, on the card and the host
    card_fn, host_fn = ("blake2xs_batch", "xof") if cip22 else ("_direct_hash_words", "hash")
    real_lane_hash, real_host_hash = getattr(db, card_fn), getattr(DirectHasher, host_fn)
    row = DirectHasher().crh(SIG_DOMAIN, msgs[0], th.HASH_BYTES) if cip22 else msgs[0]
    first = th.lane_message_words([row], th.extra_data_rows(b"", 1), "cpu")[0][:, 0]

    def lane_hash(lanes, *args, **kw):
        out = real_lane_hash(lanes, *args, **kw)
        if torch.equal(lanes[:, 0], first):
            out = out.clone()
            out[..., 0] = 0
        return out

    def host_hash(self, domain, message, n):
        if message == b"\x00" + row:
            return bytes(n)
        return real_host_hash(self, domain, message, n)

    monkeypatch.setattr(db, card_fn, lane_hash)
    monkeypatch.setattr(DirectHasher, host_fn, host_hash)
    monkeypatch.setattr(th, "ROUND1_COUNTERS", 2)
    h2c = (TryAndIncrementCIP22(DirectHasher(), "g1", True).hash_with_attempt_cip22 if cip22
           else TryAndIncrement(DirectHasher(), "g1", True).hash_with_attempt)
    want = [h2c(SIG_DOMAIN, m, b"") for m in msgs]
    assert want[0][1] > 0 and max(c for _, c in want[1:]) < 2
    assert hc.G1.scale_by_cofactor((0, 1)) is None
    hashes, fallback = th.hash_messages_device(SIG_DOMAIN, msgs, b"", num_counters=2,
                                               device="cpu", cip22=cip22)
    assert fallback == [0] and tdc.g1_unpack(hashes) == [pt for pt, _ in want]


@pytest.mark.parametrize("forged", [False, True], ids=["honest", "seal_swapped"])
def test_batch_verify_messages_before_cip22(forged):
    """The grouped check over the pre-CIP22 hashes (one message through
    the host fallback) accepts the committee's seals and rejects a batch
    with one seal of another block."""
    msgs = MSGS[1:]
    sk = 0x1234567890ABCDEF % R
    sigs = [hc.G1.mul(sk, pt) for pt, _ in host_direct(msgs)]
    if forged:
        sigs[0] = sigs[1]
    ok = tbls.batch_verify_messages_device(
        tdc.g1_pack(sigs, "cpu"), tbls.pack_g2_affine([hc.G2.mul(sk, G2_GENERATOR)], "cpu"),
        SIG_DOMAIN, msgs, b"", composite=False, num_counters=5, compat=True, cip22=False)
    assert bool(ok[0]) is not forged


def test_cip22_path_points_and_graph_tags(monkeypatch):
    """cip22=True (the default) gives the host CIP22 points through the one
    round: its graphs are h2g_crh, the rounds under h2g_round_cip22 (of the
    same scheme as the rounds before CIP22) and h2g_merge, and the round-2
    lanes are counted."""
    tags = []
    real_jit = aotcache.jit

    def recording(tag, fn, *owners):
        tags.append(tag)
        return real_jit(tag, fn, *owners)

    monkeypatch.setattr(aotcache, "jit", recording)
    monkeypatch.setattr(th, "ROUND1_COUNTERS", 1)
    # first valid CIP22 counters 2 and 1: both messages take round 2
    msgs = [b"direct msg 005", b"direct msg 006"]
    profiling.reset()
    jac, has = th.hash_to_g1_device(SIG_DOMAIN, msgs, b"", num_counters=3, device="cpu")
    h2c = TryAndIncrementCIP22(DirectHasher(), "g1", True)
    want = [h2c.hash_with_attempt_cip22(SIG_DOMAIN, m, b"") for m in msgs]
    assert [c for _, c in want] == [2, 1] and has.all()
    assert tdc.g1_unpack(jac) == [pt for pt, _ in want]
    dom = SIG_DOMAIN.hex()
    assert tags == [f"h2g_crh_{len(msgs[0])}_{dom}", f"h2g_round_cip22_33_{dom}_1_0_1_2",
                    f"h2g_round_cip22_33_{dom}_1_1_2_2", "h2g_merge_2"]
    # one chunk of cap 2 over counters 1 and 2
    assert profiling.report()[th.ROUND2_LANES] == {"calls": 1, "total_s": 4.0}


@pytest.mark.gpu
def test_the_cells_hashes_on_the_card_equal_the_reference():
    """Every message of the two timed sets of the benchmark cell
    sync100.direct (2 x 17,280), hashed on the card as its calls hash them
    (before CIP22, 24 counters, then the host fallback), equals the
    benchmark reference's affine hash, coordinate for coordinate."""
    if not torch.cuda.is_available():
        pytest.skip("hashes on a CUDA card")
    from benchmark import run
    from benchmark.reference import work

    _spec, _entry, cell, config = run.cell_spec("sync100.direct")
    M, S = cell["params"]["messages_per_call"], cell["params"]["sets"]
    ex = work.pool(work.default_workers())
    try:
        want = work.message_hashes(ex, config, range(S * M))
    finally:
        ex.shutdown()
    equal, fallback = 0, []
    for s in range(S):
        msgs = [work.message(config, i) for i in range(s * M, (s + 1) * M)]
        jac, host = th.hash_messages_device(
            config["domain"].encode(), msgs, work.extra(config, 0),
            num_counters=cell["params"]["num_counters"], compat=config["compat"],
            device="cuda", cip22=config["cip22"])
        got = tdc.g1_unpack(jac)
        equal += sum(g == want[s * M + i] for i, g in enumerate(got))
        fallback += [s * M + i for i in host]
    print(f"{equal} of {S * M} device hashes equal the reference's; "
          f"host fallback for messages {fallback}")
    assert equal == S * M

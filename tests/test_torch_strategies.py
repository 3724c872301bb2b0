"""The port's four-strategy batch-BLS bench
(celo_bls_snark_tpu_torch/scripts/bench_strategies.py) on the CPU, at
B = 2 blocks x V = 2 validators: the derived keys, signatures and
aggregates against hostmath, each strategy's verdict on honest inputs, on a
tamper of its own and on a compensating forgery (the last held to hostmath
pairings), and a strategy with the block hashing under the capture guard.
No JAX: the strategies' pairings are held to the JAX package's in
tests/test_torch_slice.py and tests/test_torch_strict_verify.py. Integer
work: the tolerance is 0."""

import numpy as np
import pytest
import torch

from celo_bls_snark_tpu_torch.hostmath import curves as hc
from celo_bls_snark_tpu_torch.hostmath import pairing as hp
from celo_bls_snark_tpu_torch.hostmath.params import G1_GENERATOR, G2_GENERATOR, R
from celo_bls_snark_tpu_torch.ops import bls as dbls
from celo_bls_snark_tpu_torch.ops import curve as dc
from celo_bls_snark_tpu_torch.scripts import bench_strategies as S
from celo_bls_snark_tpu_torch.utils import aotcache
from celo_bls_snark_tpu_torch.utils.tree import tree_map
from torch_capture_guard import rehearse_captures

torch.set_num_threads(1)

B, V, SEED = 2, 2, 20261021
NAMES = list(S.ARGS)


def needs_card():
    if not torch.cuda.is_available():
        pytest.skip("captures CUDA graphs: needs a CUDA card")


@pytest.fixture(scope="module")
def inp():
    return S.build_inputs(B, V, SEED, "cpu")


@pytest.fixture(scope="module")
def strategies(inp):
    return dict(S.make_strategies(inp))


def double_lane(pt, lane):
    """A G1 projective batch with lane `lane` replaced by its double."""
    d = dc.g1.double(tree_map(lambda x: x[:, lane:lane + 1], pt))
    return tree_map(lambda d, x: torch.cat([x[:, :lane], d, x[:, lane + 1:]], dim=-1), d, pt)


def hashed(inp):
    """The block hashes as the strategies take them, from the host's."""
    return {"h_aff": inp["h_aff"], "h_per_val": inp["h_per_val"]}


# each strategy's own tamper: one per-block aggregate, the total, one signature
TAMPER = {
    "per-epoch aggregate screening": lambda x: {"asig_b": double_lane(x["asig_b"], 1)},
    "all epoch aggregate screening": lambda x: {"asig": double_lane(x["asig"], 0)},
    "per-epoch batch verification": lambda x: {"sig_jac": double_lane(x["sig_jac"], 3)},
    "per-epoch individual verification":
        lambda x: {"sig_jac": double_lane(x["sig_jac"], 3)},
}


def test_derived_points_equal_hostmath(inp):
    """derive's public keys sk G2, signatures sk H_b, per-block aggregates
    and their total, every lane against hostmath; the messages are the JAX
    script's and the affine hashes the host's."""
    sks, hs = inp["sks"], inp["hashes"]
    assert len(set(sks)) == B * V and all(0 < s < R for s in sks)
    assert inp["msgs"] == [b"block 000000", b"block 000001"]
    assert inp["extras"] == [b"extra 0000", b"extra 0001"]
    assert dc.g2_unpack(inp["pk_jac"]) == [hc.G2.mul(s, G2_GENERATOR) for s in sks]
    assert dc.g1_unpack(inp["sig_jac"]) == [hc.G1.mul(s, hs[j // V]) for j, s in enumerate(sks)]
    sums = [sum(sks[b * V:(b + 1) * V]) % R for b in range(B)]
    assert dc.g2_unpack(inp["apk_b"]) == [hc.G2.mul(k, G2_GENERATOR) for k in sums]
    asig_b = [hc.G1.mul(k, h) for k, h in zip(sums, hs)]
    assert dc.g1_unpack(inp["asig_b"]) == asig_b
    assert dc.g1_unpack(inp["asig"]) == [hc.G1.msum(asig_b)]
    assert dc.g1_unpack(dc.g1.from_affine(inp["h_aff"])) == hs
    # 17-byte exponents in windows of 4 bits
    assert tuple(inp["expdigits"].shape) == (34, B * V)


@pytest.mark.parametrize("name", NAMES)
def test_honest_true_and_own_tamper_false(name, inp, strategies):
    """Each strategy is True on honest inputs and False on its own tamper.
    The all-epoch screening's honest call runs under the capture guard
    (tests/torch_capture_guard.py): its program runs clean after its
    eager call."""
    fn = strategies[name]
    if name == "all epoch aggregate screening":
        with rehearse_captures() as seen:
            assert bool(fn(**hashed(inp)))
        assert seen == [f"strategies_all_epoch_aggregate_{B}_{V}"]
    else:
        assert bool(fn(**hashed(inp)))
    assert not bool(fn(**hashed(inp), **TAMPER[name](inp)))


def test_block_hashing_equals_the_host_hashes(inp):
    """make_hasher's card hashing (composite CRH, try-and-increment) gives
    the host's block hashes, and to_aff and rep shape them as the
    strategies take them: affine, and each block's hash V times."""
    hash_blocks, to_aff, rep = S.make_hasher(inp)
    jac = hash_blocks()
    assert dc.g1_unpack(jac) == inp["hashes"]
    assert all(torch.equal(x, y) for x, y in zip(to_aff(jac), dc.g1.to_affine(jac)))
    assert dc.g1_unpack(rep(jac)) == [h for h in inp["hashes"] for _ in range(V)]


def test_compensating_forgery(inp, strategies):
    """Two signatures of block 0 shifted by +D and -D, the aggregates
    recomputed by derive's sums: the aggregate screenings (1, 2) stay True
    and the per-signature strategies (3, 4) turn False, the reference's
    semantics (the screenings are not rogue-key safe). hostmath agrees:
    block 0's aggregate equation holds, its first signature's fails."""
    D = hc.G1.mul(0x5EED, G1_GENERATOR)
    d = dc.g1_pack([D, hc.G1.neg(D)] + [None] * (B * V - 2), "cpu")
    sig = dc.g1.add(inp["sig_jac"], d)
    asig_b, asig = S.sig_sums(sig, B)
    forged = {"sig_jac": sig, "asig_b": asig_b, "asig": asig, **hashed(inp)}
    assert dc.g1_unpack(asig_b) == dc.g1_unpack(inp["asig_b"])
    got = [bool(strategies[name](**forged)) for name in NAMES]
    assert got == [True, True, False, False]
    negg2 = hc.G2.neg(G2_GENERATOR)
    h0, sig0 = inp["hashes"][0], dc.g1_unpack(sig)[0]
    apk0, pk0 = dc.g2_unpack(inp["apk_b"])[0], dc.g2_unpack(inp["pk_jac"])[0]
    assert hp.pairing_check([(dc.g1_unpack(asig_b)[0], negg2), (h0, apk0)])
    assert not hp.pairing_check([(sig0, negg2), (h0, pk0)])


def test_interleave_lane_order():
    """_interleave, which the strategies pair their legs with, puts lanes
    a0 b0 a1 b1 ... on every leaf of a nested tree, as the JAX script's
    interleave (jnp.stack([x, y], -1) reshaped) does."""
    a = ((torch.arange(6).reshape(2, 3), torch.arange(3)[None]), torch.arange(3)[None])
    b = tree_map(lambda x: x + 100, a)
    out = dbls._interleave(a, b)
    want = tree_map(lambda x, y: np.stack([x.numpy(), y.numpy()], -1).reshape(x.shape[0], -1),
                    a, b)
    assert tree_map(lambda x: x.tolist(), out) == tree_map(lambda x: x.tolist(), want)
    assert out[1].tolist() == [[0, 100, 1, 101, 2, 102]]


def test_bench_needs_a_card_unless_asked_for_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        S.main(["--blocks", "2", "--validators", "2"])


# --- on the card --------------------------------------------------------------

@pytest.mark.gpu
def test_strategy_graphs_replay_equal_to_their_eager_run():
    """On the card: each strategy's verdicts through its graph (eager,
    capture, replays) equal the eager run's, honest True and tampered
    False, and derive's replay equals its eager run limb for limb."""
    needs_card()
    aotcache.clear()
    x = S.build_inputs(B, V, SEED, "cuda")
    derive = aotcache.jit(f"strategies_derive_{B}_{V}", None)
    args = (dbls.scalars_to_bits(x["sks"], x["device"]),
            dc.g2_pack([G2_GENERATOR] * (B * V), x["device"]), x["h_per_val"])
    eager = derive.fn(*args)
    for got in (derive(*args), derive(*args)):
        assert all(torch.equal(p, q) for p, q in zip(aotcache.tree_leaves(got),
                                                     aotcache.tree_leaves(eager)))
    for name, fn in S.make_strategies(x):
        assert [bool(fn()) for _ in range(3)] == [True] * 3
        assert not bool(fn(**TAMPER[name](x)))
    replayed = {e.jit.tag: e.replays for e in aotcache.entries()}
    assert all(replayed[f"strategies_{t}"] >= 2 for t in (
        f"per_epoch_aggregate_{B}_{V}", f"all_epoch_aggregate_{B}_{V}",
        f"per_epoch_batch_{B}_{V}_c{S.C}", f"individual_{B}_{V}"))

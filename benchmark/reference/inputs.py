"""The input maker: every batch a cell's window sends, made from the seed
with the reference's hashes and keys and nothing of the program's.

A run cycles through its batches: honest ones over disjoint sets of lanes,
then each set again with a forged signature,

    honest.0, honest.1, ..., forged.0, forged.1, ...

so that no call sees the inputs of the call before it, and a program that
answers True (or False) regardless fails. forged.s's forgery sits in the
first half of the lanes (blocks) at an even position for even s, in the
second half at an odd one for odd s, so a program that leaves out either
half, or every other lane, accepts one of them.

The work does not depend on the seed: the messages are fixed (their hashes
are cached per checkout), and the seed draws the keys, the order of the
lanes, their signs, the exponents and where the forgeries sit.
"""

import random

import numpy as np

from . import group, work
from .params import R

BATCHES = ("honest.0", "honest.1", "forged.0", "forged.1")
CHAIN_CHUNK = 64  # seals a worker job multiplies out into lanes


def set_of(batch: int) -> int:
    return batch % 2


def _lane(rng, lo, hi, parity):
    """A lane in [lo, hi) of the given parity."""
    return lo + parity + 2 * rng.randrange((hi - lo - parity + 1) // 2)


def exponent_bytes(size: int, security: int) -> int:
    """Batch::verify's exponent size, min(ceil((security + log2 n) / 8),
    |Fr| / 8) bytes (crates/bls-crypto/src/bls/batch.rs:20-28)."""
    log2 = 0 if size <= 1 else (size - 1).bit_length()
    return min((security + log2 + 7) // 8, 253 // 8)


class GroupedInputs:
    """Committed seals of `committees` committees (config "validators"
    each), a committee's lanes contiguous, for the grouped check. Every lane
    of a call holds a distinct point: `seals` messages' hashes H_j, a
    committee's own share of them, each multiplied out over `multiples` =
    messages_per_call / seals lanes as k H_j with the seal k sk_g H_j
    (k = 1 .. multiples), and then taken under one of six variants,
    endo^e(+-P) for e = 0, 1, 2 (group.endo), the same for a lane's hash and
    seal. Each of the `sets` sets (at most six) orders a committee's lanes by
    its own permutation, and gives each point a variant that no other set
    gives it, all drawn from the seed: no lane of a set repeats in another."""

    VARIANTS = 6  # endo^e(+-P)

    def __init__(self, config, params, seed, ex):
        self.config = config
        G = self.G = params["committees"]
        M = self.M = params["messages_per_call"]
        D = self.D = params["seals"]
        S = self.S = params["sets"]
        if M % D or D % G or D // G < 2 or not 2 <= S <= self.VARIANTS:
            raise ValueError(f"messages {M}, seals {D}, committees {G}, sets {S} do not tile")
        K = self.K = M // D
        if M // G > config["epoch_blocks"]:
            raise ValueError(f"{M // G} blocks of one committee pass an epoch")
        self.batches = tuple(f"honest.{s}" for s in range(S)) + tuple(
            f"forged.{s}" for s in range(S))
        rng = random.Random(seed)
        self.sks = [sum(rng.randrange(1, R) for _ in range(config["validators"])) % R
                    for _ in range(G)]
        self._apk_jobs = [ex.submit(work.g2_mul, sk) for sk in self.sks]
        got = work.message_hashes(ex, config, range(D))
        self.hashes = [got[j] for j in range(D)]
        per = self.per = D // G
        self._lane_jobs = [
            ex.submit(work.seal_lanes, self.hashes[i:i + CHAIN_CHUNK],
                      [self.sks[j // per] for j in range(i, min(i + CHAIN_CHUNK, D))], K)
            for i in range(0, D, CHAIN_CHUNK)]
        # a lane's point: flat index j * K + k - 1, and its variant v (e =
        # v // 2, negated when v is odd)
        nprng = np.random.default_rng(rng.getrandbits(64))
        lanes_g = M // G
        variants = nprng.permuted(np.tile(np.arange(self.VARIANTS), (M, 1)), axis=1)
        self.src, self.variant = [], []
        for s in range(S):
            parts = [g * lanes_g + nprng.permutation(lanes_g) for g in range(G)]
            self.src.append(np.concatenate(parts).astype(np.int64))
            self.variant.append(variants[self.src[s], s])
        # a forged lane holds the seal of another message of its committee
        self.sig_src = list(self.src)
        self.forged_lanes = [None] * S
        for s in range(S):
            lo, hi, parity = (0, M // 2, 0) if s % 2 == 0 else (M // 2, M, 1)
            lane = _lane(rng, lo, hi, parity)
            j = int(self.src[s][lane]) // K
            g = j // per
            other = g * per + (j - g * per + 1 + rng.randrange(per - 1)) % per
            forged = self.src[s].copy()
            forged[lane] = other * K + rng.randrange(K)
            self.sig_src.append(forged)
            self.forged_lanes.append(lane)

    def finish(self):
        """Wait for the keys, the seals and their lanes: self.lanes holds,
        for the hashes and the seals, the x limbs under each map and the y
        limbs of every point in flat order."""
        self.apks = [j.result() for j in self._apk_jobs]
        done = [j.result() for j in self._lane_jobs]
        self.sigs = [p for d in done for p in d[0]]
        self.lanes = {name: ([np.concatenate([d[i][0][e] for d in done], axis=1)
                              for e in range(3)],
                             np.concatenate([d[i][1] for d in done], axis=1))
                      for i, name in ((1, "hash"), (2, "sig"))}
        return self

    def _terms(self, src, variant, mask, points):
        """(points, signed multiple a point, e) for e = 0, 1, 2, over the
        lanes of `mask`."""
        mult = src % self.K + 1
        signed = np.where(variant % 2 == 1, -mult, mult)
        out = []
        for e in range(3):
            sel = mask & (variant // 2 == e)
            counts = np.zeros(self.D, np.int64)
            np.add.at(counts, src[sel] // self.K, signed[sel])
            out.append((points, counts.tolist(), e))
        return out

    def judge_jobs(self, ex, lanes=None):
        """One job a batch deciding the grouped check (verify.grouped_ok)
        over the batch's lanes, or over `lanes` alone (a mask)."""
        from .verify import grouped_ok

        jobs = []
        lanes_g = self.M // self.G
        mask = np.ones(self.M, bool) if lanes is None else lanes
        for batch in range(len(self.batches)):
            s = batch % self.S
            groups = []
            for g in range(self.G):
                sel = np.zeros(self.M, bool)
                sel[g * lanes_g:(g + 1) * lanes_g] = True
                groups.append((self._terms(self.src[s], self.variant[s], sel & mask,
                                           self.hashes), self.apks[g]))
            jobs.append(ex.submit(grouped_ok, self._terms(self.sig_src[batch], self.variant[s],
                                                          mask, self.sigs), groups))
        return jobs


class StrategyInputs:
    """The criterion bench of crates/bls-crypto/benches/batch_bls.rs:16-97:
    `blocks` blocks, each signed by `validators` fresh keys, with the
    random exponents of Batch::verify. forged.1 is the compensating forgery
    that aggregate screening accepts: two signatures of one block shifted
    by +D and -D."""

    def __init__(self, config, params, seed, ex):
        self.config = config
        B, V = self.B, self.V = config["blocks"], config["validators_per_block"]
        self.exp_bytes = exponent_bytes(V, config["security_bits"])
        if self.exp_bytes != config["exponent_bytes"]:
            raise ValueError("exponent size differs from the configuration's")
        rng = random.Random(seed)
        self.blocks = [list(range(s * B, (s + 1) * B)) for s in range(2)]
        got = work.message_hashes(ex, config, self.blocks[0] + self.blocks[1])
        self.hashes = [[got[i] for i in idx] for idx in self.blocks]
        self.sks = [[rng.randrange(1, R) for _ in range(B * V)] for _ in range(2)]
        self.exps = [[rng.getrandbits(8 * self.exp_bytes) % R for _ in range(B * V)]
                     for _ in range(2)]
        self._key_jobs = [[ex.submit(work.block_keys, self.hashes[s][b],
                                     self.sks[s][b * V:(b + 1) * V]) for b in range(B)]
                          for s in range(2)]
        # forged.0: one signature of an even block in the first half swapped
        # for the same validator's signature of the next block
        b0 = _lane(rng, 0, B // 2, 0)
        self.forgery = [None, None, (b0, rng.randrange(V)),
                        (_lane(rng, B // 2, B, 1), *rng.sample(range(V), 2))]

    def finish(self):
        """Wait for the keys and signatures, and forge."""
        B, V = self.B, self.V
        self.pks, self.sigs = [], []
        for jobs in self._key_jobs:
            pks, sigs = [], []
            for j in jobs:
                p, s = j.result()
                pks += p
                sigs += s
            self.pks.append(pks)
            self.sigs.append(sigs)
        b0, i0 = self.forgery[2]
        f0 = list(self.sigs[0])
        f0[b0 * V + i0] = self.sigs[0][(b0 + 1) * V + i0]
        b1, i, k = self.forgery[3]
        d = self.hashes[1][(b1 + 1) % B]
        f1 = list(self.sigs[1])
        f1[b1 * V + i] = group.G1.add(f1[b1 * V + i], d)
        f1[b1 * V + k] = group.G1.add(f1[b1 * V + k], group.G1.neg(d))
        self.sigs += [f0, f1]
        return self

    def messages(self, batch: int):
        s, c = set_of(batch), self.config
        return ([work.message(c, i) for i in self.blocks[s]],
                [work.extra(c, i) for i in self.blocks[s]])

    def block(self, batch: int, b: int):
        """(H, sigs, pks, sks, exps) of block b of the batch."""
        s, V = set_of(batch), self.V
        sl = slice(b * V, (b + 1) * V)
        return (self.hashes[s][b], self.sigs[batch][sl], self.pks[s][sl],
                self.sks[s][sl], self.exps[s][sl])

    def forged_block(self, batch: int):
        return None if self.forgery[batch] is None else self.forgery[batch][0]

    def judge_jobs(self, ex, mode: str, seed: int):
        """Per batch, the verdict of each block in the discrete-logarithm
        form (a block untouched by a forgery is judged once for both batches
        of its set), and a sample of blocks in both forms: each forged block
        and one block of each honest batch drawn from the seed.
        Returns (per-batch block jobs, [(dl job, pairing job)])."""
        rng = random.Random(seed)
        memo, per_batch = {}, []
        for batch in range(len(BATCHES)):
            s, fb = set_of(batch), self.forged_block(batch)
            jobs = []
            for b in range(self.B):
                key = (s, b, batch if b == fb else None)
                if key not in memo:
                    memo[key] = ex.submit(work.block_ok, mode, "dl", *self.block(batch, b), 0)
                jobs.append(memo[key])
            per_batch.append(jobs)
        sample = []
        for batch in range(len(BATCHES)):
            b = self.forged_block(batch)
            b = rng.randrange(self.B) if b is None else b
            sample.append((per_batch[batch][b],
                           ex.submit(work.block_ok, mode, "pairing", *self.block(batch, b),
                                     rng.getrandbits(64))))
        return per_batch, sample

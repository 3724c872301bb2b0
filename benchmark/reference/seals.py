"""The input maker of the cells whose program hashes the seals' messages
itself: an epoch of committed seals a batch, as a syncing node checks them,
made from the seed with the reference's hashes and keys and nothing of the
program's.

Each of `sets` sets is one epoch of `messages_per_call` blocks (distinct
messages, no message in two sets) sealed by that epoch's committee: its key
is the sum of `validators` secret keys drawn from the seed, and a block's
seal is that sum times the reference's hash of the block's message. The
batches cycle as in inputs.py, honest.0, honest.1, ..., forged.0,
forged.1, ...: forged.s holds in one lane the seal of another block of its
epoch, in the first half at an even lane for even s, in the second half at
an odd one for odd s. The messages do not depend on the seed (their hashes
are cached per checkout); the seed draws the keys and the forgeries.
"""

import random

import numpy as np

from . import group, pack, work
from .inputs import _lane
from .params import R

SEAL_CHUNK = 256  # seals a worker job makes


def seal_chunk(hashes, sk):
    """The seals sk H of the hashes H, as affine points and as the card's
    projective limbs."""
    seals = [group.G1.mul(sk, h) for h in hashes]
    return seals, pack.g1_projective(seals)


class DirectSealInputs:
    """One committee's epoch of seals a batch (the grouped check at G = 1),
    the messages themselves handed to the program."""

    def __init__(self, config, params, seed, ex):
        self.config = config
        M = self.M = params["messages_per_call"]
        S = self.S = params["sets"]
        if params["committees"] != 1:
            raise ValueError("a batch holds one committee's epoch")
        if M > config["epoch_blocks"] or M < 4 or S < 2:
            raise ValueError(f"{M} blocks a batch, {S} sets")
        self.batches = tuple(f"honest.{s}" for s in range(S)) + tuple(
            f"forged.{s}" for s in range(S))
        rng = random.Random(seed)
        self.sks = [sum(rng.randrange(1, R) for _ in range(config["validators"])) % R
                    for _ in range(S)]
        self._apk_jobs = [ex.submit(work.g2_mul, sk) for sk in self.sks]
        self.blocks = [range(s * M, (s + 1) * M) for s in range(S)]
        got = work.message_hashes(ex, config, range(S * M))
        self.hashes = [[got[i] for i in b] for b in self.blocks]
        self.messages = [[work.message(config, i) for i in b] for b in self.blocks]
        self.extra = work.extra(config, 0)
        self._seal_jobs = [[ex.submit(seal_chunk, self.hashes[s][i:i + SEAL_CHUNK], self.sks[s])
                            for i in range(0, M, SEAL_CHUNK)] for s in range(S)]
        # forged.s: lane `lane` holds the seal of block `other` of its epoch
        self.forgery = [None] * S
        for s in range(S):
            lane = _lane(rng, *((0, M // 2, 0) if s % 2 == 0 else (M // 2, M, 1)))
            self.forgery.append((lane, (lane + 1 + rng.randrange(M - 1)) % M))

    def ready(self) -> bool:
        """Whether the workers have made the keys and the seals."""
        return all(j.done() for jobs in [self._apk_jobs, *self._seal_jobs] for j in jobs)

    def finish(self):
        """Wait for the committees' keys and the seals: self.seals holds each
        set's affine seals, self.seal_limbs their (X, Y, Z) limb arrays."""
        self.apks = [j.result() for j in self._apk_jobs]
        self.seals, self.seal_limbs = [], []
        for jobs in self._seal_jobs:
            done = [j.result() for j in jobs]
            self.seals.append([p for d in done for p in d[0]])
            self.seal_limbs.append(tuple(np.concatenate([d[1][c] for d in done], axis=1)
                                         for c in range(3)))
        return self

    def lane_seals(self, batch: int):
        """The seal index each lane of the batch holds."""
        src = list(range(self.M))
        if self.forgery[batch] is not None:
            lane, other = self.forgery[batch]
            src[lane] = other
        return src

    def judge_jobs(self, ex, lanes=None):
        """One job a batch deciding the grouped check (verify.grouped_ok) at
        G = 1 over the reference's hashes and the batch's seals, over every
        lane or over the lanes of the mask `lanes` alone."""
        from .verify import grouped_ok

        use = [True] * self.M if lanes is None else [bool(x) for x in lanes]
        hash_counts = [int(u) for u in use]
        jobs = []
        for batch in range(len(self.batches)):
            s = batch % self.S
            sig_counts = [0] * self.M
            for lane, j in enumerate(self.lane_seals(batch)):
                sig_counts[j] += use[lane]
            jobs.append(ex.submit(grouped_ok, [(self.seals[s], sig_counts, 0)],
                                  [([(self.hashes[s], hash_counts, 0)], self.apks[s])]))
        return jobs

"""One strategy of the reference's criterion bench (crates/bls-crypto/
benches/batch_bls.rs:16-97) through the program's
celo_bls_snark_tpu_torch/scripts/bench_strategies.py: each call hashes the
blocks' messages on the card as make_hasher's hash_blocks does (composite
CRH, then the try-and-increment rounds), shapes the hashes with its
to_aff or rep program, runs strategy_programs(B, V)[strategy] and reads the
verdict to the host, the calls that make_strategies makes.

Cell parameters: strategy (a name of bench_strategies.ARGS whose inputs are
signatures, keys, exponents and hashes: the batch and individual
strategies), judge (the reference's block check: strict, screen or
individual), control (the check that stands in for the program in the
control run).
"""

import numpy as np
import torch

from benchmark.reference import inputs, pack
from benchmark.reference.params import G2_GENERATOR


# replays after the warm-up, counted in the set-up: on some machines the
# first 10-15 s of replays after the set-up run about a quarter slower
SETTLE_CALLS = 80


def _to(tree, device):
    if isinstance(tree, tuple):
        return tuple(_to(t, device) for t in tree)
    return torch.from_numpy(np.ascontiguousarray(tree)).to(device)


class Driver:
    def __init__(self, config, params, seed, device, ex):
        from celo_bls_snark_tpu_torch.scripts import bench_strategies as S

        self.S, self.config, self.params, self.device = S, config, params, device
        self.seed = seed
        self.name = params["strategy"]
        self.args = S.ARGS[self.name]
        self.inp = inputs.StrategyInputs(config, params, seed, ex)
        self.batches = inputs.BATCHES
        # the cycle twice: a set's messages fix its hashing's shapes, so every
        # program's key has had its eager call and its capture after it
        self.warm_up = tuple(range(2 * len(self.batches) + SETTLE_CALLS))
        self.sigs_per_call = self.inp.B * self.inp.V

    def _set_inputs(self, batch, sigs, pks):
        """The program arguments of one batch but its hashes."""
        inp, dev = self.inp, self.device
        s = batch % 2
        args = {"sig_jac": lambda: pack.g1_projective(sigs),
                "pk_jac": lambda: pack.g2_projective(pks),
                "expdigits": lambda: pack.window_digits(inp.exps[s], 8 * inp.exp_bytes,
                                                        self.S.C)}
        return {a: _to(args[a](), dev) for a in self.args[:-1]}

    def load(self):
        """The programs and warm-up inputs of the timed shapes: each block's
        hash in place of its signatures and the generator in place of the
        keys, which are still being made."""
        inp, S = self.inp, self.S
        B, V = inp.B, inp.V
        self.progs = S.strategy_programs(B, V)
        self.messages = [inp.messages(s) for s in range(2)]
        _hash, self.to_aff, self.rep = S.make_hasher(
            {"msgs": self.messages[0][0], "extras": self.messages[0][1], "V": V,
             "device": self.device})
        self.batch_args = [self._set_inputs(b, [h for h in inp.hashes[b % 2] for _ in range(V)],
                                            [G2_GENERATOR] * (B * V))
                           for b in range(2)] * 2

    def finish(self):
        inp = self.inp.finish()
        self.batch_args = [self._set_inputs(b, inp.sigs[b], inp.pks[b % 2])
                           for b in range(len(self.batches))]

    def call(self, k, span):
        from celo_bls_snark_tpu_torch.ops.hash_to_g1 import (composite_crh_bytes,
                                                             hash_to_g1_device)

        b = k % len(self.batches)
        c = self.config
        msgs, extras = self.messages[b % 2]
        with span("h2g.crh"):
            crh_u8 = composite_crh_bytes(msgs, self.device)
        jac, has = hash_to_g1_device(c["domain"].encode(), msgs, extras, compat=c["compat"],
                                     num_counters=c["num_counters"], crh_u8=crh_u8,
                                     device=self.device)
        if not has.all():
            raise RuntimeError("a block message found no point within the counters")
        hashed = self.to_aff(jac) if self.args[-1] == "h_aff" else self.rep(jac)
        args = [*self.batch_args[b].values(), hashed]
        with span("verify.check"):
            return bool(self.progs[self.name](*args))

    def release(self):
        self.batch_args = self.progs = None

    def judge(self, ex, control=False):
        """Per batch, whether every block passes the reference's check (the
        control's check with `control`). The check's two forms must agree on
        the sampled blocks, else the reference itself is at fault and the
        run ends without a result."""
        mode = self.params["control"] if control else self.params["judge"]
        per_batch, sample = self.inp.judge_jobs(ex, mode, self.seed)
        verdicts = [all(j.result() for j in jobs) for jobs in per_batch]
        disagree = [(dl.result(), pairing.result()) for dl, pairing in sample]
        if any(a != b for a, b in disagree):
            raise RuntimeError(f"the reference's {mode} check disagrees with its "
                               f"pairing form on sampled blocks: {disagree}")
        return verdicts

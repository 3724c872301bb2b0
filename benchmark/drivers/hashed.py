"""Grouped batch verification of committed seals with the hashing of their
messages on the card, as a syncing node checks a block's seal: each call
hands the program's ops/bls.py::batch_verify_messages_device one epoch's
seals, its committee's key and the messages themselves, as bytes, hashed by
the try-and-increment before CIP22 over the direct hasher (the
configuration's hasher, cip22 and compat), and reads the verdict to the
host.

The program's entry must take `cip22`; the driver checks that before any
reference work and fails at once where it does not.

Cell parameters: messages_per_call, committees (1), sets, num_counters,
control (reference/seals.py::DirectSealInputs).
"""

import inspect

import numpy as np
import torch

from benchmark.reference import pack, seals
from benchmark.reference.params import G2_GENERATOR

# replays after the workers have made the seals, counted in the set-up: a
# run's first seconds of replays can run about a fifth slower (as in the
# strategy cells, drivers/strategy.py)
SETTLE_CALLS = 40


def _to(tree, device):
    if isinstance(tree, tuple):
        return tuple(_to(t, device) for t in tree)
    return torch.from_numpy(np.ascontiguousarray(tree)).to(device)


def program_entry():
    """The program's batch_verify_messages_device; raises where it cannot
    hash before CIP22."""
    from celo_bls_snark_tpu_torch.ops import bls as dbls

    fn = dbls.batch_verify_messages_device
    if "cip22" not in inspect.signature(fn).parameters:
        raise RuntimeError("the program's batch_verify_messages_device takes no cip22: "
                           "it cannot hash before CIP22")
    return fn


class Driver:
    def __init__(self, config, params, seed, device, ex):
        self.verify = program_entry()
        if config["hasher"] != "direct":
            raise ValueError(f"the {config['hasher']} hasher is not this driver's")
        self.config, self.params, self.device = config, params, device
        self.inp = seals.DirectSealInputs(config, params, seed, ex)
        self.batches = self.inp.batches
        self.warm_up = self._warm_up()
        self.sigs_per_call = self.inp.M

    def _warm_up(self):
        """The cycle twice (each set's round 2 has its own chunks: an eager
        call, then the captures), then replays while the workers make the
        seals, so that the card is not left idle before the window, then
        SETTLE_CALLS more."""
        k = 0
        while k < 2 * len(self.batches) or not self.inp.ready():
            yield k
            k += 1
        for k in range(k, k + SETTLE_CALLS):
            yield k

    def load(self):
        """Inputs for the warm-up, of the timed shapes: each block's hash in
        place of its seal and the generator in place of the committee's key,
        which are still being made."""
        inp, dev = self.inp, self.device
        lanes = [_to(pack.g1_projective(h), dev) for h in inp.hashes]
        self.sigs = [lanes[b % inp.S] for b in range(len(self.batches))]
        self.apks = [_to(pack.g2_affine([G2_GENERATOR]), dev)] * inp.S

    def finish(self):
        """The seals and committee keys, in place of the warm-up's."""
        inp, dev = self.inp.finish(), self.device
        self.sigs = []
        for b in range(len(self.batches)):
            src = inp.lane_seals(b)
            self.sigs.append(tuple(_to(c[:, src], dev) for c in inp.seal_limbs[b % inp.S]))
        self.apks = [_to(pack.g2_affine([a]), dev) for a in inp.apks]

    def call(self, k, span):
        b = k % len(self.batches)
        s, c = b % self.inp.S, self.config
        return bool(self.verify(
            self.sigs[b], self.apks[s], c["domain"].encode(), self.inp.messages[s],
            self.inp.extra, groups=1, composite=False, cip22=c["cip22"], compat=c["compat"],
            num_counters=self.params["num_counters"])[0])

    def release(self):
        self.sigs = self.apks = None

    def judge(self, ex, control=False):
        """The reference's verdict for each batch, or the control's: the
        cell's `control` names the guarantee it breaks."""
        lanes = None
        if control:
            if self.params["control"] != "even_lanes":
                raise ValueError(f"unknown control {self.params['control']!r}")
            lanes = np.arange(self.inp.M) % 2 == 0
        return [j.result() for j in self.inp.judge_jobs(ex, lanes)]

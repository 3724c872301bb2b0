"""Grouped (BDN18) batch verification of committed seals with their hashes
given, through the program's ops/bls.py::batch_verify_grouped_aot (the
reference's batch_verify_hashes): the seals and hash points of a batch,
the committees' keys, one grouped pairing check, the verdict read to the
host.

Cell parameters: messages_per_call, committees, seals, sets, control
(reference/inputs.py::GroupedInputs).
"""

import numpy as np
import torch

from benchmark.reference import inputs, pack
from benchmark.reference.params import G2_GENERATOR, P


def _to(tree, device):
    if isinstance(tree, tuple):
        return tuple(_to(t, device) for t in tree)
    return torch.from_numpy(np.ascontiguousarray(tree)).to(device)


def _neg(y, where):
    """-y in the lanes of `where`, on limb columns [25, lanes] of canonical
    Montgomery values, none of them 0: p - y, borrowing limb by limb."""
    p = torch.tensor(np.frombuffer(P.to_bytes(2 * pack.N_LIMBS, "little"), "<u2")
                     .astype(np.int64), device=y.device)
    out, borrow = [], torch.zeros_like(y[0], dtype=torch.int64)
    for i in range(y.shape[0]):
        d = p[i] - y[i].long() - borrow
        borrow = (d < 0).long()
        out.append(d + (borrow << 16))
    return torch.where(where, torch.stack(out).to(y.dtype), y)


class Driver:
    def __init__(self, config, params, seed, device, ex):
        self.config, self.params, self.device = config, params, device
        self.inp = inputs.GroupedInputs(config, params, seed, ex)
        self.batches = self.inp.batches
        self.warm_up = (0, 1)  # every batch has the one shape: eager, then capture
        self.sigs_per_call = self.inp.M

    def load(self):
        """Inputs for the warm-up, of the timed shapes: each lane's seal's
        hash in place of its point and of its seal, the generator in place
        of each committee's key, which are still being made."""
        inp, dev = self.inp, self.device
        pts = _to(pack.g1_projective(inp.hashes), dev)
        idx = torch.from_numpy(inp.src[0] // inp.K).to(dev)
        lanes = tuple(t.index_select(-1, idx) for t in pts)
        self.hashes, self.sigs = [lanes] * inp.S, [lanes] * len(self.batches)
        self.apks = _to(pack.g2_affine([G2_GENERATOR] * inp.G), dev)

    def finish(self):
        """The lanes, seals and committee keys, in place of the warm-up's."""
        inp, dev = self.inp.finish(), self.device
        one = _to(pack.fq([1]), dev).expand(-1, inp.M).contiguous()

        flat = {kind: (torch.stack([_to(t, dev) for t in xs]), _to(y, dev))
                for kind, (xs, y) in inp.lanes.items()}

        def lanes(kind, src, s):
            xs, y = flat[kind]
            src_t = torch.from_numpy(src).to(dev)
            v = torch.from_numpy(inp.variant[s]).to(dev)
            x = xs[v // 2, :, src_t].T.contiguous()
            return x, _neg(y.index_select(-1, src_t), v % 2 == 1), one

        self.hashes = [lanes("hash", inp.src[s], s) for s in range(inp.S)]
        self.sigs = [lanes("sig", inp.sig_src[b], b % inp.S) for b in range(len(self.batches))]
        self.apks = _to(pack.g2_affine(inp.apks), dev)

    def call(self, k, span):
        from celo_bls_snark_tpu_torch.ops import bls as dbls

        b = k % len(self.batches)
        with span("verify.check"):
            return bool(dbls.batch_verify_grouped_aot(
                self.sigs[b], self.hashes[b % self.inp.S], self.apks, self.inp.G)[0])

    def release(self):
        self.sigs = self.hashes = self.apks = None

    def judge(self, ex, control=False):
        """The reference's verdict for each batch, or the control's: the
        cell's `control` names the guarantee it breaks."""
        lanes = None
        if control:
            if self.params["control"] != "even_lanes":
                raise ValueError(f"unknown control {self.params['control']!r}")
            lanes = np.arange(self.inp.M) % 2 == 0
        return [j.result() for j in self.inp.judge_jobs(ex, lanes)]

"""Radix-2 NTT on the device, over any prime field with enough 2-adicity
(the PyTorch counterpart of the JAX package's ops/ntt.py).

The Groth16 prover's FFT workload. Instances: BLS12-377 Fr (253-bit,
2-adicity 47) and BW6-761 Fr (= BLS12-377 Fq, 377-bit, 2-adicity 46) — the
latter is the field of the epoch-circuit prover.

Layout: coefficients as [n_limbs, N] with N on the lane axis; each stage is
one twiddle multiply (a single wide Montgomery kernel launch) plus lazy
adds/subs; the permutation network uses reshapes only. One radix-2 path
serves every N.

Host oracle: snark/groth16.py fft().
"""

import numpy as np
import torch

from ..hostmath.params import P, R
from .field import FQ, FR, fq, fr


def _bit_reverse_perm(n: int):
    k = n.bit_length() - 1
    idx = np.arange(n)
    rev = np.zeros(n, dtype=np.int64)
    for b in range(k):
        rev |= ((idx >> b) & 1) << (k - 1 - b)
    return rev


class NttOps:
    """NTT over one prime field. `root_fn(n)` returns a primitive n-th root
    of unity (host int)."""

    def __init__(self, field_ops, spec, modulus, root_fn):
        self.f = field_ops
        self.spec = spec
        self.r = modulus
        self.root_fn = root_fn
        self._master_cache = {}
        self._coset_cache = {}
        self._perm_cache = {}

    def _powers(self, w: int, count: int, device):
        """Montgomery-packed w^0..w^(count-1) on `device`."""
        powers = []
        acc = 1
        for _ in range(count):
            powers.append(acc)
            acc = acc * w % self.r
        return self.spec.pack(powers, device)

    def master_table(self, N: int, inverse: bool, device):
        """Twiddle table for a length-N transform: [n, N/2] powers of the
        order-N root (of its inverse when `inverse`), cached per device so
        repeated prover calls do not rebuild or re-copy it."""
        key = (N, inverse, torch.device(device))
        dev = self._master_cache.get(key)
        if dev is None:
            w = self.root_fn(N)
            if inverse:
                w = pow(w, -1, self.r)
            dev = self._master_cache[key] = self._powers(w, N // 2, device)
        return dev

    def _perm(self, N: int, device):
        key = (N, torch.device(device))
        p = self._perm_cache.get(key)
        if p is None:
            p = self._perm_cache[key] = torch.from_numpy(
                _bit_reverse_perm(N)).to(device)
        return p

    def ntt(self, coeffs, inverse=False, master=None):
        """coeffs: [n_limbs, *batch, N] Montgomery tensor; transforms the
        LAST axis (independently per leading batch index) and returns the
        NTT (or inverse NTT, scaled by 1/N) in natural order. `master`
        optionally supplies the twiddle table (see master_table)."""
        f, spec = self.f, self.spec
        n = coeffs.shape[0]
        N = coeffs.shape[-1]
        lead = coeffs.shape[1:-1]  # leading batch dims (may be empty)
        assert N & (N - 1) == 0
        device = coeffs.device
        if master is None:
            master = self.master_table(N, inverse, device)
        stages = N.bit_length() - 1
        x = torch.index_select(coeffs, -1, self._perm(N, device))
        for s in range(stages):
            half = 1 << s          # butterfly half-width
            stride = N >> (s + 1)  # twiddle stride into the master table
            tw = master[:, ::stride]  # [n, half]
            x4 = x.reshape(n, *lead, N // (2 * half), 2, half)
            u = x4[..., 0, :]
            v = x4[..., 1, :]
            # v * w: one wide kernel launch over all batch dims (the
            # strided operands are copied contiguous on the way in)
            twb = tw.reshape(n, *([1] * (len(lead) + 1)), half).expand(v.shape)
            vw = f.mul(v.reshape(n, -1), twb.reshape(n, -1)).reshape(v.shape)
            x = torch.stack([f.add(u, vw), f.sub(u, vw)], dim=-2).reshape(
                n, *lead, N)
        if inverse:
            ninv = spec.const(pow(N, -1, self.r), (1,), device)
            flat = x.reshape(n, -1)
            x = f.mul(flat, ninv.expand(flat.shape)).reshape(x.shape)
        return x

    def coset_scale(self, N, g, device):
        """[n, N] vector of g^i on `device`, cached."""
        key = (N, g, torch.device(device))
        if key not in self._coset_cache:
            self._coset_cache[key] = self._powers(g, N, device)
        return self._coset_cache[key]

    def coset_ntt(self, coeffs, g: int, master=None, scale=None):
        """NTT of coeffs(g*X): scale coefficient i by g^i, then NTT."""
        gs = scale if scale is not None else self.coset_scale(
            coeffs.shape[-1], g, coeffs.device)
        return self.ntt(self.f.mul(coeffs, gs), master=master)

    def coset_intt(self, evals, g: int, master=None, scale=None):
        """Inverse of coset_ntt. `master` must be the INVERSE twiddle
        table; `scale` the coset_scale of g^-1."""
        x = self.ntt(evals, inverse=True, master=master)
        gs = (
            scale
            if scale is not None
            else self.coset_scale(evals.shape[-1], pow(g, -1, self.r), evals.device)
        )
        return self.f.mul(x, gs)


def _bls_fr_root(n: int):
    from ..snark.groth16 import BLS12_377_ENGINE, _root_of_unity

    return _root_of_unity(BLS12_377_ENGINE, n)


def _bw6_fr_root(n: int):
    from ..snark.api import BW6_761_ENGINE
    from ..snark.groth16 import _root_of_unity

    return _root_of_unity(BW6_761_ENGINE, n)


ntt_fr = NttOps(fr, FR, R, _bls_fr_root)
ntt_bw6 = NttOps(fq, FQ, P, _bw6_fr_root)


# --- module-level BLS-Fr entry points --------------------------------------

def ntt(coeffs, inverse=False):
    return ntt_fr.ntt(coeffs, inverse)


def coset_ntt(coeffs, g: int):
    return ntt_fr.coset_ntt(coeffs, g)


def coset_intt(evals, g: int):
    return ntt_fr.coset_intt(evals, g)

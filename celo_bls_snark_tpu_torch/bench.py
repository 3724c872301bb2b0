"""Benchmark: BLS12-377 aggregate-signature verification throughput on one
CUDA card (the counterpart of the JAX package's bench.py).

The measured pipeline is the block-sync batch verification
(crates/bls-snark-sys/src/signatures.rs:280-333 batch_verify_signature ->
crates/bls-crypto/src/bls/signature.rs:101-155 batch_verify): one committee
of `BENCH_VALIDATORS` validators signs `BENCH_MESSAGES` distinct block
messages; the verifier aggregates the signatures and checks the pairing
product. Every message shares the aggregated public key, so the
(n+1)-pairing equation collapses by bilinearity (exactly) to
  e(sum sigma_i, -g2) * e(sum_i H(m_i), apk) == 1.

The verification runs as one replayed CUDA graph
(ops/bls.py::batch_verify_grouped_aot), as the JAX bench times its one
executable; the graph is captured in the warm-up.

Message hashing is precomputed on the host: 1024 distinct messages are
CIP22-hashed, then extended to the full batch on the card by per-lane
small-scalar multiples (distinct valid G1 points), and the signatures are
the committee's summed secret key times each hash.

    python -m celo_bls_snark_tpu_torch.bench

prints ONE JSON line {"metric", "value", "unit", "vs_baseline", "device"};
vs_baseline is against 1e6 aggregate verifications/s.
"""

import json
import os
import time

import numpy as np
import torch

from .hash_to_curve import composite_hash_to_g1_cip22
from .hostmath.params import R
from .keys import SIG_DOMAIN, PrivateKey, PublicKey
from .ops import bls as dbls
from .ops import curve as dc
from .utils.devices import require_device
from .utils.rngs import XorShiftRng
from .utils.tree import tree_map

N_SEED = 1024  # messages hashed for real on the host
METRIC = "bls12377_aggregate_verifications_per_s"


def host_inputs(n_validators, seed=b"benchseedbenchsee", n_seed=N_SEED):
    """The host half of the input builder: (seed hash points, aggregated
    public key point, committee secret-key sum)."""
    rng = XorShiftRng(seed[:16])
    h2c = composite_hash_to_g1_cip22()
    sks = [PrivateKey.generate(rng) for _ in range(n_validators)]
    apk = PublicKey.aggregate([sk.to_public() for sk in sks])
    # committee secret key sum: sig_i = (sum sk) * H(m_i) — the same group
    # element as aggregating per-validator sigs, far cheaper to set up
    sk_sum = sum(sk.sk for sk in sks) % R
    seeds = [
        h2c.hash(SIG_DOMAIN, b"block %06d" % i, b"") for i in range(n_seed)
    ]
    return seeds, apk.pt, sk_sum


def build_inputs(n_messages, n_validators, seed=b"benchseedbenchsee",
                 device="cuda", n_seed=N_SEED):
    """One committee of `n_validators` signing `n_messages` distinct
    messages (the Celo block-sync shape: same committee, many blocks):
    (sigs_jac, hashes_jac, apk_aff) on `device`."""
    device = require_device(device)
    if n_messages % n_seed != 0 or n_messages < n_seed:
        raise ValueError(f"n_messages must be a multiple of {n_seed}")
    seeds, apk_pt, sk_sum = host_inputs(n_validators, seed, n_seed)
    # lane (k*n_seed + i) holds (k+1) * H(m_i); then sigs = sk_sum * hashes
    tiles = n_messages // n_seed
    tiled = tree_map(lambda x: x.repeat(1, tiles), dc.g1_pack(seeds, device))
    ks = np.repeat(np.arange(1, tiles + 1), n_seed)
    nb = max(1, int(tiles).bit_length())
    kbits = np.stack([(ks >> (nb - 1 - b)) & 1 for b in range(nb)])
    kbits = torch.from_numpy(kbits.astype(np.int32)).to(device)
    hashes_jac = dc.g1.scalar_mul_bits(kbits, tiled)
    sigs_jac = dc.g1.scalar_mul_const(sk_sum, hashes_jac)
    apk_aff = dbls.pack_g2_affine([apk_pt], device)
    return sigs_jac, hashes_jac, apk_aff


def verify(sigs_jac, hashes_jac, apk_aff):
    return dbls.batch_verify_grouped_aot(sigs_jac, hashes_jac, apk_aff, 1)


def warm_up(sigs_jac, hashes_jac, apk_aff):
    """The untimed first two verifications, which must be True: on the card
    the first runs eagerly and the second captures the graph and replays
    it, so the timed ones replay."""
    for _ in range(2):
        if not bool(verify(sigs_jac, hashes_jac, apk_aff)[0]):
            raise RuntimeError("benchmark verification failed — kernels are broken")


def timed(n_messages, sigs_jac, hashes_jac, apk_aff, n_iter=5):
    """`n_iter` verifications between two synchronizations of the card.
    Returns the metric dict."""
    device = sigs_jac[0].device
    torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    for _ in range(n_iter):
        out = verify(sigs_jac, hashes_jac, apk_aff)
    torch.cuda.synchronize(device)
    dt = (time.perf_counter() - t0) / n_iter
    if not bool(out[0]):
        raise RuntimeError("benchmark verification failed on timed run")
    rate = n_messages / dt
    return {
        "metric": METRIC,
        "value": rate,
        "unit": "verifs/s/card",
        "vs_baseline": rate / 1e6,
        "device": torch.cuda.get_device_name(device),
        "seconds_per_verify": dt,
        "iterations": n_iter,
    }


def run(n_messages, n_validators, device="cuda", n_iter=5):
    """Warm-up with its correctness check, then `n_iter` timed
    verifications. Returns the metric dict."""
    device = require_device(device)
    if device.type != "cuda":
        raise RuntimeError("the benchmark measures the card; device must be CUDA")
    inputs = build_inputs(n_messages, n_validators, device=device)
    warm_up(*inputs)
    return timed(n_messages, *inputs, n_iter=n_iter)


def main():
    n_messages = int(os.environ.get("BENCH_MESSAGES", "524288"))
    n_validators = int(os.environ.get("BENCH_VALIDATORS", "100"))
    print(json.dumps(run(n_messages, n_validators)))


if __name__ == "__main__":
    main()

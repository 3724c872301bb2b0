"""Hashing-included batch verification throughput on one CUDA card (the
counterpart of the JAX package's scripts/bench_hash_verify.py).

The reference's `batch_verify` hashes every message
(crates/bls-crypto/src/bls/signature.rs:101-117): hash to G1, then one
(n+1)-pairing product. Here the whole pipeline runs on the card through
ops/bls.py::batch_verify_messages_device: batched try-and-increment
hash-to-G1 (Blake2s CRH or the composite Pedersen CRH, Blake2Xs XOF,
Tonelli-Shanks, cofactor multiply) flowing into the grouped pairing check,
each program a replayed CUDA graph (utils/aotcache.py), the pairing check
through ops/bls.py::batch_verify_grouped_aot as the JAX bench times it. Of
the two warm-up verifications the first runs eagerly and the second
captures the graphs, so the timed ones replay them.

Inputs, as the JAX bench's: `BENCH_HASH_MESSAGES` (16,384) messages
b"block payload %08d", one committee of `BENCH_VALIDATORS` (100)
validators from XorShiftRng(b"hashbench-seed01"), num_counters = 24,
compat mode. The signatures are (sum sk) H(m_i) with H(m_i) from the
card's own hash (ops/hash_to_g1.py::hash_messages_device); the JAX bench
multiplies host hashes, which are the same points when the card's hashes
are right (chip_smoke.py holds a sample of them and every round-2 lane
against the host oracle).

    python -m celo_bls_snark_tpu_torch.scripts.bench_hash_verify

prints one JSON line per hasher, DirectHasher then composite: the metric
under the JAX bench's name, seconds per verification and their split into
the stages h2g.message_crh, h2g.pack, h2g.round1, h2g.round2 and
bls.pairing, the count of lanes hashed by the host fallback, and the
composite CRH table's set-up.
"""

import json
import os
import time

import torch

from ..hashers.composite import crh_parameters
from ..hostmath.params import R
from ..keys import SIG_DOMAIN, PrivateKey, PublicKey
from ..ops import bls as dbls
from ..ops import curve as dc
from ..ops.hash_to_g1 import hash_messages_device
from ..utils import profiling
from ..utils.rngs import XorShiftRng

METRIC = "bls12377_verifications_per_s_hashing_included"
NUM_COUNTERS = 24
STAGES = ("h2g.message_crh", "h2g.pack", "h2g.round1", "h2g.round2", "bls.pairing")


def committee(n_validators):
    """(sum of the secret keys, aggregated public key point) of the JAX
    bench's committee."""
    rng = XorShiftRng(b"hashbench-seed01")
    sks = [PrivateKey.generate(rng) for _ in range(n_validators)]
    apk = PublicKey.aggregate([sk.to_public() for sk in sks])
    return sum(sk.sk for sk in sks) % R, apk.pt


def messages(n_messages):
    return [b"block payload %08d" % i for i in range(n_messages)]


def signatures(sk_sum, msgs, composite, device):
    """sig_i = (sum sk) H(m_i) on `device`, with the hashes of the path
    itself. Returns (sigs_jac, hashes_jac, fallback lanes)."""
    hashes, fallback = hash_messages_device(
        SIG_DOMAIN, msgs, b"", composite, NUM_COUNTERS, True, device)
    return dc.g1.scalar_mul_const(sk_sum, hashes), hashes, fallback


def verify(sigs_jac, apk_aff, msgs, composite):
    return dbls.batch_verify_messages_device(
        sigs_jac, apk_aff, SIG_DOMAIN, msgs, b"", groups=1,
        composite=composite, num_counters=NUM_COUNTERS, compat=True)


def timed(sigs_jac, apk_aff, msgs, composite, n_iter):
    """`n_iter` verifications between two synchronizations of the card:
    the metric line, with the seconds of each stage per verification."""
    device = sigs_jac[0].device
    profiling.reset()
    torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    for _ in range(n_iter):
        ok = verify(sigs_jac, apk_aff, msgs, composite)
    torch.cuda.synchronize(device)
    dt = (time.perf_counter() - t0) / n_iter
    if not bool(ok[0]):
        raise RuntimeError("hashing-included verification failed on a timed run")
    rep = profiling.report()
    rate = len(msgs) / dt
    return {
        "metric": METRIC + ("_composite" if composite else ""),
        "value": rate,
        "unit": "verifs/s/card",
        "vs_baseline": rate / 1e6,
        "batch": len(msgs),
        "device": torch.cuda.get_device_name(device),
        "seconds_per_verify": dt,
        "iterations": n_iter,
        "stages_s_per_verify": {
            k: rep.get(k, {"total_s": 0.0})["total_s"] / n_iter for k in STAGES},
    }


def run(n_messages, n_validators, device="cuda", n_iter=3):
    """Both hashers: set-up, two warm-up verifications that must be True,
    then `n_iter` timed ones. Yields one dict per hasher."""
    device = torch.device(device)
    if device.type != "cuda":
        raise RuntimeError("the benchmark measures the card; device must be CUDA")
    sk_sum, apk = committee(n_validators)
    apk_aff = dbls.pack_g2_affine([apk], device)
    msgs = messages(n_messages)
    for composite in (False, True):
        t0 = time.perf_counter()
        if composite:
            crh_parameters()  # the generator table, built once in Python
        setup_s = time.perf_counter() - t0
        sigs, _hashes, fallback = signatures(sk_sum, msgs, composite, device)
        for _ in range(2):
            if not bool(verify(sigs, apk_aff, msgs, composite)[0]):
                raise RuntimeError("hashing-included verification failed")
        yield {**timed(sigs, apk_aff, msgs, composite, n_iter),
               "fallback_lanes": len(fallback), "setup_s": setup_s}


def main():
    n_messages = int(os.environ.get("BENCH_HASH_MESSAGES", "16384"))
    n_validators = int(os.environ.get("BENCH_VALIDATORS", "100"))
    for res in run(n_messages, n_validators):
        print(json.dumps(res), flush=True)


if __name__ == "__main__":
    main()

"""The four-strategy batch-BLS comparison on one CUDA card (the counterpart
of the JAX package's scripts/bench_strategies.py, itself the device form of
crates/bls-crypto/benches/batch_bls.rs:16-97).

Workload (reference shape): `--blocks` committees of `--validators` fresh
validators each sign their block's message; per block the individual (pk,
sig) pairs, the per-block aggregates (apk_b, asig_b), and the grand
aggregate asig = sum_b asig_b.

Strategies (the reference's pairing equations, each one program with ONE
batched final exponentiation):
  1. per-epoch aggregate screening   - per block: e(asig_b, -g2) e(H_b, apk_b) == 1
  2. all-epoch aggregate screening   - one check: e(asig, -g2) prod_b e(H_b, apk_b) == 1
     (Signature::batch_verify, signature.rs:101-155)
  3. per-epoch batch verification    - per block, random exponents r_i:
     e(sum_i r_i sig_i, -g2) e(H_b, sum_i r_i pk_i) == 1 (Batch::verify,
     batch.rs:44-84, exponent sizing batch.rs:20-28)
  4. per-epoch individual            - every (b, i): e(sig_bi, -g2) e(H_b, pk_bi) == 1
     (Batch::verify_each, batch.rs:87-96)
Screenings 1 and 2 are not rogue-key safe: signatures of one block shifted
by +D and -D leave every aggregate, and so their verdicts, unchanged, where
3 and 4 reject them.

Every strategy hashes the block messages on the card first (composite CRH,
try-and-increment, ops/hash_to_g1.py), as the reference's batch_verify
does, and the timed quantity includes it. Each jax.jit of the JAX script
(derive, to_aff, rep and the four strategies) is one program of
utils/aotcache.py, tagged with its static values: a key's first call runs
eagerly, its second captures a CUDA graph and later calls replay it. After
the first call, asserted True, and a second (the capture), `--iters` calls
are timed.

The secret keys and exponents come from random.Random(--seed) (the JAX
script draws them from `secrets`, so its runs cannot be repeated).

    python -m celo_bls_snark_tpu_torch.scripts.bench_strategies \\
        [--blocks 300] [--validators 20] [--seed S] [--iters 3] [--device cuda]

BENCH_BLOCKS and BENCH_VALIDATORS set the defaults of --blocks and
--validators, as in the JAX script. `--device cpu` runs the kernels' plain
versions (a rehearsal at a small size: --blocks 2 --validators 2); on
`cuda` without a card it raises. Prints one JSON line per strategy:
  {"strategy": ..., "seconds": S, "messages_per_s": R, "device": ...}
"""

import argparse
import json
import os
import random
import time

import torch

from ..batch import SECURITY_BOUND, byte_count_from_target_batch_size
from ..hash_to_curve import composite_hash_to_g1_cip22
from ..hostmath.params import G2_GENERATOR, R
from ..keys import SIG_DOMAIN
from ..ops import bls as dbls
from ..ops import curve as dc
from ..ops import msm as dmsm
from ..ops import pairing as dp
from ..ops.hash_to_g1 import hash_messages_device
from ..utils import aotcache
from ..utils.devices import require_device
from ..utils.profiling import device_span
from ..utils.tree import tree_map

C = 4  # the Straus window of strategy 3, in bits
NUM_COUNTERS = 24
# each strategy's program arguments, in order; the last is the block hashes
ARGS = {
    "per-epoch aggregate screening": ("asig_b", "apk_b", "h_aff"),
    "all epoch aggregate screening": ("asig", "apk_b", "h_aff"),
    "per-epoch batch verification": ("expdigits", "sig_jac", "pk_jac", "h_aff"),
    "per-epoch individual verification": ("sig_jac", "pk_jac", "h_per_val"),
}


def messages(B):
    """The block messages and their extra data."""
    return [b"block %06d" % b for b in range(B)], [b"extra %04d" % b for b in range(B)]


def host_hashes(msgs, extras):
    """The block hashes H_b on the host (CIP22 composite hash to G1)."""
    h2c = composite_hash_to_g1_cip22()
    return [h2c.hash(SIG_DOMAIN, m, e) for m, e in zip(msgs, extras)]


def keys(B, V, seed):
    """B V secret keys (a fresh committee per block, as the reference's
    PrivateKey::generate per entry) and the B V random exponents of
    strategy 3, with their size in bytes."""
    rng = random.Random(seed)
    sks = [rng.randrange(1, R) for _ in range(B * V)]
    exp_size = byte_count_from_target_batch_size(V, SECURITY_BOUND)
    exps = [rng.getrandbits(8 * exp_size) % R for _ in range(B * V)]
    return sks, exps, exp_size


def sig_sums(sig_jac, B):
    """derive's signature sums: the per-block aggregates [B] and their
    total [1]."""
    asig_b = dc.g1.msum_groups(sig_jac, B)
    return asig_b, dc.g1.msum(asig_b)


def derive(B, skbits, g2gen, h_per_val):
    """Public keys sk G2, signatures sk H_b, and the aggregates."""
    pk_jac = dc.g2.scalar_mul_bits(skbits, g2gen)
    sig_jac = dc.g1.scalar_mul_bits(skbits, h_per_val)
    apk_b = dc.g2.msum_groups(pk_jac, B)
    asig_b, asig = sig_sums(sig_jac, B)
    return pk_jac, sig_jac, apk_b, asig_b, asig


def build_inputs(B, V, seed, device="cuda", hashes=None):
    """The keys, signatures and aggregates on `device`, derived there from
    the secret keys; `hashes` are the host block hashes if the caller has
    them."""
    device = require_device(device)
    msgs, extras = messages(B)
    hashes = hashes if hashes is not None else host_hashes(msgs, extras)
    sks, exps, exp_size = keys(B, V, seed)
    skbits = dbls.scalars_to_bits(sks, device)
    g2gen = dc.g2_pack([G2_GENERATOR] * (B * V), device)
    # lane b V + i holds H_b (for sig_bi = sk_bi H_b)
    h_per_val = dc.g1_pack([hashes[b] for b in range(B) for _ in range(V)], device)
    derived = aotcache.jit(f"strategies_derive_{B}_{V}",
                           lambda *a: derive(B, *a))(skbits, g2gen, h_per_val)
    names = ("pk_jac", "sig_jac", "apk_b", "asig_b", "asig")
    return {
        **dict(zip(names, derived)),
        "h_aff": dc.g1.to_affine(dc.g1_pack(hashes, device)),
        "h_per_val": h_per_val,
        "expdigits": torch.from_numpy(dmsm.window_digits(exps, 8 * exp_size, C)).to(device),
        "msgs": msgs, "extras": extras, "hashes": hashes, "sks": sks,
        "B": B, "V": V, "device": device,
    }


def make_hasher(inp):
    """Card hashing of the B block messages, timed as part of every
    strategy (the reference's batch_verify hashes every message:
    signature.rs:101-117), and the programs that shape its output:
    `to_aff` (affine) and `rep` (each block's hash V times)."""
    msgs, extras, V, device = inp["msgs"], inp["extras"], inp["V"], inp["device"]

    def hash_blocks():
        return hash_messages_device(SIG_DOMAIN, msgs, extras, composite=True,
                                    num_counters=NUM_COUNTERS, device=device)[0]

    to_aff = aotcache.jit("strategies_to_aff_g1", dc.g1.to_affine)
    rep = aotcache.jit(f"strategies_rep_{V}", lambda t: tree_map(
        lambda x: x.unsqueeze(-1).expand(*x.shape, V).reshape(*x.shape[:-1], -1), t))
    return hash_blocks, to_aff, rep


def per_epoch_aggregate(asig_b, apk_b, h_aff):
    p = dbls._interleave(dc.g1.to_affine(asig_b), h_aff)
    negg2 = dbls.neg_g2_gen_affine(h_aff[0].device, h_aff[0].shape[-1])
    q = dbls._interleave(negg2, dc.g2.to_affine(apk_b))
    return dbls.verify_pairs_device(p, q).all()


def all_epoch_aggregate(asig, apk_b, h_aff):
    p = dbls.cat_lanes(dc.g1.to_affine(asig), h_aff)
    q = dbls.cat_lanes(dbls.neg_g2_gen_affine(h_aff[0].device), dc.g2.to_affine(apk_b))
    return dp.pairing_check_product(p, q)[0]


def per_epoch_batch(B, expdigits, sig_jac, pk_jac, h_aff):
    # the card's Batch::verify pipeline: Straus grouped MSMs + one batched
    # pairing pass, per-epoch results (ops/bls.py)
    return dbls.strict_batch_verify_device(expdigits, sig_jac, pk_jac, h_aff, B, c=C).all()


def per_epoch_individual(sig_jac, pk_jac, h_per_val):
    with device_span("gpu.verify.legs", sig_jac):
        p = dbls._interleave(dc.g1.to_affine(sig_jac), dc.g1.to_affine(h_per_val))
        negg2 = dbls.neg_g2_gen_affine(sig_jac[0].device, sig_jac[0].shape[-1])
        q = dbls._interleave(negg2, dc.g2.to_affine(pk_jac))
    return dbls.verify_pairs_device(p, q).all()


def strategy_programs(B, V):
    """The four strategies, each one program tagged with B, V (and c)."""
    return {
        "per-epoch aggregate screening": aotcache.jit(
            f"strategies_per_epoch_aggregate_{B}_{V}", per_epoch_aggregate),
        "all epoch aggregate screening": aotcache.jit(
            f"strategies_all_epoch_aggregate_{B}_{V}", all_epoch_aggregate),
        "per-epoch batch verification": aotcache.jit(
            f"strategies_per_epoch_batch_{B}_{V}_c{C}",
            lambda *a: per_epoch_batch(B, *a)),
        "per-epoch individual verification": aotcache.jit(
            f"strategies_individual_{B}_{V}", per_epoch_individual),
    }


def make_strategies(inp):
    """[(name, call)] in the reference's order. call(**changed) hashes the
    blocks on the card and runs the strategy's program on inp's arguments
    with `changed` in their place (a changed `h_aff` or `h_per_val` skips
    the hashing), and returns its verdict as a bool tensor on the card."""
    progs = strategy_programs(inp["B"], inp["V"])
    hash_blocks, to_aff, rep = make_hasher(inp)

    def call(name, **changed):
        args = {**inp, **changed}
        hashed = ARGS[name][-1]
        if hashed not in changed:
            jac = hash_blocks()
            args[hashed] = to_aff(jac) if hashed == "h_aff" else rep(jac)
        return progs[name](*(args[a] for a in ARGS[name]))

    return [(name, lambda name=name, **changed: call(name, **changed)) for name in ARGS]


def run(B, V, seed, iters=3, device="cuda"):
    """Yields one result dict per strategy: a first call (eager) and a
    second (the capture) that must be True, then `iters` timed calls."""
    inp = build_inputs(B, V, seed, device)
    for name, fn in make_strategies(inp):
        for _ in range(2):
            if not bool(fn()):
                raise RuntimeError(f"strategy {name!r} failed verification")
        t0 = time.perf_counter()
        for _ in range(iters):
            out = fn()
        if not bool(out):  # waits for the card
            raise RuntimeError(f"strategy {name!r} failed a timed verification")
        dt = (time.perf_counter() - t0) / iters
        yield {"strategy": name, "seconds": round(dt, 4),
               "messages_per_s": round(B / dt, 1),
               "device": (torch.cuda.get_device_name(inp["device"])
                          if inp["device"].type == "cuda" else "cpu")}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--blocks", type=int, default=int(os.environ.get("BENCH_BLOCKS", "300")))
    ap.add_argument("--validators", type=int,
                    default=int(os.environ.get("BENCH_VALIDATORS", "20")))
    ap.add_argument("--seed", type=int, default=20261021)
    ap.add_argument("--iters", type=int, default=3)
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args(argv)
    for res in run(a.blocks, a.validators, a.seed, a.iters, a.device):
        print(json.dumps(res), flush=True)


if __name__ == "__main__":
    main()

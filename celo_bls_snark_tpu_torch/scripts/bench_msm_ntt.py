"""The Groth16 prover's device stages at a given size, with correctness
(the counterpart of the JAX package's scripts/bench_msm_ntt.py): fixed-base
batch multiplication, Pippenger MSM, the h-polynomial coset-NTT pipeline and
an NTT round trip, all through snark/accel.py's DeviceAccel and ops/ntt.py.
2^20 is the evaluation-domain size of the epoch circuit, so at log2 = 20
these are the prover's hot loops at their real width.

Correctness oracles (a 2^20 host Pippenger or host FFT would take many
minutes in Python, so):
  - bases: P_i = a_i G from the device fixed-base batch (random a_i), a
    sample of them checked against host scalar multiplications; or, with
    --chain, P_i = (a + i) G from host affine chain adds;
  - MSM: the exact answer is ((sum_i s_i a_i) mod r) G, ONE host
    scalar multiplication;
  - h-polynomial: with c = a b on the domain, h t = A B - C holds as
    polynomials, so h (Horner over the output) is checked against the
    inputs' interpolants (barycentric evaluation on the host) at random
    points; a dense run at 2^12 equals the host fft pipeline;
  - NTT: intt(ntt(x)) == x at full size, plus Horner evaluation of the
    polynomial at omega^j for a few indices j.

Usage: python -m celo_bls_snark_tpu_torch.scripts.bench_msm_ntt [log2_size]
           [--engine bw6_761|bls12_377] [--chain] [--tc] [--cpu]
Prints one JSON line per stage.
"""

import json
import random
import sys
import time

import torch

from ..entry import chain_points, host_h_poly
from ..ops import field as F
from ..ops import msm as dmsm
from ..snark import groth16 as g16
from ..snark.accel import DeviceAccel
from ..snark.api import BW6_761_ENGINE
from ..utils import aotcache, profiling

ENGINES = {"bw6_761": BW6_761_ENGINE, "bls12_377": g16.BLS12_377_ENGINE}


class Meter:
    """Seconds per utils.profiling stage, kernel launches, wall time and
    the card's peak memory over one `with` block. `launches` counts the
    kernels' launches that ran from Python (eager code, and the first call
    of a program, which runs eagerly), `graph_launches` those replayed from
    utils/aotcache.py's graphs; a capture only records launches, and
    counts none."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.out = {}

    def __enter__(self):
        profiling.reset()
        F.reset_launches()
        aotcache.reset_replays()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
            torch.cuda.reset_peak_memory_stats(self.device)
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
            self.out["peak_bytes"] = torch.cuda.max_memory_allocated(self.device)
        self.out["wall_s"] = time.perf_counter() - self.t0
        self.out["stage_s"] = {k: v["total_s"] for k, v in profiling.report().items()}
        self.out["launches"] = {k.name: k.launches for k in F.KERNELS}
        self.out["graph_launches"] = aotcache.graph_launches()


def fixed_base_stage(accel, engine, B, seed, sample=4):
    """B random scalars a_i -> the PointVec of a_i G through the device
    fixed-base batch; `sample` of them held against the host."""
    rnd = random.Random(seed)
    ks = [rnd.randrange(engine.fr) for _ in range(B)]
    ks[0] = 0  # an infinity lane
    with Meter(accel.device) as m:
        bases = accel.g1.fixed_base_batch(ks)
    idx = sorted({0, B - 1, *(rnd.randrange(B) for _ in range(sample))})
    cols = [bases.spec.unpack_raw(l[:, idx]) for l in bases.leaves]
    got = [None if (x, y) == (0, 0) else (x, y) for x, y in zip(*cols)]
    want = [engine.g1.mul(ks[i], engine.g1_gen) if ks[i] else None for i in idx]
    return ks, bases, {"stage": "fixed_base", "B": B, "sample": idx,
                       "ok": got == want, **m.out}


def msm_scalars(engine, B, seed):
    rnd = random.Random(seed)
    return [rnd.randrange(engine.fr) for _ in range(B)]


def msm_stage(accel, engine, bases, ks, seed, ss=None):
    """sum_i s_i P_i with P_i = ks[i] G, against one host scalar mul
    (ss: the scalars, by default msm_scalars(engine, len(ks), seed))."""
    r = engine.fr
    ss = ss if ss is not None else msm_scalars(engine, len(ks), seed)
    with Meter(accel.device) as m:
        got = accel.g1.msm(bases, ss)
    k = sum(a * s for a, s in zip(ks, ss)) % r
    want = engine.g1.mul(k, engine.g1_gen) if k else None
    return got, {"stage": "msm", "B": len(ks), "ok": got == want,
                 "c": dmsm._auto_c(len(ks), accel.g1.nbits),
                 "L": dmsm._auto_lanes(len(ks)), **m.out}


def _interpolants_at(evals_list, z, omega, d, r):
    """Barycentric evaluation at z of the degree < d interpolants of each
    evaluation vector over the domain {omega^j}: (z^d - 1)/d *
    sum_j e_j omega^j / (z - omega^j)."""
    ws = [1] * d
    for j in range(1, d):
        ws[j] = ws[j - 1] * omega % r
    inv = g16._batch_inverse([(z - w) % r for w in ws], r)
    terms = [w * i % r for w, i in zip(ws, inv)]
    scale = (pow(z, d, r) - 1) * pow(d, -1, r) % r
    return [sum(e * t for e, t in zip(ev, terms)) % r * scale % r
            for ev in evals_list]


def horner(coeffs, z, r):
    acc = 0
    for cf in reversed(coeffs):
        acc = (acc * z + cf) % r
    return acc


def h_inputs(engine, d, seed):
    """Seeded evaluations of a satisfied system: c = a b on the domain."""
    rnd = random.Random(seed)
    r = engine.fr
    a_e = [rnd.randrange(r) for _ in range(d)]
    b_e = [rnd.randrange(r) for _ in range(d)]
    return a_e, b_e, [a * b % r for a, b in zip(a_e, b_e)]


def h_stage(accel, engine, d, seed, points=2, evals=None):
    """compute_h_evals at size d, checked by h(z) t(z) = A(z) B(z) - C(z)
    at `points` random z (evals: by default h_inputs(engine, d, seed))."""
    r = engine.fr
    evals = evals if evals is not None else h_inputs(engine, d, seed)
    with Meter(accel.device) as m:
        h = accel.compute_h_evals(*evals, d, engine.fr_generator)
    coeffs = h.to_ints()
    omega = g16._root_of_unity(engine, d)
    rnd = random.Random(seed + 1)
    ok = len(coeffs) == d - 1
    for _ in range(points):
        z = rnd.randrange(2, r)
        az, bz, cz = _interpolants_at(evals, z, omega, d, r)
        ok &= horner(coeffs, z, r) * (pow(z, d, r) - 1) % r == (az * bz - cz) % r
    return h, {"stage": "h_poly", "d": d, "points": points, "ok": bool(ok), **m.out}


def h_dense(accel, engine, d, seed):
    """compute_h_evals on arbitrary evaluations at a small d against the
    host fft pipeline, coefficient for coefficient."""
    rnd = random.Random(seed)
    evals = [[rnd.randrange(engine.fr) for _ in range(d)] for _ in range(3)]
    got = accel.compute_h_evals(*evals, d, engine.fr_generator).to_ints()
    want = host_h_poly(engine, *evals, d, engine.fr_generator)
    return {"stage": "h_poly_dense", "d": d, "ok": got == want}


def ntt_values(nttops, N, seed):
    rnd = random.Random(seed)
    return [rnd.randrange(nttops.r) for _ in range(N)]


def ntt_stage(nttops, N, seed, device, vals=None):
    """ntt then inverse ntt at size N: round trip on the head and tail,
    Horner spot checks of the forward transform (vals: by default
    ntt_values(nttops, N, seed))."""
    spec, r = nttops.spec, nttops.r
    vals = vals if vals is not None else ntt_values(nttops, N, seed)
    x = nttops.f.from_raw(spec.pack_raw(vals, device))
    with Meter(device) as m:
        y = nttops.ntt(x)
        back = nttops.ntt(y, inverse=True)
    ok = spec.unpack(back[:, :64]) == vals[:64] and spec.unpack(back[:, -64:]) == vals[-64:]
    w = nttops.root_fn(N)
    for j in (0, 1, N // 2 + 3):
        ok &= spec.unpack(y[:, j : j + 1])[0] == horner(vals, pow(w, j, r), r)
    return {"stage": "ntt_roundtrip", "field": spec.name, "N": N, "ok": bool(ok), **m.out}


def run(lg=20, engine_name="bw6_761", device="cuda", chain=False, seed=20261016):
    """All stages; yields one result dict per stage."""
    engine = ENGINES[engine_name]
    accel = DeviceAccel(engine_name, device)
    B = 1 << lg
    if chain:
        a = random.Random(seed).randrange(1, 1 << 62)
        ks = [a + i for i in range(B)]
        bases = chain_points(engine.g1, engine.g1_gen, a, B)
    else:
        ks, bases, res = fixed_base_stage(accel, engine, B, seed)
        yield res
    yield msm_stage(accel, engine, bases, ks, seed + 1)[1]
    yield h_stage(accel, engine, B, seed + 2)[1]
    yield h_dense(accel, engine, min(B, 1 << 12), seed + 3)
    yield ntt_stage(accel.nttops, B, seed + 4, accel.device)


def main():
    args = sys.argv[1:]
    lg = next((int(a) for a in args if a.isdigit()), 20)
    name = args[args.index("--engine") + 1] if "--engine" in args else "bw6_761"
    device = "cpu" if "--cpu" in args else "cuda"
    with F.mul_kernel("tc" if "--tc" in args else "cios"):
        ok = True
        for res in run(lg, name, device, chain="--chain" in args):
            print(json.dumps(res), flush=True)
            ok &= res["ok"]
    if not ok:
        sys.exit("a stage disagrees with its host oracle")


if __name__ == "__main__":
    main()

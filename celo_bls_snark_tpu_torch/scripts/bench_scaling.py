"""Scaling of the sharded Pippenger MSM and four-step NTT over D ranks (the
counterpart of the repo's scripts/bench_scaling.py): the same sharded
function over one problem size at D = 1, 2, 4; speedup(D) = T(1) / T(D)
and efficiency = speedup / D, T the slowest rank's best of three.

On the CPU the ranks are processes joined over gloo: a proxy, as the JAX
script's virtual CPU devices were, of the collective layout (one
all-gather of partial sums for Pippenger, the one all_to_all of the
four-step NTT) and of any serial point in the sharded code. On the card it
runs at D = 1 only unless the machine has D cards (NCCL takes one rank a
card).

Usage: python -m celo_bls_snark_tpu_torch.scripts.bench_scaling
           [log2_msm] [log2_ntt] [--device cpu|cuda] [--ranks 1,2,4]
Defaults: 2^8 points and 2^12 NTT lanes on the CPU (the plain versions),
2^20 and 2^20 on the card. Prints one JSON line per (workload, D).
"""

import argparse
import datetime
import json
import os
import tempfile
import time

import numpy as np
import torch
import torch.multiprocessing as mp


def _workloads(log_msm, log_ntt):
    """Host inputs from one numpy seed: sampled small multiples of G (a
    host-cheap set of bases; the device work is that of any bases) and
    random scalars and NTT values."""
    from ..hostmath import curves as hc
    from ..hostmath.params import G1_GENERATOR, R

    rng = np.random.default_rng(7)
    mults = [hc.G1.mul(k, G1_GENERATOR) for k in range(1, 33)]
    pts = [mults[i] for i in rng.integers(0, 32, 1 << log_msm)]
    big = lambda n: [int.from_bytes(rng.bytes(32), "little") % R for _ in range(n)]  # noqa: E731
    return pts, big(1 << log_msm), big(1 << log_ntt)


def _rank(rank, world, store, device, log_msm, log_ntt, out_dir):
    from ..ops import ntt as dntt
    from ..parallel import distributed as pdist
    from ..parallel import mesh as pmesh

    if device == "cpu":
        torch.set_num_threads(1)
    pdist.init_distributed(f"file://{store}", world, rank, device=device,
                           timeout=datetime.timedelta(seconds=1800))
    try:
        mesh = pdist.global_mesh()
        pts, scalars, vals = _workloads(log_msm, log_ntt)
        x = dntt.ntt_fr.spec.pack(vals, mesh.device)
        runs = {
            "msm": lambda: pmesh.sharded_msm_pippenger(mesh, pts, scalars),
            "ntt": lambda: pmesh.sharded_ntt(mesh, x, dntt.ntt_fr).cpu(),
        }
        best = {}
        for name, fn in runs.items():
            for _ in range(3):
                torch.distributed.barrier()
                t0 = time.perf_counter()
                fn()
                dt = time.perf_counter() - t0
                best[name] = min(best.get(name, dt), dt)
        with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
            json.dump(best, f)
    finally:
        pdist.shutdown()


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("log_msm", type=int, nargs="?")
    ap.add_argument("log_ntt", type=int, nargs="?")
    ap.add_argument("--device", choices=("cpu", "cuda"), default="cuda")
    ap.add_argument("--ranks", default=None,
                    help="comma-separated world sizes (default 1,2,4 on the "
                         "CPU, 1 on the card)")
    args = ap.parse_args(argv)
    cpu = args.device == "cpu"
    log_msm = args.log_msm or (8 if cpu else 20)
    log_ntt = args.log_ntt or (12 if cpu else 20)
    ranks = [int(r) for r in (args.ranks or ("1,2,4" if cpu else "1")).split(",")]
    if not cpu and torch.cuda.device_count() < max(ranks):
        raise SystemExit(f"{max(ranks)} ranks need {max(ranks)} cards")
    kind = "cpu processes" if cpu else torch.cuda.get_device_name(0)
    if not cpu:
        from ..ops import kernels

        kernels.build()  # once, before the ranks load it
    t1 = {}
    for D in ranks:
        with tempfile.TemporaryDirectory() as tmp:
            mp.start_processes(_rank, nprocs=D, start_method="spawn",
                               args=(D, os.path.join(tmp, "store"), args.device,
                                     log_msm, log_ntt, tmp))
            per_rank = [json.load(open(os.path.join(tmp, f"rank{r}.json")))
                        for r in range(D)]
        for name, lg in (("msm", log_msm), ("ntt", log_ntt)):
            t = max(p[name] for p in per_rank)
            t1.setdefault(name, t if D == 1 else None)
            row = {"bench": f"sharded_{name}", "log2_size": lg, "D": D, "s": t,
                   "device": args.device, "kind": kind}
            if t1[name] is not None:
                row.update(speedup=t1[name] / t, efficiency=t1[name] / (t * D))
            print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main()

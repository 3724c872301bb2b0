"""A/B of the two Montgomery multiplies on the card: mont_mul (32-bit-word
CIOS on the CUDA cores) against mont_mul_tc (reduction on the tensor cores), the
counterpart of the JAX package's scripts/prof_mxu_mul.py.

Per field (fq761 and fq377) at the MSM's madd working shape (6 x 16,384
lanes): both kernels against host integers on canonical and on lazy inputs,
limb equality of the two, and the card's time per multiply over a 16-deep
dependent chain (replayed from a CUDA graph).

With --msm [log2 of the points, default 20] it then runs the prover's MSM
stage (scripts/bench_msm_ntt.py's, against its host oracle) under the two
multiplies in turns, three times each in one process right after the
fixed-base batch that makes the bases: the stage's seconds under either
multiply with nothing but the multiply changed between them.

Usage: python -m celo_bls_snark_tpu_torch.scripts.prof_mxu_mul [--msm [log2]]
"""

import json
import random
import sys

import torch

from ..ops import field as F
from ..snark.accel import DeviceAccel
from ..snark.api import BW6_761_ENGINE
from ..utils.devices import require_device
from ..utils.profiling import time_ms
from . import bench_msm_ntt

K = 16  # dependent multiplies per timed run


def run(spec, B, device="cuda"):
    device = require_device(device)
    p = spec.modulus
    rnd = random.Random(7)
    xs = [rnd.randrange(p) for _ in range(B)]
    ys = [rnd.randrange(p) for _ in range(B)]
    a, b = spec.pack(xs, device), spec.pack(ys, device)
    lazy = a * 2 - spec.pack([5] * B, device)  # value 2x - 5, drifted
    step = max(1, B // 64)
    out = {"field": spec.name, "B": B}
    for tag, aa, vals in (("canonical", a, xs),
                          ("lazy", lazy, [(2 * x - 5) % p for x in xs])):
        o1, o2 = F.mont_mul(spec, aa, b), F.mont_mul_tc(spec, aa, b)
        want = [v * y % p for v, y in zip(vals, ys)][::step]
        got1 = spec.unpack(o1[:, ::step])
        got2 = spec.unpack(o2[:, ::step])
        out[tag] = {"cios_ok": got1 == want, "tc_ok": got2 == want,
                    "limbs_equal": bool(torch.equal(o1, o2))}
    if device.type == "cuda":
        for name, kern in (("cios", F.mont_mul), ("tc", F.mont_mul_tc)):
            def chain():
                acc = a
                for _ in range(K):
                    acc = kern(spec, acc, b)
                return acc
            ms = time_ms(chain, 5, graph=True) / K  # the card's time
            out[name] = {"ms_per_mul": ms, "ns_per_mul_lane": ms * 1e6 / B}
    return out


def msm_in_turns(lg=20, order=("cios", "tc", "tc", "cios", "cios", "tc"),
                 device="cuda", seed=20261016):
    """The MSM stage of 2^lg BW6-761 points under mont_mul ("cios") and
    mont_mul_tc ("tc") in the given order; one row a run."""
    device = require_device(device)
    accel = DeviceAccel("bw6_761", device)
    ks, bases, _ = bench_msm_ntt.fixed_base_stage(accel, BW6_761_ENGINE, 1 << lg, seed)
    rows = []
    for name in order:
        with F.mul_kernel(name):
            _, res = bench_msm_ntt.msm_stage(accel, BW6_761_ENGINE, bases, ks, seed + 1)
        rows.append({"mul": name, "points": 1 << lg, "ok": res["ok"],
                     **res["stage_s"], **res.get("launches", {})})
    return rows


def main():
    ok = True
    for spec in (F.FQ761, F.FQ):
        res = run(spec, 6 * 16384)  # the madd stacked-multiply shape
        print(json.dumps(res), flush=True)
        ok &= all(all(res[t].values()) for t in ("canonical", "lazy"))
    if "--msm" in sys.argv:
        rest = sys.argv[sys.argv.index("--msm") + 1:]
        for row in msm_in_turns(int(rest[0]) if rest else 20):
            print(json.dumps(row), flush=True)
            ok &= row["ok"]
    if not ok:
        raise SystemExit("a multiply disagrees with the host integers")
    print("DONE")


if __name__ == "__main__":
    main()

"""Launch-shape sweep of the Montgomery multiply on the card: mont_mul's
32-bit-word body at n = 25 (fq377), the one the paths run, compiled for and
launched with 32, 64, 128, 256 and 512 threads a block (the counterpart of
the block-width sweep of the JAX package's scripts/prof_field.py, which
sweeps its production multiply to find the block shape it runs best at),
and beside those five rows mont_mul itself, which picks its own block
(one warp up to one warp a scheduler, 128 threads above). Every shape is
built for 512 threads an SM, so each has mont_mul's budget of 128
registers and the rows differ by the block shape alone; the 128-thread
shape is mont_mul's own instance.

Per row it prints ns per multiply per lane over an 8-deep dependent chain
at B = 2^16 lanes, and the registers per thread and spill bytes ptxas
reported for that instantiation. The chains are replayed from a CUDA graph,
so the time is the card's (issued eagerly from Python a launch costs more
than this kernel runs; `eager_us_per_call` shows that cost). The chain's
output must equal mont_mul's limb for limb.

Usage: python -m celo_bls_snark_tpu_torch.scripts.prof_field [B] [threads ...]
"""

import json
import sys

import numpy as np
import torch

from ..ops import field as F
from ..ops import kernels
from ..utils.devices import require_device
from ..utils.profiling import time_ms

CHAIN = 8  # dependent multiplies per timed run, so the card stays busy


def _inputs(spec, B, device):
    rng = np.random.default_rng(0)
    vals = [[int.from_bytes(rng.bytes(47), "little") % spec.modulus
             for _ in range(256)] for _ in range(2)]
    reps = -(-B // 256)
    return tuple(spec.pack(v, device).repeat(1, reps)[:, :B].contiguous()
                 for v in vals)


def _chain(mul, a, b):
    x = a
    for _ in range(CHAIN):
        x = mul(x, b)
    return x


def shape_kernel(threads):
    """The instance csrc/field.cu launches for a block of `threads`:
    built for 512 threads an SM."""
    return f"mont_mul_kernel<25,{threads},{512 // threads}>"


def sweep(B=1 << 16, threads=kernels.SHAPE_THREADS, iters=20, device="cuda"):
    """One row per block size of mont_mul's kernel and a last row for
    mont_mul ("threads": null, it picks its own): {"kernel", "threads",
    "us_per_call", "ns_per_mul_lane", "eager_us_per_call", "registers",
    "stack", "spill_stores", "spill_loads", "smem", "equal"}."""
    device = require_device(device)
    spec = F.FQ
    a, b = _inputs(spec, B, device)
    want = _chain(lambda x, y: F.mont_mul(spec, x, y), a, b)
    on_card = device.type == "cuda"
    regs = kernels.ptxas_report(kernels.build()["ptxas"]) if on_card else {}
    cases = [(shape_kernel(th), th,
              lambda x, y, th=th: F.mont_mul_shape(spec, x, y, th))
             for th in threads]
    cases.append((shape_kernel(128), None, lambda x, y: F.mont_mul(spec, x, y)))
    rows = []
    for kernel, th, mul in cases:
        got = _chain(mul, a, b)
        row = {"kernel": kernel, "threads": th, "equal": bool(torch.equal(got, want))}
        if on_card:
            us = time_ms(lambda: _chain(mul, a, b), iters, graph=True) * 1e3 / CHAIN
            eager = time_ms(lambda: _chain(mul, a, b), iters) * 1e3 / CHAIN
            row.update(us_per_call=us, ns_per_mul_lane=us * 1e3 / B,
                       eager_us_per_call=eager)
        row.update(regs.get(kernel, {}))
        rows.append(row)
    return rows


def main():
    B = int(sys.argv[1]) if len(sys.argv) > 1 else 1 << 16
    threads = tuple(int(x) for x in sys.argv[2:]) or kernels.SHAPE_THREADS
    for row in sweep(B, threads):
        print(json.dumps({"B": B, **row}), flush=True)
        if not row["equal"]:
            sys.exit(f"{row['kernel']}: output differs from mont_mul")


if __name__ == "__main__":
    main()

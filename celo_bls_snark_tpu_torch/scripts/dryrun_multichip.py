"""entry.dryrun_multichip over N ranks: N processes joined into one
process group (gloo on the CPU, NCCL on the cards, one card a rank) with a
file:// store in a temporary directory; every rank runs the dry run and
prints its progress; the exit code is 0 when every rank passed.

Usage: python -m celo_bls_snark_tpu_torch.scripts.dryrun_multichip
           [--world-size N] [--device cpu|cuda] [--timeout SECONDS]
NCCL takes one rank a card, so --device cuda needs N cards.
"""

import argparse
import datetime
import os
import sys
import tempfile

import torch
import torch.multiprocessing as mp


def _rank(rank, world, store, device, timeout_s):
    from ..entry import dryrun_multichip
    from ..parallel import distributed as pdist

    if device == "cpu":
        torch.set_num_threads(1)
    pdist.init_distributed(f"file://{store}", world, rank, device=device,
                           timeout=datetime.timedelta(seconds=timeout_s))
    try:
        dryrun_multichip(pdist.global_mesh())
    finally:
        pdist.shutdown()


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--world-size", type=int, default=2)
    ap.add_argument("--device", choices=("cpu", "cuda"), default="cuda")
    ap.add_argument("--timeout", type=float, default=600.0,
                    help="seconds a rendezvous or collective may wait")
    args = ap.parse_args(argv)
    if args.world_size < 1 or args.world_size & (args.world_size - 1):
        sys.exit(f"--world-size {args.world_size}: the four-step NTT splits "
                 "over a power of two of ranks")
    if args.device == "cuda" and torch.cuda.device_count() < args.world_size:
        sys.exit(f"--device cuda needs {args.world_size} cards, "
                 f"this machine has {torch.cuda.device_count()}")
    if args.device == "cuda":
        from ..ops import kernels

        kernels.build()  # once, before the ranks load it
    with tempfile.TemporaryDirectory() as tmp:
        mp.start_processes(
            _rank, nprocs=args.world_size, start_method="spawn",
            args=(args.world_size, os.path.join(tmp, "store"), args.device,
                  args.timeout))
    print(f"dryrun_multichip ok: {args.world_size} ranks on {args.device}", flush=True)


if __name__ == "__main__":
    main()

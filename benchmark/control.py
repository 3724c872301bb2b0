"""The control of a cell: the reference, with the guarantee that the cell's
`control` names broken, put in the program's place at the cell's own size.
Its verdicts are judged as a run judges the program's, over the calls of a
window; a sound benchmark finds them wrong.

    python3 -m benchmark.control --workload <cell> --seeds 1 2 3 [--calls N]

Host work alone (no card). Prints one JSON line a seed:
{"workload", "seed", "calls", "wrong_verdicts", "limit", "correct"}.
"""

import argparse
import json
import sys


def control_run(workload, seed, calls, workers=None, overrides=None):
    from benchmark import run
    from benchmark.reference import work

    import torch

    _spec, _entry, cell, config = run.cell_spec(workload, overrides)
    ex = work.pool(workers or work.default_workers())
    try:
        drv = run.load_module("drivers", cell["driver"]).Driver(
            config, cell["params"], seed, torch.device("cpu"), ex)
        drv.inp.finish()
        expected = drv.judge(ex)
        controlled = drv.judge(ex, control=True)
    finally:
        ex.shutdown()
    n = len(expected)
    wrong = sum(controlled[k % n] != expected[k % n] for k in range(calls))
    return {"workload": workload, "seed": seed, "calls": calls, "wrong_verdicts": wrong,
            "limit": 0, "correct": wrong == 0,
            "expected": expected, "control": controlled}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--calls", type=int, default=100)
    a = ap.parse_args(argv)
    for seed in a.seeds:
        print(json.dumps(control_run(a.workload, seed, a.calls)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

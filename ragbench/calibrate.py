"""Readings a cell's limits are set from: whole runs of the cell on several
seeds in one process, each checked against the reference with the float8
control beside it.  The benchmark's own runs never run the control.

    python3 -m ragbench.calibrate --workload <cell> --seeds 1,2,3 \\
        --seconds <s>

Prints one ``readings`` line a seed: the program's numbers and the
control's, under the names of the cell's checks.
"""

from __future__ import annotations

import argparse
import json
import sys


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, required=True)
    args = p.parse_args(argv)
    from ragbench import run as rb_run

    rb_run.set_env()
    import time

    import torch

    from ragbench import spec

    cell = spec.cell(args.workload)
    if not torch.cuda.is_available():
        print("ragbench.calibrate: needs a CUDA device", file=sys.stderr)
        return 2
    for seed in (int(s) for s in args.seeds.split(",")):
        res = rb_run.run_cell(cell, seed, args.seconds, False, "cuda",
                              time.perf_counter(), control=True)
        print("readings " + json.dumps({
            "seed": seed, "correct": res["correct"],
            "metrics": {k: v["value"] for k, v in res["metrics"].items()},
            **res["readings"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

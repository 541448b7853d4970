"""The one-time knee sweep of an open-loop cell: one deployment, one window
at each offered rate, on the card.

    python3 -m ragbench.sweep --workload <cell> --seed <n> --seconds <s> \\
        --rates 100,200,400

For each rate it prints the completed rate, p50 and p95, the unanswered
requests, and whether a backlog grew: the p95 of the window's last quarter
against its first.  The knee is the highest rate whose completions keep
up, with no failures and no growing backlog.  A cell's mix file takes its
rate from the sweep as a number: a cell at about 0.8 of the knee judges
the tails, a cell above it the completed rate.  The readings a limit is
set from come from ``python3 -m ragbench.calibrate``.
"""

from __future__ import annotations

import argparse
import json
import sys

from ragbench import run as rb_run
from ragbench import stats


def backlog(w) -> tuple[float, float]:
    """p95 (ms) of the requests due in the window's first and last quarter."""
    lat = stats.latencies_ms(w.due, w.done)
    n = len(lat)
    return (stats.percentile(lat[:n // 4], 95),
            stats.percentile(lat[-(n // 4):], 95))


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, default=10.0)
    p.add_argument("--rates", required=True)
    args = p.parse_args(argv)
    rb_run.set_env()
    import torch

    from ragbench import spec
    from ragbench.runctx import Run
    from ragbench.trace import Tracer

    cell = spec.cell(args.workload)
    if not torch.cuda.is_available():
        print("ragbench.sweep: needs a CUDA device", file=sys.stderr)
        return 2
    mod = cell.traffic_module()
    r = Run(cell, args.seed, args.seconds, torch.device("cuda"),
            Tracer(False, ""), rb_run.T_PROCESS, "")
    dep = mod.Deployment(r)
    rates = [float(x) for x in args.rates.split(",")]
    probes, _ = dep.queries(0)
    mod.warm(r, dep.st, dep.ret, dep.kind, dep.k, probes)
    for rate in rates:
        _, queries = dep.queries(int(round(rate * args.seconds)))
        w = dep.window(queries, args.seconds, f"sweep{rate}")
        e2e = mod.end_to_end(w)
        first, last = backlog(w)
        row = {"rate": rate, **e2e, "unanswered": w.unanswered,
               "p95_first_quarter_ms": first, "p95_last_quarter_ms": last}
        print("sweep " + json.dumps(row), flush=True)
    dep.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())

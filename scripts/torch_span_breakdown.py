#!/usr/bin/env python3
"""Where a traced benchmark run's micro-batches spend their time, by the
program's own spans (``archi_tpu_torch.utils.tracing``).

Runs one cell of ``ragbench`` in this process (``ragbench.run.main`` with
the arguments given, so it prints its result line as usual) and then, from
the spans that end in the run's traced slice, writes a JSON table: for
each span name its count, and per micro-batch (over the slice's
``batcher.batch`` spans) its wall time, its thread-CPU time, its time off
the CPU (wall less CPU) and its self time (wall less the wall of its child
spans), in milliseconds; the ``wait`` spans are marked.  In a traced run
(``--trace 1``) it also reads the benchmark's own spans over the same
slice.  Without a profiler (``--trace 0`` with ``ARCHI_TRACE=1``) it
reads the last 10 s of micro-batches the ring holds.  Under
``ARCHI_TRACE=1`` it also totals, under ``setup``, the spans that ended
before that slice (the store's fill: ``bm25.add`` and the first
``bm25.build``, with their attributes summed); give such a run a short
``--seconds``, or the window's spans push the set-up's out of the ring.

Usage (on the card, from the root of the repository):

    python3 -m scripts.torch_span_breakdown OUT.json --workload <cell> \\
        --seed <n> --seconds 50 --trace 1
    ARCHI_TRACE=1 python3 -m scripts.torch_span_breakdown OUT.json ... \\
        --trace 0
"""

from __future__ import annotations

import collections
import json
import sys


def breakdown(spans: list) -> dict:
    batches = sum(1 for s in spans if s.name == "batcher.batch")
    child_wall = collections.Counter()
    for s in spans:
        if s.parent is not None:
            child_wall[s.parent] += s.wall_ns
    rows = {}
    for s in spans:
        r = rows.setdefault(s.name, {"count": 0, "wall": 0, "cpu": 0,
                                     "self": 0, "wait": s.wait})
        r["count"] += 1
        r["wall"] += s.wall_ns
        r["cpu"] += s.cpu_ns or 0
        r["self"] += s.wall_ns - child_wall[s.id]
    per = max(batches, 1) * 1e6
    out = {}
    for name, r in sorted(rows.items(), key=lambda kv: -kv[1]["wall"]):
        out[name] = {"count": r["count"], "wait": r["wait"],
                     "wall_ms_per_batch": r["wall"] / per,
                     "cpu_ms_per_batch": r["cpu"] / per,
                     "offcpu_ms_per_batch": (r["wall"] - r["cpu"]) / per
                     if r["cpu"] else None,
                     "self_ms_per_batch": r["self"] / per,
                     "mean_wall_ms": r["wall"] / r["count"] / 1e6}
    return {"batches": batches, "spans": out}


def setup_totals(spans: list) -> dict:
    """Count, wall and thread-CPU seconds, and summed numeric attributes
    of each span name."""
    out = {}
    for s in spans:
        r = out.setdefault(s.name, {"count": 0, "wall_s": 0.0, "cpu_s": 0.0})
        r["count"] += 1
        r["wall_s"] += s.wall_ns / 1e9
        r["cpu_s"] += (s.cpu_ns or 0) / 1e9
        for k, v in s.attrs.items():
            if isinstance(v, int) and not isinstance(v, bool):
                r[k] = r.get(k, 0) + v
    return dict(sorted(out.items(), key=lambda kv: -kv[1]["wall_s"]))


def harness_in(tracer, t0: float, t1: float, batches: int) -> dict:
    """The benchmark's own spans (its wrappers around the program's
    calls) that end in [t0, t1], read as its metrics read them."""
    def of(name):
        return [s for s in tracer.of(name) if t0 <= s[2] <= t1]

    embeds = of("embed")
    return {"bm25_ms_per_batch": 1e3 * sum(b - a for _, a, b, _ in of("bm25"))
            / max(batches, 1),
            "embed_mean_ms": 1e3 * sum(b - a for _, a, b, _ in embeds)
            / max(len(embeds), 1),
            "batches": len(of("batch"))}


def main(argv: list[str]) -> int:
    from ragbench import run as rb_run
    from ragbench import trace as rb_trace

    out_path, args = argv[0], argv[1:]
    tracers = []
    reduce = rb_trace.Tracer.reduce

    def keep_tracer(self):
        tracers.append(self)
        return reduce(self)

    rb_trace.Tracer.reduce = keep_tracer
    rc = rb_run.main(args)
    from archi_tpu_torch.utils import tracing

    tracer = tracers[-1] if tracers else None
    if tracer is not None and tracer.slice and tracer.slice[1] is not None:
        t0, t1 = tracer.slice
        source = "the traced slice"
    else:
        # no profiler (spans on through ARCHI_TRACE=1): the last 10 s of
        # micro-batches the ring holds
        ends = [s.end_ns for s in tracing.spans() if s.name == "batcher.batch"]
        t1 = max(ends, default=0) / 1e9
        t0 = t1 - 10.0
        source = "the last 10 s of batches"
    table = breakdown(tracing.spans(t0, t1))
    table.update(source=source, seconds=t1 - t0, dropped=tracing.dropped(),
                 setup=setup_totals(tracing.spans(None, t0)))
    if tracer is not None and tracer.enabled:
        table["harness"] = harness_in(tracer, t0, t1, table["batches"])
    with open(out_path, "w") as f:
        json.dump(table, f, indent=1)
    return rc


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))

"""Benchmark service entry point: ingest the configured sources and score a
question set over the port's store.

Counterpart of ``archi_tpu/bin/service_benchmark.py`` (reference
``src/bin/service_benchmark.py:626``), over the port's ``build_context``,
on the card unless the caller passes ``device="cpu"``::

    python -m archi_tpu_torch.bin.service_benchmark config.yaml queries.json

queries.json: [{"question": ..., "reference_answer": ...,
                "reference_sources": [{"display_name": "guide.md"}]}]

``run_benchmark`` ingests and runs the ``Benchmarker``
(``services.benchmarking.modes``, default SOURCES and RETRIEVAL) and
returns its report with the context; ``main`` prints the totals.
"""

from __future__ import annotations

import json
import sys

from archi_tpu_torch.benchmarking.harness import (
    Benchmarker, wait_for_ingestion,
)
from archi_tpu_torch.bin.bootstrap import build_context
from archi_tpu_torch.orchestrator.archi import Archi


def run_benchmark(queries, config_paths=(), overrides=None, ctx=None, *,
                  device=None, devices=None):
    """→ (report, ctx): ingest, wait for the ingestion, run the
    ``Benchmarker`` over ``queries``."""
    ctx = ctx or build_context(config_paths, overrides, device=device,
                               devices=devices)
    ctx.data_manager.run_ingestion()
    wait_for_ingestion(lambda: ctx.data_manager.status)

    bench_cfg = ctx.config.get("services", {}).get("benchmarking", {})
    modes = tuple(bench_cfg.get("modes", ["SOURCES", "RETRIEVAL"]))
    archi = Archi(ctx.config.get("active_pipeline", "QAPipeline"),
                  config=ctx.config, vectorstore=ctx.vectorstore)
    bench = Benchmarker(
        archi, queries, modes=modes,
        out_dir=bench_cfg.get("out_dir", "./benchmark_results"),
        vectorstore=ctx.vectorstore,
    )
    return bench.run(), ctx


def main() -> None:
    config_paths = [a for a in sys.argv[1:] if a.endswith((".yaml", ".yml"))]
    query_files = [a for a in sys.argv[1:] if a.endswith(".json")]
    if not query_files:
        print("usage: service_benchmark [config.yaml] queries.json")
        sys.exit(2)
    with open(query_files[0]) as f:
        queries = json.load(f)

    report, _ctx = run_benchmark(queries, config_paths)
    print(json.dumps(report["totals"], indent=2))


if __name__ == "__main__":
    main()

"""``archi-tpu-torch evaluate`` without the command line: the body of the
port's ``evaluate`` command (``cli/cli_main.py``), which imports ``click``,
as a function a script calls where ``click`` is absent.

It is the JAX package's ``evaluate`` command (``archi_tpu/cli/cli_main.py``)
over the port's store, with one argument more: ``device``, where the store
is built (``cuda``, the card, by default; ``cpu``).
"""

from __future__ import annotations

import json


def run_evaluate(*, configs=(), queries=None, fixture=False, beir=None,
                 retriever_mode="hybrid", mode=("SOURCES", "RETRIEVAL"),
                 judge=None, out="./benchmark_results",
                 device="cuda") -> dict:
    """→ ``evaluate_beir``'s metrics with ``beir`` (a BEIR-format
    directory), else the ``Benchmarker``'s report (``totals`` and
    ``questions``; ``results.json`` and ``results.html`` under ``out``)
    over the fixture corpus with ``fixture``, or over the corpus of
    ``configs`` with ``queries`` (a JSON file of questions)."""
    from archi_tpu_torch.benchmarking.harness import Benchmarker
    from archi_tpu_torch.orchestrator.archi import Archi

    if beir:
        from archi_tpu_torch.benchmarking.beir import evaluate_beir

        embedder = None
        if configs:
            from archi_tpu_torch.config.manager import ConfigurationManager
            from archi_tpu_torch.models.registry import resolve_embedder

            cm = ConfigurationManager(list(configs))
            embedder = resolve_embedder(cm.config["data_manager"],
                                        device=device)
        return evaluate_beir(beir, embedder=embedder, mode=retriever_mode,
                             device=device)

    judge_model = None
    if judge:
        from archi_tpu_torch.providers.registry import get_model

        judge_model = get_model(judge)

    if fixture:
        from archi_tpu_torch.benchmarking.fixture import fixture_corpus
        from archi_tpu_torch.data.chunking import character_split
        from archi_tpu_torch.engine.vectorstore import TorchVectorStore
        from archi_tpu_torch.models.hashed_embedder import (
            HashedNgramEmbedder,
        )

        docs, qs = fixture_corpus()
        store = TorchVectorStore(HashedNgramEmbedder(), device=device)
        texts, metas, ids = [], [], []
        for dname, text, meta in docs:
            for i, chunk in enumerate(character_split(text)):
                texts.append(chunk)
                metas.append(dict(meta))
                ids.append(f"{dname}:{i}")
        store.add_texts(texts, metas, ids=ids)
        archi = Archi("QAPipeline", vectorstore=store)
        vectorstore = store
    else:
        if not queries:
            raise ValueError("--queries required without --fixture")
        from archi_tpu_torch.bin.bootstrap import build_context

        with open(queries) as f:
            qs = json.load(f)
        ctx = build_context(list(configs), device=device)
        ctx.data_manager.run_ingestion()
        archi = Archi(ctx.config.get("active_pipeline", "QAPipeline"),
                      config=ctx.config, vectorstore=ctx.vectorstore)
        vectorstore = ctx.vectorstore
    bench = Benchmarker(archi, qs, modes=tuple(mode), out_dir=out,
                        vectorstore=vectorstore, judge_model=judge_model)
    return bench.run()

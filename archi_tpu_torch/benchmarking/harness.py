"""Quality benchmark harness — the ``archi evaluate`` engine of the port.

Counterpart of ``archi_tpu/benchmarking/harness.py`` (the reference's
``Benchmarker``, ``src/bin/service_benchmark.py:46,134``):
- per config × per question: run the pipeline,
- **SOURCES mode**: match each reference source against retrieved-document
  metadata; ``source_accuracy`` = ALL sources found (strict),
  ``relative_source_accuracy`` = >=1 found (``:344-382,513-528``),
- **RAGAS mode**: LLM-judged answer/context metrics, through
  ``benchmarking/llm_judge.py`` where the ``ragas`` package is absent,
- ``time_elapsed`` per question (``:480-487``),
- results dumped as JSON + HTML report,
- **RETRIEVAL mode**: recall@k of the index against a NumPy brute-force
  scan of the same rows, and the query rate.

One departure: the RETRIEVAL mode reads the port's ``FlatIndex`` tensors
(rows to f32 on the host, int8 rows scaled by 1/127 as the top-k kernel
scales them, ``alive > 0.5``) where the JAX package reads its arrays.  The
rest is the JAX package's code.
"""

from __future__ import annotations

import json
import os
import time
from typing import Any

import numpy as np


def match_sources(result, reference_sources: list[dict]) -> list[bool]:
    """For each {metadata_field: expected_value} reference source, check the
    retrieved documents (reference get_source_results:344-382)."""
    docs = result.source_documents if hasattr(result, "source_documents") \
        else result.get("source_documents", [])
    matches = []
    for source in reference_sources:
        field, expected = next(iter(source.items()))
        found = False
        for doc in docs:
            value = (doc.metadata or {}).get(field)
            if value is None:
                continue
            values = [str(v).strip() for v in value] \
                if isinstance(value, list) else [str(value).strip()]
            if str(expected) in values:
                found = True
                break
        matches.append(found)
    return matches


class Benchmarker:
    """Runs question sets against an Archi instance.

    queries: [{question, reference_answer?, reference_sources?: [{field: value}]}]
    modes: subset of {"SOURCES", "RAGAS", "RETRIEVAL"}.
    """

    def __init__(self, archi, queries: list[dict], *,
                 modes: tuple[str, ...] = ("SOURCES",),
                 out_dir: str = "./benchmark_results",
                 vectorstore=None,
                 retrieval_k: int = 10,
                 judge_model=None):
        self.archi = archi
        self.queries = queries
        self.modes = modes
        self.out_dir = out_dir
        self.vectorstore = vectorstore
        self.retrieval_k = retrieval_k
        self.judge_model = judge_model  # RAGAS-fallback LLM judge

    # ---------------------------------------------------------------- modes
    def _retrieval_metrics(self) -> dict:
        """recall@k vs NumPy brute force + QPS on the live index."""
        store = self.vectorstore
        if store is None or store.count() == 0:
            return {}
        import torch

        idx = store.index
        n = idx.n_rows
        emb = idx.emb[:n].float().cpu().numpy()
        if idx.dtype == torch.int8:
            emb = emb / 127.0
        alive = idx.alive[:n].cpu().numpy() > 0.5
        texts = [q["question"] for q in self.queries]
        qvecs = np.asarray(
            store._embedding_function.embed_documents(texts), np.float32)
        qn = qvecs / np.maximum(
            np.linalg.norm(qvecs, axis=1, keepdims=True), 1e-12)
        brute = qn @ emb.T
        brute[:, ~alive] = -np.inf
        k = min(self.retrieval_k, int(alive.sum()))
        ref_top = np.argsort(-brute, axis=1)[:, :k]

        t0 = time.time()
        _ids, _vals, rows = idx.search(qvecs, k=k)
        elapsed = max(time.time() - t0, 1e-9)
        recall = float(np.mean([
            len(set(rows[b]) & set(ref_top[b])) / k
            for b in range(len(texts))
        ]))
        return {
            "recall_at_k": recall,
            "k": k,
            "query_qps": round(len(texts) / elapsed, 2),
        }

    def _ragas_metrics(self, ragas_input: list[dict]) -> dict:
        try:
            from datasets import Dataset  # noqa: F401
            from ragas import evaluate  # noqa: F401
        except ImportError:
            # vendored fallback: the same four metrics as direct LLM-judge
            # calls through the provider layer (benchmarking/llm_judge.py) —
            # the mode produces numbers even without the ragas package.
            judge = self.judge_model
            if judge is None:
                try:
                    from archi_tpu_torch.providers.registry import get_model

                    judge = get_model("local/echo")
                except Exception:
                    judge = None
            if judge is None:
                return {"ragas_skipped": "ragas absent and no judge model"}
            from archi_tpu_torch.benchmarking.llm_judge import LLMJudge

            scores = LLMJudge(judge).evaluate(ragas_input)
            scores["ragas_backend"] = "llm_judge_fallback"
            return scores
        # Full RAGAS path mirrors reference get_ragas_results:385-426.
        from datasets import Dataset
        from ragas import evaluate
        from ragas.metrics import (
            answer_relevancy, context_precision, context_recall, faithfulness,
        )

        data = Dataset.from_list(ragas_input)
        res = evaluate(data, metrics=[answer_relevancy, faithfulness,
                                      context_precision, context_recall])
        df = res.to_pandas()
        return {f"aggregate_{m}": float(df[m].mean())
                for m in ("answer_relevancy", "faithfulness",
                          "context_precision", "context_recall")}

    # ------------------------------------------------------------------ run
    def run(self) -> dict:
        question_results: dict[str, Any] = {}
        totals: dict[str, Any] = {"n_questions": len(self.queries)}
        source_acc = rel_acc = 0.0
        ragas_input = []

        for i, q in enumerate(self.queries, 1):
            question = q["question"]
            t0 = time.time()
            result = self.archi.invoke(history=[("User", question)])
            elapsed = time.time() - t0
            entry: dict[str, Any] = {
                "question": question,
                "answer": result.answer,
                "time_elapsed": round(elapsed, 3),
                "sources_metadata": [d.metadata for d in
                                     result.source_documents],
                "sources_trunc_content": [d.page_content[:300] for d in
                                          result.source_documents],
            }
            refs = q.get("reference_sources") or []
            if "SOURCES" in self.modes and refs:
                matches = match_sources(result, refs)
                entry["reference_sources_metadata"] = [
                    {**src, "matched": m} for src, m in zip(refs, matches)
                ]
                if any(matches):
                    rel_acc += 1
                if matches and all(matches):
                    source_acc += 1
            if "RAGAS" in self.modes:
                ragas_input.append({
                    "question": question,
                    "contexts": [d.page_content for d in
                                 result.source_documents],
                    "answer": result.answer,
                    "ground_truth": q.get("reference_answer", ""),
                })
            question_results[f"question_{i}"] = entry

        with_refs = sum(1 for q in self.queries
                        if q.get("reference_sources"))
        if "SOURCES" in self.modes and with_refs:
            totals["source_accuracy"] = source_acc / with_refs
            totals["relative_source_accuracy"] = rel_acc / with_refs
        if "RAGAS" in self.modes and ragas_input:
            totals.update(self._ragas_metrics(ragas_input))
        if "RETRIEVAL" in self.modes:
            totals.update(self._retrieval_metrics())
        totals["avg_time_elapsed"] = round(float(np.mean([
            e["time_elapsed"] for e in question_results.values()
        ])), 3) if question_results else 0.0

        report = {"totals": totals, "questions": question_results}
        self._dump(report)
        return report

    # ----------------------------------------------------------------- output
    def _dump(self, report: dict) -> None:
        os.makedirs(self.out_dir, exist_ok=True)
        with open(os.path.join(self.out_dir, "results.json"), "w") as f:
            json.dump(report, f, indent=2, default=str)
        with open(os.path.join(self.out_dir, "results.html"), "w") as f:
            f.write(self._html(report))

    @staticmethod
    def _html(report: dict) -> str:
        """Minimal HTML report (reference ResultHandler.dump_html)."""
        rows = "".join(
            f"<tr><td>{k}</td><td>{v}</td></tr>"
            for k, v in report["totals"].items()
        )
        qrows = "".join(
            f"<details><summary>{e['question'][:100]} "
            f"({e['time_elapsed']}s)</summary><pre>{e['answer'][:2000]}"
            f"</pre></details>"
            for e in report["questions"].values()
        )
        return (
            "<html><head><title>archi-tpu benchmark</title></head><body>"
            f"<h1>Benchmark results</h1><table border=1>{rows}</table>"
            f"<h2>Questions</h2>{qrows}</body></html>"
        )


def wait_for_ingestion(status_fn, *, timeout: float = 600.0,
                       poll: float = 2.0) -> bool:
    """Poll an ingestion-status callable until done (reference
    wait_for_ingestion_completion:576-624 polls the data-manager HTTP API)."""
    deadline = time.time() + timeout
    while time.time() < deadline:
        st = status_fn()
        if st.get("status") in ("done", "idle") and \
                not st.get("by_status", {}).get("pending") and \
                not st.get("by_status", {}).get("embedding"):
            return True
        time.sleep(poll)
    return False

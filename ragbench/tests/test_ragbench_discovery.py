"""A cell added from files alone is found and dry-run: a copy of the
benchmark gets a new mix file, a cell file and a BENCHMARK.json entry (the
semantic retriever over the TREC-COVID deployment), and no file that was
there changes."""

import json
import os
import shutil

from ragbench import spec
from ragbench.tests._small import run_small, small_cell


def test_cell_from_files_alone(tmp_path):
    root = tmp_path / "checkout"
    shutil.copytree(spec.HERE, root / "ragbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(spec.ROOT, "BENCHMARK.json"), root)
    before = {p: p.read_bytes() for p in root.rglob("*") if p.is_file()}

    mix = json.loads((root / "ragbench/traffic/trec-covid.hybrid-over.json")
                     .read_text())
    mix["retriever"] = "semantic"
    (root / "ragbench/traffic/trec-covid.semantic-open.json").write_text(
        json.dumps(mix))
    (root / "ragbench/cells/trec-covid.semantic.json").write_text(json.dumps(
        {"config": "minilm-l6.trec-covid",
         "traffic": "trec-covid.semantic-open",
         "limits": {"unanswered": 0, "bad_answers": 0, "rank_gap": 1e-3,
                    "score_err": 1e-3}}))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["workloads"].append(
        {"name": "trec-covid.semantic", "config": "minilm-l6.trec-covid",
         "traffic": "trec-covid.semantic-open", "chips": 1,
         "why": "the lexical layer bypassed on the same rows"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "trec-covid.hybrid" in m.get("workloads", []) and \
                m["name"] != "lexical.bm25_ms.query":
            m["workloads"].append("trec-covid.semantic")

    cell = small_cell("trec-covid.semantic", bench, str(root / "ragbench"))
    assert cell.traffic["retriever"] == "semantic"
    assert [m["name"] for m in cell.end_to_end] == [
        "queries_per_s", "setup_s"]
    res = run_small(cell, seconds=1.0, trace=True)
    assert res["correct"], res["checks"]
    assert "sched.mean_batch.query" in res["metrics"]
    assert "lexical.bm25_ms.query" not in res["metrics"]
    after = {p: p.read_bytes() for p in before}
    assert after == before

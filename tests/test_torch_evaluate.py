"""``archi-tpu-torch evaluate``, the benchmark service and the deployment
CLI on the CPU, held against the JAX package's.

- The ``Benchmarker`` (SOURCES and RETRIEVAL) over the fixture corpus on
  ``TpuVectorStore`` and ``TorchVectorStore(device="cpu")`` at each storage
  type (bf16, f32, int8): the same totals, but for the clocks (``query_qps``,
  ``avg_time_elapsed``).
- ``evaluate_beir`` on ``write_fixture_beir`` in each retrieval mode:
  nDCG@10, recall@10/100 and MRR@10 within 1e-4.
- ``bin/service_benchmark``: a config's local files ingested and scored, as
  the JAX service scores them.
- The port's Click group (``CliRunner``): ``list-services``, ``evaluate
  --fixture --device cpu`` and ``--beir``; ``run_evaluate`` without Click.
- ``render_compose``, ``DeploymentManager.prepare`` and ``start`` (with
  ``Popen`` replaced) name and spawn ``archi_tpu_torch.bin.service_*``
  with the repository's root on ``PYTHONPATH``.
"""

import json
import os
import pathlib
import sys

import pytest
import yaml
from click.testing import CliRunner

from archi_tpu.benchmarking.beir import evaluate_beir as jax_evaluate_beir
from archi_tpu.benchmarking.harness import Benchmarker as JaxBenchmarker
from archi_tpu.cli.cli_main import cli as jax_cli
from archi_tpu.engine.vectorstore import TpuVectorStore
from archi_tpu.models.hashed_embedder import \
    HashedNgramEmbedder as JaxHashedEmbedder
from archi_tpu.orchestrator.archi import Archi as JaxArchi
from archi_tpu_torch.benchmarking.beir import (evaluate_beir,
                                               write_fixture_beir)
from archi_tpu_torch.benchmarking.fixture import fixture_corpus
from archi_tpu_torch.benchmarking.harness import Benchmarker
from archi_tpu_torch.cli import deployment
from archi_tpu_torch.cli.cli_main import cli
from archi_tpu_torch.cli.evaluate import run_evaluate
from archi_tpu_torch.cli.registry import SERVICES
from archi_tpu_torch.data.chunking import character_split
from archi_tpu_torch.engine.vectorstore import TorchVectorStore
from archi_tpu_torch.models.hashed_embedder import HashedNgramEmbedder
from archi_tpu_torch.orchestrator.archi import Archi

ROOT = pathlib.Path(__file__).resolve().parents[1]
#: totals that carry a clock
CLOCKS = ("query_qps", "avg_time_elapsed")


def _timeless(totals):
    return {k: v for k, v in totals.items() if k not in CLOCKS}


def _fixture_chunks():
    docs, queries = fixture_corpus()
    texts, metas, ids = [], [], []
    for name, text, meta in docs:
        for i, chunk in enumerate(character_split(text)):
            texts.append(chunk)
            metas.append(dict(meta))
            ids.append(f"{name}:{i}")
    return (texts, metas, ids), queries


@pytest.mark.parametrize("dtype", ["bfloat16", "float32", "int8"])
def test_benchmarker_totals_equal_the_jax_packages(dtype, tmp_path):
    (texts, metas, ids), queries = _fixture_chunks()
    reports = []
    for name, store, archi_cls, bench_cls in (
            ("port", TorchVectorStore(HashedNgramEmbedder(), dtype=dtype,
                                      device="cpu"), Archi, Benchmarker),
            ("jax", TpuVectorStore(JaxHashedEmbedder(), dtype=dtype),
             JaxArchi, JaxBenchmarker)):
        store.add_texts(texts, metas, ids=ids)
        bench = bench_cls(archi_cls("QAPipeline", vectorstore=store),
                          queries, modes=("SOURCES", "RETRIEVAL"),
                          out_dir=str(tmp_path / name), vectorstore=store)
        reports.append(bench.run())
    got, want = (_timeless(r["totals"]) for r in reports)
    assert got == want
    assert got["n_questions"] == len(queries) and got["k"] == 10
    # int8: the index scores a quantised query, the brute force an f32 one
    assert got["recall_at_k"] >= (0.98 if dtype == "int8" else 0.99)
    assert got["source_accuracy"] > 0.9
    assert [q["sources_metadata"] for q in reports[0]["questions"].values()] \
        == [q["sources_metadata"] for q in reports[1]["questions"].values()]
    assert (tmp_path / "port" / "results.json").exists()
    assert (tmp_path / "port" / "results.html").exists()


@pytest.fixture(scope="module")
def beir_dir(tmp_path_factory):
    path = tmp_path_factory.mktemp("beir") / "fixture"
    write_fixture_beir(str(path), n_topics=30, docs_per_topic=8, seed=5)
    return str(path)


@pytest.mark.parametrize("mode", ["hybrid", "semantic", "bm25"])
def test_evaluate_beir_matches_the_jax_package(beir_dir, mode):
    got = evaluate_beir(beir_dir, mode=mode, device="cpu")
    want = jax_evaluate_beir(beir_dir, mode=mode)
    assert set(got) == set(want)
    for key, value in want.items():
        if isinstance(value, float):
            assert abs(got[key] - value) <= 1e-4, (key, got, want)
        else:
            assert got[key] == value
    assert (got["documents"], got["queries"]) == (240, 30)


def _write_config(tmp, *, n_docs=48):
    """A deployment config over the fixture corpus's first ``n_docs``
    documents as local files, and the queries whose sources are among
    them (sources named by ``display_name``)."""
    docs, queries = fixture_corpus()
    corpus = tmp / "corpus"
    corpus.mkdir()
    names = set()
    for name, text, _meta in docs[:n_docs]:
        (corpus / name).write_text(text)
        names.add(name)
    qs = [{"question": q["question"], "reference_sources": [
        {"display_name": s["source"]} for s in q["reference_sources"]]}
        for q in queries
        if all(s["source"] in names for s in q["reference_sources"])]
    cfg = tmp / "config.yaml"
    cfg.write_text(yaml.safe_dump({
        "data_manager": {"embedding_name": "hash",
                         "data_path": str(tmp / "data"),
                         "db_path": str(tmp / "catalog.db"),
                         "sources": {"local_files": {"paths": [str(corpus)]}}},
        "services": {"benchmarking": {"out_dir": str(tmp / "out")}}}))
    qfile = tmp / "queries.json"
    qfile.write_text(json.dumps(qs))
    return cfg, qfile, qs


def test_service_benchmark_scores_as_the_jax_service(tmp_path, monkeypatch,
                                                     capsys):
    from archi_tpu.bin import service_benchmark as jax_service
    from archi_tpu_torch.bin.service_benchmark import run_benchmark

    (tmp_path / "port").mkdir()
    (tmp_path / "jax").mkdir()
    cfg, _qfile, qs = _write_config(tmp_path / "port")
    report, ctx = run_benchmark(qs, [str(cfg)], device="cpu")
    ctx.scheduler.stop()
    jcfg, jqfile, _ = _write_config(tmp_path / "jax")
    monkeypatch.setattr(sys, "argv", ["service_benchmark", str(jcfg),
                                      str(jqfile)])
    jax_service.main()
    want = json.loads(capsys.readouterr().out)
    assert len(qs) >= 8 and report["totals"]["n_questions"] == len(qs)
    assert _timeless(report["totals"]) == _timeless(want)
    assert report["totals"]["recall_at_k"] >= 0.99
    assert (tmp_path / "port" / "out" / "results.json").exists()


# -------------------------------------------------------------------- CLI
def test_cli_list_services_names_the_ports_services():
    r = CliRunner().invoke(cli, ["list-services"])
    assert r.exit_code == 0, r.output
    assert r.output == CliRunner().invoke(jax_cli, ["list-services"]).output
    assert "data_manager" in r.output and "sources:" in r.output
    assert all(s.module.startswith("archi_tpu_torch.bin.service_")
               for s in SERVICES.values())


def test_cli_evaluate_fixture_on_the_cpu(tmp_path):
    r = CliRunner().invoke(cli, ["evaluate", "--fixture", "--device", "cpu",
                                 "-o", str(tmp_path / "port")])
    assert r.exit_code == 0, r.output
    jr = CliRunner().invoke(jax_cli, ["evaluate", "--fixture", "-o",
                                      str(tmp_path / "jax")])
    assert jr.exit_code == 0, jr.output
    got = json.loads(r.output[:r.output.rindex("}") + 1])
    want = json.loads(jr.output[:jr.output.rindex("}") + 1])
    assert _timeless(got) == _timeless(want)
    assert "full report:" in r.output
    report = run_evaluate(fixture=True, device="cpu",
                          out=str(tmp_path / "direct"))
    assert _timeless(report["totals"]) == _timeless(got)


def test_cli_evaluate_beir_and_its_errors(beir_dir):
    r = CliRunner().invoke(cli, ["evaluate", "--beir", beir_dir,
                                 "--retriever-mode", "semantic",
                                 "--device", "cpu"])
    assert r.exit_code == 0, r.output
    assert json.loads(r.output) == run_evaluate(
        beir=beir_dir, retriever_mode="semantic", device="cpu")
    r = CliRunner().invoke(cli, ["evaluate", "--device", "cpu"])
    assert r.exit_code == 2 and "--queries required" in r.output
    with pytest.raises(ValueError, match="--queries"):
        run_evaluate(device="cpu")


def test_cli_evaluate_device_defaults_to_the_card(monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    r = CliRunner().invoke(cli, ["evaluate", "--fixture"])
    assert r.exit_code != 0 and "CUDA" in str(r.exception)


# ------------------------------------------------------------- deployment
CONFIG = {"name": "t", "services": {
    "chat": {"enabled": True, "port": 7861},
    "data_manager": {"enabled": True, "port": 7862},
    "grader": {"enabled": False, "port": 7863},
    "benchmarking": {"enabled": True}}, "verbosity": 2}


def test_render_compose_names_the_ports_services():
    compose = yaml.safe_load(deployment.render_compose(CONFIG))
    assert set(compose["services"]) == {"chat", "data_manager",
                                        "benchmarking"}
    for name, entry in compose["services"].items():
        assert entry["command"][:3] == ["python", "-m", SERVICES[name].module]
        assert SERVICES[name].module.startswith("archi_tpu_torch.bin.")
    assert compose["services"]["chat"]["depends_on"] == ["data_manager"]
    assert compose["services"]["chat"]["ports"] == ["7861:7861"]


@pytest.fixture
def deploy_root(tmp_path, monkeypatch):
    monkeypatch.setattr(deployment, "DEPLOY_ROOT", str(tmp_path / "deps"))
    return tmp_path / "deps"


def test_prepare_stages_the_ports_deployment(deploy_root):
    mgr = deployment.DeploymentManager("t")
    env = mgr.prepare(CONFIG)
    assert env == {}
    cfg = yaml.safe_load(open(os.path.join(mgr.dir, "config.yaml")))
    assert cfg["data_manager"]["data_path"] == os.path.join(mgr.dir, "data")
    compose = open(os.path.join(mgr.dir, "compose.yaml")).read()
    assert "archi_tpu_torch.bin.service_chat" in compose
    assert "archi_tpu.bin" not in compose
    assert os.path.exists(os.path.join(mgr.dir, "grafana", "dashboards",
                                       "archi-tpu.json"))


def test_start_spawns_the_ports_services(deploy_root, monkeypatch):
    spawned = []

    class FakePopen:
        def __init__(self, argv, *, stdout, stderr, cwd, env):
            self.pid = 10_000_000 + len(spawned)   # no such process
            spawned.append((argv, cwd, env))

    monkeypatch.setattr(deployment.subprocess, "Popen", FakePopen)
    mgr = deployment.DeploymentManager("t")
    started = mgr.start(CONFIG)
    assert list(started) == ["data_manager", "chat"]    # no benchmarking
    assert [argv[1:3] for argv, _cwd, _env in spawned] == [
        ["-m", "archi_tpu_torch.bin.service_data_manager"],
        ["-m", "archi_tpu_torch.bin.service_chat"]]
    for argv, cwd, env in spawned:
        assert argv[0] == sys.executable and cwd == mgr.dir
        assert argv[3] == os.path.join(mgr.dir, "config.yaml")
        assert env["PYTHONPATH"].split(os.pathsep)[0] == str(ROOT)
    assert started["chat"]["port"] == 7861
    status = mgr.status()
    assert set(status) == {"data_manager", "chat"}
    assert not any(s["alive"] for s in status.values())
    mgr.delete()
    assert not os.path.isdir(mgr.dir)

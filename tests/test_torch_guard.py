"""Package rules of the PyTorch/CUDA port.

- No file of ``archi_tpu_torch`` (nor ``scripts/torch_*.py`` nor
  ``chip_smoke.py``) imports ``jax`` or the JAX package ``archi_tpu``:
  checked on the source (AST) and on what an import of every module really
  loads (a fresh interpreter).
- Entry points default to CUDA and raise without it; they never fall back
  to the CPU quietly, and the kernel wrappers take their plain versions
  only for CPU tensors.
- The kernel build finds its sources and refuses to run without nvcc.
"""

import ast
import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
FILES = (sorted((ROOT / "archi_tpu_torch").rglob("*.py"))
         + sorted((ROOT / "scripts").glob("torch_*.py"))
         + [ROOT / "chip_smoke.py"])


def _forbidden(name: str) -> bool:
    """JAX, the JAX package, and ml_dtypes (absent where the port runs:
    bf16 arrays travel through npz as uint16 bit views)."""
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "archi_tpu", "ml_dtypes")


def _imported_names(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""
        elif isinstance(node, ast.Call) and node.args \
                and isinstance(node.args[0], ast.Constant) \
                and isinstance(node.args[0].value, str):
            fn = node.func
            name = fn.attr if isinstance(fn, ast.Attribute) else \
                getattr(fn, "id", "")
            if name in ("import_module", "__import__"):
                yield node.args[0].value


@pytest.mark.parametrize("path", FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_sources_import_no_jax_and_no_reference(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = [n for n in _imported_names(tree) if _forbidden(n)]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_importing_every_module_loads_no_jax():
    code = (
        "import importlib, json, pathlib, pkgutil, sys\n"
        "import archi_tpu_torch\n"
        "for m in pkgutil.walk_packages(archi_tpu_torch.__path__,"
        " 'archi_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        "for p in sorted(pathlib.Path('scripts').glob('torch_*.py')):\n"
        "    importlib.import_module('scripts.' + p.stem)\n"
        "print(json.dumps(sorted(sys.modules)))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120,
                         check=True)
    mods = json.loads(out.stdout.strip().splitlines()[-1])
    assert "archi_tpu_torch.engine.vectorstore" in mods
    # the multi-device tier
    assert {f"archi_tpu_torch.engine.{m}" for m in (
        "distributed", "sharded_index", "sharded_ivf", "sharded_ivfpq",
        "sharded_xl")} <= set(mods)
    # the data-manager service
    assert {"archi_tpu_torch.bin.service_data_manager",
            "archi_tpu_torch.web.data_app", "archi_tpu_torch.data.manager",
            "archi_tpu_torch.data.collectors.tickets",
            "archi_tpu_torch.config.service"} <= set(mods)
    # the chat service
    assert {f"archi_tpu_torch.{m}" for m in (
        "bin.service_chat", "web.chat_app", "orchestrator.archi",
        "pipelines.qa", "pipelines.agents.base_react", "providers.registry",
        "engine.remote_vectorstore")} <= set(mods)
    # the other entry points, the Postgres backends, evaluation and the CLI
    assert {f"archi_tpu_torch.{m}" for m in NEW_MODULES} <= set(mods)
    # the benchmark tooling and the scripts of BASELINE configs 3 and 5
    assert {f"archi_tpu_torch.benchmarking.{m}" for m in (
        "timing", "synth_corpus", "ivf_sweep", "pq_sweep")} <= set(mods)
    assert {"scripts.torch_run_config3",
            "scripts.torch_bench_streaming_ingest"} <= set(mods)
    # the scripts of BASELINE config 4
    assert {"scripts.torch_fill_host_store", "scripts.torch_run_config4",
            "scripts.torch_run_config4_sharded",
            "scripts.torch_bench_shard_scaling"} <= set(mods)
    # the measurement and tooling scripts
    assert {f"scripts.torch_{m}" for m in (
        "diag_cfg4_misses", "bench_serving", "bench_serving_http",
        "bench_ingest", "bench_encoder", "run_quality", "ann_builder",
        "exp_encoder", "bench_attention_refold")} <= set(mods)
    assert not [m for m in mods if _forbidden(m)]


#: the modules of the other entry points, the Postgres backends,
#: evaluation and the CLI
NEW_MODULES = (
    "utils.connection_pool", "data.catalog_postgres", "utils.app_db_postgres",
    "utils.grader_service", "web.grader_ui", "web.grader_app", "web.bots",
    "web.redmine_mailer", "data.collectors.sso", "web.js_lint",
    "bin.service_grader", "bin.service_create_account",
    "bin.service_mattermost", "bin.service_piazza", "bin.service_mailbox",
    "bin.service_redmine", "bin.service_benchmark",
    "benchmarking.fixture", "benchmarking.llm_judge", "benchmarking.harness",
    "benchmarking.beir", "cli.registry", "cli.managers", "cli.deployment",
    "cli.evaluate", "cli.cli_main", "version")

#: what the card's machine lacks (JAX, the JAX package, and the packages
#: the services import only inside the functions that need them), and
#: ``cryptography``, which BYOK needs and a deployment may lack
ABSENT = ("jax", "jaxlib", "archi_tpu", "ml_dtypes", "requests", "yaml",
          "psycopg2", "bs4", "pypdf", "cryptography")

SERVICE_WITHOUT_JAX = """
import importlib.abc, json, os, sys, time, urllib.request

ABSENT = set(sys.argv[2].split(","))


class Absent(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ABSENT:
            raise ImportError(f"no module named {name!r} on this machine")
        return None


sys.meta_path.insert(0, Absent())
for name in ABSENT:
    try:
        __import__(name)
    except ImportError:
        continue
    raise SystemExit(f"{name} imported")

from archi_tpu_torch.bin.service_data_manager import build_app

tmp = sys.argv[1]
os.makedirs(os.path.join(tmp, "corpus"))
for i, text in enumerate(("slurm array jobs are submitted with sbatch",
                          "eos storage quotas are set per user",
                          "the mailing list archive is searchable")):
    with open(os.path.join(tmp, "corpus", f"doc{i}.md"), "w") as f:
        f.write(text)
app, ctx = build_app(overrides={"data_manager": {
    "embedding_name": "hash", "data_path": os.path.join(tmp, "data"),
    "db_path": os.path.join(tmp, "catalog.db"),
    "sources": {"local_files": {"paths": [os.path.join(tmp, "corpus")]}},
    "serving": {"micro_batch": {"enabled": True}}}}, device="cpu")
url = f"http://127.0.0.1:{app.serve('127.0.0.1', 0, background=True)}"
deadline = time.time() + 60
while True:
    with urllib.request.urlopen(url + "/api/ingestion/status") as r:
        status = json.load(r)
    if status["status"] == "done" or time.time() > deadline:
        break
    time.sleep(0.05)
req = urllib.request.Request(
    url + "/api/query/hybrid", method="POST",
    data=json.dumps({"query": "how do I submit slurm jobs", "k": 2}).encode())
with urllib.request.urlopen(req) as r:
    hits = json.load(r)
app.shutdown()
ctx.scheduler.stop()
ctx.vectorstore._batcher.close()
print(json.dumps({"status": status, "hits": hits,
                  "modules": sorted(sys.modules)}))
"""


def test_service_runs_where_jax_and_the_optional_packages_are_absent(
        tmp_path):
    """The card's machine, simulated: in a fresh interpreter where importing
    JAX, the JAX package, requests, PyYAML, psycopg2, bs4, pypdf or
    cryptography raises, the port's data-manager service ingests a
    directory and answers ``/api/query/hybrid`` over HTTP."""
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run(
        [sys.executable, "-c", SERVICE_WITHOUT_JAX, str(tmp_path),
         ",".join(ABSENT)], cwd=ROOT, env=env, capture_output=True,
        text=True, timeout=180)
    assert out.returncode == 0, out.stderr[-3000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got["status"]["status"] == "done"
    assert got["status"]["added"] == 3 and got["status"]["failed"] == 0
    assert "sbatch" in got["hits"][0]["page_content"]
    assert not [m for m in got["modules"] if m.split(".")[0] in ABSENT]


CHAT_WITHOUT_JAX = """
import importlib.abc, json, logging, os, sys, time, urllib.error
import urllib.request

ABSENT = set(sys.argv[2].split(","))


class Absent(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ABSENT:
            raise ImportError(f"no module named {name!r} on this machine")
        return None


sys.meta_path.insert(0, Absent())


class Records(logging.Handler):
    def __init__(self):
        super().__init__(logging.WARNING)
        self.messages = []

    def emit(self, record):
        self.messages.append(record.getMessage())


records = Records()
logging.getLogger("archi_tpu_torch.bin.bootstrap").addHandler(records)

from archi_tpu_torch.bin.service_chat import build_app as build_chat
from archi_tpu_torch.bin.service_data_manager import build_app as build_dm


def call(url, path, body=None):
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(url + path, data=data,
                                 headers={"X-User-Email": "u@example.org"})
    try:
        with urllib.request.urlopen(req) as r:
            return r.status, json.load(r)
    except urllib.error.HTTPError as e:
        return e.code, json.load(e)


tmp = sys.argv[1]
os.makedirs(os.path.join(tmp, "corpus"))
for i, text in enumerate(("slurm array jobs are submitted with sbatch",
                          "eos storage quotas are set per user",
                          "the mailing list archive is searchable")):
    with open(os.path.join(tmp, "corpus", f"doc{i}.md"), "w") as f:
        f.write(text)
dm = {"embedding_name": "hash", "data_path": os.path.join(tmp, "data"),
      "db_path": os.path.join(tmp, "catalog.db"),
      "sources": {"local_files": {"paths": [os.path.join(tmp, "corpus")]}},
      "serving": {"micro_batch": {"enabled": True}}}
app, ctx = build_dm(overrides={"data_manager": dm}, device="cpu")
url = f"http://127.0.0.1:{app.serve('127.0.0.1', 0, background=True)}"
warnings = [len(records.messages)]
deadline = time.time() + 60
while call(url, "/api/ingestion/status")[1]["status"] != "done" \\
        and time.time() < deadline:
    time.sleep(0.05)
# one config for both services: the chat's own data path, the
# data-manager's URL, micro-batching on
chat_app, chat_ctx = build_chat(overrides={
    "data_manager": dict(dm, data_path=os.path.join(tmp, "chat")),
    "services": {"chat": {"engine_url": url}}}, remote_engine=True)
warnings.append(len(records.messages))
chat = f"http://127.0.0.1:{chat_app.serve('127.0.0.1', 0, background=True)}"
answer = call(chat, "/api/get_chat_response",
              {"message": "how do I submit slurm jobs"})
byok = call(chat, "/api/user/api_key",
            {"provider": "openai", "api_key": "sk-x"})
status = call(chat, "/api/dm/status")
chat_app.shutdown()
app.shutdown()
ctx.scheduler.stop()
ctx.vectorstore._batcher.close()
print(json.dumps({"answer": answer, "byok": byok, "status": status,
                  "store": type(chat_ctx.vectorstore).__name__,
                  "byok_store": repr(chat_ctx.byok_store),
                  "warnings": warnings, "messages": records.messages,
                  "modules": sorted(sys.modules)}))
"""


def test_chat_answers_where_jax_and_the_optional_packages_are_absent(
        tmp_path):
    """The card's machine, simulated for the chat service, and without
    ``cryptography``: the port's data-manager ingests a directory, and the
    port's chat in remote mode (one config for both, micro-batching on)
    answers ``/api/get_chat_response`` over ``urllib`` with sources; each
    context logs one warning that names ``cryptography``, and the BYOK
    route answers 501."""
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run(
        [sys.executable, "-c", CHAT_WITHOUT_JAX, str(tmp_path),
         ",".join(ABSENT)], cwd=ROOT, env=env, capture_output=True,
        text=True, timeout=180)
    assert out.returncode == 0, out.stderr[-3000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    code, answer = got["answer"]
    assert code == 200 and answer["answer"].startswith("ECHO:")
    assert answer["sources"][0]["display_name"] == "doc0.md"
    assert answer["metadata"]["condensed_output"] == \
        "how do I submit slurm jobs"
    assert got["store"] == "RemoteVectorStore" and got["byok_store"] == "None"
    assert got["byok"] == [501, {"error": "BYOK not configured"}]
    assert got["status"][0] == 200 and got["status"][1]["status"] == "done"
    assert got["warnings"] == [1, 2]
    assert all("cryptography" in m for m in got["messages"])
    assert not [m for m in got["modules"] if m.split(".")[0] in ABSENT]


ENTRY_POINTS_WITHOUT_JAX = """
import importlib, importlib.abc, json, sys

ABSENT = set(sys.argv[2].split(","))


class Absent(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ABSENT:
            raise ImportError(f"no module named {name!r} on this machine")
        return None


sys.meta_path.insert(0, Absent())
for name in sys.argv[3].split(","):
    importlib.import_module("archi_tpu_torch." + name)

from click.testing import CliRunner

from archi_tpu_torch.bin.bootstrap import build_context
from archi_tpu_torch.bin.service_grader import build_app
from archi_tpu_torch.cli.cli_main import cli
from archi_tpu_torch.web.framework import Request

tmp = sys.argv[1]
ctx = build_context(overrides={"data_manager": {
    "embedding_name": "hash", "data_path": tmp + "/data",
    "db_path": tmp + "/catalog.db"}}, device="cpu")
ctx.vectorstore.add_texts(["the integral of x is x squared over two",
                           "storage quotas are set per user"])
app, _ = build_app(ctx=ctx)
r = app.router.dispatch(Request("POST", "/api/grade", {}, {}, json.dumps({
    "submission": "the integral of x", "rubric": "calculus"}).encode()))
grade = [r.status, json.loads(r.body)]
ctx.scheduler.stop()
ev = CliRunner().invoke(cli, ["evaluate", "--fixture", "--device", "cpu",
                              "-o", tmp + "/out"])
print(json.dumps({"grade": grade, "evaluate": [ev.exit_code, ev.output],
                  "modules": sorted(sys.modules)}))
"""


def test_grading_and_evaluate_run_without_jax(
        tmp_path):
    """In a fresh interpreter where JAX, the JAX package, requests,
    psycopg2, selenium and cryptography cannot be imported, every new
    module imports, the grader grades a submission over the port's store,
    and ``evaluate --fixture --device cpu`` reports its totals."""
    absent = ("jax", "jaxlib", "archi_tpu", "ml_dtypes", "requests",
              "psycopg2", "selenium", "cryptography")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run(
        [sys.executable, "-c", ENTRY_POINTS_WITHOUT_JAX, str(tmp_path),
         ",".join(absent), ",".join(NEW_MODULES)], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=180)
    assert out.returncode == 0, out.stderr[-3000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    code, grade = got["grade"]
    assert code == 200 and grade["status"] == "pending"
    assert grade["grade"].startswith("ECHO:")
    ev_code, ev_out = got["evaluate"]
    assert ev_code == 0, ev_out
    totals = json.loads(ev_out[:ev_out.rindex("}") + 1])
    assert totals["n_questions"] == 80 and totals["recall_at_k"] >= 0.99
    assert not [m for m in got["modules"] if m.split(".")[0] in absent]


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_default_device_is_cuda_and_raises_without_it(no_cuda):
    from archi_tpu_torch.engine.bm25 import BM25Index
    from archi_tpu_torch.engine.flat_index import FlatIndex
    from archi_tpu_torch.engine.vectorstore import TorchVectorStore
    from archi_tpu_torch.models.bert import BertConfig
    from archi_tpu_torch.models.embedder import TorchEmbedder
    from archi_tpu_torch.utils.hardware import default_device, on_cuda

    assert not on_cuda()
    cfg = BertConfig(vocab_size=128, hidden_size=16, num_layers=1,
                     num_heads=2, intermediate_size=32,
                     max_position_embeddings=64)

    class Emb:
        dim = 16

    from archi_tpu_torch.engine.ann_index import AnnFlatIndex
    from archi_tpu_torch.engine.ivf_index import IVFIndex
    from archi_tpu_torch.engine.ivfpq_index import IVFPQIndex
    from archi_tpu_torch.engine.distributed import data_mesh
    from archi_tpu_torch.engine.kmeans import kmeans
    from archi_tpu_torch.engine.pq import PQCodec
    from archi_tpu_torch.engine.sharded_index import ShardedFlatIndex
    from archi_tpu_torch.engine.sharded_ivf import ShardedIVFIndex
    from archi_tpu_torch.engine.sharded_ivfpq import ShardedIVFPQIndex
    from archi_tpu_torch.engine.sharded_xl import ShardedXlPQIndex

    from archi_tpu_torch.benchmarking.ivf_sweep import (
        run_sweep, synthetic_corpus_device)
    from archi_tpu_torch.benchmarking.pq_sweep import run_pq_sweep
    from archi_tpu_torch.benchmarking.synth_corpus import make_block_fn
    from archi_tpu_torch.benchmarking.timing import measure_relay_rtt
    from scripts import torch_bench_shard_scaling as scaling
    from scripts import torch_bench_streaming_ingest as cfg5
    from scripts import torch_fill_host_store as fill
    from scripts import torch_run_config3 as cfg3
    from scripts import torch_run_config4 as cfg4
    from scripts import torch_run_config4_sharded as cfg4s
    from scripts import (torch_ann_builder, torch_bench_attention_refold,
                         torch_bench_encoder, torch_bench_ingest,
                         torch_bench_serving, torch_bench_serving_http,
                         torch_diag_cfg4_misses, torch_exp_encoder,
                         torch_run_quality)

    x = np.eye(4, 16, dtype=np.float32)
    for make in (measure_relay_rtt, lambda: synthetic_corpus_device(64, 8),
                 lambda: make_block_fn(0, 1, block_rows=64),
                 lambda: run_sweep(64, 8, nlist=2),
                 lambda: run_pq_sweep(64, 8, m=2, nlist=2),
                 lambda: cfg3.run(rows=64), lambda: cfg5.phase_vector(0.1),
                 lambda: cfg5.phase_hybrid(0.1),
                 lambda: fill.fill(blocks=1, block_rows=64),
                 lambda: cfg4.run(rows=64, block_rows=64),
                 lambda: cfg4s.run(shards=1, block_rows=64),
                 lambda: scaling.measure(rows=64),
                 lambda: torch_bench_serving.measure(rows=64),
                 lambda: torch_bench_serving_http.measure(n_chunks=4),
                 lambda: torch_bench_ingest.measure(4, 2),
                 lambda: torch_bench_encoder.measure(1, 8, 1),
                 lambda: torch_run_quality.run(None, encoder="hash"),
                 lambda: torch_exp_encoder.run(hash_only=True,
                                               log_path=None),
                 lambda: torch_ann_builder.run("no_such_export"),
                 lambda: torch_diag_cfg4_misses.measure(None, rows=64,
                                                        block_rows=64),
                 lambda: torch_bench_attention_refold.measure(2, 8),
                 default_device, lambda: FlatIndex(16), BM25Index,
                 lambda: TorchEmbedder(config=cfg),
                 lambda: TorchVectorStore(Emb()),
                 lambda: AnnFlatIndex(16, snapshot_kind="ivfpq"),
                 lambda: kmeans(x, 2), lambda: PQCodec(np.zeros((2, 4, 8))),
                 lambda: IVFIndex.build(x, None, nlist=2),
                 lambda: IVFPQIndex.build(x, nlist=2, m=2, ksub=4),
                 data_mesh, lambda: ShardedFlatIndex(16),
                 lambda: ShardedXlPQIndex(16),
                 lambda: ShardedIVFIndex.build(x, None, nlist=2),
                 lambda: ShardedIVFPQIndex.build(x, nlist=2, m=2, ksub=4)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make()
    assert default_device("cpu") == torch.device("cpu")
    assert TorchVectorStore(Emb(), device="cpu").index.emb.device.type == "cpu"
    assert TorchEmbedder(config=cfg, device="cpu").compute_dtype == torch.float32


def test_wrappers_raise_on_devices_they_do_not_serve():
    """Plain versions only for CPU tensors: anything else launches the
    kernel or raises (here: tensors on the meta device)."""
    from archi_tpu_torch.ops.attention import encoder_attention
    from archi_tpu_torch.ops.topk import fused_topk

    m = torch.device("meta")
    with pytest.raises(ValueError, match="unsupported device"):
        fused_topk(torch.empty(2, 8, device=m), torch.empty(64, 8, device=m),
                   torch.empty(64, device=m), 64, k=3)
    q = torch.empty(1, 4, 2, 8, device=m)
    with pytest.raises(ValueError, match="unsupported device"):
        encoder_attention(q, q, q, torch.empty(1, 4, device=m), sm_scale=1.0)
    from archi_tpu_torch.ops.adc import adc_scores, adc_scores_lut16

    luts = torch.empty(4, 2, 16, device=m)
    with pytest.raises(ValueError, match="unsupported device"):
        adc_scores(luts, torch.empty(4, 9, dtype=torch.uint8, device=m))
    with pytest.raises(ValueError, match="unsupported device"):
        adc_scores_lut16(luts, torch.empty(2, 9, dtype=torch.uint8, device=m))


def test_cpu_wrappers_count_no_launches():
    from archi_tpu_torch.ops import LAUNCHES, ROUTE_LAUNCHES
    from archi_tpu_torch.ops.attention import encoder_attention
    from archi_tpu_torch.ops.topk import fused_topk

    before, routes_before = dict(LAUNCHES), dict(ROUTE_LAUNCHES)
    rng = np.random.default_rng(0)
    e = torch.from_numpy(rng.standard_normal((64, 8)).astype(np.float32))
    fused_topk(e[:2], e, torch.zeros(64), 64, k=3)
    q = torch.from_numpy(rng.standard_normal((1, 4, 2, 8)).astype(np.float32))
    encoder_attention(q, q, q, torch.zeros(1, 4), sm_scale=0.5)
    from archi_tpu_torch.ops.adc import (adc_scores, adc_scores_lut16,
                                         pack_nibbles)

    luts = torch.from_numpy(rng.standard_normal((4, 2, 16)).astype(np.float32))
    codes = torch.from_numpy(rng.integers(0, 16, (4, 33)).astype(np.uint8))
    assert adc_scores(luts, codes).shape == (2, 33)
    assert adc_scores_lut16(luts, pack_nibbles(codes.t()).t()).shape == (2, 33)
    from archi_tpu_torch.ops.bm25 import bm25_scatter

    work = torch.tensor([[0, 0, 3, 0]], dtype=torch.int32)
    work[:, 3] = torch.tensor([1.5]).view(torch.int32)
    scores, hit = bm25_scatter(torch.arange(4, dtype=torch.int32),
                               torch.ones(4), torch.ones(4), work, 1.0,
                               n_pad=8, n_rows=2, k1=1.2, b=0.75)
    assert scores.shape == (2, 8) and hit.tolist() == [True, False]
    assert set(LAUNCHES) == {"fused_topk", "encoder_attention", "adc_scores",
                             "adc_scores_lut16", "bm25_scatter"}
    assert LAUNCHES == before and ROUTE_LAUNCHES == routes_before


def test_build_finds_sources_and_needs_nvcc(monkeypatch, tmp_path):
    from archi_tpu_torch.ops import _build

    assert _build.sources() == ["adc", "bm25_scatter", "encoder_attention",
                                "fused_topk"]
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path))
    assert _build._stale("fused_topk")           # nothing built yet
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build(["fused_topk"])

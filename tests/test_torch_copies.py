"""Drift guard for the modules the port copies from the JAX package.

The port imports nothing of ``archi_tpu`` (``tests/test_torch_guard.py``),
so the two services' framework-free modules live in the port as copies.  Each copy must stay the JAX package's source with the import prefix
renamed (``archi_tpu.`` → ``archi_tpu_torch.``) and one line added to its
docstring that names the original.  The modules over the store are copies
too, with the store's class renamed as well; only their docstrings are
their own.  A change to either side fails here until the other follows.
"""

import ast
import difflib
import pathlib

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]

#: what the port renames in a copied module
RENAMES = (("archi_tpu.", "archi_tpu_torch."),
           ("TpuVectorStore", "TorchVectorStore"))


def _jax_source(rel: str) -> str:
    """The JAX package's module as the port would copy it."""
    text = (ROOT / "archi_tpu" / rel).read_text()
    for old, new in RENAMES:
        text = text.replace(old, new)
    return text


def _after_docstring(text: str) -> str:
    """A module's source after its module docstring and the blank lines
    that follow it (all of it for a module without one)."""
    body = ast.parse(text).body
    if body and isinstance(body[0], ast.Expr) \
            and isinstance(body[0].value, ast.Constant):
        text = "".join(text.splitlines(keepends=True)[body[0].end_lineno:])
    return text.lstrip("\n")


def _changed_lines(rel: str) -> list[str]:
    """The lines, after the docstrings, in which the port's module differs
    from the JAX package's as the port would copy it (``difflib.ndiff``)."""
    got = _after_docstring((ROOT / "archi_tpu_torch" / rel).read_text())
    want = _after_docstring(_jax_source(rel))
    return [line for line in difflib.ndiff(want.splitlines(),
                                           got.splitlines())
            if line[:2] in ("- ", "+ ")]


COPIES = (
    "config/defaults.py", "config/manager.py", "config/service.py",
    "utils/app_db.py", "utils/logging_utils.py", "utils/documents.py",
    "utils/stemmer.py",
    "data/catalog.py", "data/chunking.py", "data/loaders.py",
    "data/persistence.py", "data/resource.py", "data/scheduler.py",
    "data/collectors/local_files.py", "data/collectors/scraper.py",
    "data/collectors/git_scraper.py", "data/collectors/tickets.py",
    "data/collectors/anonymizer.py",
    "pipelines/agents/tools/base.py",
    "pipelines/agents/tools/catalog_tools.py",
    "web/framework.py", "web/data_app.py",
    # the chat service
    "utils/messages.py", "utils/timing.py", "utils/sessions.py",
    "utils/rbac/audit.py", "utils/rbac/jwt_parser.py",
    "utils/rbac/permissions.py", "utils/user_service.py",
    "utils/conversation_service.py", "utils/trace_service.py",
    "utils/prompt_service.py",
    "providers/chat_model.py", "providers/base.py", "providers/providers.py",
    "providers/registry.py", "providers/byok.py",
    "orchestrator/output.py", "orchestrator/archi.py",
    "pipelines/prompts.py", "pipelines/token_limiter.py", "pipelines/qa.py",
    "pipelines/grading.py", "pipelines/image_processing.py",
    "pipelines/agents/agent_spec.py", "pipelines/agents/run_memory.py",
    "pipelines/agents/tools/retriever.py", "pipelines/agents/tools/monit.py",
    "pipelines/agents/base_react.py", "pipelines/agents/comp_ops.py",
    "pipelines/agents/toolbox.py", "pipelines/agents/skills.py",
    "pipelines/agents/mcp.py", "pipelines/agents/mcp_server.py",
    "web/chat_wrapper.py", "web/frontend.py",
    # the Postgres backends
    "utils/connection_pool.py", "data/catalog_postgres.py",
    "utils/app_db_postgres.py",
    # the other services' modules
    "utils/grader_service.py", "web/grader_ui.py", "web/grader_app.py",
    "web/bots.py", "web/redmine_mailer.py", "data/collectors/sso.py",
    "web/js_lint.py",
    # evaluation and the CLI
    "benchmarking/fixture.py", "benchmarking/llm_judge.py",
    "cli/registry.py", "cli/managers.py", "cli/deployment.py", "version.py",
)

#: copies over the port's store: the code after the docstring is the JAX
#: package's, renamed; the docstring names the original and speaks of the
#: card, not of the TPU
STORE_COPIES = ("data/manager.py", "data/data_manager.py",
                "retrievers/__init__.py", "retrievers/base.py",
                "retrievers/hybrid.py", "retrievers/semantic.py",
                "retrievers/grading.py",
                "orchestrator/vectorstore_connector.py")

#: counterparts that differ from the JAX package's module, and why
DEPARTURES = {
    "data/data_viewer.py": "names the index dtype as the JAX package does "
                           "('bfloat16', not 'torch.bfloat16'); otherwise a "
                           "store copy (test_data_viewer_departs_by_the_"
                           "dtype_name_only)",
    "bin/service_data_manager.py": "builds the port's context (device=, "
                                   "devices=) and logs a checkpoint that "
                                   "was not written",
    "bin/bootstrap.py": "builds the services' context on the port's store "
                        "(device=, devices=); BYOK is None without "
                        "cryptography; micro-batching passes a "
                        "RemoteVectorStore by (a Postgres app_db opens "
                        "through the copy's open_app_database, "
                        "test_bootstrap_opens_the_app_db_through_the_copy)",
    "bin/service_grader.py": "build_app takes device=, devices= "
                             "(test_departure_diff)",
    "bin/service_create_account.py": "main takes device= "
                                     "(test_departure_diff)",
    "bin/service_mattermost.py": "build_bot (device=, devices=, the "
                                 "transports) returns the bot; main only "
                                 "polls (test_departure_diff)",
    "bin/service_piazza.py": "build_bot (device=, devices=, the "
                             "transports) returns the bot; main only polls "
                             "(test_departure_diff)",
    "bin/service_mailbox.py": "build_mailer (device=, devices=, the "
                              "transports) returns the mailer; main only "
                              "polls (test_departure_diff)",
    "bin/service_redmine.py": "build_processor (device=, devices=, the "
                              "transports) returns the processor; main "
                              "only polls (test_departure_diff)",
    "bin/service_benchmark.py": "run_benchmark (device=, devices=) returns "
                                "the report; main prints its totals "
                                "(test_departure_diff)",
    "benchmarking/harness.py": "RETRIEVAL reads the port's FlatIndex "
                               "tensors (test_departure_diff)",
    "benchmarking/beir.py": "evaluate_beir takes device= "
                            "(test_departure_diff)",
    "cli/cli_main.py": "evaluate takes --device and runs "
                       "cli/evaluate.py::run_evaluate, the JAX command's "
                       "body with device= (test_departure_diff, "
                       "test_run_evaluate_is_the_jax_commands_body)",
    "bin/service_chat.py": "builds the port's context (device=, devices=) "
                           "and imports its modules at load",
    "engine/remote_vectorstore.py": "posts with urllib, not requests "
                                    "(urllib.error.HTTPError on an error "
                                    "status)",
    "pipelines/base.py": "reranks over the port's local embedder (one with "
                         "a model, not params) (test_pipeline_base_departs_"
                         "by_the_rerank_condition_only)",
    "web/chat_app.py": "proxies the data-manager over urllib; /api/v2/info "
                       "names the port (test_chat_app_departs_by_the_proxy_"
                       "and_the_info_only)",
    "utils/hardware.py": "resolves CUDA devices (the JAX module's on_tpu)",
    "utils/metrics.py": "adds use_registry (METRICS forwards to the "
                        "registry in use)",
}


@pytest.mark.parametrize("rel", COPIES)
def test_copy_equals_the_jax_module(rel):
    want = _jax_source(rel)
    got = (ROOT / "archi_tpu_torch" / rel).read_text()
    note = f"Copy of ``archi_tpu/{rel}``.\n\n"
    if not want.startswith('"""'):  # a module without a docstring gets one
        note = f'"""Copy of ``archi_tpu/{rel}``."""\n\n'
    assert got.count(note) == 1, f"{rel}: the docstring does not name it"
    assert got.replace(note, "", 1) == want, \
        f"archi_tpu_torch/{rel} drifted from archi_tpu/{rel}"


@pytest.mark.parametrize("rel", sorted(DEPARTURES))
def test_departures_are_not_copies(rel):
    """A module listed as departing must really differ, so that a module
    brought back in line moves to ``COPIES`` and is guarded again."""
    assert (ROOT / "archi_tpu_torch" / rel).read_text() != _jax_source(rel)


@pytest.mark.parametrize("rel", STORE_COPIES)
def test_store_copy_equals_the_jax_module(rel):
    got = (ROOT / "archi_tpu_torch" / rel).read_text()
    assert f"Counterpart of ``archi_tpu/{rel}``" in ast.get_docstring(
        ast.parse(got)), f"{rel}: the docstring does not name it"
    assert _after_docstring(got) == _after_docstring(_jax_source(rel)), \
        f"archi_tpu_torch/{rel} drifted from archi_tpu/{rel}"


def test_data_viewer_departs_by_the_dtype_name_only():
    assert _changed_lines("data/data_viewer.py") == [
        '+             # the dtype\'s name as the JAX package reports it '
        '("bfloat16",',
        '+             # not "torch.bfloat16")',
        '-             "index_dtype": str(self.vectorstore.index.dtype),',
        '+             "index_dtype": str(self.vectorstore.index.dtype)'
        '.removeprefix(',
        '+                 "torch."),',
    ]


def test_pipeline_base_departs_by_the_rerank_condition_only():
    assert _changed_lines("pipelines/base.py") == [
        '-             if embedder is not None and hasattr(embedder, '
        '"params"):',
        '+             if embedder is not None and hasattr(embedder, '
        '"model"):',
    ]


def test_chat_app_departs_by_the_proxy_and_the_info_only():
    assert _changed_lines("web/chat_app.py") == [
        '-         import requests as _rq',
        '+         import urllib.error',
        '+         import urllib.request',
        '+         data = None',
        '+         if json_body is not None:',
        '+             data = json.dumps(json_body).encode()',
        '+             headers["Content-Type"] = "application/json"',
        '-         r = _rq.request(method, data_manager_url.rstrip("/") + path,',
        '+         rq = urllib.request.Request(data_manager_url.rstrip("/") + '
        'path,',
        '-                         json=json_body, headers=headers, '
        'timeout=300)',
        '+                                     data=data, headers=headers, '
        'method=method)',
        '+         try:',
        '+             with urllib.request.urlopen(rq, timeout=300) as r:',
        '-         return json_response(r.json(), r.status_code)',
        '+                 return json_response(json.loads(r.read()), '
        'r.status)',
        '+         except urllib.error.HTTPError as e:',
        '+             return json_response(json.loads(e.read()), e.code)',
        '-         import archi_tpu',
        '+         import archi_tpu_torch',
        '-         return {"name": "archi-tpu",',
        '+         return {"name": "archi-tpu-torch",',
        '-                 "version": getattr(archi_tpu, "__version__", '
        '"0.1"),',
        '+                 "version": getattr(archi_tpu_torch, "__version__", '
        '"0.1"),',
        '-                 "engine": "jax/pallas TPU retrieval engine"}',
        '+                 "engine": "PyTorch/CUDA retrieval engine"}',
    ]


def test_every_module_with_a_jax_namesake_is_listed():
    """Each port module of the service layers is a guarded copy or a listed
    departure (the engine, models, ops and native layers are ports held by
    their parity tests)."""
    layers = ("config", "data", "pipelines", "web", "utils", "bin",
              "orchestrator", "retrievers", "providers", "cli",
              "benchmarking")
    port = ROOT / "archi_tpu_torch"
    unlisted = []
    for path in sorted(port.rglob("*.py")):
        rel = str(path.relative_to(port))
        if rel.split("/")[0] not in layers or path.name == "__init__.py":
            continue
        if (ROOT / "archi_tpu" / rel).exists() and rel not in COPIES \
                and rel not in STORE_COPIES and rel not in DEPARTURES:
            unlisted.append(rel)
    assert not unlisted


_BUILD_CONTEXT = [
    '+     ctx = ctx or build_context(config_paths, overrides, device=device,',
    '+                                devices=devices)',
]
_MAIN_ONLY_POLLS = ['+ ', '+ ', '+ def main() -> None:']

#: the departures of the modules over the other entry points, line by line
#: (``_changed_lines``: the JAX module's lines first, "- ", then the port's)
DEPARTURE_DIFFS = {
    "benchmarking/harness.py": [
        '-         import jax.numpy as jnp',
        '+         import torch',
        '-         emb = np.asarray(idx.emb[:n].astype(jnp.float32))',
        '+         emb = idx.emb[:n].float().cpu().numpy()',
        '-         if idx.dtype == jnp.int8:',
        '+         if idx.dtype == torch.int8:',
        '-         alive = np.asarray(idx.alive[:n]) > 0.5',
        '+         alive = idx.alive[:n].cpu().numpy() > 0.5',
    ],
    "benchmarking/beir.py": [
        '-                   store=None) -> dict:',
        '+                   store=None, device=None) -> dict:',
        '-     pretrained weights in this image); pass a '
        '`JaxEmbedder(model_dir=...)`',
        '+     pretrained weights in this image); pass a '
        '`TorchEmbedder(model_dir=...)`',
        '+     device: where the store it builds lives (the card unless '
        '"cpu").',
        '-         store = TorchVectorStore(embedder or HashedNgramEmbedder())',
        '+         store = TorchVectorStore(embedder or HashedNgramEmbedder(),',
        '+                                  device=device)',
    ],
    "bin/service_grader.py": [
        '- def build_app(config_paths=(), overrides=None, ctx=None):',
        '+ def build_app(config_paths=(), overrides=None, ctx=None, *, '
        'device=None,',
        '+               devices=None):',
        '-     ctx = ctx or build_context(config_paths, overrides)',
        *_BUILD_CONTEXT,
    ],
    "bin/service_create_account.py": [
        '- def main(argv=None) -> None:',
        '+ def main(argv=None, *, device=None) -> None:',
        '-     ctx = build_context(args.configs)',
        '+     ctx = build_context(args.configs, device=device)',
    ],
    "bin/service_mattermost.py": [
        '- def main() -> None:',
        '-     ctx = build_context(sys.argv[1:])',
        '+ def build_bot(config_paths=(), overrides=None, ctx=None, *, '
        'device=None,',
        '+               devices=None, **transport):',
        '+     """→ (bot, ctx).  ``transport``: ``MattermostBot``\'s '
        '``fetch_fn`` and',
        '+     ``post_fn`` (default: the Mattermost API over ``requests``)."""',
        *_BUILD_CONTEXT,
        '+         **transport,',
        '+     return bot, ctx',
        *_MAIN_ONLY_POLLS,
        '+     bot, _ctx = build_bot(sys.argv[1:])',
    ],
    "bin/service_piazza.py": [
        '- def main() -> None:',
        '-     ctx = build_context(sys.argv[1:])',
        '+ def build_bot(config_paths=(), overrides=None, ctx=None, *, '
        'device=None,',
        '+               devices=None, **transport):',
        '+     """→ (bot, ctx).  ``transport``: ``PiazzaBot``\'s ``fetch_fn`` '
        'and',
        "+     ``post_fn`` (default: Piazza's API and the Slack webhook over",
        '+     ``requests``)."""',
        *_BUILD_CONTEXT,
        '+         **transport,',
        '+     return bot, ctx',
        *_MAIN_ONLY_POLLS,
        '+     bot, _ctx = build_bot(sys.argv[1:])',
    ],
    "bin/service_mailbox.py": [
        '- def main() -> None:',
        '-     ctx = build_context(sys.argv[1:])',
        '+ def build_mailer(config_paths=(), overrides=None, ctx=None, *, '
        'device=None,',
        '+                  devices=None, **transport):',
        '+     """→ (mailer, ctx).  ``transport``: any of ``RedmineMailer``\'s',
        '+     arguments (``mailbox``, ``sender``, ``redmine_client``,',
        '+     ``agent_archi``, ``project_id``) in place of the ones made from '
        'the',
        '+     environment."""',
        *_BUILD_CONTEXT,
        '-     mailer = RedmineMailer(',
        '+     kw = dict(',
        '+     kw.update(transport)',
        '+     return RedmineMailer(**kw), ctx',
        *_MAIN_ONLY_POLLS,
        '+     mailer, _ctx = build_mailer(sys.argv[1:])',
    ],
    "bin/service_redmine.py": [
        '- def main() -> None:',
        '-     ctx = build_context(sys.argv[1:])',
        '+ def build_processor(config_paths=(), overrides=None, ctx=None, *,',
        '+                     device=None, devices=None, **transport):',
        '+     """→ (processor, ctx).  ``transport``: any of',
        "+     ``RedmineIssueProcessor``'s arguments (``list_issues``,",
        '+     ``redmine_client``, ``agent_archi``, ``sender``, '
        '``project_id``) in',
        '+     place of the ones made from the environment."""',
        *_BUILD_CONTEXT,
        '-     proc = RedmineIssueProcessor(',
        '+     kw = dict(',
        '+     kw.update(transport)',
        '+     return RedmineIssueProcessor(**kw), ctx',
        *_MAIN_ONLY_POLLS,
        '+     proc, _ctx = build_processor(sys.argv[1:])',
    ],
    "bin/service_benchmark.py": [
        '- from archi_tpu_torch.benchmarking.harness import Benchmarker, '
        'wait_for_ingestion',
        '+ from archi_tpu_torch.benchmarking.harness import (',
        '+     Benchmarker, wait_for_ingestion,',
        '+ )',
        '+ def run_benchmark(queries, config_paths=(), overrides=None, '
        'ctx=None, *,',
        '+                   device=None, devices=None):',
        '+     """→ (report, ctx): ingest, wait for the ingestion, run the',
        '+     ``Benchmarker`` over ``queries``."""',
        *_BUILD_CONTEXT,
        '- def main() -> None:',
        '-     config_paths = [a for a in sys.argv[1:] if a.endswith(('
        '".yaml", ".yml"))]',
        '-     query_files = [a for a in sys.argv[1:] if a.endswith(".json")]',
        '-     if not query_files:',
        '-         print("usage: service_benchmark [config.yaml] '
        'queries.json")',
        '-         sys.exit(2)',
        '-     with open(query_files[0]) as f:',
        '-         queries = json.load(f)',
        '- ',
        '-     ctx = build_context(config_paths)',
        '-     report = bench.run()',
        '+     return bench.run(), ctx',
        *_MAIN_ONLY_POLLS,
        '+     config_paths = [a for a in sys.argv[1:] if a.endswith(('
        '".yaml", ".yml"))]',
        '+     query_files = [a for a in sys.argv[1:] if a.endswith(".json")]',
        '+     if not query_files:',
        '+         print("usage: service_benchmark [config.yaml] '
        'queries.json")',
        '+         sys.exit(2)',
        '+     with open(query_files[0]) as f:',
        '+         queries = json.load(f)',
        '+ ',
        '+     report, _ctx = run_benchmark(queries, config_paths)',
    ],
}


def _jax_evaluate_body() -> list[str]:
    """The JAX ``evaluate`` command's body after its docstring, renamed."""
    src = _jax_source("cli/cli_main.py")
    fn = next(n for n in ast.walk(ast.parse(src))
              if isinstance(n, ast.FunctionDef) and n.name == "evaluate")
    return src.splitlines()[fn.body[1].lineno - 1:fn.end_lineno]


#: the port's command: --device, and run_evaluate in place of the JAX
#: command's body
DEPARTURE_DIFFS["cli/cli_main.py"] = [
    '-     """archi-tpu: TPU-native RAG framework."""',
    '+     """archi-tpu-torch: the RAG framework on PyTorch and CUDA."""',
    '+ @click.option("--device", default="cuda",',
    '+               help="where the store is built: cuda (the card) or cpu")',
    '-              judge, out):',
    '+              judge, out, device):',
    '+     from archi_tpu_torch.cli.evaluate import run_evaluate',
    '-     from archi_tpu_torch.benchmarking.harness import Benchmarker',
    '-     from archi_tpu_torch.orchestrator.archi import Archi',
    '+     if not (beir or fixture or queries):',
    '+         raise click.UsageError("--queries required without --fixture")',
    '+     result = run_evaluate(configs=configs, queries=queries,'
    ' fixture=fixture,',
    '+                           beir=beir, retriever_mode=retriever_mode,',
    '+                           mode=mode, judge=judge, out=out,'
    ' device=device)',
    '-         from archi_tpu_torch.benchmarking.beir import evaluate_beir',
    '- ',
    '-         embedder = None',
    '-         if configs:',
    '-             from archi_tpu_torch.config.manager import'
    ' ConfigurationManager',
    '-             from archi_tpu_torch.models.registry import'
    ' resolve_embedder',
    '- ',
    '-             cm = ConfigurationManager(list(configs))',
    '-             embedder = resolve_embedder(cm.config["data_manager"])',
    '-         result = evaluate_beir(beir, embedder=embedder,',
    '-                                mode=retriever_mode)',
    '- ',
    '-     judge_model = None',
    '-     if judge:',
    '-         from archi_tpu_torch.providers.registry import get_model',
    '- ',
    '-         judge_model = get_model(judge)',
    '- ',
    '-     if fixture:',
    '-         from archi_tpu_torch.benchmarking.fixture import'
    ' fixture_corpus',
    '-         from archi_tpu_torch.data.chunking import character_split',
    '-         from archi_tpu_torch.engine.vectorstore import'
    ' TorchVectorStore',
    '-         from archi_tpu_torch.models.hashed_embedder import'
    ' HashedNgramEmbedder',
    '- ',
    '-         docs, qs = fixture_corpus()',
    '-         store = TorchVectorStore(HashedNgramEmbedder())',
    '-         texts, metas, ids = [], [], []',
    '-         for dname, text, meta in docs:',
    '-             for i, chunk in enumerate(character_split(text)):',
    '-                 texts.append(chunk)',
    '-                 metas.append(dict(meta))',
    '-                 ids.append(f"{dname}:{i}")',
    '-         store.add_texts(texts, metas, ids=ids)',
    '-         archi = Archi("QAPipeline", vectorstore=store)',
    '-         vectorstore = store',
    '-     else:',
    '-         if not queries:',
    '-             raise click.UsageError("--queries required without'
    ' --fixture")',
    '-         from archi_tpu_torch.bin.bootstrap import build_context',
    '- ',
    '-         with open(queries) as f:',
    '-             qs = json.load(f)',
    '-         ctx = build_context(list(configs))',
    '-         ctx.data_manager.run_ingestion()',
    '-         archi = Archi(ctx.config.get("active_pipeline", "QAPipeline"),',
    '-                       config=ctx.config, vectorstore=ctx.vectorstore)',
    '-         vectorstore = ctx.vectorstore',
    '-     bench = Benchmarker(archi, qs, modes=tuple(mode), out_dir=out,',
    '-                         vectorstore=vectorstore,'
    ' judge_model=judge_model)',
    '-     report = bench.run()',
    '-     click.echo(json.dumps(report["totals"], indent=2))',
    '+     click.echo(json.dumps(result["totals"], indent=2))',
]


@pytest.mark.parametrize("rel", sorted(DEPARTURE_DIFFS))
def test_departure_diff(rel):
    assert _changed_lines(rel) == DEPARTURE_DIFFS[rel]


def test_run_evaluate_is_the_jax_commands_body():
    """``cli/evaluate.py::run_evaluate`` is the JAX ``evaluate`` command's
    body with ``device=`` passed on, a ``ValueError`` for Click's usage
    error, and the results returned rather than echoed."""
    src = (ROOT / "archi_tpu_torch" / "cli" / "evaluate.py").read_text()
    fn = next(n for n in ast.walk(ast.parse(src))
              if isinstance(n, ast.FunctionDef) and n.name == "run_evaluate")
    got = src.splitlines()[fn.body[1].lineno - 1:fn.end_lineno]
    assert [line for line in difflib.ndiff(_jax_evaluate_body(), got)
            if line[:2] in ("- ", "+ ")] == [
        '-             embedder = resolve_embedder(cm.config["data_manager"])',
        '+             embedder = resolve_embedder(cm.config["data_manager"],',
        '+                                         device=device)',
        '-         result = evaluate_beir(beir, embedder=embedder,',
        '+         return evaluate_beir(beir, embedder=embedder, '
        'mode=retriever_mode,',
        '-                                mode=retriever_mode)',
        '+                              device=device)',
        '-         click.echo(json.dumps(result, indent=2))',
        '-         return',
        '-         from archi_tpu_torch.models.hashed_embedder import '
        'HashedNgramEmbedder',
        '+         from archi_tpu_torch.models.hashed_embedder import (',
        '+             HashedNgramEmbedder,',
        '+         )',
        '-         store = TorchVectorStore(HashedNgramEmbedder())',
        '+         store = TorchVectorStore(HashedNgramEmbedder(), '
        'device=device)',
        '-             raise click.UsageError("--queries required without '
        '--fixture")',
        '+             raise ValueError("--queries required without '
        '--fixture")',
        '-         ctx = build_context(list(configs))',
        '+         ctx = build_context(list(configs), device=device)',
        '-     report = bench.run()',
        '+     return bench.run()',
        '-     click.echo(json.dumps(report["totals"], indent=2))',
        '-     click.echo(f"full report: {out}/results.json, '
        '{out}/results.html")',
    ]


def test_bootstrap_opens_the_app_db_through_the_copy():
    """The port's ``build_context`` opens ``app_db`` with the copied
    dispatch, as the JAX package's does (``tests/test_torch_postgres.py``
    opens a Postgres DSN through it)."""
    from archi_tpu_torch.bin import bootstrap
    from archi_tpu_torch.utils import app_db_postgres

    assert bootstrap.open_app_database is app_db_postgres.open_app_database


def test_grafana_dashboard_is_the_jax_packages():
    """``cli/managers.py`` stages the dashboard beside its package."""
    name = "assets/grafana_dashboard.json"
    assert (ROOT / "archi_tpu_torch" / name).read_bytes() == \
        (ROOT / "archi_tpu" / name).read_bytes()

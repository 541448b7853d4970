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
                        "(device=, devices=); a Postgres app_db raises; "
                        "BYOK is None without cryptography; micro-batching "
                        "passes a RemoteVectorStore by",
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
              "orchestrator", "retrievers", "providers")
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

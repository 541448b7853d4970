"""The port's data-manager service on the CPU, held against the JAX
package's.

``archi_tpu_torch.bin.service_data_manager.build_app(..., device="cpu")``
ingests a local directory (the initial ingestion: ingest, checkpoint, warm
up, the status held at ``"warming"``) and serves on localhost; the JAX
package's ``build_app`` serves the same corpus with the same embedder.  For
flat, hot_tail, ivf, ivfpq_xl and sharded (four CPU shards,
``devices=["cpu"] * 4``) every data route that reads answers with the JAX
service's JSON body: hybrid and semantic queries (scores within 1e-4,
tie-aware), count, stats, catalog search, document and grep, sources and
schedules; uploads, resyncs and deletes leave both equal.  Also: the JAX
package's ``RemoteVectorStore`` (which imports no JAX) against the port's
service (the counterpart of ``tests/integration/test_remote_vectorstore.py``),
``/metrics`` with the port's counters and no ``use_registry``, a restart
that restores the checkpoint with a zero diff, the ``DATA_MANAGER_TOKEN``
gate, the error paths, the status hold, the source-management routes of
``tests/unit/test_data_app_sources.py`` (a Postgres ``app_db``:
``tests/test_torch_postgres.py``).
"""

import base64
import json
import re
import threading
import time
from unittest.mock import patch

import jax
import pytest
import requests

from archi_tpu.bin.service_data_manager import build_app as build_jax_app
from archi_tpu.engine.remote_vectorstore import RemoteVectorStore
from archi_tpu.retrievers import HybridRetriever
from archi_tpu_torch.bin.bootstrap import build_context
from archi_tpu_torch.bin.service_data_manager import build_app
from archi_tpu_torch.data.resource import Resource, ResourceMetadata
from archi_tpu_torch.web.framework import Request
from tests.test_torch_data_layer import jax_cache_in_tmp  # noqa: F401
from tests.test_torch_data_layer import same_ranking
from tests.test_torch_service import INDEX_CONFIGS, INDEX_TYPES, SHARDS

KINDS = ("flat", "hot_tail", "ivf", "ivfpq_xl", "sharded")
QUERIES = ("batch schedulers", "storage quotas", "topic3 cluster",
           "document 7", "zzz unmatched words")
#: fields that carry the clock or the data directory of one service
VOLATILE = {"created_at", "updated_at", "collected_at", "file_path",
            "finished_at", "elapsed_s"}


def _config(tmp, sub, kind, corpus, *, batched=False):
    return {"data_manager": {
        "embedding_name": "hash",
        "data_path": str(tmp / sub / "data"),
        "db_path": str(tmp / sub / "catalog.db"),
        "index": dict(INDEX_CONFIGS[kind]),
        "sources": {"local_files": {"paths": [str(corpus)]}},
        "serving": {"micro_batch": {"enabled": batched, "max_wait_ms": 15}}}}


def _write_corpus(corpus):
    corpus.mkdir()
    for i in range(24):
        (corpus / f"doc{i}.md").write_text(
            f"document {i} about "
            f"{'batch schedulers' if i % 2 else 'storage quotas'} "
            f"cluster topic{i % 6} " * 8)


def _wait_done(url, timeout=300):
    deadline = time.time() + timeout
    while True:
        status = requests.get(url + "/api/ingestion/status", timeout=30).json()
        if status["status"] in ("done", "failed") or time.time() > deadline:
            return status
        time.sleep(0.05)


def _serve(app):
    return f"http://127.0.0.1:{app.serve('127.0.0.1', 0, background=True)}"


def _port_app(overrides, kind, **kw):
    devices = SHARDS if kind == "sharded" else None
    return build_app(overrides=overrides, device="cpu", devices=devices, **kw)


@pytest.fixture(scope="module", params=KINDS)
def services(request, tmp_path_factory):
    """(kind, port ctx, port url, JAX url): the two services over one
    corpus, each after its initial ingestion."""
    kind = request.param
    tmp = tmp_path_factory.mktemp(f"data_svc_{kind}")
    _write_corpus(tmp / "corpus")
    port_app, ctx = _port_app(
        _config(tmp, "port", kind, tmp / "corpus", batched=True), kind)
    jax_app, jax_ctx = build_jax_app(
        overrides=_config(tmp, "jax", kind, tmp / "corpus"))
    port_url, jax_url = _serve(port_app), _serve(jax_app)
    try:
        for url in (port_url, jax_url):
            status = _wait_done(url)
            assert status["status"] == "done", status
            assert status["added"] == 24 and status["failed"] == 0
        assert type(ctx.vectorstore.index).__name__ == INDEX_TYPES[kind]
        assert ctx.vectorstore._batcher is not None
        yield kind, ctx, port_url, jax_url
    finally:
        for app, c in ((port_app, ctx), (jax_app, jax_ctx)):
            app.shutdown()
            c.scheduler.stop()
        ctx.vectorstore._batcher.close()


def _strip(body):
    """The body without the fields that name a clock or a directory."""
    if isinstance(body, dict):
        return {k: _strip(v) for k, v in body.items() if k not in VOLATILE}
    if isinstance(body, (list, tuple)):
        return [_strip(v) for v in body]
    return body


def _get(url, path, **params):
    r = requests.get(url + path, params=params, timeout=30)
    return r.status_code, r.json()


def _post(url, path, body):
    r = requests.post(url + path, json=body, timeout=60)
    return r.status_code, r.json()


def _assert_same_hits(got, want):
    """Query bodies: the same ranking (scores 1e-4, tie-aware) and, for
    every chunk in both, the same text and metadata."""
    def ranked(hits):
        return [(h["metadata"]["chunk_id"], h["score"]) for h in hits]

    same_ranking(ranked(got), ranked(want))
    by_id = {h["metadata"]["chunk_id"]: _strip(h) for h in want}
    for h in got:
        w = by_id.get(h["metadata"]["chunk_id"])
        if w is not None:
            assert _strip(h)["page_content"] == w["page_content"]
            assert _strip(h)["metadata"] == w["metadata"]


def _assert_same_reads(port_url, jax_url, hashes):
    for route in ("/api/query/hybrid", "/api/query/semantic"):
        for q in QUERIES:
            got = _post(port_url, route, {"query": q, "k": 5})
            want = _post(jax_url, route, {"query": q, "k": 5})
            assert got[0] == want[0] == 200, (route, q)
            assert got[1], (route, q)
            _assert_same_hits(got[1], want[1])
    for path, params in (("/api/query/count", {}), ("/api/stats", {}),
                         ("/api/sources", {}), ("/api/schedules", {}),
                         ("/api/catalog/schema", {}), ("/healthz", {})):
        assert _strip(_get(port_url, path, **params)) == \
            _strip(_get(jax_url, path, **params)), path
    for params in ({"q": "doc1"}, {"q": "md", "limit": "30"}):
        code, got = _get(port_url, "/api/catalog/search", **params)
        want = _get(jax_url, "/api/catalog/search", **params)
        assert code == want[0] == 200 and got
        key = lambda d: d["resource_hash"]  # noqa: E731
        assert sorted(_strip(got), key=key) == sorted(_strip(want[1]), key=key)
    for pattern in ("topic3", "document 1[0-9] about"):
        code, got = _get(port_url, "/api/catalog/grep", pattern=pattern)
        want = _get(jax_url, "/api/catalog/grep", pattern=pattern)
        assert code == want[0] == 200 and got
        key = lambda d: (d["resource_hash"], d["snippet"])  # noqa: E731
        assert sorted(got, key=key) == sorted(want[1], key=key)
    for h in hashes:
        got = _get(port_url, f"/api/catalog/document/{h}")
        assert got[0] == 200 and got[1]["content"]
        assert _strip(got) == _strip(_get(jax_url,
                                          f"/api/catalog/document/{h}"))


def test_jax_cache_stays_in_the_runs_tmp(services, jax_cache_in_tmp):
    """The JAX service's ``build_context`` pointed JAX's compilation cache
    at the module's temporary directory, not at the shared default."""
    assert jax.config.jax_compilation_cache_dir == jax_cache_in_tmp


def test_health(services):
    _kind, _ctx, port_url, _jax_url = services
    assert _get(port_url, "/healthz") == (
        200, {"status": "ok", "service": "data_manager"})


def test_reads_equal_the_jax_service(services):
    _kind, ctx, port_url, jax_url = services
    assert _get(port_url, "/api/query/count")[1]["count"] == \
        ctx.vectorstore.count() == 24
    hashes = sorted(ctx.catalog.all_hashes())[:3]
    _assert_same_reads(port_url, jax_url, hashes)


def _upload(url, name, text):
    code, body = _post(url, "/api/upload", {
        "filename": name, "sync": False,
        "content_b64": base64.b64encode(text.encode()).decode()})
    assert code == 200
    return body["resource_hash"]


def test_upload_resync_and_delete_keep_the_services_equal(services):
    """Counterparts of ``test_data_api_status_upload_catalog`` and
    ``test_data_api_delete_resyncs``: the same writes to both services, and
    every read equal after each."""
    _kind, ctx, port_url, jax_url = services
    text = "The GPU partition requires special approval. " * 5
    h = _upload(port_url, "notes.txt", text)
    assert _upload(jax_url, "notes.txt", text) == h
    got = _post(port_url, "/api/ingestion/trigger", {})
    want = _post(jax_url, "/api/ingestion/trigger", {})
    assert got[0] == 200 and got[1]["added"] == 1
    assert _strip(got) == _strip(want)
    hits = _get(port_url, "/api/catalog/search", q="notes")[1]
    assert hits and hits[0]["display_name"] == "notes.txt"
    hybrid = _post(port_url, "/api/query/hybrid",
                   {"query": "gpu partition approval", "k": 3})[1]
    assert hybrid[0]["metadata"]["resource_hash"] == h
    _assert_same_reads(port_url, jax_url, [h])

    for url in (port_url, jax_url):
        r = requests.delete(url + f"/api/documents/{h}", timeout=30)
        assert r.json() == {"deleted": True}
        # the delete route resyncs in the background; a trigger waits for
        # the ingestion lock and finds nothing left to remove
        _post(url, "/api/ingestion/trigger", {})
    deadline = time.time() + 60
    while h in {cid.rsplit(":", 1)[0] for cid in ctx.vectorstore.ids()}:
        assert time.time() < deadline, "the deleted document stayed"
        time.sleep(0.05)
    assert _get(port_url, "/api/query/count")[1]["count"] == 24
    hybrid = _post(port_url, "/api/query/hybrid",
                   {"query": "gpu partition approval", "k": 24})[1]
    assert all(x["metadata"]["resource_hash"] != h for x in hybrid)
    _assert_same_reads(port_url, jax_url, [])


def test_remote_vectorstore_against_the_port(services):
    """The JAX package's ``RemoteVectorStore`` pointed at the port's service
    gets what the port's store gives in-process."""
    _kind, ctx, port_url, _jax_url = services
    remote = RemoteVectorStore(port_url)
    store = ctx.vectorstore
    assert remote.count() == store.count()
    for q in QUERIES:
        local = store.hybrid_search(q, k=4)
        over_http = remote.hybrid_search(q, k=4)
        assert [(d.page_content, round(s, 4)) for d, s in over_http] == \
            [(d.page_content, round(s, 4)) for d, s in local]
        sem = remote.similarity_search_with_score(q, k=2)
        assert [d.page_content for d, _ in sem] == \
            [d.page_content for d, _ in store.similarity_search_with_score(
                q, k=2)]
    results = HybridRetriever(remote, k=2).invoke("storage quotas cluster")
    assert "storage quotas" in results[0][0].page_content
    doc1 = next(d["resource_hash"] for d in ctx.catalog.list_documents()
                if d["display_name"] == "doc1.md")
    res = remote.hybrid_search("batch schedulers", k=5, enabled_ids={doc1})
    assert res and all(d.metadata["display_name"] == "doc1.md"
                       for d, _ in res)
    with pytest.raises(NotImplementedError):
        remote.add_texts(["nope"])


def _scrape(url) -> dict:
    r = requests.get(url + "/metrics", timeout=30)
    r.raise_for_status()
    return {m.group(1): float(m.group(2)) for m in (
        re.match(r"^(\S+) (\S+)$", line) for line in r.text.splitlines())
        if m}


def test_metrics_show_the_port_counters(services):
    """The port's app renders the port's registry: no ``use_registry``."""
    _kind, ctx, port_url, _jax_url = services
    before = _scrape(port_url)
    threads = [threading.Thread(target=_post, args=(
        port_url, "/api/query/hybrid", {"query": q, "k": 3}))
        for q in QUERIES * 3]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    after = _scrape(port_url)
    rose = {k: after.get(k, 0.0) - before.get(k, 0.0) for k in (
        'archi_engine_queries_total{kind="hybrid"}',
        "archi_micro_batches_total_total",
        "archi_micro_batched_requests_total_total")}
    assert rose['archi_engine_queries_total{kind="hybrid"}'] >= len(threads)
    assert rose["archi_micro_batched_requests_total_total"] >= len(threads)
    assert rose["archi_micro_batches_total_total"] > 0
    assert after["archi_index_chunks"] == ctx.vectorstore.count()
    assert after["archi_catalog_documents"] == ctx.catalog.stats()["total"]
    assert after.get("archi_ingest_chunks_total", 0) >= 24


def test_error_paths_equal_the_jax_service(services):
    """The data routes' errors (counterpart of ``test_error_paths``)."""
    _kind, _ctx, port_url, jax_url = services
    for method, path, body in (
            ("GET", "/api/nope", None),
            ("GET", "/api/upload", None),
            ("POST", "/api/upload", {"filename": "x.txt"}),
            ("POST", "/api/query/hybrid", {"k": 3}),
            ("GET", "/api/catalog/document/" + "0" * 64, None),
            ("GET", "/api/data/document/" + "0" * 64, None)):
        got = requests.request(method, port_url + path, json=body, timeout=30)
        want = requests.request(method, jax_url + path, json=body, timeout=30)
        assert got.status_code == want.status_code >= 400, (method, path)
        assert got.json() == want.json(), (method, path)


def test_status_hold_gates_readiness(services):
    _kind, ctx, _port_url, _jax_url = services
    dm = ctx.data_manager
    assert dm.status["status"] == "done"
    dm.hold_status("warming")
    try:
        assert dm.status["status"] == "warming"
        dm._status = "embedding"          # transitional: not masked
        assert dm.status["status"] == "embedding"
        dm._status = "done"
    finally:
        dm.release_status()
    assert dm.status["status"] == "done"


# ------------------------------------------------------------- restart
@pytest.mark.parametrize("kind", ["flat", "hot_tail", "ivf", "sharded"])
def test_restart_restores_the_checkpoint_with_a_zero_diff(kind, tmp_path):
    """The initial ingestion checkpoints the store; a second service on the
    same data path restores it, syncs nothing and answers alike.  (An
    ``ivfpq_xl`` restart builds afresh, as in the JAX package:
    ``test_torch_bootstrap.py::test_xl_restart_builds_afresh_in_port``.)"""
    _write_corpus(tmp_path / "corpus")
    overrides = _config(tmp_path, "svc", kind, tmp_path / "corpus")
    answers = []
    for run in range(2):
        app, ctx = _port_app(overrides, kind)
        url = _serve(app)
        try:
            status = _wait_done(url)
            assert status["status"] == "done", status
            assert (status["added"], status["removed"]) == \
                ((24, 0) if run == 0 else (0, 0))
            assert (tmp_path / "svc" / "data" / "engine_checkpoint").is_dir()
            answers.append([_post(url, "/api/query/hybrid",
                                  {"query": q, "k": 5})[1] for q in QUERIES])
        finally:
            app.shutdown()
            ctx.scheduler.stop()
    for got, want in zip(*answers):
        _assert_same_hits(got, want)


# ----------------------------------------------- a port app, no socket
@pytest.fixture
def app_ctx(tmp_path, monkeypatch):
    monkeypatch.delenv("DATA_MANAGER_TOKEN", raising=False)
    overrides = {"data_manager": {
        "data_path": str(tmp_path / "data"),
        "db_path": str(tmp_path / "catalog.db"),
        "embedding_name": "hash", "embedding_kwargs": {"dim": 32},
        "index": {"dtype": "float32", "tile_n": 256}}}
    app, ctx = build_app(overrides=overrides, initial_ingestion=False,
                         device="cpu")
    yield app, ctx
    ctx.scheduler.stop()


def _request(method, path, headers=None, body=b""):
    return Request(method, path, {}, headers or {}, body)


def test_token_gate(app_ctx, monkeypatch):
    _app, ctx = app_ctx
    monkeypatch.setenv("DATA_MANAGER_TOKEN", "s3cret")
    app, _ = build_app(ctx=ctx, initial_ingestion=False)
    url = _serve(app)
    try:
        assert requests.get(url + "/api/query/count",
                            timeout=30).status_code == 401
        wrong = {"X-Data-Token": "wrong"}
        assert requests.get(url + "/api/query/count", timeout=30,
                            headers=wrong).status_code == 401
        r = requests.get(url + "/api/query/count", timeout=30,
                         headers={"X-Data-Token": "s3cret"})
        assert r.status_code == 200 and r.json() == {"count": 0}
        assert requests.get(url + "/healthz", timeout=30).status_code == 200
    finally:
        app.shutdown()


def _seed_git_docs(ctx, repo="https://git.x/lab/docs"):
    hashes = []
    for i in range(3):
        meta = ResourceMetadata(
            display_name=f"doc{i}.md", source_type="git",
            url=f"{repo}/blob/main/doc{i}.md", extension=".md")
        hashes.append(ctx.data_manager.persistence.persist_resource(
            Resource(f"{repo} git doc number {i} about quota", meta)))
    return hashes


def test_remove_git_repo(app_ctx):
    app, ctx = app_ctx
    _seed_git_docs(ctx)
    _seed_git_docs(ctx, repo="https://git.x/other/repo")
    r = app.router.dispatch(_request(
        "DELETE", "/api/git",
        body=json.dumps({"url": "https://git.x/lab/docs"}).encode()))
    assert r.status == 200 and json.loads(r.body)["removed"] == 3
    left = [d for d in ctx.catalog.list_documents()
            if d.get("source_type") == "git"]
    assert len(left) == 3
    assert all(d["url"].startswith("https://git.x/other") for d in left)


def test_refresh_git_calls_collector(app_ctx):
    app, ctx = app_ctx
    with patch.object(ctx.data_manager.git, "collect",
                      return_value=["h1", "h2"]) as collect:
        r = app.router.dispatch(_request(
            "POST", "/api/git/refresh",
            body=b'{"url": "https://git.x/lab/docs", "branch": "main"}'))
    assert r.status == 200 and json.loads(r.body)["collected"] == 2
    collect.assert_called_once_with("https://git.x/lab/docs", branch="main")


def test_add_jira_project(app_ctx):
    app, ctx = app_ctx
    with patch.object(ctx.data_manager.tickets, "collect_jira",
                      return_value=["j1"]) as collect:
        r = app.router.dispatch(_request(
            "POST", "/api/jira",
            body=json.dumps({"url": "https://jira.x", "project": "OPS",
                             "sync": False}).encode()))
    assert r.status == 200 and json.loads(r.body)["collected"] == 1
    assert collect.call_args.args[0].base_url == "https://jira.x"
    assert collect.call_args.args[1] == "OPS"


def test_sources_listing(app_ctx):
    app, ctx = app_ctx
    _seed_git_docs(ctx)
    r = app.router.dispatch(_request("GET", "/api/sources"))
    data = json.loads(r.body)
    assert data["collected_counts"].get("git") == 3
    assert data["git_repos"] == ["https://git.x/lab/docs"]
    assert "configured" in data


def test_build_context_takes_a_store_and_micro_batches_it(tmp_path):
    """A caller's store is the context's, with the config's
    ``serving.micro_batch`` applied to it, as the JAX package does."""
    from archi_tpu_torch.bin.bootstrap import build_vectorstore

    dm = {"embedding_name": "hash", "data_path": str(tmp_path / "data"),
          "db_path": str(tmp_path / "catalog.db")}
    store = build_vectorstore(dm, device="cpu")
    assert store._batcher is None
    dm["serving"] = {"micro_batch": {"enabled": True, "max_batch": 8}}
    ctx = build_context(overrides={"data_manager": dm}, vectorstore=store)
    try:
        assert ctx.vectorstore is store is ctx.data_manager.vectorstore
        assert store._batcher is not None and store._batcher.max_batch == 8
    finally:
        store._batcher.close()


def test_a_checkpoint_that_fails_is_logged(tmp_path, monkeypatch, caplog):
    """The initial ingestion serves on when the checkpoint cannot be
    written, and says so in the log (the JAX package passes silently)."""
    from archi_tpu_torch.engine.vectorstore import TorchVectorStore

    def refuse(self, directory):
        raise OSError("disk full")

    monkeypatch.setattr(TorchVectorStore, "save", refuse)
    _write_corpus(tmp_path / "corpus")
    with caplog.at_level("ERROR",
                         logger="archi_tpu_torch.bin.service_data_manager"):
        app, ctx = _port_app(
            _config(tmp_path, "svc", "flat", tmp_path / "corpus"), "flat")
        url = _serve(app)
        try:
            assert _wait_done(url)["added"] == 24
            assert _get(url, "/api/query/count")[1]["count"] == 24
        finally:
            app.shutdown()
            ctx.scheduler.stop()
    assert any("engine checkpoint" in r.getMessage() for r in caplog.records)
    assert not (tmp_path / "svc" / "data" / "engine_checkpoint").exists()

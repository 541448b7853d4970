"""Data-manager service: uploads, sources, ingestion control, catalog API.

Copy of ``archi_tpu/web/data_app.py``.

Mirrors the reference's uploader/data-manager HTTP surface
(``src/interfaces/uploader_app/app.py:30``; endpoints ``:88-108``,
``api_catalog_search:449``; ingestion status + schedules from
``src/bin/service_data_manager.py:159-228``): upload/delete files, URL
scrape, git repo add/refresh, schedule updates, catalog
search/document/schema/grep (consumed by the agent's RemoteCatalogClient),
ingestion status/trigger/retry, and stats.
"""

from __future__ import annotations

import base64
import threading

from archi_tpu_torch.web.framework import App, Request, error_response


def create_data_app(
    *,
    data_manager,
    scheduler=None,
    catalog_client=None,
    config_service=None,
    auth_token=None,
) -> App:
    app = App("data_manager")
    dm = data_manager

    if auth_token:
        # Shared-secret gate for non-loopback deployments: the chat app
        # forwards the token on its /api/dm/* proxy; direct callers must
        # present it too (the per-user RBAC lives on the chat app).
        import hmac

        def token_middleware(req: Request):
            if req.path == "/healthz":
                return None
            supplied = req.headers.get("x-data-token", "")
            if not hmac.compare_digest(supplied, auth_token):
                return error_response("data token required", 401)
            return None

        app.use(token_middleware)

    def _run_ingestion_async():
        threading.Thread(
            target=dm.index_manager.update_vectorstore, daemon=True
        ).start()

    # -------------------------------------------------------------- ingestion
    @app.get("/api/ingestion/status")
    def status(req: Request):
        return dm.status

    @app.post("/api/ingestion/trigger")
    def trigger(req: Request):
        body = req.json()
        reset = bool(body.get("reset"))
        if body.get("async"):
            threading.Thread(
                target=lambda: dm.run_ingestion(reset=reset), daemon=True
            ).start()
            return {"started": True}
        return dm.run_ingestion(reset=reset)

    @app.post("/api/ingestion/retry")
    def retry(req: Request):
        body = req.json()
        return dm.index_manager.retry_failed(body.get("resource_hash"))

    @app.get("/api/ingestion/failed")
    def failed(req: Request):
        return dm.catalog.get_failed()

    # ---------------------------------------------------------------- uploads
    @app.post("/api/upload")
    def upload(req: Request):
        """Body: {"filename": ..., "content_b64": ...} (the reference uses
        multipart; base64-JSON keeps the stdlib server simple)."""
        body = req.json()
        if "filename" not in body or "content_b64" not in body:
            raise ValueError("need filename and content_b64")
        content = base64.b64decode(body["content_b64"])
        h = dm.local_files.ingest_uploaded_file(body["filename"], content)
        if body.get("sync", True):
            _run_ingestion_async()
        return {"resource_hash": h}

    @app.delete("/api/documents/<resource_hash>")
    def delete_doc(req: Request):
        ok = dm.persistence.delete_resource(req.path_params["resource_hash"])
        _run_ingestion_async()
        return {"deleted": ok}

    # ---------------------------------------------------------------- sources
    @app.post("/api/links")
    def add_link(req: Request):
        body = req.json()
        hashes = dm.scrapers.collect_url(
            body["url"], depth=body.get("depth"))
        if body.get("sync", True):
            _run_ingestion_async()
        return {"collected": len(hashes), "hashes": hashes[:50]}

    @app.post("/api/git")
    def add_git(req: Request):
        body = req.json()
        hashes = dm.git.collect(body["url"], branch=body.get("branch"))
        if body.get("sync", True):
            _run_ingestion_async()
        return {"collected": len(hashes)}

    def _git_docs(url: str) -> list[dict]:
        return [d for d in dm.catalog.list_documents()
                if d.get("source_type") == "git"
                and (d.get("url") or "").startswith(url.rstrip("/"))]

    @app.delete("/api/git")
    def remove_git(req: Request):
        """Remove all documents collected from a repo (reference
        remove_git_repo, uploader_app/app.py:98)."""
        url = req.json().get("url", "")
        if not url:
            raise ValueError("missing 'url'")
        removed = 0
        for d in _git_docs(url):
            if dm.persistence.delete_resource(d["resource_hash"]):
                removed += 1
        if removed:
            _run_ingestion_async()
        return {"removed": removed}

    @app.post("/api/git/refresh")
    def refresh_git(req: Request):
        """Re-clone + re-collect a repo; diff-sync drops stale chunks
        (reference refresh_git, uploader_app/app.py:100)."""
        body = req.json()
        hashes = dm.git.collect(body["url"], branch=body.get("branch"))
        _run_ingestion_async()
        return {"collected": len(hashes)}

    @app.post("/api/jira")
    def add_jira(req: Request):
        """Ingest a Jira project (reference add_jira_project,
        uploader_app/app.py:99)."""
        from archi_tpu_torch.data.collectors.tickets import JiraClient

        body = req.json()
        client = JiraClient(body["url"], token=body.get("token"))
        hashes = dm.tickets.collect_jira(client, body["project"])
        if body.get("sync", True):
            _run_ingestion_async()
        return {"collected": len(hashes)}

    @app.get("/api/sources")
    def list_sources(req: Request):
        """Configured + collected sources (reference /api/sources/*,
        app.py:2248-2250)."""
        by_type: dict[str, int] = {}
        git_urls: set[str] = set()
        for d in dm.catalog.list_documents():
            st = d.get("source_type") or "unknown"
            by_type[st] = by_type.get(st, 0) + 1
            if st == "git" and d.get("url"):
                git_urls.add(d["url"].split("/blob/")[0])
        return {
            "configured": dm.sources_config,
            "collected_counts": by_type,
            "git_repos": sorted(git_urls)[:100],
        }

    # -------------------------------------------------------------- schedules
    @app.get("/api/schedules")
    def get_schedules(req: Request):
        if scheduler is None:
            return {}
        return {"jobs": scheduler.jobs()}

    @app.put("/api/schedules")
    def update_schedules(req: Request):
        if config_service is None:
            return error_response("config service not configured", 501)
        changes = {f"data_manager.schedules.{k}": v
                   for k, v in req.json().items()}
        config_service.update_dynamic(changes, changed_by="data-api")
        if scheduler is not None:
            scheduler._reload_config()
        return {"ok": True}

    # ---------------------------------------------------------------- catalog
    @app.get("/api/catalog/search")
    def catalog_search(req: Request):
        q = req.param("q", "")
        return dm.catalog.search_documents(q, limit=int(req.param("limit", "50")))

    @app.get("/api/catalog/grouped")
    def catalog_grouped(req: Request):
        return dm.catalog.list_documents_grouped()

    @app.get("/api/catalog/document/<resource_hash>")
    def catalog_document(req: Request):
        h = req.path_params["resource_hash"]
        doc = dm.catalog.get_document(h)
        if doc is None:
            return error_response("not found", 404)
        doc["content"] = dm.persistence.read_content(h)
        return doc

    @app.get("/api/catalog/schema")
    def catalog_schema(req: Request):
        if catalog_client is not None:
            return catalog_client.schema()
        return {}

    @app.get("/api/catalog/grep")
    def catalog_grep(req: Request):
        if catalog_client is None:
            return []
        pattern = req.param("pattern", "")
        return catalog_client.grep(pattern)

    # ------------------------------------------------------------ query API
    # The engine's serving surface: other processes (chat/grader/bots) query
    # the TPU index owned by this process via RemoteVectorStore.
    @app.post("/api/query/hybrid")
    def query_hybrid(req: Request):
        body = req.json()
        enabled = set(body["enabled_ids"]) if body.get("enabled_ids") else None
        results = dm.vectorstore.hybrid_search(
            body["query"], k=int(body.get("k", 5)),
            semantic_weight=float(body.get("semantic_weight", 0.7)),
            bm25_weight=float(body.get("bm25_weight", 0.3)),
            filter=body.get("filter"),
            enabled_ids=enabled,
        )
        return [{"page_content": d.page_content, "metadata": d.metadata,
                 "score": s} for d, s in results]

    @app.post("/api/query/semantic")
    def query_semantic(req: Request):
        body = req.json()
        enabled = set(body["enabled_ids"]) if body.get("enabled_ids") else None
        results = dm.vectorstore.similarity_search_with_score(
            body["query"], k=int(body.get("k", 5)),
            filter=body.get("filter"), enabled_ids=enabled,
        )
        return [{"page_content": d.page_content, "metadata": d.metadata,
                 "score": s} for d, s in results]

    @app.get("/api/query/count")
    def query_count(req: Request):
        return {"count": dm.vectorstore.count()}

    # ------------------------------------------------------------------ stats
    @app.get("/api/stats")
    def stats(req: Request):
        return {
            **dm.catalog.stats(),
            "chunks": dm.vectorstore.count(),
            "bm25_terms": dm.vectorstore.bm25.n_terms,
        }

    # -------------------------------------------------------------- data UI
    from archi_tpu_torch.data.data_viewer import DataViewerService

    viewer = DataViewerService(dm.catalog, dm.persistence, dm.vectorstore)

    @app.get("/api/data/grouped")
    def data_grouped(req: Request):
        return viewer.grouped_documents()

    @app.get("/api/data/document/<resource_hash>")
    def data_document(req: Request):
        d = viewer.document_detail(req.path_params["resource_hash"])
        if d is None:
            return error_response("not found", 404)
        return d

    @app.get("/api/data/chunks/<resource_hash>")
    def data_chunks(req: Request):
        return viewer.document_chunks(req.path_params["resource_hash"])

    @app.get("/metrics")
    def metrics(req: Request):
        from archi_tpu_torch.utils.metrics import METRICS
        from archi_tpu_torch.web.framework import Response

        METRICS.set_gauge("archi_index_chunks", dm.vectorstore.count())
        METRICS.set_gauge("archi_catalog_documents",
                          dm.catalog.stats()["total"])
        return Response(METRICS.render(), 200, "text/plain; version=0.0.4")

    @app.get("/healthz")
    def health(req: Request):
        return {"status": "ok", "service": "data_manager"}

    return app

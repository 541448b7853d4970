"""Data-manager service entry point: start the scheduler, kick an initial
asynchronous ingestion, serve the uploader, catalog and query API.

Counterpart of ``archi_tpu/bin/service_data_manager.py`` (reference
``src/bin/service_data_manager.py:23``), over the port's ``build_context``:
the process that owns the index.  It runs on the card unless the caller
passes ``device="cpu"``::

    python -m archi_tpu_torch.bin.service_data_manager config.yaml

(a YAML config needs PyYAML; ``build_app(overrides=...)`` takes the same
settings as a dict).  ``DATA_MANAGER_TOKEN`` in the environment gates every
route but ``/healthz`` on the ``X-Data-Token`` header.
"""

from __future__ import annotations

import logging
import os
import sys
import threading

from archi_tpu_torch.bin.bootstrap import build_context
from archi_tpu_torch.pipelines.agents.tools.catalog_tools import CatalogClient
from archi_tpu_torch.web.data_app import create_data_app

_logger = logging.getLogger(__name__)


def build_app(config_paths=(), overrides=None, ctx=None,
              *, initial_ingestion: bool = True, device=None, devices=None):
    """→ (app, ctx).  ``ctx`` defaults to ``build_context(config_paths,
    overrides, device=device, devices=devices)``.  With
    ``initial_ingestion`` a background thread ingests the configured
    sources, checkpoints the store and warms the query path, with the
    reported status held at ``"warming"`` until it is done."""
    ctx = ctx or build_context(config_paths, overrides, device=device,
                               devices=devices)
    dm = ctx.data_manager
    client = CatalogClient(ctx.catalog, dm.persistence)
    app = create_data_app(
        data_manager=dm,
        scheduler=ctx.scheduler,
        catalog_client=client,
        config_service=ctx.config_service,
        auth_token=os.environ.get("DATA_MANAGER_TOKEN"),
    )
    ctx.scheduler.start()
    if initial_ingestion:
        checkpoint_dir = os.path.join(
            ctx.config["data_manager"]["data_path"], "engine_checkpoint"
        )

        def ingest_then_warm():
            # clients (the chat proxy, benchmarks, smoke) gate on
            # status == "done": hold it until the query path has run once
            # at every batch bucket, so no first request waits behind that
            dm.hold_status("warming")
            try:
                result = dm.run_ingestion()
                if result.get("added") or result.get("removed") or \
                        not os.path.isdir(checkpoint_dir):
                    # checkpoint so a restart resumes without re-embedding
                    try:
                        ctx.vectorstore.save(checkpoint_dir)
                    except Exception:
                        _logger.exception("engine checkpoint %s not written",
                                          checkpoint_dir)
                ctx.vectorstore.warmup(
                    k=ctx.config.get("data_manager", {}).get(
                        "retrievers", {}).get("hybrid_retriever", {}).get(
                        "num_documents_to_retrieve", 5))
            finally:
                dm.release_status()

        threading.Thread(target=ingest_then_warm, daemon=True,
                         name="initial-ingestion").start()
    return app, ctx


def main() -> None:
    app, ctx = build_app(sys.argv[1:])
    svc = ctx.config["services"]["data_manager"]
    print(f"data-manager service on {svc['host']}:{svc['port']}")
    app.serve(svc["host"], svc["port"])


if __name__ == "__main__":
    main()

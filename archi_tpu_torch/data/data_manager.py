"""DataManager — ingestion composition root.

Counterpart of ``archi_tpu/data/data_manager.py``, over ``TorchVectorStore``.

Mirrors the reference's ``DataManager``
(``src/data_manager/data_manager.py:16``; ``run_ingestion:60``): wire the
collectors, run them over the source config, optionally reset, then sync the
index via the IndexManager.  An ``RLock`` serializes concurrent ingestion
triggers (reference ``service_data_manager.py:38,62-69``).
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Optional

from archi_tpu_torch.data.catalog import CatalogService
from archi_tpu_torch.data.collectors.git_scraper import GitScraper
from archi_tpu_torch.data.collectors.local_files import LocalFileManager
from archi_tpu_torch.data.collectors.scraper import ScraperManager
from archi_tpu_torch.data.collectors.tickets import TicketManager
from archi_tpu_torch.data.manager import IndexManager
from archi_tpu_torch.data.persistence import PersistenceService
from archi_tpu_torch.engine.vectorstore import TorchVectorStore

logger = logging.getLogger(__name__)


class DataManager:
    def __init__(
        self,
        *,
        data_path: str,
        catalog: CatalogService,
        vectorstore: TorchVectorStore,
        sources_config: Optional[dict] = None,
        chunk_size: int = 1000,
        chunk_overlap: int = 0,
        parallel_workers: int = 32,
        anonymize_tickets: bool = False,
    ):
        self.catalog = catalog
        self.persistence = PersistenceService(data_path, catalog)
        self.vectorstore = vectorstore
        self.index_manager = IndexManager(
            catalog, self.persistence, vectorstore,
            chunk_size=chunk_size, chunk_overlap=chunk_overlap,
            parallel_workers=parallel_workers,
        )
        self.local_files = LocalFileManager(self.persistence)
        self.scrapers = ScraperManager(self.persistence)
        self.git = GitScraper(self.persistence)
        self.tickets = TicketManager(self.persistence,
                                     anonymize=anonymize_tickets)
        self.sources_config = sources_config or {}
        self._lock = threading.RLock()
        self.last_ingestion: Optional[dict] = None
        self._status = "idle"  # idle|collecting|embedding|done|failed
        # an override reported INSTEAD of a terminal status while the
        # service finishes startup work (query-path warmup compiles) —
        # clients gate readiness on status == "done"
        self._status_hold: Optional[str] = None

    def hold_status(self, label: str) -> None:
        self._status_hold = label

    def release_status(self) -> None:
        self._status_hold = None

    @property
    def status(self) -> dict:
        reported = self._status
        if self._status_hold is not None and reported in ("done", "idle"):
            reported = self._status_hold
        st = {"status": reported}
        if self.last_ingestion:
            st.update(self.last_ingestion)
        st.update(self.catalog.stats())
        return st

    def run_ingestion(self, *, reset: bool = False,
                      sources_config: Optional[dict] = None) -> dict:
        """collect all sources → diff-sync the index (reference
        run_ingestion:60-89)."""
        with self._lock:
            cfg = sources_config or self.sources_config
            t0 = time.time()
            self._status = "collecting"
            try:
                if reset:
                    self.persistence.reset()
                    # drop all chunks too
                    self.vectorstore.delete(self.vectorstore.ids())
                collected = {
                    "local_files": len(
                        self.local_files.collect_all_from_config(
                            cfg.get("local_files", {}))),
                    "links": len(self.scrapers.collect_all_from_config(
                        cfg.get("links_cfg", cfg))),
                    "git": len(self.git.collect_all_from_config(
                        cfg.get("git", {}))),
                    "tickets": len(self.tickets.collect_all_from_config(
                        cfg.get("tickets", {}))),
                }
                self._status = "embedding"
                sync = self.index_manager.update_vectorstore()
                self._status = "done"
                self.last_ingestion = {
                    "collected": collected,
                    **sync,
                    "elapsed_s": round(time.time() - t0, 3),
                    "finished_at": time.time(),
                }
                return self.last_ingestion
            except Exception:
                self._status = "failed"
                raise

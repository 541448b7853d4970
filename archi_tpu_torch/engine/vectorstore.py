"""TorchVectorStore — the archi vector-store contract over the port's engine.

Counterpart of ``archi_tpu/engine/vectorstore.py`` (``TpuVectorStore``):
``add_texts``, ``similarity_search*``, ``hybrid_search*``, ``delete``,
``count`` with the same result shapes ((Document, score) lists) and
semantics, over a device-resident ``FlatIndex`` and ``BM25Index``.

Hybrid search scores every chunk ``semantic*w_sem + bm25*w_b`` and takes
the global top-k in ONE fused scan, with the BM25 dense vector as the
kernel's additive row bias; when BM25 matches nothing the search falls back
to semantic scores.  Metadata filtering is a cached per-(key, value) row
bitmask multiplied into the alive mask.  ``enable_micro_batching`` routes
concurrent public searches through the scheduler of ``engine/batcher.py``;
the ``_*_impl`` methods are the direct paths its workers run.
"""

from __future__ import annotations

import itertools
import json
import logging
import os
import threading
from typing import Iterable, Optional, Sequence

import numpy as np
import torch

from archi_tpu_torch.engine.batcher import (hybrid_batcher, hybrid_signature,
                                            semantic_signature)
from archi_tpu_torch.engine.bm25 import BM25Index
from archi_tpu_torch.engine.flat_index import FlatIndex
from archi_tpu_torch.engine.topk import alive_to_bias, next_pow2, pad_bias_rows
from archi_tpu_torch.utils.documents import Document
from archi_tpu_torch.utils.hardware import default_device
from archi_tpu_torch.utils.metrics import METRICS
from archi_tpu_torch.utils.tracing import span

#: device-memory budget for the batched-hybrid [B, capacity] f32 bias
#: (patchable in tests)
BIAS_BUDGET_BYTES = 1 << 30

_logger = logging.getLogger(__name__)


def _to_host(t: torch.Tensor):
    """(a host copy of t, an event to wait on before reading it or None):
    from a CUDA tensor the copy goes to pinned memory behind the work
    queued so far, without waiting for it."""
    if t.device.type != "cuda":
        return t.cpu(), None
    host = t.to("cpu", non_blocking=True)
    ready = torch.cuda.Event()
    ready.record(torch.cuda.current_stream(t.device))
    return host, ready


class TorchVectorStore:
    def __init__(
        self,
        embedding_function,
        *,
        index: FlatIndex | None = None,
        bm25: BM25Index | None = None,
        dim: int | None = None,
        collection_name: str = "default",
        dtype=torch.bfloat16,
        device=None,
    ):
        self._embedding_function = embedding_function
        if device is None and index is not None:
            device = index.device
        self.device = default_device(device)
        dim = dim or getattr(embedding_function, "dim", None)
        if dim is None:
            dim = len(embedding_function.embed_query("probe"))
        self.index = index if index is not None else FlatIndex(
            dim, dtype=dtype, device=self.device)
        self.bm25 = bm25 if bm25 is not None else BM25Index(device=self.device)
        self.collection_name = collection_name
        # metadata plane: physical row -> (chunk_id, text, metadata)
        self._row_data: dict[int, tuple[str, str, dict]] = {}
        self._filter_masks: dict[tuple, np.ndarray] = {}
        self._id_counter = itertools.count()
        self._lock = threading.RLock()
        # micro-batching scheduler (enable_micro_batching), None = direct
        self._batcher = None

    # ------------------------------------------------------------------ write
    def add_texts(
        self,
        texts: Iterable[str],
        metadatas: Optional[Sequence[dict]] = None,
        ids: Optional[Sequence[str]] = None,
        embeddings=None,
    ) -> list[str]:
        """Embed + insert chunks; returns chunk ids.  Re-adding an existing
        id replaces the old row (upsert).  ``embeddings`` ([n, D] numpy or
        tensor) skips the encoder."""
        texts = list(texts)
        if not texts:
            return []
        if ids is None:
            ids = [f"{self.collection_name}:{next(self._id_counter)}"
                   for _ in texts]
        metadatas = list(metadatas) if metadatas else [{} for _ in texts]
        with self._lock:
            existing = [i for i in ids if i in self.index._id_rows]
            if existing:
                self.delete(existing)
            if embeddings is None:
                encode = getattr(self._embedding_function, "encode_numpy",
                                 None)
                if encode is not None:
                    embeddings = encode(texts)
                else:
                    embeddings = np.asarray(
                        self._embedding_function.embed_documents(texts),
                        np.float32)
            rows = self.index.add(embeddings, ids)
            self.bm25.add(rows, texts)
            for row, cid, text, meta in zip(rows, ids, texts, metadatas):
                self._row_data[row] = (cid, text, dict(meta))
            self._filter_masks.clear()
        return list(ids)

    def delete(self, ids: Optional[Sequence[str]] = None, **kw) -> bool:
        if not ids:
            return False
        with self._lock:
            rows = []
            for i in ids:
                rows.extend(self.index._id_rows.get(i, []))
            self.index.delete(ids)
            # keep BM25 df/avgdl exact: deleted rows leave the stats too
            self.bm25.remove(rows)
            for r in rows:
                self._row_data.pop(r, None)
            self._filter_masks.clear()
        return True

    def count(self) -> int:
        return len(self.index)

    # ----------------------------------------------------------------- filter
    def _filter_mask(self, metadata_filter: dict | None,
                     enabled_ids: Optional[set] = None):
        """Row bitmask for metadata filters + doc enablement.

        ``enabled_ids`` may contain chunk ids OR resource hashes: a
        resource hash enables every chunk whose metadata carries it."""
        if not metadata_filter and enabled_ids is None:
            return None
        mask = np.ones(self.index.capacity, np.float32)
        with self._lock:  # _row_data mutates under concurrent ingest
            if metadata_filter:
                key = tuple(sorted((k, str(v))
                            for k, v in metadata_filter.items()))
                cached = self._filter_masks.get(key)
                if cached is None:
                    cached = np.zeros(self.index.capacity, np.float32)
                    for row, (_cid, _t, meta) in self._row_data.items():
                        if all(str(meta.get(k)) == v for k, v in key):
                            cached[row] = 1.0
                    self._filter_masks[key] = cached
                mask = mask * cached
            if enabled_ids is not None:
                em = np.zeros(self.index.capacity, np.float32)
                for cid in enabled_ids:
                    for row in self.index._id_rows.get(cid, []):
                        em[row] = 1.0
                for row, (_cid, _t, meta) in self._row_data.items():
                    if meta.get("resource_hash") in enabled_ids:
                        em[row] = 1.0
                mask = mask * em
        return mask

    def _rows_to_results(self, rows, vals) -> list[tuple[Document, float]]:
        out = []
        for r, v in zip(rows, vals):
            if v <= -1e29:
                continue
            data = self._row_data.get(int(r))
            if data is None:
                continue
            cid, text, meta = data
            md = dict(meta)
            md.setdefault("chunk_id", cid)
            out.append((Document(page_content=text, metadata=md), float(v)))
        return out

    # ----------------------------------------------------------------- search
    def similarity_search_by_vector_with_score(
        self, embedding, k: int = 4, *, filter: dict | None = None,
        enabled_ids: Optional[set] = None,
    ) -> list[tuple[Document, float]]:
        METRICS.inc("archi_engine_queries", labels={"kind": "semantic"})
        if len(self.index) == 0:
            return []
        fm = self._filter_mask(filter, enabled_ids)
        ids, vals, rows = self.index.search(
            np.asarray(embedding, np.float32), k=k, filter_mask=fm)
        return self._rows_to_results(rows[0], vals[0])

    def similarity_search_with_score(
        self, query: str, k: int = 4, **kw
    ) -> list[tuple[Document, float]]:
        batcher = self._batcher
        if batcher is not None and len(self.index) > 0 \
                and set(kw) <= {"filter", "enabled_ids"}:
            return batcher.submit(query, semantic_signature(
                k, kw.get("filter"), kw.get("enabled_ids")))
        return self._similarity_search_impl(query, k, **kw)

    def _similarity_search_impl(self, query: str, k: int = 4, **kw):
        """Direct (unbatched) semantic search — the only form safe to call
        from INSIDE a batcher worker (the public method would re-enter the
        scheduler and deadlock at workers=1)."""
        emb = self._embedding_function.embed_query(query)
        return self.similarity_search_by_vector_with_score(emb, k, **kw)

    def _embed_queries(self, queries: Sequence[str]) -> np.ndarray:
        """Embed a batch of QUERIES: one batched ``embed_documents`` pass
        for embedders that declare ``instruction_prefix`` (they promise
        ``embed_query(q) == embed_documents([prefix + q])[0]``), else one
        ``embed_query`` per query."""
        emb = self._embedding_function
        try:
            prefix = emb.instruction_prefix
        except AttributeError:
            return np.asarray(
                [emb.embed_query(q) for q in queries], np.float32)
        q_texts = [prefix + q for q in queries] if prefix else list(queries)
        return np.asarray(emb.embed_documents(q_texts), np.float32)

    def similarity_search(self, query: str, k: int = 4, **kw) -> list[Document]:
        return [d for d, _ in self.similarity_search_with_score(query, k, **kw)]

    def similarity_search_batch(
        self, queries: Sequence[str], k: int = 4, *,
        filter: dict | None = None, enabled_ids: Optional[set] = None,
    ) -> list[list[tuple[Document, float]]]:
        """Batched semantic search: one device scan for B queries, padded
        to a power of two with zero queries whose results are dropped."""
        queries = list(queries)
        if not queries:
            return []
        METRICS.inc("archi_engine_queries", labels={"kind": "semantic"},
                    value=len(queries))
        if len(self.index) == 0:
            return [[] for _ in queries]
        with span("store.embed"):
            embs = self._embed_queries(queries)
        with span("store.filter"):
            fm = self._filter_mask(filter, enabled_ids)
        nb = len(queries)
        with span("store.scan"):
            bucket = next_pow2(nb)
            if bucket > nb:
                embs = np.concatenate(
                    [embs, np.zeros((bucket - nb, embs.shape[1]), np.float32)])
            ids, vals, rows = self.index.search(embs, k=k, filter_mask=fm)
        with span("store.results"):
            return [self._rows_to_results(rows[b], vals[b]) for b in range(nb)]

    def enable_micro_batching(self, *, max_batch: int = 32,
                              max_wait_ms: float = 4.0,
                              workers: int = 2) -> None:
        """Route concurrent ``hybrid_search`` and
        ``similarity_search_with_score`` calls through the micro-batching
        scheduler (``engine/batcher.py``): requests arriving within
        ``max_wait_ms`` of each other with compatible parameters run as ONE
        fused device pass.  Config: ``data_manager.serving.micro_batch``."""
        old = self._batcher
        if old is not None:
            old.close()   # don't leak the previous scheduler's workers
        self._batcher = hybrid_batcher(
            self, max_batch=max_batch, max_wait_s=max_wait_ms / 1e3,
            workers=workers)

    def hybrid_search(
        self,
        query: str,
        k: int = 4,
        *,
        semantic_weight: float = 0.7,
        bm25_weight: float = 0.3,
        filter: dict | None = None,
        enabled_ids: Optional[set] = None,
    ) -> list[tuple[Document, float]]:
        """Fused semantic+BM25 ranking.  With micro-batching enabled,
        concurrent calls coalesce into ``hybrid_search_batch`` (identical
        results, one device pass)."""
        batcher = self._batcher
        if batcher is not None and semantic_weight > 0.0 \
                and len(self.index) > 0:
            return batcher.submit(query, hybrid_signature(
                k, semantic_weight, bm25_weight, filter, enabled_ids))
        return self._hybrid_search_impl(
            query, k, semantic_weight=semantic_weight,
            bm25_weight=bm25_weight, filter=filter, enabled_ids=enabled_ids)

    def _hybrid_search_impl(
        self,
        query: str,
        k: int = 4,
        *,
        semantic_weight: float = 0.7,
        bm25_weight: float = 0.3,
        filter: dict | None = None,
        enabled_ids: Optional[set] = None,
    ) -> list[tuple[Document, float]]:
        """Direct (unbatched) hybrid search; safe inside a batcher worker."""
        METRICS.inc("archi_engine_queries", labels={"kind": "hybrid"})
        if len(self.index) == 0:
            return []
        if semantic_weight <= 0.0:
            # pure lexical ranking
            fm = self._filter_mask(filter, enabled_ids)
            alive = self.index.alive
            if fm is not None:
                alive = alive * pad_bias_rows(
                    torch.as_tensor(fm, device=alive.device), alive.shape[0])
            vals, rows = self.bm25.topk(
                query, self.index.capacity, k=k,
                alive_bias=alive_to_bias(alive))
            # filter masked rows BEFORE scaling: a small weight would shrink
            # the NEG_INF sentinel past the -1e29 cutoff and leak disabled
            # documents into results
            results = self._rows_to_results(rows.cpu().numpy(),
                                            vals.cpu().numpy())
            return [(d, s * bm25_weight) for d, s in results]
        bm = self.bm25.scores(query, self.index.capacity)
        if float(bm.max()) <= 0.0:
            # BM25 found nothing → pure semantic scores.  Direct impl: this
            # may run inside a batcher worker (sequential fallback), where
            # the public method would re-enter the queue.
            return self._similarity_search_impl(
                query, k, filter=filter, enabled_ids=enabled_ids)
        emb = np.asarray(self._embedding_function.embed_query(query), np.float32)
        fm = self._filter_mask(filter, enabled_ids)
        # The index L2-normalizes queries, so instead of pre-scaling the
        # query by w_sem, the bias is scaled by w_b/w_sem and the combined
        # scores are rescaled by w_sem afterwards.
        ids, vals, rows = self.index.search(
            emb, k=k, filter_mask=fm,
            bias=bm * (bm25_weight / max(semantic_weight, 1e-9)))
        # filter on UNSCALED scores (NEG_INF sentinel intact), then scale
        results = self._rows_to_results(rows[0], vals[0])
        return [(d, s * semantic_weight) for d, s in results]

    def hybrid_search_batch(
        self,
        queries: Sequence[str],
        k: int = 4,
        *,
        semantic_weight: float = 0.7,
        bm25_weight: float = 0.3,
        filter: dict | None = None,
        enabled_ids: Optional[set] = None,
    ) -> list[list[tuple[Document, float]]]:
        """Batched hybrid search: ONE fused device scan for B queries.

        Each query's BM25 dense scores become one row of a [B, N] per-query
        bias; semantics match B independent ``hybrid_search`` calls,
        including the per-query semantic fallback when BM25 matches
        nothing."""
        queries = list(queries)
        if not queries:
            return []
        if len(self.index) == 0:
            METRICS.inc("archi_engine_queries", labels={"kind": "hybrid"},
                        value=len(queries))
            return [[] for _ in queries]
        if not getattr(self.index, "supports_batched_bias", False) \
                or semantic_weight <= 0.0:
            # an index that takes no [B, N] bias, or the degenerate
            # lexical-only path: one direct call per query (each counts its
            # query; NOT hybrid_search, which would re-enter the batcher
            # from its own worker)
            return [self._hybrid_search_impl(
                q, k, semantic_weight=semantic_weight,
                bm25_weight=bm25_weight, filter=filter,
                enabled_ids=enabled_ids) for q in queries]
        cap = self.index.capacity
        # bound the [B, capacity] f32 device bias: split oversized batches;
        # each slice is still one fused scan
        max_b = max(1, int(BIAS_BUDGET_BYTES // max(cap * 4, 1)))
        if len(queries) > max_b:
            out = []
            for s0 in range(0, len(queries), max_b):
                out.extend(self.hybrid_search_batch(
                    queries[s0:s0 + max_b], k,
                    semantic_weight=semantic_weight,
                    bm25_weight=bm25_weight, filter=filter,
                    enabled_ids=enabled_ids))
            return out
        METRICS.inc("archi_engine_queries", labels={"kind": "hybrid"},
                    value=len(queries))
        nb = len(queries)
        # the batch is padded to a power of two with zero queries and zero
        # bias rows; their rows of the result are never returned
        bucket = next_pow2(nb)
        with span("store.bm25"):
            bm, hit = self.bm25.scores_batch(queries, cap, n_rows=bucket)
            # the flags come back behind the scatter: read after the scan,
            # they wait for nothing queued since
            hit, hit_ready = _to_host(hit[:nb])
        # embed as QUERIES (instruction prefixes apply to queries only)
        with span("store.embed"):
            embs = self._embed_queries(queries)
        with span("store.filter"):
            fm = self._filter_mask(filter, enabled_ids)
        with span("store.scan"):
            if bucket > nb:
                embs = np.concatenate(
                    [embs, np.zeros((bucket - nb, embs.shape[1]), np.float32)])
            ids, vals, rows = self.index.search(
                embs, k=k, filter_mask=fm,
                bias=bm * (bm25_weight / max(semantic_weight, 1e-9)))
        with span("store.results"):
            if hit_ready is not None:
                hit_ready.synchronize()
            hit = hit.numpy()
            out = []
            for b in range(nb):
                results = self._rows_to_results(rows[b], vals[b])
                if not hit[b]:
                    # semantic fallback: report UNSCALED cosine scores when
                    # the lexical side matched nothing
                    out.append(results)
                else:
                    out.append([(d, s * semantic_weight) for d, s in results])
        return out

    def warmup(self, k: int = 5) -> None:
        """Run one hybrid and one semantic query so that the kernels are
        built before the first user request.  With micro-batching enabled,
        also run every power-of-two batch bucket up to ``max_batch`` that
        the scheduler can produce."""
        if len(self.index) == 0:
            return
        try:
            if self._batcher is not None:
                mb = self._batcher.max_batch
                sizes, b = [], 1
                while b < mb:
                    sizes.append(b)
                    b *= 2
                sizes.append(mb)
                probes = [f"warmup probe query {i}" for i in range(mb)]
                for sz in sizes:
                    self.hybrid_search_batch(probes[:sz], k=k)
                    self.similarity_search_batch(probes[:sz], k=k)
            self._hybrid_search_impl("warmup probe query", k=k)
            self._similarity_search_impl("warmup probe query", k=k)
        except Exception:
            # a failed warmup must not take the service down; the first
            # real query raises the same error to its caller
            _logger.exception("vector store warmup failed")

    # -------------------------------------------------------------- persist
    def save(self, directory: str) -> None:
        """Persist the store (embeddings + BM25 + chunk metadata) in the JAX
        package's layout: index.npz, bm25.json, rows.json."""
        os.makedirs(directory, exist_ok=True)
        with self._lock:
            self.index.save(os.path.join(directory, "index.npz"))
            self.bm25.save(os.path.join(directory, "bm25.json"))
            rows = {
                str(row): {"chunk_id": cid, "text": text, "metadata": meta}
                for row, (cid, text, meta) in self._row_data.items()
            }
            with open(os.path.join(directory, "rows.json"), "w") as f:
                json.dump({"collection": self.collection_name,
                           "rows": rows}, f)

    @classmethod
    def load(cls, directory: str, embedding_function, *, device=None,
             index_cls=None, index_loader=None, **kw) -> "TorchVectorStore":
        """index_cls: the index class to load (default ``FlatIndex``).
        index_loader: callable(path) -> index, for index types that need
        constructor arguments on restart (an ``AnnFlatIndex``'s nlist,
        nprobe, snapshot kind, ...)."""
        path = os.path.join(directory, "index.npz")
        if index_loader is not None:
            index = index_loader(path)
        else:
            index = (index_cls or FlatIndex).load(path, device=device)
        bm25 = BM25Index.load(os.path.join(directory, "bm25.json"),
                              device=index.device)
        with open(os.path.join(directory, "rows.json")) as f:
            state = json.load(f)
        store = cls(embedding_function, index=index, bm25=bm25,
                    collection_name=state.get("collection", "default"), **kw)
        # FlatIndex.load compacts tombstones, so physical rows changed;
        # remap via chunk_id -> new rows.
        new_rows = {}
        for data in state["rows"].values():
            cid = data["chunk_id"]
            for new_row in index._id_rows.get(cid, []):
                new_rows[new_row] = (cid, data["text"],
                                     data.get("metadata") or {})
        store._row_data = new_rows
        # bm25 postings reference OLD physical rows; rebuild from row data
        # when compaction changed them.
        if set(new_rows) != set(int(r) for r in state["rows"]):
            store.bm25 = BM25Index(k1=bm25.k1, b=bm25.b,
                                   stemming=bm25.stemming, device=index.device)
            store.bm25.add(list(new_rows),
                           [t for _c, t, _m in new_rows.values()])
        # resume the auto-id counter past restored ids
        prefix = f"{store.collection_name}:"
        max_auto = -1
        for cid, _t, _m in new_rows.values():
            if cid.startswith(prefix):
                suffix = cid[len(prefix):]
                if suffix.isdigit():
                    max_auto = max(max_auto, int(suffix))
        store._id_counter = itertools.count(max_auto + 1)
        return store

    # -------------------------------------------------- catalog-style access
    def get_by_ids(self, ids: Sequence[str]) -> list[Document]:
        out = []
        for cid in ids:
            for row in self.index._id_rows.get(cid, []):
                _c, text, meta = self._row_data[row]
                out.append(Document(page_content=text, metadata=dict(meta)))
        return out

    def ids(self) -> list[str]:
        return list(self.index._id_rows.keys())

